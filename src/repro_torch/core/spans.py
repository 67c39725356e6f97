"""Named spans of the program's phases, for a profiler's trace.

`span(name)` opens a `torch.profiler.record_function` range only while a
torch profiler records; otherwise it returns one shared no-op context, so
an untraced run pays a function call and a flag read per span and records
nothing.  The ranges land on the profiler's own clock beside the device
work they launch: in a trace, the innermost span that encloses a launch on
its thread names the phase that the device time (and the idle gap before
it) belongs to, and an enclosing span is the one that caused it.

Every name starts with ``ame.``: ``ame.coll.*`` for a collection's steps
(`api/collection.py`), ``ame.index.*`` for the index templates
(`core/index.py`), ``ame.kernel.<kernel>`` around each hand-written
kernel's launch (`kernels/*.py`).
"""
from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler


class _Off:
    """The no-op context (cheaper to enter than `contextlib.nullcontext`)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A context that records `name` as a profiler range while a torch
    profiler records, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
