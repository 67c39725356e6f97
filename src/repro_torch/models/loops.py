"""Loops of identical iterations, marked for the dry run.

The reference writes these loops as ``lax.scan``; its dry run reads the
trip count of each ``while`` in the compiled HLO and multiplies the body's
cost by it (``src/repro/launch/hlo_analysis.py`` ``rollup``).  The port
runs them as Python loops, so `scan` marks them by name:
`repro_torch.launch.op_analysis` traces a step with each marked loop cut
to a few trips and extends the counts to the real trip count, which keeps
a full-width dry run of a 32k-token rwkv6 prefill (about 49,000
iterations) within seconds.

Outside `truncated` (every real run) `scan` is a plain loop.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

# {loop name: trips to run} and {loop name: its real trip count} while the
# dry run traces one corner (`truncated`); None otherwise.  Module state and
# not thread-local: autograd may recompute a checkpointed layer, loops
# included, on its own thread.
_TRIPS: Optional[Dict[str, int]] = None
_SEEN: Optional[Dict[str, int]] = None


def scan(name: str, body: Callable, carry, n: int) -> Tuple[object, List]:
    """``carry, y_i = body(i, carry)`` for i in range(n); returns (carry,
    [y_0, ..., y_{n-1}]).

    Inside `truncated`, only the first ``min(n, trips[name])`` iterations
    run and the last output stands in for the rest (the tensors are on the
    meta device, so only their shapes matter); every iteration must cost
    the same."""
    k = n
    if _TRIPS is not None:
        if _SEEN.setdefault(name, n) != n:
            raise ValueError(f"loop {name!r} ran {n} and {_SEEN[name]} trips "
                             "in one step; the dry run extends one count")
        k = min(n, _TRIPS.get(name, _TRIPS["*"]))
    ys = []
    for i in range(k):
        carry, y = body(i, carry)
        ys.append(y)
    return carry, ys + ys[-1:] * (n - k)


@contextlib.contextmanager
def truncated(trips: Dict[str, int]):
    """Run each marked loop for at most ``trips[name]`` trips (a loop not
    named, at most ``trips["*"]``); yields ``{name: real trip count}`` of
    the loops that ran."""
    global _TRIPS, _SEEN
    if _TRIPS is not None:
        raise RuntimeError("truncated() does not nest")
    _TRIPS, _SEEN = dict(trips), {}
    try:
        yield _SEEN
    finally:
        _TRIPS = _SEEN = None
