"""Host milliseconds per `ame.index.probed` range of the traced window:
all of `query_probed` for one B=1 request (the centroid top-k, the slabs'
gather, the scan's launch, the top-k).  Inclusive: its child spans
(`ame.index.probed.gather`, `ame.kernel.*`) are of the same layer, and
the GIL's share (a ctypes launch wins the GIL back inside its range) and
the profiler's own cost a range are in it, so it moves with the host's
speed as well as with the path's work."""
from portbench.lib.readers import per_span_ms


def read(ctx):
    return per_span_ms(ctx, "ame.index.probed", "host_s")
