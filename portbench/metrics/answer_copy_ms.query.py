"""Host milliseconds per `ame.coll.query.to_host` range of the traced
window: the answers' two copies to the host.  The copy is the query's
first sync, so the range also waits for the device work queued on the
stream before it (other sessions' scans among it): it moves with that
queue as well as with the copies."""
from portbench.lib.readers import per_span_ms


def read(ctx):
    return per_span_ms(ctx, "ame.coll.query.to_host", "host_s")
