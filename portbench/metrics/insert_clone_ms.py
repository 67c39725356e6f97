"""Device milliseconds per `ame.index.insert.clone` range of the traced
window: the copy-on-write clone of the store's fields that an insert
touches, no work the insert itself needs."""
from portbench.lib.readers import per_span_ms


def read(ctx):
    return per_span_ms(ctx, "ame.index.insert.clone", "device_s")
