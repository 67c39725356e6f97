"""Launches of the two scan kernels (`scan_scores`, `scan_scores_q8`, every
variant the port counts) per query vector answered, from the window's
differences of `MemoryService.counters()`.  `launches.scan_scores.two_segment`
is left out: it counts again launches that the variant keys count."""
from portbench.lib.readers import COLLECTION

SCANS = ("launches.scan_scores.", "launches.scan_scores_q8.")
AGAIN = "launches.scan_scores.two_segment"


def read(ctx):
    vectors = ctx.counters(f"coll.{COLLECTION}.queries")
    if not vectors:
        return None
    return sum(v for k, v in ctx.counters.items()
               if k.startswith(SCANS) and k != AGAIN) / vectors
