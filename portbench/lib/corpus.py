"""The benchmark's data: a clustered unit-norm corpus, the rows that
writers insert, and the perturbed queries, all made on the device from the
seed.

Frozen copy of `chip_smoke.py`'s phase-4 generator (`make_corpus`,
`perturb`): unit rows around n/25 random topic directions, and a query is a
live row plus 0.3/sqrt(d) of noise, renormalised.  Three changes: the
corpus is written in chunks into a buffer the caller owns (no second 4 GB
temporary), the topic directions are kept, so that rows inserted later
come from the same topics as the corpus, and the queries' noise is drawn
ahead, many vectors in one call (`noise`).  Every row is a function of its
id alone: corpus row i of `corpus_into`, inserted batch j of `batch_rows`,
so the reference can make any row again after the window.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 17          # corpus rows made per call


def mix(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for (seed, tags): any whole seed, however
    large, gives its own stream."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *[int(t) for t in tags]]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


# stream tags: one per use of the seed
TOPICS, CORPUS, INSERT, SESSION, WARMUP, PROGRAM = range(6)


def n_topics(rows: int, rows_per_topic: int) -> int:
    return max(1, rows // rows_per_topic)


def topic_centers(seed: int, topics: int, d: int, device) -> torch.Tensor:
    g = generator(device, seed, TOPICS)
    return torch.nn.functional.normalize(
        torch.randn(topics, d, generator=g, device=device), dim=1)


def _around(centers: torch.Tensor, topic: torch.Tensor,
            g: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    d = centers.shape[1]
    torch.index_select(centers, 0, topic, out=out)
    out += torch.randn(out.shape, generator=g,
                       device=out.device).div_(math.sqrt(d))
    return torch.nn.functional.normalize(out, dim=1, out=out)


def corpus_into(out: torch.Tensor, centers: torch.Tensor,
                seed: int) -> torch.Tensor:
    """Fill out f32[N, D] with the corpus: row i gets a topic drawn
    uniformly and unit noise of 1/sqrt(D) a component, renormalised."""
    g = generator(out.device, seed, CORPUS)
    topics = centers.shape[0]
    for lo in range(0, out.shape[0], CHUNK):
        hi = min(lo + CHUNK, out.shape[0])
        topic = torch.randint(0, topics, (hi - lo,), generator=g,
                              device=out.device)
        _around(centers, topic, g, out[lo:hi])
    return out


def batch_rows(centers: torch.Tensor, seed: int, j: int,
               rows: int) -> torch.Tensor:
    """Inserted batch j: `rows` rows around topics drawn uniformly."""
    g = generator(centers.device, seed, INSERT, j)
    topic = torch.randint(0, centers.shape[0], (rows,), generator=g,
                          device=centers.device)
    out = torch.empty((rows, centers.shape[1]), dtype=torch.float32,
                      device=centers.device)
    return _around(centers, topic, g, out)


def noise(n: int, d: int, g: torch.Generator, scale: float) -> torch.Tensor:
    """f32[n, d] of noise, `scale`/sqrt(d) a component."""
    return torch.randn((n, d), generator=g,
                       device=g.device).mul_(scale / math.sqrt(d))


def perturb(rows: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Queries: rows plus their noise, renormalised."""
    return torch.nn.functional.normalize(rows + noise, dim=1)
