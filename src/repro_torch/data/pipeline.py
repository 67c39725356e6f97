"""Data pipeline: memmap token shards, per-host slicing, prefetch.

A copy of ``src/repro/data/pipeline.py`` (numpy and threading only), so
that the port imports nothing of the JAX package; the same seed gives the
same batches in both.

Production shape: a directory of uint32 token files (one per shard);
each host reads only its slice (host_id/host_count), a deterministic
shuffled cursor walks sequence windows, and a background thread keeps a
prefetch queue full so step N+1's batch is host-resident before step N
finishes.  A synthetic backend generates data when no corpus directory is
given (CPU container / tests).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenDataset:
    def __init__(self, directory: Optional[str], vocab_size: int,
                 seq_len: int, batch_size: int, *, host_id: int = 0,
                 host_count: int = 1, seed: int = 0,
                 synthetic_tokens: int = 1 << 22):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.host_id = host_id
        self.host_count = host_count
        self.rng = np.random.default_rng(seed + host_id)
        if directory and os.path.isdir(directory):
            shards = sorted(
                os.path.join(directory, f) for f in os.listdir(directory)
                if f.endswith(".bin"))
            mine = shards[host_id::host_count]
            assert mine, "no shards for this host"
            self.data = np.concatenate(
                [np.memmap(s, dtype=np.uint32, mode="r") for s in mine])
        else:
            # synthetic: Zipf-ish token stream, deterministic per host
            self.data = self.rng.integers(
                0, vocab_size, synthetic_tokens, dtype=np.uint32)
        self.n_windows = (len(self.data) - 1) // seq_len
        self.order = self.rng.permutation(self.n_windows)
        self.cursor = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        for i in range(self.batch):
            if self.cursor >= self.n_windows:
                self.cursor = 0
                self.order = self.rng.permutation(self.n_windows)
            w = self.order[self.cursor] * self.seq
            toks[i] = self.data[w: w + self.seq + 1]
            self.cursor += 1
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state(self) -> dict:
        return {"cursor": int(self.cursor)}

    def restore(self, state: dict):
        self.cursor = state["cursor"]


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
