"""HNSW baseline (Malkov & Yashunin) — numpy, single-threaded; copy of
``src/repro/core/hnsw.py``.

The paper's primary comparison index: exponentially-sampled levels, greedy
descent through the upper layers, beam (ef) search at layer 0, M-bounded
neighbor lists with the simple-pruning heuristic.  It stays host numpy in
the port, line for line the reference's algorithm, so the same seed and the
same rows give the same graph, ids and distances bit for bit: it is the
serial pointer-chasing baseline the paper measures the GEMM templates
against, not a kernel to move onto the card.

It is also a *live* index tier: `repro_torch.api.Collection` with
`index_policy` "hnsw" (or "auto", above the size threshold) serves queries
from this graph.  The graph is strictly a derived structure — the IVF row
store (`core/index.IVFState`) remains the single source of truth for
durability, delta replay, residency, and save/load — so the lifecycle
semantics here are exact: `add` of an existing external id supersedes the
old node, `delete` tombstones the node (`dead`), and `live_ids()` always
equals the set of externally-visible ids.  Mutation and search are guarded
by the owning Collection's graph lock; within this class everything stays
single-threaded numpy on purpose.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class HNSW:
    def __init__(self, dim: int, *, m: int = 16, ef_construction: int = 100,
                 metric: str = "ip", seed: int = 0, max_elements: int = 1 << 20):
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.efc = ef_construction
        self.metric = metric
        self.ml = 1.0 / math.log(m)
        self.rng = np.random.default_rng(seed)
        self.vecs = np.zeros((0, dim), np.float32)
        self.levels: List[int] = []
        # graph[level][node] -> np.ndarray of neighbor ids
        self.graph: List[Dict[int, np.ndarray]] = []
        self.entry: Optional[int] = None
        self.max_level = -1
        self.ids: List[int] = []          # external ids (per internal node)
        self.id2node: Dict[int, int] = {}  # ext id -> its CURRENT node
        self.dead: set = set()             # internal nodes no longer visible

    # ------------------------------------------------------------------
    def _dist(self, q: np.ndarray, idx) -> np.ndarray:
        v = self.vecs[idx]
        if self.metric == "ip":
            return -(v @ q)
        d = v - q
        return np.einsum("...d,...d->...", d, d)

    def _sample_level(self) -> int:
        return int(-math.log(max(self.rng.random(), 1e-12)) * self.ml)

    # ------------------------------------------------------------------
    def _search_layer(self, q: np.ndarray, entry: int, ef: int,
                      level: int) -> List[Tuple[float, int]]:
        """Beam search in one layer; returns sorted (dist, node)."""
        import heapq
        g = self.graph[level]
        d0 = float(self._dist(q, entry))
        visited = {entry}
        cand = [(d0, entry)]                  # min-heap by distance
        best = [(-d0, entry)]                 # max-heap (worst first)
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0]:
                break
            for v in g.get(u, ()):            # pointer-chase: irregular reads
                v = int(v)
                if v in visited:
                    continue
                visited.add(v)
                dv = float(self._dist(q, v))
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-nd, n) for nd, n in best)

    def _select(self, cands: List[Tuple[float, int]], m: int) -> np.ndarray:
        """SELECT-NEIGHBORS-HEURISTIC (Malkov & Yashunin, Alg. 4).

        Keep candidate c only if it is closer to the query than to every
        already-selected neighbor — preserves cross-cluster connectivity
        that naive closest-m pruning destroys on clustered data.
        """
        selected: List[int] = []
        for d_cq, c in cands:                     # increasing distance
            if len(selected) >= m:
                break
            ok = True
            for s in selected:
                if float(self._dist(self.vecs[c], [s])[0]) < d_cq:
                    ok = False
                    break
            if ok:
                selected.append(c)
        # backfill with pruned candidates if the heuristic was too strict
        if len(selected) < m:
            chosen = set(selected)
            for _, c in cands:
                if len(selected) >= m:
                    break
                if c not in chosen:
                    selected.append(c)
        return np.asarray(selected, np.int64)

    def _link(self, node: int, neigh: np.ndarray, level: int):
        g = self.graph[level]
        g[node] = neigh
        mmax = self.m0 if level == 0 else self.m
        for v in neigh:
            v = int(v)
            cur = g.get(v)
            cur = np.append(cur, node) if cur is not None else np.asarray(
                [node], np.int64)
            if len(cur) > mmax:
                # shrink with the SAME diversity heuristic (as hnswlib):
                # naive closest-m eviction drops the cross-cluster edges and
                # disconnects the layer-0 graph on clustered data.
                d = self._dist(self.vecs[v], cur)
                order = np.argsort(d)
                cands = [(float(d[i]), int(cur[i])) for i in order]
                cur = self._select(cands, mmax)
            g[v] = cur

    # ------------------------------------------------------------------
    def add(self, x: np.ndarray, ext_id: Optional[int] = None) -> int:
        x = np.asarray(x, np.float32)
        node = len(self.levels)
        ext = int(ext_id) if ext_id is not None else node
        old = self.id2node.get(ext)
        if old is not None:               # re-insert supersedes the old row
            self.dead.add(old)
        self.id2node[ext] = node
        self.vecs = np.concatenate([self.vecs, x[None]], 0)
        self.ids.append(ext)
        lvl = self._sample_level()
        self.levels.append(lvl)
        while len(self.graph) <= lvl:
            self.graph.append({})
        if self.entry is None:
            self.entry = node
            self.max_level = lvl
            for l in range(lvl + 1):
                self.graph[l][node] = np.asarray([], np.int64)
            return node
        ep = self.entry
        for l in range(self.max_level, lvl, -1):       # greedy descent
            ep = self._search_layer(x, ep, 1, l)[0][1]
        for l in range(min(lvl, self.max_level), -1, -1):
            cands = self._search_layer(x, ep, self.efc, l)
            m = self.m0 if l == 0 else self.m
            self._link(node, self._select(cands, m), l)
            ep = cands[0][1]
        if lvl > self.max_level:
            self.max_level = lvl
            self.entry = node
        return node

    def build(self, xs: np.ndarray, ids=None):
        for i, x in enumerate(xs):
            self.add(x, None if ids is None else int(ids[i]))

    def delete(self, ext_id: int):
        """Tombstone an external id; absent ids are a no-op (idempotent)."""
        node = self.id2node.pop(int(ext_id), None)
        if node is not None:
            self.dead.add(node)

    def __len__(self) -> int:
        """Number of live (externally visible) ids."""
        return len(self.id2node)

    def live_ids(self) -> np.ndarray:
        """Sorted external ids currently visible to search."""
        return np.asarray(sorted(self.id2node), np.int64)

    # ------------------------------------------------------------------
    def search(self, q: np.ndarray, k: int, ef: int = 50
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float32)
        if self.entry is None or not self.id2node:
            return np.full(k, -1, np.int64), np.full(k, np.inf, np.float32)
        ep = self.entry
        for l in range(self.max_level, 0, -1):
            ep = self._search_layer(q, ep, 1, l)[0][1]
        # dead nodes still route (their edges hold the graph together until
        # the next rebuild purges them) but never surface in results; under
        # heavy churn the beam may be mostly dead, so widen it until k live
        # results emerge or the beam saturates
        ef_eff = max(ef, k)
        want = min(k, len(self.id2node))
        while True:
            res = self._search_layer(q, ep, ef_eff, 0)
            out = [(d, n) for d, n in res if n not in self.dead][:k]
            if len(out) >= want or len(res) < ef_eff or ef_eff >= 8 * max(ef, k):
                break
            ef_eff *= 2
        ids = np.asarray([self.ids[n] for _, n in out], np.int64)
        ds = np.asarray([d for d, _ in out], np.float32)
        if len(ids) < k:
            ids = np.pad(ids, (0, k - len(ids)), constant_values=-1)
            ds = np.pad(ds, (0, k - len(ds)), constant_values=np.inf)
        return ids, ds

    def search_batch(self, qs: np.ndarray, k: int, ef: int = 50):
        ids = np.stack([self.search(q, k, ef)[0] for q in qs])
        return ids

    def search_batch_scored(self, qs: np.ndarray, k: int, ef: int = 50
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Like `search_batch` but also returns the stacked distances."""
        outs = [self.search(q, k, ef) for q in qs]
        return (np.stack([o[0] for o in outs]),
                np.stack([o[1] for o in outs]))
