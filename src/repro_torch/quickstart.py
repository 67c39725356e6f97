"""Quickstart of the port: the multi-tenant agentic memory service.

    python -m repro_torch.quickstart [--device cpu]

Two named collections live behind one `MemoryService`, on the CUDA card
unless ``--device`` names another.  Every op routes through the workload
templates and the windowed scheduler: synchronous calls, futures, and
cross-collection batched queries all take the same execution path — and
return the same results, which this script asserts.  The counterpart of
``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import MemoryOp, MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    dim, n = 256, 8_000
    cfg = EngineConfig(dim=dim, n_clusters=128, list_capacity=256,
                       nprobe=16, k=5, kmeans_iters=5)

    def corpus(seed):
        x = np.random.default_rng(seed).standard_normal(
            (n, dim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    notes, docs = corpus(1), corpus(2)

    with MemoryService(device=args.device) as svc:
        svc.create_collection("notes", cfg)
        svc.create_collection("docs", cfg)
        stats = svc.build("notes", notes)
        svc.build("docs", docs, ids=np.arange(1_000_000, 1_000_000 + n))
        print(f"built 2 collections x {n} vectors on {svc.device} "
              f"(notes in {stats['build_s']:.2f}s)")

        # --- query: recall vs exact ground truth, per tenant ---
        q = notes[:16] + 0.02 * rng.standard_normal(
            (16, dim)).astype(np.float32)
        ids, scores = svc.query("notes", q, k=5)
        true = metrics.brute_force_topk(q, notes, np.arange(n), 5,
                                        device=svc.device)
        print(f"notes recall@5 = {metrics.recall_at_k(ids, true):.3f}")
        print(f"query 0 -> ids {ids[0].tolist()} scores "
              f"{np.round(scores[0], 3).tolist()}")

        # --- same request, three execution modes, identical answers ---
        qd = docs[:8]
        sync_ids, _ = svc.query("docs", qd, k=5)
        fut = svc.submit(MemoryOp("query", "docs", qd, k=5))
        fut_ids, _ = fut.result()
        batched = svc.query_many([("notes", q), ("docs", qd)], k=5)
        np.testing.assert_array_equal(sync_ids, fut_ids)
        np.testing.assert_array_equal(sync_ids, batched[1][0])
        np.testing.assert_array_equal(ids, batched[0][0])
        print("sync == future == cross-collection batched: OK "
              f"(docs ids all >= 1e6: {(sync_ids >= 1_000_000).all()})")

        # --- continual updates: insert / delete / rebuild, per tenant ---
        new = rng.standard_normal((512, dim)).astype(np.float32)
        spilled = svc.insert("notes", new)
        print(f"inserted 512 rows into notes ({spilled} spilled)")
        svc.delete("notes", np.arange(100))
        live = svc.collection("notes").stats()["live"]
        print(f"deleted 100 ids from notes; live={live}")
        r = svc.rebuild("notes")
        print(f"rebuilt notes in {r['rebuild_s']:.2f}s "
              f"(reclaimed tombstones, drained spill)")
        st = svc.stats()
        print(f"final: notes live={st['collections']['notes']['live']} "
              f"docs live={st['collections']['docs']['live']} "
              f"scheduler completed={st['scheduler'].get('completed', 0)}")


if __name__ == "__main__":
    main()
