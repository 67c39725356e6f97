"""The agentic memory sharded over a mesh, through the port's service.

    python -m repro_torch.distributed_memory [--device cpu]

The counterpart of ``examples/distributed_memory.py``.  A collection
created with ``shard_db=True`` and a `ShardMesh` splits its IVF lists
slot-wise over 8 shards (a 4 x 2 mesh), all on the CUDA card unless
``--device`` names another; each shard scans its own slots and the
candidates merge into a global top-k, behind the same `MemoryService`
calls as an unsharded collection.  It runs block-wise insert routing,
cross-collection fused queries over sharded tenants (one dispatch for G
tenants, equal to querying each alone), shard-local deletes and a rebuild
of one shard with its siblings untouched, and sharded save/load — and
asserts what the example checks.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.api import MemoryService
from repro_torch.configs.base import EngineConfig
from repro_torch.core import metrics
from repro_torch.core.distributed import make_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of every shard (default: the card)")
    args = ap.parse_args(argv)

    mesh = make_mesh((4, 2), ("data", "model"), args.device)
    cfg = EngineConfig(dim=128, n_clusters=128, list_capacity=64,
                       nprobe=16, k=5, kmeans_iters=4, shard_db=True)
    rng = np.random.default_rng(0)
    n = 16_384
    x = rng.standard_normal((n, cfg.dim), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = np.arange(n, dtype=np.int32)

    with MemoryService(device=mesh.devices[0]) as svc:
        svc.create_collection("planet", cfg, mesh=mesh)
        svc.build("planet", x, ids=ids)
        print(f"distributed build ok: lists sharded over {mesh.size} "
              f"shards on {mesh.devices[0]} (slots per shard "
              f"{cfg.capacity})")

        q = x[:8] + 0.02 * rng.standard_normal((8, cfg.dim),
                                               dtype=np.float32)
        got_ids, _ = svc.query("planet", q, k=5)
        true = metrics.brute_force_topk(q, x, ids, 5, device=svc.device)
        rec = metrics.recall_at_k(got_ids, true)
        print(f"distributed query recall@5 = {rec:.3f}")
        # every slot is scanned; bf16 products may swap near-ties
        assert rec >= 0.9, rec

        new = rng.standard_normal((256, cfg.dim), dtype=np.float32)
        spilled = svc.insert("planet", new,
                             ids=np.arange(n, n + 256, dtype=np.int32))
        print(f"distributed insert: 256 rows routed to shards "
              f"({spilled} spilled)")
        got_ids2, _ = svc.query("planet", new[:4], k=1)
        hit = np.mean(got_ids2[:, 0] >= n)
        print(f"fresh inserts retrievable: {hit:.0%} of probes return a "
              "new id at rank 1")
        assert hit == 1.0, got_ids2

        # shard-local maintenance: tombstone rows, compact ONE shard
        n_hit = svc.delete("planet", np.arange(512))
        coll = svc.collection("planet")
        hot = int(np.argmax([s["tombstones"]
                             for s in coll.maintenance_pressure()["shards"]]))
        v_before = coll.shard_versions()
        out = svc.rebuild("planet", shard=hot)
        v_after = coll.shard_versions()
        untouched = sum(a == b for a, b in zip(v_before, v_after))
        print(f"deleted {n_hit} rows; shard-local rebuild of shard {hot} "
              f"reclaimed its tombstones in {out['rebuild_s']:.2f}s "
              f"({untouched}/{len(v_after)} sibling shards untouched)")
        assert n_hit == 512 and untouched == mesh.size - 1

        # G same-mesh sharded tenants in one window: one dispatch, equal
        # to querying each tenant on its own
        svc.create_collection("moon", cfg, mesh=mesh)
        svc.build("moon", rng.standard_normal((4_096, cfg.dim),
                                              dtype=np.float32))
        planet_r, _ = svc.query_many([("planet", q), ("moon", q)], k=5)
        solo_ids, solo_scores = svc.query("planet", q, k=5)
        np.testing.assert_array_equal(planet_r[0], solo_ids)
        np.testing.assert_array_equal(planet_r[1], solo_scores)
        print("fused 2-tenant sharded window == per-tenant query "
              "(one dispatch, equal results)")
        svc.drop_collection("moon")

        # sharded persistence: one checkpoint namespace per shard
        live = coll.stats()["live"]
        with tempfile.TemporaryDirectory() as d:
            svc.save(d)
            restored = MemoryService.load(d, mesh=mesh, maintenance=False,
                                          device=svc.device)
            st = restored.collection("planet").stats()
            print(f"sharded save/load round-trip: {st['live']} live rows "
                  f"on {st['shards']} shards")
            assert st["live"] == live == n + 256 - 512
            restored.shutdown()


if __name__ == "__main__":
    main()
