"""The port's single-tenant engine shim and quickstart, on the CPU.

`repro_torch.core.engine.AgenticMemoryEngine` keeps the reference's
signatures and on-disk layout: engines saved by either package load in the
other and answer with the same ids.  The quickstart asserts sync ==
futures == cross-collection batched results; the sharded example
(`repro_torch.distributed_memory`) what ``examples/distributed_memory.py``
checks, on 8 CPU shards.
"""
import numpy as np
import pytest

from repro.configs.base import EngineConfig as JConfig
from repro.core.engine import AgenticMemoryEngine as JEngine
from repro_torch import distributed_memory, quickstart
from repro_torch.configs.base import EngineConfig
from repro_torch.core.engine import AgenticMemoryEngine
from repro_torch.core.scheduler import WindowedScheduler

ARGS = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=4,
            kmeans_iters=2)
CFG = EngineConfig(**ARGS)


def _corpus(n, seed=0, dim=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_engine_shim_lifecycle_and_submit():
    sched = WindowedScheduler()
    try:
        eng = AgenticMemoryEngine(CFG, scheduler=sched, device="cpu")
        x = _corpus(300)
        eng.build(x)
        assert eng.stats()["live"] == 300 and eng._built
        ids, scores = eng.query(x[:5], k=4)
        np.testing.assert_array_equal(ids[:, 0], np.arange(5))
        assert eng.insert(_corpus(8, seed=1)) == 0
        assert eng._next_id == 308
        assert eng.delete(np.arange(3)) == 3
        assert eng.rebuild()["aborted"] is False
        assert eng.stats()["live"] == 305
        task = eng.submit("query", x[5:7], k=4)
        assert task.done.wait(30) and task.error is None
        np.testing.assert_array_equal(task.result[0][:, 0], [5, 6])
        assert eng.counters["queries"] >= 7
        with pytest.raises(TypeError, match="unknown submit kwargs"):
            eng.submit("query", x[:1], bogus=1)
        no_sched = AgenticMemoryEngine(CFG, device="cpu")
        with pytest.raises(RuntimeError, match="without scheduler"):
            no_sched.submit("query", x[:1])
    finally:
        sched.shutdown()


@pytest.mark.parametrize("store_dtype", ["float32", "int8"])
def test_engine_saved_by_the_reference_loads_in_the_port(tmp_path,
                                                         store_dtype):
    jeng = JEngine(JConfig(use_kernel=False, store_dtype=store_dtype,
                           rescore_k=32, **ARGS))
    x = _corpus(300, seed=3)
    jeng.build(x)
    jeng.insert(_corpus(8, seed=4))
    jeng.save(str(tmp_path), step=2)
    cfg = EngineConfig(store_dtype=store_dtype, rescore_k=32, **ARGS)
    eng = AgenticMemoryEngine.load(str(tmp_path), cfg, device="cpu")
    assert eng._built and eng._next_id == 308
    assert eng.counters["inserts"] == jeng.counters["inserts"]
    for path in ("full_scan", "probed"):
        want = jeng.query(x[:6], k=4, path=path)
        got = eng.query(x[:6], k=4, path=path)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-3)
    # and back: the port's save loads in the reference
    eng.save(str(tmp_path / "back"))
    back = JEngine.load(str(tmp_path / "back"), jeng.cfg)
    np.testing.assert_array_equal(back.query(x[:6], k=4)[0],
                                  eng.query(x[:6], k=4)[0])


def test_quickstart_runs_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "sync == future == cross-collection batched: OK" in out
    assert "recall@5 = 1.000" in out


def test_distributed_memory_runs_on_the_cpu(capsys):
    distributed_memory.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "lists sharded over 8 shards" in out
    assert "(7/8 sibling shards untouched)" in out
    assert "fused 2-tenant sharded window == per-tenant query" in out
    assert "16128 live rows on 8 shards" in out
