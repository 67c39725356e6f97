"""The dry run's collective bytes of every arch's reduced train step on
the port mesh (2, 2) of "cpu" against a `CollectiveCounter` around the
same step of the live `Trainer(mesh=)` (one step, forward, backward, the
replicas' gradient sums and the global norm), kind for kind (exact
fractions).  The (1, 4) mesh is `test_torch_collective_bytes_train_tp.py`;
the decode steps and the formulas `test_torch_collective_bytes.py`."""
import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import api, sharding
from repro_torch.train.trainer import Trainer
from test_torch_collective_bytes import BATCH, SEQ, dry_bytes
from test_torch_mesh_serving import one_thread  # noqa: F401

ARCHS = registry.list_archs()
SHAPE = (2, 2)


def live_train_bytes(cfg, shape) -> dict:
    """A `CollectiveCounter` around one step of `Trainer(mesh=)` on the
    CPU mesh, on a batch of the dry run's shape."""
    tr = Trainer(cfg, TrainConfig(), mesh=lmesh.model_mesh(
        shape, ("data", "model"), "cpu"))
    rng = np.random.default_rng(0)
    host = {k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(
        np.int32) for k in ("tokens", "targets")}
    with sharding.CollectiveCounter() as c:
        tr.train(api.adapt_batches(iter([host]), cfg, seed=0), 1)
    return c.wire


def check(arch: str, shape) -> None:
    cfg = registry.reduced_arch(arch)
    want = live_train_bytes(cfg, shape)
    assert want
    assert dry_bytes(cfg, "train", shape) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_dry_run_bytes_equal_the_live_step(arch, one_thread):
    check(arch, SHAPE)
