"""`test_torch_collective_bytes_train.py`'s check on the port mesh (1, 4)
of "cpu" (tensor and expert parallelism over four shards): the dry run's
collective bytes of every arch's reduced train step equal the live
step's, kind for kind."""
import pytest

from repro_torch.configs import registry
from test_torch_collective_bytes_train import check
from test_torch_mesh_serving import one_thread  # noqa: F401


@pytest.mark.parametrize("arch", registry.list_archs())
def test_train_dry_run_bytes_equal_the_live_step(arch, one_thread):
    check(arch, (1, 4))
