"""`test_torch_collective_extend.py`'s check for train steps: the mesh
dry run of a reduced train step on the port mesh (1, 4) of meta devices,
its layer stacks cut to 1 and 2 trips and extended to 3, equals the
unrolled trace (collective bytes by kind, raw bytes, ops and paths; one
device's FLOPs, bytes and ops), for an arch of each family."""
import pytest

from test_torch_collective_extend import check_extended
from test_torch_mesh_serving import one_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b",
                                  "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_train_extended_equals_unrolled(arch, one_thread):
    check_extended("train", arch)
