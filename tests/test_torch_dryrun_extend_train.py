"""The dry run's trip-count extension against the unrolled train step
(forward, per-layer recompute, backward and AdamW), as
`test_torch_dryrun_extend` holds prefill and decode."""
import pytest

from repro_torch.configs import registry
from test_torch_dryrun_extend import check_extension


@pytest.mark.parametrize("arch", registry.list_archs())
def test_extended_counts_equal_the_unrolled_train_step(arch):
    check_extension(arch, "train")
