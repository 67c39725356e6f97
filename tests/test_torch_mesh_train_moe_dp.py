"""Training over the port's (data, model) mesh on the CPU for the MoE
family on (2, 1), by `test_torch_mesh_train.py`'s checks: reduced
olmoe-1b-7b with the batch over 'data' and the experts whole on each data
block (the reference's GSPMD branch), against the reference's
``Trainer(mesh=jax.sharding.Mesh(...))`` on (2, 1): 3 steps' loss and
grad norm, step 1's gradient leaf by leaf (the aux loss's fractions the
mean over the data blocks), replicas, bytes a shard.

Tolerances: `test_torch_mesh_train.py`'s (rtol 1e-5; each gradient leaf
to 1e-5 of its largest magnitude).
"""
import jax

from test_torch_mesh_serving import one_thread  # noqa: F401
from test_torch_mesh_train import reference_run, run_against_reference

jax.config.update("jax_platform_name", "cpu")

ARCH = "olmoe-1b-7b"


def test_olmoe_data_parallel_train_matches_reference_mesh_step():
    """olmoe-1b-7b on (2, 1), the experts whole, against the reference's
    Trainer on (2, 1)."""
    run_against_reference(reference_run(ARCH, (2, 1)), ARCH, (2, 1))
