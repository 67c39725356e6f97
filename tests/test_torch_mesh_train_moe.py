"""Training over the port's (data, model) mesh on the CPU for the MoE
family, by `test_torch_mesh_train.py`'s checks: reduced olmoe-1b-7b (4
experts, top-2) through `Trainer(mesh=)` on (1, 2): the expert-parallel
branch (2 experts a 'model' shard, one sum over 'model'), against the
reference's ``Trainer(mesh=jax.sharding.Mesh(...))`` on (1, 2): 3 steps'
loss and grad norm (the aux loss's router gradient included), step 1's
gradient leaf by leaf, replicas, bytes a shard.  (2, 1), the experts
whole on each data block, is `test_torch_mesh_train_moe_dp.py` (each file
compiles its own reference run).

Tolerances: `test_torch_mesh_train.py`'s (rtol 1e-5; each gradient leaf
to 1e-5 of its largest magnitude).
"""
import jax

from test_torch_mesh_serving import one_thread  # noqa: F401
from test_torch_mesh_train import reference_run, run_against_reference

jax.config.update("jax_platform_name", "cpu")

ARCH = "olmoe-1b-7b"


def test_olmoe_expert_parallel_train_matches_reference_mesh_step():
    """olmoe-1b-7b on (1, 2), expert-parallel, against the reference's
    Trainer on (1, 2)."""
    run_against_reference(reference_run(ARCH, (1, 2)), ARCH, (1, 2))
