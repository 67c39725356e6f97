"""The control: the plain reference put in the program's place at the
precision below the configuration's (fp8 for bf16 products, bf16 for the
int8 store's exact float32 rescore) must come out not correct, at a size
a CPU test holds; the program's own run on the same cell is correct."""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench.lib import harness, tiny  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, seed, **kw):
    return harness.run(cell, seed, 1.0, False, t_process=time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("name", ["f32-hybrid", "f32-recall", "int8-hybrid"])
def test_control_fails_where_the_program_passes(name):
    cell = tiny.cell(name, ROOT)
    seed = 2 ** 32 + 99
    prog = _run(cell, seed)
    ctl = _run(cell, seed, control=cell.limits["control"])
    assert prog["correct"], prog["checks"]
    assert not ctl["correct"], ctl["checks"]
    c, p = ctl["checks"], prog["checks"]
    assert c["score_err"]["value"] > c["score_err"]["limit"]
    assert c["score_err"]["value"] > 3 * p["score_err"]["value"]

