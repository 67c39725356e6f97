"""The dry run's trip-count extension (`op_analysis.extend`) against the
unrolled step, op for op, at reduced width on the meta device.

Each arch is deepened so that every repeated loop is longer than the two
cut trip counts the extension traces: 4 trips of its layer stack (a trip
is a layer, gemma2's local/global pair or zamba2's group of mamba layers
with the shared block; seamless has two stacks), and sequences long
enough for rwkv6's chunk and sub-block loops (4 x 4) and zamba2's SSD
chunk recurrence (4 chunks).
"""
import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

TRIPS = 4


def _deep(arch: str):
    cfg = registry.reduced_arch(arch)
    if cfg.is_encdec:
        return cfg.replace(num_enc_layers=TRIPS, num_dec_layers=TRIPS)
    (_, _, unit), = dryrun.layer_axes(cfg).values()
    return cfg.replace(num_layers=TRIPS * unit)


def _seq(cfg) -> int:
    return 512 if cfg.family == "hybrid" else 256


def check_extension(arch: str, kind: str) -> None:
    """Dot FLOPs, HBM bytes (in total, by aten op and by module), ops,
    argument, output and alias bytes equal the unrolled trace's exactly;
    so does the peak of live bytes, but zamba2's prefill, whose peak the
    extension puts 1 KiB (two 512-byte allocations) above the unrolled
    one."""
    cfg = _deep(arch)
    shape = ShapeConfig("extend", kind, _seq(cfg), 2)
    ext, n_traces = dryrun.trace_cell(cfg, shape)
    full, _ = dryrun.trace_cell(cfg, shape, unrolled=True)
    assert n_traces >= 2
    for field in ("dot_flops", "dot_flops_by_dtype", "hbm_bytes_est",
                  "hbm_by_op", "by_module", "n_ops", "argument_bytes",
                  "output_bytes", "alias_bytes"):
        assert getattr(ext, field) == getattr(full, field), field
    slack = 1024 if (cfg.family, kind) == ("hybrid", "prefill") else 0
    assert 0 <= ext.temp_bytes - full.temp_bytes <= slack


@pytest.mark.parametrize("arch", registry.list_archs())
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_extended_counts_equal_the_unrolled_step(arch, kind):
    check_extension(arch, kind)
