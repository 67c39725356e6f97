"""The yardstick's cost functions against hand counts at PAPER_1M."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.lib import costs  # noqa: E402

F32 = {"dim": 1024, "n_clusters": 1024, "list_capacity": 1464, "nprobe": 64,
       "k": 10, "store_dtype": "float32", "compute_dtype": "bfloat16",
       "rescore_k": 128, "kmeans_iters": 10}
I8 = dict(F32, store_dtype="int8")
SPILL = 4096
SLOTS = 1024 * 1464 + 4096          # 1,503,232


def test_slots():
    assert costs.slots(F32, SPILL) == SLOTS == 1_503_232


def test_full_scan_f32_is_the_store_once():
    # 1,503,232 slots x (1024 f32 + an i32 id), 8 queries in, 8 x 10 out
    nbytes = SLOTS * (1024 * 4 + 4) + 8 * 1024 * 4 + 8 * 10 * 8
    assert costs.full_scan_s(F32, SPILL, 8) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert costs.full_scan_s(F32, SPILL, 8) * 1e3 == pytest.approx(1.84,
                                                                  abs=5e-3)


def test_probed_f32_b1():
    # the centroids, 64 lists of 1464 slots and the spill, one query
    nbytes = (1024 * 1024 * 4 + 64 * 1464 * (1024 * 4 + 4)
              + 4096 * (1024 * 4 + 4) + 1024 * 4 + 10 * 8)
    assert costs.probed_s(F32, SPILL, 1) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert costs.probed_s(F32, SPILL, 1) * 1e3 == pytest.approx(0.12,
                                                               abs=2e-3)


def test_probed_reads_a_list_once_however_many_queries_probe_it():
    many = costs.probed_s(F32, SPILL, 64)     # 64 x 64 probes > 1024 lists
    assert costs.probed_s(F32, SPILL, 16) <= many
    whole = 1024 * 1464 * (1024 * 4 + 4)
    assert many * 3.35e12 < whole + 1024 * 1024 * 4 + 4096 * 4100 + 64 * 5000


def test_full_scan_int8_reads_codes_and_rescores():
    b, r = 8, 128
    nbytes = (SLOTS * (1024 + 4) + 2 * (1024 + 4096) * 4
              + b * r * (1024 * 4 + 4) + b * 1024 * 4 + b * 10 * 8)
    t_ops = 2 * b * SLOTS * 1024 / 1979e12 + 2 * b * r * 1024 / 67e12
    assert costs.full_scan_s(I8, SPILL, b) == pytest.approx(
        max(nbytes / 3.35e12, t_ops), rel=1e-12)
    # a quarter of the f32 scan's bytes, about
    assert 0.2 < costs.full_scan_s(I8, SPILL, b) / costs.full_scan_s(
        F32, SPILL, b) < 0.3


def test_insert_of_1024_rows():
    # read the rows and the centroids, write rows and ids; 1024 x 1024
    # x 1024 bf16 products (2.2 us) lose to the bytes (3.8 us)
    nbytes = 1024 * 1024 * 4 + 1024 * 1024 * 4 + 1024 * (1024 * 4 + 4)
    assert costs.insert_s(F32, SPILL, 1024) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert costs.insert_s(I8, SPILL, 1024) > costs.insert_s(F32, SPILL, 1024)


def test_delete_reads_every_id_once():
    assert costs.delete_s(F32, SPILL, 1024) == pytest.approx(
        (SLOTS * 4 + 2 * 1024 * 4) / 3.35e12, rel=1e-12)


def test_rebuild_of_a_million_live_rows():
    m = 1_000_000
    # eleven passes of m x 1024 x 1024 bf16 products (2.17 ms each) beat
    # each pass's read of the rows (1.22 ms); then the pack's writes
    one = max((m * 1024 * 4 + 1024 * 1024 * 4) / 3.35e12,
              2 * m * 1024 * 1024 / 989e12 + m * 1024 / 67e12)
    pack = m * (1024 * 4 + 4) / 3.35e12
    ids = SLOTS * 4 / 3.35e12
    assert costs.rebuild_s(F32, SPILL, m) == pytest.approx(
        ids + 11 * one + pack, rel=1e-12)
    assert 24e-3 < costs.rebuild_s(F32, SPILL, m) < 26e-3
    assert costs.build_s(F32, SPILL, m) < costs.rebuild_s(F32, SPILL, m)


def test_query_dispatch_by_path():
    assert costs.query_s(F32, SPILL, 4, "full_scan") == costs.full_scan_s(
        F32, SPILL, 4)
    assert costs.query_s(F32, SPILL, 1, "probed") == costs.probed_s(
        F32, SPILL, 1)
    with pytest.raises(ValueError):
        costs.query_s(F32, SPILL, 1, "hnsw")
