"""The work counters (K1's bound and the whole predict's) on hand-worked shapes."""

import numpy as np
import pytest

from portbench.models import xrlinear_work as work

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flop_per_s": 1e12}


def test_level_work_counts_real_slots_of_distinct_rows():
    children = np.array([[0, 1, -1], [2, 3, 4]])
    real = np.array([5, 5, 4, 4, 0])  # node 4 holds no real weight
    beam = np.array([[0, 1], [1, -1]])  # query 2's second slot is empty
    lw = work.level_work(beam, children, real)
    # candidates: q0 -> 0, 1, 2, 3, 4; q1 -> 2, 3, 4
    assert lw == {"candidates": 8, "slots": 5 + 5 + 4 + 4 + 0 + 4 + 4 + 0, "rows": 5, "row_slots": 18}


def test_k1_call_bound_bytes_and_operations():
    lw = {"candidates": 8, "slots": 26, "rows": 5, "row_slots": 18}
    one = work.k1_call(lw, query_nnz=10, peaks=PEAKS)
    assert one["bytes"] == 8 * 18 + 12 * 8 + 8 * 10
    assert one["ops"] == 52
    assert one["by"] == "bytes" and one["seconds"] == pytest.approx(320e-12)
    fast_memory = dict(PEAKS, hbm_bytes_per_s=1e15)
    assert work.k1_call(lw, 10, fast_memory)["by"] == "operations"


def test_predict_bound_counts_queries_and_top_k_once():
    lws = [{"candidates": 2, "slots": 10, "rows": 2, "row_slots": 10},
           {"candidates": 8, "slots": 26, "rows": 5, "row_slots": 18}]
    one = work.predict_batch(lws, query_nnz=10, n_queries=2, topk=3, peaks=PEAKS)
    assert one["bytes"] == 8 * 28 + 8 * 10 + 8 * 2 * 3
    assert one["ops"] == 72


def test_traced_work_sums_calls_of_k1_levels_only():
    children = [np.array([[0, 1]]), np.array([[0, 1], [2, -1]])]
    real = [np.array([3, 3]), np.array([2, 2, 2])]
    batch = (np.array([4, 6]), [np.zeros((2, 1), np.int64), np.array([[0], [1]])])
    got = work.traced_work([batch, batch], children, real, [False, True], topk=1, peaks=PEAKS)
    assert got["k1"]["calls"] == 2 and got["batches"] == 2
    # level 1: q0 -> rows 0, 1; q1 -> row 2: 3 candidates, 6 slots, 3 rows
    assert got["k1"]["bytes"] == 2 * (8 * 6 + 12 * 3 + 8 * 10)
    assert got["predict"]["bytes"] == 2 * (8 * (6 + 6) + 8 * 10 + 8 * 2)
    assert got["predict"]["ops"] == 2 * 2 * (12 + 6)


def test_k1_levels_is_the_ports_dense_rule():
    assert work.k1_levels(2381304, [2, 32]) == [False, True]
    assert work.k1_levels((1 << 23) - 1, [2, 3]) == [False, True]


def test_leaf_spread_against_uniform_beams():
    beam = np.array([[0, 1], [1, 2], [3, -1]])
    got = work.leaf_spread(beam, n_leaf=8)
    assert got["distinct"] == 4
    assert got["uniform"] == pytest.approx(8 * (1 - (1 - 2 / 8) ** 3))


def test_a_changed_batching_stops_a_traced_run():
    from portbench import harness

    lines = []
    harness.check_batching(32, 8, 4, True, lines.append)  # as counted
    harness.check_batching(16, 8, 4, False, lines.append)  # untraced: said, not raised
    assert "as counted" in lines[0] and "16 K1 launches in a probe call" in lines[1]
    with pytest.raises(RuntimeError, match="batch size or its layout rule"):
        harness.check_batching(16, 8, 4, True, lines.append)


def test_k1_roofline_reader_raises_where_trace_and_work_disagree():
    from portbench import harness

    read = harness.metric_reader("k1_roofline.batch")
    k1 = "intersect_scores_kernel"
    ctx = {"k1_kernel": k1, "work": {"k1": {"calls": 2, "seconds": 1e-3}},
           "trace": {"kernels": [(k1 + "(int*)", 2e-3), ("other", 1.0), (k1 + "(int*)", 2e-3)]}}
    assert read(ctx) == pytest.approx(25.0)
    ctx["work"]["k1"]["calls"] = 3
    with pytest.raises(ValueError, match="2 K1 kernels"):
        read(ctx)
    ctx["trace"]["kernels"] = [("other", 1.0)]  # K1 off the path: nothing to read
    assert read(ctx) is None
