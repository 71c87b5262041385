"""K1 (sparse-query x sparse-weight id intersection): the port against JAX.

Both the port's plain PyTorch version and the JAX package's Pallas kernel (run
in interpret mode) are held against the JAX package's XLA formulation
``_intersect_scores`` on the same numpy inputs.  Tolerance: the matched-value
sums are exact on every side (ids are unique per row, so each weight slot
matches at most one query nonzero); only the order of the final P-sum differs,
so rtol=1e-5 plus an atol of 1e-6 x the row's sum of |wv * qv| terms for
results that cancel towards zero.

The CUDA kernel's own tests (``test_cuda_*``) skip without a card.  The JAX
package is imported inside the tests that use it, so that on a machine with
the port alone the card's tests run by themselves:

    python -m pytest --noconftest tests/test_torch_intersect.py -k cuda
"""

import numpy as np
import pytest
import torch

from pecos_tpu_torch.ops import intersect as ops
from pecos_tpu_torch.ops.intersect import intersect_scores, intersect_scores_reference


def pallas():
    """The JAX package's (jnp, intersect_scores_pallas, supports_shapes)."""
    import jax.numpy as jnp
    from pecos_tpu.ops.intersect import intersect_scores_pallas, supports_shapes

    return jnp, intersect_scores_pallas, supports_shapes


def _unique_rows(rng, n_rows, width, hi):
    """(n_rows, width) int32, each row strictly increasing ids in [0, hi)."""
    base = np.sort(rng.integers(0, hi - width + 1, size=(n_rows, width)), axis=1)
    return (base + np.arange(width)).astype(np.int32)


def make_case(N, K, P, Qn, D, seed):
    """Queries and packed weight slots with frequent matches, query pad ids D+1
    (value 0) and zero-valued weight pad slots (id 0), the bias id D in some slots."""
    rng = np.random.default_rng(seed)
    qids = _unique_rows(rng, N, Qn, D)
    qvals = rng.standard_normal((N, Qn)).astype(np.float32)
    n_qpad = rng.integers(0, Qn // 2 + 1, size=N)
    qpad = np.arange(Qn)[None, :] >= (Qn - n_qpad)[:, None]
    qids[qpad], qvals[qpad] = D + 1, 0.0
    wi = _unique_rows(rng, N * K, P, D + 1).reshape(N, K, P)  # ids up to D: bias id included
    wv = rng.standard_normal((N, K, P)).astype(np.float32)
    n_wpad = rng.integers(0, P // 2 + 1, size=(N, K))
    wpad = np.arange(P)[None, None, :] >= (P - n_wpad)[:, :, None]
    wi[wpad], wv[wpad] = 0, 0.0
    return qids, qvals, wi, wv


def packed(wi, wv):
    return np.concatenate([wi, wv.view(np.int32)], axis=-1)


def jax_scores(qids, qvals, wi, wv, bias_id, bias_val):
    import jax.numpy as jnp
    from pecos_tpu.xmc.inference import _intersect_scores

    return np.asarray(
        _intersect_scores(
            jnp.asarray(qids), jnp.asarray(qvals), jnp.asarray(wi), jnp.asarray(wv),
            8, bias_id, bias_val,
        )
    )


def abs_scale(qids, qvals, wi, wv, bias_id, bias_val):
    """Per-row max of the sum of |wv * qv| terms (and |bias_val * wv|)."""
    out = intersect_scores_reference(
        torch.from_numpy(qids), torch.from_numpy(np.abs(qvals)),
        torch.from_numpy(packed(wi, np.abs(wv))), bias_id, abs(bias_val),
    ).numpy()
    return out.max(axis=1, keepdims=True)


SHAPES = [  # (N, K, P, Qn, D)
    (3, 37, 8, 5, 40),
    (16, 32, 16, 64, 300),
    (8, 20, 24, 200, 600),
    (4, 160, 64, 256, 2000),
]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_jax(shape, bias):
    N, K, P, Qn, D = shape
    qids, qvals, wi, wv = make_case(N, K, P, Qn, D, seed=sum(shape))
    bias_id, bias_val = (D, 1.0) if bias else (None, 0.0)
    want = jax_scores(qids, qvals, wi, wv, bias_id, bias_val)
    got = intersect_scores(
        torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(packed(wi, wv)),
        bias_id, bias_val,
    ).numpy()
    assert got.shape == (N, K) and got.dtype == np.float32
    atol = 1e-6 * abs_scale(qids, qvals, wi, wv, bias_id, bias_val)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want) + atol + 1e-30)


@pytest.mark.parametrize("bias", [False, True])
def test_pallas_kernel_interpret_matches_xla(bias):
    """The JAX package's Pallas kernel itself, run in interpret mode on the CPU."""
    jnp, intersect_scores_pallas, supports_shapes = pallas()
    N, K, P, Qn, D = 16, 32, 16, 64, 300
    assert supports_shapes(N, K, P, Qn)
    qids, qvals, wi, wv = make_case(N, K, P, Qn, D, seed=7)
    bias_id, bias_val = (D, 1.0) if bias else (None, 0.0)
    want = jax_scores(qids, qvals, wi, wv, bias_id, bias_val)
    got = np.asarray(
        intersect_scores_pallas(
            jnp.asarray(qids), jnp.asarray(qvals), jnp.asarray(wi), jnp.asarray(wv),
            bias_id=bias_id, bias_val=bias_val, interpret=True,
        )
    )
    atol = 1e-6 * abs_scale(qids, qvals, wi, wv, bias_id, bias_val)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want) + atol + 1e-30)


def test_cpu_tensors_use_plain_version_without_launching():
    qids, qvals, wi, wv = make_case(2, 5, 8, 8, 30, seed=1)
    before = intersect_scores.launches
    out = intersect_scores(torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(packed(wi, wv)))
    assert out.shape == (2, 5)
    assert intersect_scores.launches == before


def test_other_devices_raise():
    q = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 4), dtype=torch.float32, device="meta")
    w = torch.zeros((2, 3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        intersect_scores(q, v, w)


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda q, v, w: (q.long(), v, w), "qids must be torch.int32"),
        (lambda q, v, w: (q, v.double(), w), "qvals must be torch.float32"),
        (lambda q, v, w: (q, v, w[:, :, :-1].contiguous()),r"w_packed must be \(N=2, K, 2P\)"),
        (lambda q, v, w: (q, v, w.transpose(0, 1)), "w_packed must be contiguous"),
        (lambda q, v, w: (q, v[:1], w), "qvals shape"),
    ],
)
def test_kernel_argument_checks(mutate, match):
    """What the CUDA wrapper checks before it hands pointers to the kernel."""
    qids, qvals, wi, wv = make_case(2, 2, 8, 8, 30, seed=2)
    args = mutate(torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(packed(wi, wv)))
    with pytest.raises(ValueError, match=match):
        ops._check_cuda_args(*args)


# ---- K1 by row id: intersect_scores_rows and its launch plan ----

from pecos_tpu_torch.ops.intersect import (  # noqa: E402
    _launch_plan,
    intersect_scores_rows,
    intersect_scores_rows_reference,
)

HNSW_PAD = 1 << 30


def make_rows_case(kind, seed):
    """(qids, qvals, table, rows, bias_id) for one by-id case: rows name table
    rows (-1 for none), as the port's callers pass them."""
    rng = np.random.default_rng(seed)
    N, K, P, Qn, D = 8, 16, 16, 32, 200
    qids, qvals, wi, wv = make_case(N, 1, P, Qn, D, seed)  # the queries; weights below
    R = 60
    _, _, wi, wv = make_case(R, 1, P, 8, D, seed + 1)
    table = packed(wi[:, 0], wv[:, 0])
    bias_id = D
    if kind == "minus-one":
        rows = rng.integers(0, R, size=(N, K))
        rows[rng.uniform(size=(N, K)) < 0.25] = -1
    elif kind == "parent-layout":
        # runs of maxc = 4 consecutive rows, the children of a beam of 4
        # parents where labels are numbered by parent, some rows zero
        maxc, n_parents = 4, R // 4
        table[rng.uniform(size=R) < 0.2] = 0
        parents = rng.integers(0, n_parents, size=(N, 4))
        rows = (parents[:, :, None] * maxc + np.arange(maxc)).reshape(N, -1)
    elif kind == "hnsw-pads":
        # SPARSE_PAD_ID (value 0) pads on both sides, no bias
        qids[qvals == 0] = HNSW_PAD
        ids, vals = table[:, :P].copy(), table[:, P:].view(np.float32).copy()
        ids[vals == 0] = HNSW_PAD
        table = packed(ids, vals)
        rows = rng.integers(0, R, size=(N, K))
        bias_id = None
    elif kind == "duplicates":
        # repeated nonzero ids in a query row add up, as in the reference
        qids[:, 1::2] = qids[:, 0::2]
        qids, order = np.sort(qids, axis=1), np.argsort(qids, axis=1, kind="stable")
        qvals = np.take_along_axis(qvals, order, axis=1)
        rows = rng.integers(0, R, size=(N, K))
    else:
        raise ValueError(kind)
    return qids, qvals, table, rows.astype(np.int64), bias_id


def gathered(table, rows):
    """(wi, wv) of the rows, a -1 row all zeros."""
    w = np.where((rows >= 0)[..., None], table[np.clip(rows, 0, None)], 0).astype(np.int32)
    P = table.shape[1] // 2
    return w[..., :P], w[..., P:].view(np.float32)


ROW_KINDS = ["minus-one", "parent-layout", "hnsw-pads", "duplicates"]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_rows_reference_matches_jax(kind):
    """The plain by-id version against JAX's _intersect_scores on the gathered rows."""
    qids, qvals, table, rows, bias_id = make_rows_case(kind, seed=len(kind))
    bias_val = 1.0 if bias_id is not None else 0.0
    wi, wv = gathered(table, rows)
    want = jax_scores(qids, qvals, wi, wv, bias_id, bias_val)
    before = intersect_scores.launches
    got = intersect_scores_rows(
        torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(table), torch.from_numpy(rows),
        bias_id, bias_val,
    ).numpy()
    assert intersect_scores.launches == before  # CPU tensors: the plain version
    assert got.shape == rows.shape and got.dtype == np.float32
    assert (got[rows < 0] == 0).all()
    atol = 1e-6 * abs_scale(qids, qvals, wi, wv, bias_id, bias_val)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want) + atol + 1e-30)


def test_rows_reference_equals_block_form_bit_for_bit():
    """By id or through the gathered block, the plain version gives the same bits."""
    qids, qvals, table, rows, _ = make_rows_case("parent-layout", seed=3)
    wi, wv = gathered(table, rows)
    q, v = torch.from_numpy(qids), torch.from_numpy(qvals)
    by_id = intersect_scores_rows_reference(q, v, torch.from_numpy(table), torch.from_numpy(rows), 200, 1.0)
    block = intersect_scores_reference(q, v, torch.from_numpy(packed(wi, wv)), 200, 1.0)
    assert torch.equal(by_id, block)


def test_pallas_kernel_interpret_on_gathered_rows():
    """The JAX package's Pallas kernel, in interpret mode, on a block gathered
    by parent-layout row ids, against the port's by-id plain version."""
    jnp, intersect_scores_pallas, supports_shapes = pallas()
    qids, qvals, table, rows, bias_id = make_rows_case("parent-layout", seed=5)
    wi, wv = gathered(table, rows)
    N, K, P = wi.shape
    assert supports_shapes(N, K, P, qids.shape[1])
    want = np.asarray(
        intersect_scores_pallas(
            jnp.asarray(qids), jnp.asarray(qvals), jnp.asarray(wi), jnp.asarray(wv),
            bias_id=bias_id, bias_val=1.0, interpret=True,
        )
    )
    got = intersect_scores_rows(
        torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(table), torch.from_numpy(rows), bias_id, 1.0
    ).numpy()
    atol = 1e-6 * abs_scale(qids, qvals, wi, wv, bias_id, 1.0)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want) + atol + 1e-30)


# chip_smoke.py's K1 shapes (N, K, P, Qn), queries above one table's
# capacity, odd P, more candidates than a block takes, and an empty batch
PLAN_SHAPES = [
    (1024, 160, 64, 256), (3, 37, 8, 5), (8, 37, 64, 4096), (64, 160, 64, 256), (1, 160, 64, 256),
    (2048, 256, 96, 96), (2048, 32, 96, 96), (4, 40, 64, 5000), (16, 32, 16, 64), (5, 7, 13, 600),
    (2, 5000, 64, 256), (0, 160, 64, 256),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plan(shape):
    N, K, P, Qn = shape
    plan = _launch_plan(N, K, P, Qn)
    assert plan.slots & (plan.slots - 1) == 0 and plan.slots >= 2 * plan.chunk
    assert plan.chunks * plan.chunk >= Qn and (plan.chunks - 1) * plan.chunk < max(Qn, 1)
    assert plan.shared_bytes == 8 * (plan.slots + plan.per_block) <= 48 * 1024 <= 232_448
    assert plan.lanes & (plan.lanes - 1) == 0 and 1 <= plan.lanes <= 32
    assert plan.lanes == 32 or 2 * plan.lanes >= P  # about two slots a lane, a warp from P = 64
    # every candidate in exactly one block, and no block empty
    assert plan.per_block * plan.blocks_per_row >= K > plan.per_block * (plan.blocks_per_row - 1)
    assert plan.grid == N * plan.blocks_per_row <= 2**31 - 1
    if (N, K) == (1, 160):
        assert plan.grid >= 16  # a batch of one spreads over many SMs
    if Qn > 512:
        assert plan.chunks > 1


@pytest.mark.parametrize("kernel_name, wrapper_name", [("kThreads", "_THREADS"), ("kCands", "_CANDS")])
def test_wrapper_constants_equal_the_kernels(kernel_name, wrapper_name):
    """The launch plan's copies of the kernel's block size and candidates a
    group are the values csrc/intersect.cu compiles with."""
    import re
    from pathlib import Path

    source = (Path(ops.__file__).parent / "csrc" / "intersect.cu").read_text()
    found = re.findall(rf"constexpr int {kernel_name} = (\d+);", source)
    assert found == [str(getattr(ops, wrapper_name))]


def test_rows_other_devices_raise():
    q = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 4), dtype=torch.float32, device="meta")
    t = torch.zeros((5, 8), dtype=torch.int32, device="meta")
    r = torch.zeros((2, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        intersect_scores_rows(q, v, t, r)


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda q, v, t, r: (q, v, t, r.int()), "rows must be torch.int64"),
        (lambda q, v, t, r: (q, v, t.float(), r), "table must be torch.int32"),
        (lambda q, v, t, r: (q, v, t[None], r), "table must have 2 dims"),
        (lambda q, v, t, r: (q, v, t[:, :-1].contiguous(), r), r"table must be \(R, 2P\)"),
        (lambda q, v, t, r: (q, v, t.t().contiguous().t(), r), "table must be contiguous"),
        (lambda q, v, t, r: (q, v, t, r[:1]), r"rows must be \(N=2, K\)"),
        (lambda q, v, t, r: (q, v, t, r.to("meta")), "rows is on meta"),
        (lambda q, v, t, r: (q, v[:1], t, r), "qvals shape"),
    ],
)
def test_rows_argument_checks(mutate, match):
    """What the by-id wrapper checks before it hands pointers to the kernel."""
    q, v = torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 4))
    t, r = torch.zeros((5, 8), dtype=torch.int32), torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        ops._check_rows_args(*mutate(q, v, t, r))


def test_rows_table_of_2_31_rows_raises():
    meta = dict(device="meta")
    q, v = torch.zeros((2, 4), dtype=torch.int32, **meta), torch.zeros((2, 4), **meta)
    t = torch.empty((2**31, 8), dtype=torch.int32, **meta)
    r = torch.zeros((2, 3), dtype=torch.int64, **meta)
    with pytest.raises(ValueError, match="fewer than 2"):
        ops._check_rows_args(q, v, t, r)


# ---- the pass pair: query chunks probed, of the chunks had ----


def test_cpu_calls_make_no_pass_pair_and_launch_nothing():
    """The plain version counts no passes: CPU calls leave no pair to take,
    and ``intersect_scores.launches`` as it was."""
    qids, qvals, table, rows, bias_id = make_rows_case("minus-one", seed=9)
    before = intersect_scores.launches
    intersect_scores_rows(torch.from_numpy(qids), torch.from_numpy(qvals), torch.from_numpy(table),
                          torch.from_numpy(rows), bias_id, 1.0)
    assert intersect_scores.launches == before
    assert torch.device("cpu") not in ops._PASSES
    assert ops.take_pass_counts(torch.device("cpu")) is None
    assert ops.take_pass_counts("cpu") is None


def test_take_pass_counts_moves_the_counts_and_zeroes_them(monkeypatch):
    """A take returns what the launches added since the last take: the
    card's passes past each block's first, plus the host's first passes and
    chunks; the next take starts from zero."""
    dev = torch.device("cpu")  # a stand-in for a card's count: take reads it as it would a card's
    passes = ops._PassCount(dev)
    monkeypatch.setitem(ops._PASSES, dev, passes)
    passes.card += 5
    passes.first, passes.chunks = 10, 80
    assert ops.take_pass_counts(dev) == (15, 80)
    assert ops.take_pass_counts(dev) == (0, 0)
    passes.card += 3
    passes.first += 20
    passes.chunks += 160
    assert ops.take_pass_counts(dev) == (23, 160)
    assert ops.take_pass_counts(dev) == (0, 0)


# (N, K, P, Qn) -> blocks a query: one wave of blocks where every query fits
# one chunk, up to four where queries are longer, at 16 candidates a block or
# more (two a group) for that spread
SPREAD_SHAPES = {
    (1024, 620, 512, 4096): 5,  # wiki500k-batch's label level
    (1024, 160, 512, 4096): 5,  # its levels 2 and 3
    (1024, 32, 512, 4096): 2,  # its level 1: 16 candidates a block
    (1024, 620, 512, 512): 2,  # one chunk: one wave
    (1024, 160, 64, 256): 2,
    (2048, 32, 96, 96): 1,
    (1, 160, 64, 256): 20,  # one candidate a group
    (8, 37, 64, 5000): 5,
}


@pytest.mark.parametrize("shape", SPREAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_spreads_long_queries_over_more_blocks(shape):
    plan = _launch_plan(*shape)
    assert plan.blocks_per_row == SPREAD_SHAPES[shape]
    N, K, P, Qn = shape
    if plan.chunks > 1 and plan.blocks_per_row > _launch_plan(N, K, P, 512).blocks_per_row:
        assert plan.per_block >= 2 * (256 // plan.lanes)


# Qn 4,096 of 512-slot chunks, rows of P 512: the label level of wiki500k-batch
CUDA_QN, CUDA_P, CUDA_D = 4096, 512, 20000
# the slots of a query row that hold its nonzeros, by kind; the rest are pads
CUDA_ROWS = {
    "chunk 0 only": range(0, 300),
    "spills into chunk 1": range(0, 600),
    "fills all 8 chunks": range(0, 4096),
    "a later chunk only": range(1100, 1400),  # chunk 2; chunk 0 all pads
    "no nonzeros": range(0),
}


CUDA_KINDS = [k for k in CUDA_ROWS for _ in range(2)]  # two rows of each kind


def cuda_queries(seed=11):
    """(qids, qvals) of the CUDA_KINDS rows at Qn CUDA_QN: each row's
    nonzeros where CUDA_ROWS puts them, the other slots pads (id D + 1,
    value 0)."""
    rng = np.random.default_rng(seed)
    qids = np.full((len(CUDA_KINDS), CUDA_QN), CUDA_D + 1, np.int32)
    qvals = np.zeros((len(CUDA_KINDS), CUDA_QN), np.float32)
    for n, kind in enumerate(CUDA_KINDS):
        slots = np.array(CUDA_ROWS[kind], dtype=np.int64)
        qids[n, slots] = rng.choice(CUDA_D, size=len(slots), replace=False)
        qvals[n, slots] = rng.standard_normal(len(slots)).astype(np.float32)
    return qids, qvals


def without_pad_chunks(qids, qvals, chunk):
    """Each row with its chunks past the first that hold pads alone taken
    out, the others kept in order, slot for slot: [(ids, vals)], a multiple
    of ``chunk`` long.  Chunk 0 stays, as the kernel always probes it."""
    N = qids.shape[0]
    ci, cv = qids.reshape(N, -1, chunk), qvals.reshape(N, -1, chunk)
    keep = (cv != 0).any(axis=2)
    keep[:, 0] = True
    return [(ci[n][keep[n]].reshape(-1), cv[n][keep[n]].reshape(-1)) for n in range(N)]


def cuda_table(N, K, seed=12):
    """(table (R, 2P) int32, rows (N, K) int64 with some -1): rows of 512
    distinct ids up to D (the bias id), a quarter of their slots pads."""
    rng = np.random.default_rng(seed)
    R = 200
    wi = _unique_rows(rng, R, CUDA_P, CUDA_D + 1)
    wv = rng.standard_normal((R, CUDA_P)).astype(np.float32)
    pad = rng.uniform(size=(R, CUDA_P)) < 0.25
    wi[pad], wv[pad] = 0, 0.0
    rows = rng.integers(0, R, size=(N, K))
    rows[rng.uniform(size=(N, K)) < 0.1] = -1
    return packed(wi, wv), rows.astype(np.int64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's kernel has no CPU mode")
    return torch.device("cuda", 0)


def cuda_scores(card, qids, qvals, table, rows, bias_id, bias_val):
    """The kernel's scores on the host, and the pass pair its one launch added."""
    ops.take_pass_counts(card)  # zero the pair
    before = intersect_scores.launches
    out = intersect_scores_rows(*(torch.from_numpy(a).to(card) for a in (qids, qvals, table, rows)),
                                bias_id, bias_val).cpu()
    assert intersect_scores.launches == before + 1
    return out, ops.take_pass_counts(card)


def same_bits_up_to_zero_sign(a, b):
    return torch.equal(torch.where(a == 0, 0.0, a), torch.where(b == 0, 0.0, b))


def plain_on_card(card, qids, qvals, table, rows, bias_id, bias_val):
    """The plain version's scores, computed on the card, and an atol of 1e-6
    x each row's largest sum of |wv * qv| terms (as abs_scale's)."""
    q, v, t, r = (torch.from_numpy(a).to(card) for a in (qids, qvals, table, rows))
    P = table.shape[1] // 2
    t_abs = torch.cat([t[:, :P], t[:, P:].view(torch.float32).abs().view(torch.int32)], dim=1)
    want = intersect_scores_rows_reference(q, v, t, r, bias_id, bias_val)
    scale = intersect_scores_rows_reference(q, v.abs(), t_abs, r, bias_id, abs(bias_val))
    return want.cpu().numpy(), 1e-6 * scale.amax(dim=1, keepdim=True).cpu().numpy()


# (copies of CUDA_KINDS' rows, K): the rows once at K 48, a plan of one wave;
# ten times at K 620, where the launch of Qn 4,096 spreads a query over more
# blocks than one of a single chunk would take
CUDA_BATCHES = [(1, 48), (10, 620)]


@pytest.mark.parametrize("reps, K", CUDA_BATCHES, ids=lambda v: str(v))
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_chunks_of_pads_alone_are_skipped(card, bias, reps, K):
    """Rows of every chunk pattern at Qn 4,096 agree with the plain version,
    and the pass pair counts each block's chunk 0 and its chunks past 0 that
    hold a nonzero, of 8 chunks a block.  Their scores equal, bit for bit up
    to the sign of zero, those of the same rows with their chunks of pads
    alone taken out (past chunk 0), launched where no chunk is skipped: a row
    whose nonzeros all sit in chunk 0 at Qn 512, one chunk, a row whose
    nonzeros sit in chunk 2 at Qn 1,024, its nonzeros in chunk 1.  (Not with
    those nonzeros moved to chunk 0: the bias term is added with chunk 0,
    before later chunks' sums, by any chunked pass, and one rounding moves.)
    The rows with nonzeros past chunk 0 also equal themselves at Qn 8,192,
    eight more chunks of pads."""
    bias_id, bias_val = (CUDA_D, 0.7) if bias else (None, 0.0)
    qids, qvals = (np.tile(a, (reps, 1)) for a in cuda_queries())
    N = len(CUDA_KINDS) * reps
    table, rows = cuda_table(N, K)
    plan = _launch_plan(N, K, CUDA_P, CUDA_QN)
    assert plan.chunks == 8 and plan.chunk == 512
    spread = plan.blocks_per_row > _launch_plan(N, K, CUDA_P, plan.chunk).blocks_per_row
    assert spread == (reps > 1)

    got, (passes, chunks) = cuda_scores(card, qids, qvals, table, rows, bias_id, bias_val)
    nonempty = [(qvals[n].reshape(plan.chunks, plan.chunk) != 0).any(axis=1) for n in range(N)]
    assert passes == plan.blocks_per_row * sum(1 + int(ne[1:].sum()) for ne in nonempty)
    assert chunks == plan.grid * plan.chunks
    assert [int(ne.sum()) for ne in nonempty[: len(CUDA_KINDS) : 2]] == [1, 2, 8, 1, 0]

    want, atol = plain_on_card(card, qids, qvals, table, rows, bias_id, bias_val)
    np.testing.assert_array_less(np.abs(got.numpy() - want), 1e-5 * np.abs(want) + atol + 1e-30)
    assert (got[torch.from_numpy(rows) < 0] == 0).all()

    kept = without_pad_chunks(qids, qvals, plan.chunk)
    lengths = np.array([len(ids) for ids, _ in kept])
    assert sorted(set(lengths // plan.chunk)) == [1, 2, 8]
    for Qn in sorted(set(lengths)):
        at = np.flatnonzero(lengths == Qn)
        q1, v1 = (np.stack([kept[n][j] for n in at]) for j in (0, 1))
        got1, (passes1, chunks1) = cuda_scores(card, q1, v1, table, rows[at], bias_id, bias_val)
        assert same_bits_up_to_zero_sign(got[at], got1), f"rows of {Qn} slots"
        assert passes1 == chunks1  # no chunk skipped

    many = lengths > plan.chunk
    wide_ids = np.concatenate([qids, np.full_like(qids, CUDA_D + 1)], axis=1)
    wide_vals = np.concatenate([qvals, np.zeros_like(qvals)], axis=1)
    got2, (passes2, chunks2) = cuda_scores(card, wide_ids[many], wide_vals[many], table, rows[many], bias_id, bias_val)
    assert same_bits_up_to_zero_sign(got[many], got2)
    plan2 = _launch_plan(int(many.sum()), K, CUDA_P, 2 * CUDA_QN)
    assert passes2 == plan2.blocks_per_row * sum(1 + int(ne[1:].sum()) for ne, m in zip(nonempty, many) if m)
    assert chunks2 == plan2.grid * 16
