"""K1 (sparse-query x sparse-weight id intersection): the port against JAX.

Both the port's plain PyTorch version and the JAX package's Pallas kernel (run
in interpret mode) are held against the JAX package's XLA formulation
``_intersect_scores`` on the same numpy inputs.  Tolerance: the matched-value
sums are exact on every side (ids are unique per row, so each weight slot
matches at most one query nonzero); only the order of the final P-sum differs,
so rtol=1e-5 plus an atol of 1e-6 x the row's sum of |wv * qv| terms for
results that cancel towards zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecos_tpu.ops.intersect import intersect_scores_pallas, supports_shapes
from pecos_tpu.xmc.inference import _intersect_scores
from pecos_tpu_torch.ops import intersect as ops
from pecos_tpu_torch.ops.intersect import intersect_scores, intersect_scores_reference


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
