"""The grouped GEMMs of the sparse-expert layer (``pecos_tpu_torch/ops/grouped_gemm.py``).

On the CPU: the plain version against one matmul a group, with empty and
uneven groups and rows past the last group, and the wrapper's checks; the
plain versions of the SwiGLU and scatter-storing entries against
the unfused ops they replace, bit for bit.  The CUDA kernel's tests
(``test_cuda_*``) skip without a card; on the card, where there is no JAX,
run them without the tests' ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_grouped_gemm.py -k cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pecos_tpu_torch.ops import grouped_gemm as gg


def uneven_offsets(rng, E, M, empty=(), tail=0):
    """(E + 1,) int64 offsets of M - tail rows split unevenly over E groups,
    the groups in ``empty`` holding none; ``tail`` rows past the last group."""
    share = rng.gamma(0.7, size=E)
    share[list(empty)] = 0.0
    counts = np.floor(share / share.sum() * (M - tail)).astype(np.int64)
    counts[np.argmax(counts)] += M - tail - counts.sum()
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))


def per_group(a, w, offsets):
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float64)
    b = offsets.tolist()
    for e in range(w.shape[0]):
        out[b[e] : b[e + 1]] = a[b[e] : b[e + 1]].double() @ w[e].double().T
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_a_matmul_a_group(dtype):
    rng = np.random.default_rng(0)
    E, M, N, K = 8, 203, 24, 40
    offsets = uneven_offsets(rng, E, M, empty=(0, 3, 7), tail=11)
    a = torch.from_numpy(rng.standard_normal((M, K))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, N, K))).to(dtype)
    got = gg.grouped_gemm(a, w, offsets)
    want = per_group(a, w, offsets)
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.all(got[int(offsets[-1]) :] == 0)
    # float32: a sum of 40 products rounded; bfloat16: the product rounded to 8 bits
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    assert torch.allclose(got.double(), want, rtol=rtol, atol=rtol * want.abs().max().item())


def test_plain_version_takes_every_row_in_one_group_and_none():
    a = torch.randn(16, 8)
    w = torch.randn(3, 4, 8)
    all_in_one = torch.tensor([0, 0, 16, 16])
    assert torch.allclose(gg.grouped_gemm(a, w, all_in_one), a @ w[1].T)
    none = torch.zeros(4, dtype=torch.int64)
    assert torch.all(gg.grouped_gemm(a, w, none) == 0)
    assert gg.grouped_gemm(a[:0], w, none).shape == (0, 4)


def test_checks_raise():
    a, w = torch.randn(4, 8), torch.randn(2, 4, 8)
    with pytest.raises(ValueError, match="offsets"):
        gg.grouped_gemm(a, w, torch.tensor([0, 2, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        gg.grouped_gemm(a, w, torch.tensor([0, 4]))
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        gg.grouped_gemm(a, torch.randn(2, 4, 6), torch.tensor([0, 2, 4]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        gg.grouped_gemm(a.to("meta"), w.to("meta"), torch.tensor([0, 2, 4]).to("meta"))


@pytest.mark.parametrize("kernel_name, wrapper_name",
                         [("kBM", "TILE_ROWS"), ("kBN", "TILE_COLS"), ("kBK", "STAGE_DEPTH")])
def test_wrapper_constants_equal_the_kernels(kernel_name, wrapper_name):
    """The wrapper's copies of the kernel's tile and stage sizes are the
    values csrc/grouped_gemm.cu compiles with."""
    import re
    from pathlib import Path

    source = (Path(gg.__file__).parent / "csrc" / "grouped_gemm.cu").read_text()
    found = re.findall(rf"constexpr int {kernel_name} = (\d+);", source)
    assert found == [str(getattr(gg, wrapper_name))]


def pairs_case(dtype, seed, device="cpu", T=60, k=3, K=64, width=64, pad_tokens=9):
    """An expert layer's pairs at small widths: T tokens of k pairs each,
    the last ``pad_tokens`` pads; the real pairs sorted into 8 groups that
    are ragged, two of them empty and two of a single row, the pads' pairs
    past the last group (in their own slots, as the layer sorts them).
    Returns x (T, K), gate_up (8, 2 width, K), down (8, K, width), offsets,
    order (the token slot of each sorted pair) and rows (its token)."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 37, 1, 0, 50, 29, 1, 35])
    real = (T - pad_tokens) * k
    assert counts.sum() == real
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    order = torch.from_numpy(np.concatenate([rng.permutation(real), real + rng.permutation(pad_tokens * k)]))
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((T, K), generator=gen).to(dtype)
    gate_up = (0.2 * torch.randn((8, 2 * width, K), generator=gen)).to(dtype)
    down = (0.2 * torch.randn((8, K, width), generator=gen)).to(dtype)
    return [t.to(device) for t in (x, gate_up, down, offsets, order, order // k)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_swiglu_equals_the_unfused_ops(dtype):
    """The gathered tokens' grouped GEMM, then SiLU of the gate half times
    the up half: bit for bit, rows past the last group zero."""
    x, gate_up, _, offsets, _, rows = pairs_case(dtype, 1)
    a = x[rows]
    got = gg.grouped_gemm_swiglu(a, gate_up, offsets)
    h = gg.grouped_gemm(a, gate_up, offsets)
    width = gate_up.shape[1] // 2
    want = F.silu(h[:, :width]) * h[:, width:]
    assert got.dtype == dtype and got.shape == (rows.shape[0], width)
    assert torch.equal(got, want)
    assert torch.all(got[int(offsets[-1]) :] == 0)
    assert torch.all(got[int(offsets[1]) : int(offsets[2])] != 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_scatter_equals_the_index_put(dtype):
    """Rows stored in their token slots as ``pairs[order] = y`` puts them,
    bit for bit; the pads' slots, which no row names, zero."""
    x, gate_up, down, offsets, order, rows = pairs_case(dtype, 2)
    act = gg.grouped_gemm_swiglu(x[rows], gate_up, offsets)
    y = gg.grouped_gemm(act, down, offsets)
    want = torch.empty_like(y)
    want[order] = y
    got = gg.grouped_gemm_scatter(act, down, offsets, order)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    real = int(offsets[-1])
    assert torch.all(got[order[real:]] == 0) and torch.all(got[order[:real]].abs().sum(1) > 0)


def test_new_entries_check_their_index():
    x, gate_up, down, offsets, order, rows = pairs_case(torch.float32, 3)
    with pytest.raises(ValueError, match="gate and up"):
        gg.grouped_gemm_swiglu(x[rows], gate_up[:, 1:], offsets)
    act = gg.grouped_gemm_swiglu(x[rows], gate_up, offsets)
    with pytest.raises(ValueError, match="dest"):
        gg.grouped_gemm_scatter(act, down, offsets, order[1:])
    with pytest.raises(ValueError, match="dest"):
        gg.grouped_gemm_scatter(act, down, offsets, order.int())
    with pytest.raises(ValueError, match="offsets"):
        gg.grouped_gemm_scatter(act, down, offsets[1:], order)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped GEMM kernel has no CPU mode")
    return torch.device("cuda", 0)


def check_kernel(card, E, M, N, K, empty, tail, seed):
    """The kernel against float32 products of the same bfloat16 operands and
    against the plain version, on the rows of the groups; one launch."""
    rng = np.random.default_rng(seed)
    offsets = uneven_offsets(rng, E, M, empty=empty, tail=tail).to(card)
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=card).to(torch.bfloat16)
    w = (0.02 * torch.randn((E, N, K), generator=gen, device=card)).to(torch.bfloat16)
    before = gg.grouped_gemm.launches
    got = gg.grouped_gemm(a, w, offsets)
    torch.cuda.synchronize(card)
    assert gg.grouped_gemm.launches == before + 1
    plain = gg.grouped_gemm_reference(a, w, offsets)
    rows = int(offsets[-1])
    want = torch.empty((rows, N), device=card)
    b = offsets.tolist()
    torch.backends.cuda.matmul.allow_tf32 = False
    for e in range(E):
        want[b[e] : b[e + 1]] = a[b[e] : b[e + 1]].float() @ w[e].float().T
    # the float32 sums differ in order only; the kernel rounds once to bfloat16
    # (half a unit in the 8th bit), the sum's own error is ~1e-6 of the terms
    scale = want.abs().mean().item()
    for out in (got[:rows].float(), plain[:rows].float()):
        err = (out - want).abs()
        assert torch.all(err <= 2.0**-8 * want.abs() + 1e-4 * scale), float((err / (want.abs() + scale)).max())
    return got


def test_cuda_kernel_at_the_expert_layer_shapes(card):
    """Moonlight-16B-A3B's expert GEMMs at 256 texts of 128 tokens: 196,608
    (token, expert) pairs over 64 experts, some empty, the pairs of pads past
    the last group; gate-up (N 2,816, K 2,048), then down (N 2,048, K 1,408)."""
    check_kernel(card, E=64, M=196608, N=2816, K=2048, empty=(5, 17, 40), tail=9000, seed=1)
    check_kernel(card, E=64, M=196608, N=2048, K=1408, empty=(0, 63), tail=0, seed=2)


def test_cuda_kernel_at_small_and_ragged_shapes(card):
    check_kernel(card, E=8, M=1000, N=128, K=64, empty=(1,), tail=37, seed=3)
    check_kernel(card, E=3, M=130, N=256, K=128, empty=(), tail=0, seed=4)
    check_kernel(card, E=64, M=64, N=128, K=64, empty=tuple(range(0, 64, 2)), tail=5, seed=5)


def test_cuda_kernel_checks_raise(card):
    a = torch.randn(4, 64, device=card, dtype=torch.bfloat16)
    off = torch.tensor([0, 2, 4], device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        gg.grouped_gemm(a.float(), torch.randn(2, 128, 64, device=card), off)
    with pytest.raises(ValueError, match="multiple"):
        gg.grouped_gemm(a, torch.randn(2, 100, 64, device=card, dtype=torch.bfloat16), off)


def unfused_expert_gemms(x, gate_up, down, offsets, order, rows):
    """The expert layer's GEMMs as they ran before the fused modes: the
    gather, the plain-store kernel, SiLU and the product, the kernel again,
    the rows put back in token order."""
    h = gg.grouped_gemm(x[rows], gate_up, offsets)
    width = gate_up.shape[1] // 2
    act = F.silu(h[:, :width]) * h[:, width:]
    y = gg.grouped_gemm(act, down, offsets)
    pairs = torch.empty_like(y)
    pairs[order] = y
    return act, pairs


def check_fused_modes(card, x, gate_up, down, offsets, order, rows):
    """Each fused mode bit-equal to the unfused kernels and ops, and within
    rounding of its plain version; one launch a call."""
    real = int(offsets[-1])
    before = gg.grouped_gemm.launches
    act = gg.grouped_gemm_swiglu(x[rows], gate_up, offsets)
    pairs = gg.grouped_gemm_scatter(act, down, offsets, order)
    torch.cuda.synchronize(card)
    assert gg.grouped_gemm.launches == before + 2
    want_act, want_pairs = unfused_expert_gemms(x, gate_up, down, offsets, order, rows)
    slots = order[:real]
    assert torch.equal(act[:real], want_act[:real])
    assert torch.equal(pairs[slots], want_pairs[slots])
    # against the plain versions (cuBLAS's float32 sums, another order): a
    # unit of bfloat16's 8th bit in gate or up, carried through SiLU's product
    plain = gg.grouped_gemm_swiglu_reference(x[rows], gate_up, offsets)[:real].float()
    scale = plain.abs().mean().item()
    assert float(((act[:real].float() - plain).abs() / (plain.abs() + scale)).max()) <= 2.0**-6
    plain_rows = gg.grouped_gemm_scatter_reference(act, down, offsets, order)[slots].float()
    scale = plain_rows.abs().mean().item()
    assert float(((pairs[slots].float() - plain_rows).abs() / (plain_rows.abs() + scale)).max()) <= 2.0**-7


def test_cuda_fused_modes_at_small_ragged_shapes(card):
    for seed in (4, 5):
        check_fused_modes(card, *pairs_case(torch.bfloat16, seed, device=card, K=128, width=128))


def test_cuda_fused_modes_at_the_expert_layer_widths(card):
    """One forward of Moonlight-16B-A3B's expert layer: 256 texts of 128
    slots, ~7% pads, top-6 of 64 experts, unevenly: ~183K pairs; hidden
    2,048, expert width 1,408."""
    T, k, E, H, width = 256 * 128, 6, 64, 2048, 1408
    gen = torch.Generator(device=card).manual_seed(6)
    keep = torch.rand(T, generator=gen, device=card) >= 0.07
    skew = torch.linspace(0.0, 0.6, E, device=card)
    chosen = (torch.rand((T, E), generator=gen, device=card) + skew).topk(k, dim=1).indices
    flat = torch.where(keep[:, None].expand(T, k).reshape(-1), chosen.reshape(-1), E)
    sorted_experts, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(sorted_experts, torch.arange(E + 1, device=card))
    x = torch.randn((T, H), generator=gen, device=card).to(torch.bfloat16)
    gate_up = (0.02 * torch.randn((E, 2 * width, H), generator=gen, device=card)).to(torch.bfloat16)
    down = (0.02 * torch.randn((E, H, width), generator=gen, device=card)).to(torch.bfloat16)
    check_fused_modes(card, x, gate_up, down, offsets, order, order // k)
