"""The grouped GEMM of the sparse-expert layer (``pecos_tpu_torch/ops/grouped_gemm.py``).

On the CPU: the plain version against one matmul a group, with empty and
uneven groups and rows past the last group, and the wrapper's checks.  The
CUDA kernel's tests (``test_cuda_*``) skip without a card; on the card, where
there is no JAX, run them without the tests' ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_grouped_gemm.py -k cuda
"""

import numpy as np
import pytest
import torch

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
