"""The expert layer's combine (``pecos_tpu_torch/ops/expert_combine.py``).

On the CPU: the plain version against the unfused ops it replaces, bit for
bit, the rows of tokens no expert computed never read, and the wrapper's
checks.  The CUDA kernel's tests (``test_cuda_*``) skip without a card; on
the card, where there is no JAX, run them without the tests' ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_expert_combine.py -k cuda
"""

import pytest
import torch

from pecos_tpu_torch.ops import expert_combine as ec
from pecos_tpu_torch.ops.grouped_gemm import KERNEL_NAME as GEMM_KERNEL_NAME


def combine_case(dtype, seed, device="cpu", T=50, k=3, H=64, dropped=(0, 7, 8, 49)):
    """Pairs in token order (the slots of dropped tokens NaN, as a kernel
    that never wrote them might leave them), float32 gates, keep, shared."""
    gen = torch.Generator().manual_seed(seed)
    pairs = torch.randn((T * k, H), generator=gen).to(dtype)
    gates = torch.rand((T, k), generator=gen)
    keep = torch.ones(T, dtype=torch.bool)
    keep[list(dropped)] = False
    pairs.view(T, k, H)[~keep] = float("nan")
    shared = torch.randn((T, H), generator=gen).to(dtype)
    return [t.to(device) for t in (pairs, gates, keep, shared)]


def ulps_apart(a, b):
    """Units in the last place of bfloat16 between a and b (+0 and -0 are 0 apart)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_equals_the_unfused_ops(dtype):
    """A float32 bmm of the gates and the pairs, where(keep), the cast and
    the add of the shared row, bit for bit; a dropped token's NaN slots
    never reach its output, which is its shared row."""
    pairs, gates, keep, shared = combine_case(dtype, 1)
    T, k = gates.shape
    got = ec.expert_combine(pairs, gates, keep, shared)
    routed = torch.bmm(gates[:, None, :], pairs.view(T, k, -1).float())[:, 0]
    want = torch.where(keep[:, None], routed, 0.0).to(dtype) + shared
    assert got.dtype == dtype and got.shape == shared.shape
    assert torch.equal(got, want)
    assert bool(got.isfinite().all())
    assert torch.equal(got[~keep], torch.zeros_like(shared[~keep]) + shared[~keep])


def test_checks_raise():
    pairs, gates, keep, shared = combine_case(torch.float32, 2)
    with pytest.raises(ValueError, match="pairs must be"):
        ec.expert_combine(pairs[1:], gates, keep, shared)
    with pytest.raises(ValueError, match="keep"):
        ec.expert_combine(pairs, gates, keep[1:], shared)
    with pytest.raises(ValueError, match="float32"):
        ec.expert_combine(pairs, gates.double(), keep, shared)
    with pytest.raises(ValueError, match="bool"):
        ec.expert_combine(pairs, gates, keep.long(), shared)
    with pytest.raises(ValueError, match="gates must be"):
        ec.expert_combine(pairs, gates[0], keep, shared)
    with pytest.raises(ValueError, match="device"):
        ec.expert_combine(pairs.to("meta"), gates.to("meta"), keep.to("meta"), shared.to("meta"))


def test_kernel_name_is_the_sources_and_not_the_grouped_gemms():
    """The trace name the wrapper gives is the kernel's in
    csrc/expert_combine.cu, and no reader of the grouped GEMM's launches
    (which match on its name) can count the combine."""
    from pathlib import Path

    source = (Path(ec.__file__).parent / "csrc" / "expert_combine.cu").read_text()
    assert f"{ec.KERNEL_NAME}(" in source and f"constexpr int kVec = {ec.VECTOR};" in source
    assert GEMM_KERNEL_NAME not in ec.KERNEL_NAME


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the combine kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("T, k, H", [(50, 3, 64), (7, 1, 8), (256 * 128, 6, 2048)])
def test_cuda_kernel_within_a_unit_of_the_plain_version(card, T, k, H):
    """The kernel's in-order float32 sum against the batched matmul's: a
    unit of bfloat16's last place at most, the share that differs printed;
    a dropped token's slots (NaN) never read.  The last shape is one forward
    of Moonlight-16B-A3B's expert layer."""
    pairs, gates, keep, shared = combine_case(torch.bfloat16, 3, device=card, T=T, k=k, H=H,
                                              dropped=range(0, T, 13))
    before = ec.expert_combine.launches
    got = ec.expert_combine(pairs, gates, keep, shared)
    torch.cuda.synchronize(card)
    assert ec.expert_combine.launches == before + 1
    want = ec.expert_combine_reference(pairs, gates, keep, shared)
    ulps = ulps_apart(got, want)
    print(f"combine T {T} k {k} H {H}: {float((ulps > 0).float().mean())!r} of the elements differ, "
          f"at most {int(ulps.max())} unit")
    assert int(ulps.max()) <= 1
    assert bool(got.isfinite().all())
    assert torch.equal(got[~keep], shared[~keep] + torch.zeros_like(shared[~keep]))
