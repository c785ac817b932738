"""The CUDA kernels B1 (decode) and B2 (prefill) against their plain PyTorch
versions on the card.  Needs an NVIDIA GPU and nvcc; skipped without them.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: fp32 inputs atol 1e-4 (another summation order); bf16 inputs
atol = rtol = 2e-2 against the plain version run in fp32 on the same bf16
values (the output's bf16 rounding)."""
import pytest
import torch

from visualcla_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_case(dev, dtype, B, Sq, N, Nkv, hd, L=2, S=320, decode=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, N, hd, generator=g, device=dev).to(dtype)
    kc = torch.randn(L, B, Nkv, S, hd, generator=g, device=dev).to(dtype)
    vc = torch.randn(L, B, Nkv, S, hd, generator=g, device=dev).to(dtype)
    if decode:
        slot = torch.tensor([100 + 37 * b for b in range(B)], dtype=torch.int32, device=dev)
        valid = torch.arange(S, device=dev)[None] <= slot[:, None].long()
        valid[:, :3] = False
        valid[-1] = False  # fully masked row
    else:
        slot = torch.tensor([7 * b for b in range(B)], dtype=torch.int32, device=dev)
        valid = torch.arange(S, device=dev)[None] < (slot[:, None].long() + Sq)
        valid[-1, : slot[-1] + 1] = False  # the last row's first query sees nothing
    return q, kc, vc, valid, slot


def check(out, q, kc, vc, valid, slot, ref_fn, dtype):
    ref = ref_fn(q.float(), kc.float(), vc.float(), valid, slot, 1)
    tol = TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,hd", [(8, 8, 128), (8, 2, 128)], ids=["mha", "gqa"])
def test_prefill_kernel_matches_plain(dev, dtype, N, Nkv, hd):
    q, kc, vc, valid, slot = make_case(dev, dtype, 3, 100, N, Nkv, hd)
    before = fa.LAUNCHES["flash_prefill"]
    out = fa.flash_prefill_stacked(q, kc, vc, valid, slot, 1)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_prefill"] == before + 1
    check(out, q, kc, vc, valid, slot, fa.flash_prefill_stacked_ref, dtype)
    assert bool((out[-1, 0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,hd", [(8, 8, 128), (8, 2, 128)], ids=["mha", "gqa"])
def test_decode_kernel_matches_plain(dev, dtype, N, Nkv, hd):
    q, kc, vc, valid, slot = make_case(dev, dtype, 4, 1, N, Nkv, hd, decode=True)
    before = fa.LAUNCHES["flash_decode"]
    out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 1)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == before + 1
    check(out, q, kc, vc, valid, slot, fa.flash_decode_stacked_ref, dtype)
    assert bool((out[-1] == 0).all())


def test_kernel_rejects_unsupported_head_dim(dev):
    q, kc, vc, valid, slot = make_case(dev, torch.bfloat16, 1, 1, 2, 2, 32, decode=True)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_decode_stacked(q, kc, vc, valid, slot, 0)
