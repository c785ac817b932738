"""The CUDA kernels B1 (decode), B2 (prefill) and B2u (attention over
unstacked bsnh / bnsh K/V, causal or not, hd 64 and 128), with bf16/f32 and int8 K/V,
B3 (int4 matmul, decode and prefill forms), B4 (paged append attention), B5
(paged verify attention) and B6 (paged decode attention), with float and int8
pools, against their plain PyTorch versions on the card.  Needs an NVIDIA GPU
and nvcc; skipped without them.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: fp32 inputs atol 1e-4 (another summation order); bf16 inputs
atol = rtol = 2e-2 against the plain version run in fp32 on the same bf16
values (the output's bf16 rounding).  B3: |err| <= 1e-2 * max|ref| +
1e-2 * |ref| against the plain version in fp32 on the same bf16 x and carrier
(the prefill form rounds the dequantized weight to bf16).  B4: the output as
B1's against the plain version on the same inputs (which rounds where the
kernel does, at other running maxima), bf16's tolerance for an int8 pool
(it computes in bf16), and the pools after the call bitwise equal.  B5 as
B4, on the running rows' outputs, the pools bitwise outside the dummy block
0.  B6 computes in f32 whatever the pool: the tolerance of q's type."""
import pytest
import torch

from visualcla_tpu_torch.fixtures import paged_case, paged_decode_args, paged_verify_case
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.ops.quantization import quantize_grouped, quantize_kv

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
def test_decode_kernel_at_the_beam_shape(dev, dtype, kv8):
    """B1 as a beam search step runs it: 4 rows that share a 260-token
    prompt, all at slot 276 of a 2048-slot cache (the 7B heads); every row
    against its plain version, and a row's output the same alone as beside
    the others (the beams' rows are independent)."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, slot_v = 4, 2048, 276
    q = torch.randn(B, 1, 32, 128, generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn(2, B, 32, S, 128, generator=g, device=dev).to(dtype)
              for _ in range(2))
    kc[:, :, :, :260] = kc[:, :1, :, :260].clone()  # the shared prompt
    vc[:, :, :, :260] = vc[:, :1, :, :260].clone()
    slot = torch.full((B,), slot_v, dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev) <= slot_v)[None].expand(B, -1).contiguous()
    sc = {}
    if kv8:
        (kc, ks), (vc, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
        sc = {"k_scale": ks, "v_scale": vs}
    before = fa.LAUNCHES["flash_decode_kv8" if kv8 else "flash_decode"]
    out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 1, **sc)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode_kv8" if kv8 else "flash_decode"] == before + 1
    if kv8:
        ref = fa.flash_decode_stacked_ref(q.float(), kc, vc, valid, slot, 1, **sc)
    else:
        ref = fa.flash_decode_stacked_ref(q.float(), kc.float(), vc.float(), valid, slot, 1)
    tol = TOL[torch.bfloat16] if kv8 else TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    one = fa.flash_decode_stacked(q[2:3], kc[:, 2:3].contiguous(), vc[:, 2:3].contiguous(),
                                  valid[2:3], slot[2:3], 1,
                                  **{k: v[:, 2:3].contiguous() for k, v in sc.items()})
    assert torch.equal(one, out[2:3])


def full_case(dev, dtype, layout, hd, kv8, B=3, Sq=37, S=45, N=8, Nkv=2, seed=0):
    """B2u inputs: K/V in ``layout``, per-row slots, holes in kv_valid and a
    fully masked last row; int8 K/V with scales in the layout's order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, N, hd, generator=g, device=dev).to(dtype)
    shape = (B, S, Nkv, hd) if layout == "bsnh" else (B, Nkv, S, hd)
    k = torch.randn(*shape, generator=g, device=dev).to(dtype)
    v = torch.randn(*shape, generator=g, device=dev).to(dtype)
    slot = torch.tensor([3 * b for b in range(B)], dtype=torch.int32, device=dev)
    valid = torch.rand(B, S, generator=g, device=dev) > 0.2
    valid[-1] = False
    sc = {}
    if kv8:  # per (row, slot, head) scales, in the layout's own order
        (k, ks), (v, vs) = quantize_kv(k.float()), quantize_kv(v.float())
        sc = {"k_scale": ks, "v_scale": vs}
    return q, k, v, valid, slot, sc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bsnh", "bnsh"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
def test_full_kernel_matches_plain(dev, dtype, layout, causal, hd, kv8):
    q, k, v, valid, slot, sc = full_case(dev, dtype, layout, hd, kv8, seed=hd + causal)
    name = "flash_full_kv8" if kv8 else "flash_full"
    before = fa.LAUNCHES[name]
    out = fa.flash_attention(q, k, v, valid, slot, causal=causal, kv_layout=layout, **sc)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    ref = fa.flash_attention_ref(q.float(), k if kv8 else k.float(), v if kv8 else v.float(),
                                 valid, slot, causal=causal, kv_layout=layout, **sc)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    assert bool((out[-1] == 0).all())  # the fully masked row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_kernel_reads_strided_vit_kv(dev, dtype):
    """The ViT's shape (257 tokens, 16 heads x 64), K/V read in place as
    non-contiguous views of one fused (B, S, 3, N, hd) projection."""
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(2, 257, 3, 16, 64, generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0].contiguous(), qkv[:, :, 1], qkv[:, :, 2]
    assert not k.is_contiguous()
    valid = torch.ones(2, 257, dtype=torch.bool, device=dev)
    out = fa.flash_attention(q, k, v, valid, 0, causal=False)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, 0, causal=False)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_full_decode_form_goes_to_b1(dev):
    """Sq == 1 with causal bnsh K/V launches B1 (hd 64 and 128), as in the JAX dispatch."""
    for hd in (64, 128):
        q, k, v, valid, slot, _ = full_case(dev, torch.bfloat16, "bnsh", hd, False, Sq=1)
        before = dict(fa.LAUNCHES)
        out = fa.flash_attention(q, k, v, valid, slot, causal=True, kv_layout="bnsh")
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_decode"] == before["flash_decode"] + 1
        assert fa.LAUNCHES["flash_full"] == before["flash_full"]
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, slot,
                                     kv_layout="bnsh")
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


def test_kernel_rejects_unsupported_head_dim(dev):
    q, kc, vc, valid, slot = make_case(dev, torch.bfloat16, 1, 1, 2, 2, 32, decode=True)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_decode_stacked(q, kc, vc, valid, slot, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("N,Nkv", [(8, 8), (8, 2)], ids=["mha", "gqa"])
def test_kv8_kernels_match_plain(dev, dtype, kind, N, Nkv):
    decode = kind == "decode"
    q, kc, vc, valid, slot = make_case(dev, dtype, 4 if decode else 3, 1 if decode else 100,
                                       N, Nkv, 128, decode=decode)
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    wrapper = fa.flash_decode_stacked if decode else fa.flash_prefill_stacked
    plain = fa.flash_decode_stacked_ref if decode else fa.flash_prefill_stacked_ref
    name = f"flash_{kind}_kv8"
    before = fa.LAUNCHES[name]
    out = wrapper(q, kq, vq, valid, slot, 1, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    ref = plain(q.float(), kq, vq, valid, slot, 1, k_scale=ks, v_scale=vs)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    assert bool((out[-1] == 0).all()) if decode else bool((out[-1, 0] == 0).all())


@pytest.mark.parametrize("T", [1, 3, 8, 16, 17, 24, 32, 48, 64, 130])
@pytest.mark.parametrize("in_dim,out,gs", [(512, 384, 128), (384, 250, 128), (256, 200, 64),
                                           (256, 66, 32), (96, 40, 16), (256, 49, 128)])
def test_int4_kernel_matches_plain(dev, T, in_dim, out, gs):
    g = torch.Generator(device=dev).manual_seed(T + out)
    w = (torch.randn(in_dim, out, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=gs)
    x = torch.randn(T, in_dim, generator=g, device=dev).to(torch.bfloat16)
    ref = i4.int4_matmul_ref(x.float(), wq["q"], wq["scale"])
    decode = (gs // 2) % 32 or i4.decode_form(T, in_dim, out, i4._sm_count(x.device))
    form = "int4_matmul_decode" if decode else "int4_matmul_prefill"
    for out_dtype in (torch.float32, torch.bfloat16):
        before = i4.LAUNCHES[form]
        y = i4.int4_matmul(x, wq["q"], wq["scale"], out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert i4.LAUNCHES[form] == before + 1
        assert y.dtype == out_dtype and y.shape == (T, out)
        tol = 1e-2 * ref.abs().max() + 1e-2 * ref.abs()
        assert bool(((y.float() - ref).abs() <= tol).all())


def test_int4_kernel_forms_agree_and_stacked_layer(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    w = (torch.randn(3, 256, 192, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    wq = [quantize_grouped(w[i], group=128) for i in range(3)]
    q = torch.stack([d["q"] for d in wq])
    s = torch.stack([d["scale"] for d in wq])
    x = torch.randn(32, 256, generator=g, device=dev)  # f32 x: rounded to bf16
    # layer 2 of a stacked carrier: a view at an offset
    dec = i4._launch(x, q[2], s[2], form="decode")
    pre = i4._launch(x, q[2], s[2], form="prefill")
    ref = i4.int4_matmul_ref(x.to(torch.bfloat16).float(), q[2], s[2])
    assert dec.dtype == torch.float32
    for y in (dec, pre):
        assert bool(((y - ref).abs() <= 1e-2 * ref.abs().max() + 1e-2 * ref.abs()).all())


@pytest.mark.parametrize("in_dim,out", [(4096, 4096), (4096, 1024), (14336, 4096), (4096, 32768),
                                        (384, 250)])
def test_int4_decode_row_is_its_token_alone(dev, in_dim, out):
    """Row i of a 32-token call of the decode form equals the same token
    alone (T = 1) and in a 16- and a 64-token call, bit for bit: the splits
    and the sum order do not depend on the token count."""
    g = torch.Generator(device=dev).manual_seed(in_dim + out)
    w = (torch.randn(in_dim, out, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=128)
    x = torch.randn(64, in_dim, generator=g, device=dev).to(torch.bfloat16)
    calls = {T: i4._launch(x[:T], wq["q"], wq["scale"], torch.float32, form="decode")
             for T in (16, 32, 64)}
    for i in (0, 5, 16, 31):
        alone = i4._launch(x[i:i + 1], wq["q"], wq["scale"], torch.float32, form="decode")
        assert torch.equal(calls[32][i], alone[0]), i
        assert torch.equal(calls[64][i], alone[0]), i
        if i < 16:
            assert torch.equal(calls[16][i], alone[0]), i


def test_int4_launches_of_a_32_row_pool_pass(dev):
    """A 2-layer tower at Mistral-7B's widths (int4, int8 K/V) in a 32-row
    paged pool: one decode pass launches the decode form for each layer's 7
    products and the head (T = 32 rows, the free and gated ones included),
    and no prefill form; an admission at the 256-token bucket launches the
    prefill form for the layers' products and the decode form for the head
    (one token)."""
    import dataclasses

    from visualcla_tpu_torch.core.config import tiny_visualcla_config
    from visualcla_tpu_torch.engine import graphs
    from visualcla_tpu_torch.engine.paged import PagedServingEngine
    from visualcla_tpu_torch.engine.sampling import SamplingConfig
    from visualcla_tpu_torch.models.visualcla import (VisualCLAModel, init_random_,
                                                      quantize_text_tower_)

    cfg = tiny_visualcla_config(vocab_size=32768, hidden_size=4096)
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, intermediate_size=14336, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=512))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_random_(VisualCLAModel(cfg, device=dev, dtype=torch.bfloat16), gen)
    quantize_text_tower_(model, 4)
    eng = PagedServingEngine(model, cfg, eos_token_id=2, pad_token_id=0, pool_size=32,
                             block_size=64, num_blocks=64, max_seq_len=512,
                             max_new_tokens_cap=16, prompt_buckets=(256, 512),
                             sampling=SamplingConfig.greedy(16), kv_quant="int8", seed=5)
    L = cfg.text_config.num_hidden_layers
    prompt = torch.randint(3, 32768, (200,), generator=torch.Generator().manual_seed(1)).numpy()
    with graphs.eager():
        i4.reset_launch_counts()
        passes = eng.counts["prefill_passes"]
        eng.prefill_row(0, prompt, None, None, 8)
        assert eng.counts["prefill_passes"] == passes + 1
        assert i4.LAUNCHES == {"int4_matmul_decode": 1, "int4_matmul_prefill": 7 * L}
        i4.reset_launch_counts()
        eng.step_n(1)
        assert i4.LAUNCHES == {"int4_matmul_decode": 7 * L + 1, "int4_matmul_prefill": 0}


def _int4_case(dev, in_dim, out, gs, T, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn(in_dim, out, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=gs)
    x = torch.randn(T, in_dim, generator=g, device=dev).to(torch.bfloat16)
    return x, wq["q"], wq["scale"]


def _prefill_every_tiling(x, q, s, out_dtype):
    """The prefill form at each block tiling, then the one the wrapper picks,
    each against the plain version in fp32."""
    ref = i4.int4_matmul_ref(x.float(), q, s)
    tol = 1e-2 * ref.abs().max() + 1e-2 * ref.abs()
    for tiling in (*i4.PREFILL_TILES, None):
        before = i4.LAUNCHES["int4_matmul_prefill"]
        y = i4._launch(x, q, s, out_dtype, form="prefill", tile=tiling)
        torch.cuda.synchronize()
        assert i4.LAUNCHES["int4_matmul_prefill"] == before + 1
        assert y.dtype == out_dtype and y.shape == ref.shape
        assert bool(((y.float() - ref).abs() <= tol).all()), tiling


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [25, 130, 512])
@pytest.mark.parametrize("in_dim,out", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_int4_prefill_7b_widths(dev, in_dim, out, T, out_dtype):
    """B3's wgmma prefill form at the 7B text tower's widths (gs 128)."""
    _prefill_every_tiling(*_int4_case(dev, in_dim, out, 128, T, seed=T + out), out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_dim,out,gs", [(384, 250, 128), (256, 200, 64), (256, 49, 128),
                                           (384, 250, 192)],
                         ids=["ragged", "gs64", "odd_out", "gs192"])
def test_int4_prefill_ragged_and_group_sizes(dev, in_dim, out, gs, out_dtype):
    """Ragged and odd widths, gs 64 (32 carrier rows a step) and gs 192 (two
    runs of 32 x columns a step), 70 tokens (a ragged 64-row tile)."""
    _prefill_every_tiling(*_int4_case(dev, in_dim, out, gs, 70, seed=out + gs), out_dtype)


POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(8, 8), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("BS", [16, 64])
def test_paged_append_kernel_matches_plain(dev, dtype, kv_int8, N, Nkv, BS):
    # a parked row, offsets 0 and BS-1, one token, a long row
    ctx = [-1, 2 * BS, 3 * BS - 1, 0, 5 * BS + 7, 300]
    case = paged_case(ctx, N, Nkv, block_size=BS, dtype=dtype, kv_int8=kv_int8, device=dev,
                      seed=BS + N + Nkv)
    ref_case = {k: (v.clone() if k in POOL_KEYS else v) for k, v in case.items()}
    name = "paged_append_kv8" if kv_int8 else "paged_append"
    before = pa.LAUNCHES[name]
    out = pa.paged_append_attention(**case)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_append_attention_ref(**ref_case)
    assert out.dtype == dtype and out.shape == case["q"].shape
    # an int8 pool computes in bf16 (q and p rounded to it), whatever q's type
    tol = TOL[torch.bfloat16 if kv_int8 else dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for key in POOL_KEYS:
        if case.get(key) is not None:
            assert torch.equal(case[key], ref_case[key]), key


def test_paged_append_kernel_rejects_bad_inputs(dev):
    case = paged_case([3, 9], 4, 4, block_size=16, device=dev)
    with pytest.raises(TypeError):
        pa.paged_append_attention(**{**case, "k_new": case["k_new"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_append_attention(**{**case, "q": case["q"].transpose(0, 1).contiguous()
                                     .transpose(0, 1)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(8, 8), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("BS,Sq", [(16, 3), (64, 9)])
def test_paged_verify_kernel_matches_plain(dev, dtype, kv_int8, N, Nkv, BS, Sq):
    # a parked row, appends from offsets 0 and BS-2 (straddling a block edge),
    # an empty context, a long row
    ctx = [-1, 2 * BS, 3 * BS - 2, 0, 5 * BS + 7, 300]
    case = paged_verify_case(ctx, Sq, N, Nkv, block_size=BS, dtype=dtype, kv_int8=kv_int8,
                             device=dev, seed=BS + Sq + N + Nkv)
    ref_case = {k: (v.clone() if k in POOL_KEYS else v) for k, v in case.items()}
    name = "paged_verify_kv8" if kv_int8 else "paged_verify"
    before = pa.LAUNCHES[name]
    out = pa.paged_verify_attention(**case)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_verify_attention_ref(**ref_case)
    assert out.dtype == dtype and out.shape == case["q"].shape
    tol = TOL[torch.bfloat16 if kv_int8 else dtype]
    # the parked row's output is dropped (it reads the dummy block)
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), atol=tol, rtol=tol)
    for key in POOL_KEYS:
        if case.get(key) is not None:
            assert torch.equal(case[key][:, 1:], ref_case[key][:, 1:]), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(8, 8), (8, 2)], ids=["mha", "gqa"])
def test_paged_decode_kernel_matches_plain(dev, dtype, kv_int8, N, Nkv):
    case = paged_case([-1, 128, 191, 0, 327, 300], N, Nkv, block_size=64, dtype=dtype,
                      kv_int8=kv_int8, device=dev, seed=N + Nkv)
    args = paged_decode_args(case)
    name = "paged_decode_kv8" if kv_int8 else "paged_decode"
    before = pa.LAUNCHES[name]
    out = pa.paged_decode_attention(**args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_decode_attention_ref(**args)
    assert out.dtype == dtype and out.shape == args["q"].shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert bool((out[0] == 0).all())  # lens 0: zeros


# ---------------------------------------------------------------------------
# the redesigned flash kernels: split-KV B1, tensor-core B2 / B2u
# ---------------------------------------------------------------------------

def stacked_case(dev, dtype, Sq, N, Nkv, hd, S, slots, kv8, dead_row=None, seed=0):
    """A 2-layer cache of ``S`` slots, row b's queries at slots[b] .. + Sq,
    ragged left padding, optionally a row that sees nothing and int8 K/V."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(slots)
    q = torch.randn(B, Sq, N, hd, generator=g, device=dev).to(dtype)
    kc = torch.randn(2, B, Nkv, S, hd, generator=g, device=dev).to(dtype)
    vc = torch.randn(2, B, Nkv, S, hd, generator=g, device=dev).to(dtype)
    slot = torch.tensor(slots, dtype=torch.int32, device=dev)
    valid = torch.arange(S, device=dev)[None] < (slot[:, None].long() + Sq)
    for b in range(B):
        valid[b, :b + 2] = False
    if dead_row is not None:
        valid[dead_row] = False
    sc = {}
    if kv8:
        (kc, ks), (vc, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
        sc = {"k_scale": ks, "v_scale": vs}
    return q, kc, vc, valid, slot, sc


def check_stacked(wrapper, plain, q, kc, vc, valid, slot, sc, dtype):
    out = wrapper(q, kc, vc, valid, slot, 1, **sc)
    torch.cuda.synchronize()
    ref = plain(q.float(), kc if sc else kc.float(), vc if sc else vc.float(), valid, slot, 1,
                **sc)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("N,Nkv,hd", [(8, 8, 128), (8, 2, 128), (4, 4, 64)],
                         ids=["mha", "gqa4", "hd64"])
def test_decode_kernel_split_cases(dev, dtype, kv8, N, Nkv, hd):
    """B1 with slots in the first run, in later runs, at the end of the cache,
    a negative slot and a row with nothing valid (both zeros)."""
    slots = [40, 300, 1023, -1, 700, 128, 127]
    q, kc, vc, valid, slot, sc = stacked_case(dev, dtype, 1, N, Nkv, hd, 1024, slots, kv8,
                                              dead_row=4, seed=N + hd)
    out = check_stacked(fa.flash_decode_stacked, fa.flash_decode_stacked_ref, q, kc, vc, valid,
                        slot, sc, dtype)
    assert bool((out[3] == 0).all()) and bool((out[4] == 0).all())
    # the same call again gives the same bits: no atomics, a fixed combine order
    again = fa.flash_decode_stacked(q, kc, vc, valid, slot, 1, **sc)
    assert torch.equal(out, again)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
def test_decode_kernel_row_does_not_depend_on_its_batch(dev, kv8):
    """f32: a row served in a batch of 5 equals, bit for bit, the same row
    served alone (what keeps batched generation equal to single rows)."""
    slots = [40, 300, 1023, 700, 511]
    q, kc, vc, valid, slot, sc = stacked_case(dev, torch.float32, 1, 8, 8, 128, 1024, slots, kv8)
    out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 1, **sc)
    for b in range(len(slots)):
        one_sc = {n: a[:, b:b + 1].contiguous() for n, a in sc.items()}
        one = fa.flash_decode_stacked(q[b:b + 1], kc[:, b:b + 1].contiguous(),
                                      vc[:, b:b + 1].contiguous(), valid[b:b + 1],
                                      slot[b:b + 1], 1, **one_sc)
        assert torch.equal(out[b:b + 1], one), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("N,Nkv,hd", [(8, 8, 128), (8, 2, 128), (4, 4, 64)],
                         ids=["mha", "gqa4", "hd64"])
@pytest.mark.parametrize("Sq", [5, 9, 130])
def test_prefill_kernel_verify_shapes(dev, dtype, kv8, N, Nkv, hd, Sq):
    """B2 at Sq 5 and 9 (the speculative verify) and 130 (two query tiles and
    a ragged third) at per-row slots; one row starts at slot 0, one sees
    nothing."""
    slots = [600, 0, 37, 64]
    q, kc, vc, valid, slot, sc = stacked_case(dev, dtype, Sq, N, Nkv, hd, 1024, slots, kv8,
                                              dead_row=2, seed=Sq + N)
    for tiling in (1, 2, 3, None):  # every block tiling of the bf16 kernel, then the picked one
        fa.TILING = tiling
        try:
            out = check_stacked(fa.flash_prefill_stacked, fa.flash_prefill_stacked_ref, q, kc,
                                vc, valid, slot, sc, dtype)
        finally:
            fa.TILING = None
        assert bool((out[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("tokens", [257, 1025])
def test_full_kernel_vit_token_counts(dev, dtype, kv8, tokens):
    """B2u at the ViT's token counts (224 and 448 px): no multiple of the
    tile, causal off, hd 64, bsnh, a fully masked row."""
    q, k, v, valid, slot, sc = full_case(dev, dtype, "bsnh", 64, kv8, B=2, Sq=tokens, S=tokens,
                                         N=16, Nkv=16, seed=tokens)
    for tiling in (1, 2, 3, None):
        fa.TILING = tiling
        try:
            out = fa.flash_attention(q, k, v, valid, 0, causal=False, **sc)
        finally:
            fa.TILING = None
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q.float(), k if kv8 else k.float(), v if kv8 else v.float(),
                                     valid, 0, causal=False, **sc)
        torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])
        assert bool((out[-1] == 0).all())


def test_bf16_kernel_rejects_misaligned_rows(dev):
    """The tensor-core kernel copies rows 16 bytes at a time: a K/V view that
    starts 2 bytes into a row raises instead of reading misaligned."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(1, 8, 4, 64, generator=g, device=dev).to(torch.bfloat16)
    wide = torch.randn(1, 16, 4, 65, generator=g, device=dev).to(torch.bfloat16)
    valid = torch.ones(1, 16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, wide[..., 1:], wide[..., 1:], valid, 0, causal=False)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_flash_kernels_replay_in_a_cuda_graph(dev, kind):
    """One B1 call and one B2 call captured in a CUDA graph and replayed give
    the eager result (no host read, no allocation outside the graph's pool)."""
    Sq = 1 if kind == "decode" else 70
    wrapper = fa.flash_decode_stacked if kind == "decode" else fa.flash_prefill_stacked
    q, kc, vc, valid, slot, _ = stacked_case(dev, torch.bfloat16, Sq, 8, 8, 128, 1024,
                                             [300, 700], False, seed=9)
    eager = wrapper(q, kc, vc, valid, slot, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wrapper(q, kc, vc, valid, slot, 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = wrapper(q, kc, vc, valid, slot, 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    slot.add_(17)  # the slots live on the device: a replay follows them
    valid[:] = torch.arange(1024, device=dev)[None] < (slot[:, None].long() + Sq)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, wrapper(q, kc, vc, valid, slot, 1))


# ---------------------------------------------------------------------------
# split-KV B5 / B6
# ---------------------------------------------------------------------------

def _verify_and_ref(case, rows):
    """B5 on ``case`` and its plain version on a copy: (out, ref); the pools
    after the call bitwise equal outside the dummy block 0."""
    ref_case = {k: (v.clone() if k in POOL_KEYS and v is not None else v)
                for k, v in case.items()}
    out = pa.paged_verify_attention(**case)
    torch.cuda.synchronize()
    ref = pa.paged_verify_attention_ref(**ref_case)
    for key in POOL_KEYS:
        if case.get(key) is not None:
            assert torch.equal(case[key][:, 1:], ref_case[key][:, 1:]), key
    return out[rows], ref[rows]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv,Sq", [(8, 8, 5), (8, 2, 9)], ids=["mha", "gqa"])
def test_paged_verify_kernel_long_rows_and_edges(dev, dtype, kv_int8, N, Nkv, Sq):
    """Several splits a row (rows of ~2048 slots), an append crossing a block
    edge, one running past the table (its tail goes to dummy block 0 and is
    not attended), a parked row; a call repeated gives the same bits."""
    BS = 64
    ctx = [2039, 1500, 2 * BS - 3, -1, 700]
    case = paged_verify_case(ctx, Sq, N, Nkv, block_size=BS, dtype=dtype, kv_int8=kv_int8,
                             device=dev, seed=Sq + Nkv)
    rows = [0, 1, 2, 4]
    out, ref = _verify_and_ref(case, rows)
    tol = TOL[torch.bfloat16 if kv_int8 else dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    again = pa.paged_verify_attention(**case)  # the pools already hold the append
    assert torch.equal(again[rows], out)
    # a table two blocks wide: row 0's append runs past it from slot 128
    edge = paged_verify_case([2 * BS - 3, 40], Sq, N, Nkv, block_size=BS, dtype=dtype,
                             kv_int8=kv_int8, device=dev, seed=Sq + N)
    edge["tables"] = edge["tables"][:, :2].contiguous()
    out2, ref2 = _verify_and_ref(edge, [0, 1])
    torch.testing.assert_close(out2.float(), ref2.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_kernel_row_does_not_depend_on_its_batch(dev, dtype):
    """A row served in a batch of 4 equals, bit for bit, the same row served
    alone (float pools: f32 on the FMA kernel, bf16 on the tensor cores)."""
    ctx = [300, 1100, 64, 777]
    Sq = 5
    case = paged_verify_case(ctx, Sq, 8, 8, block_size=64, dtype=dtype, device=dev, seed=11)
    pools = {k: case[k].clone() for k in POOL_KEYS if case.get(k) is not None}
    out = pa.paged_verify_attention(**case)
    for b in range(len(ctx)):
        one = dict(case, **{k: v.clone() for k, v in pools.items()})
        for key in ("q", "k_new", "v_new", "tables", "lens"):
            one[key] = case[key][b:b + 1].contiguous()
        assert torch.equal(pa.paged_verify_attention(**one), out[b:b + 1]), b


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
def test_paged_verify_kernel_replays_in_a_cuda_graph(dev, kv_int8):
    """One B5 call captured in a CUDA graph follows lens changed on the device
    between replays (the split count depends on the table width alone)."""
    Sq = 5
    case = paged_verify_case([200, 900, -1], Sq, 8, 8, block_size=64, dtype=torch.bfloat16,
                             kv_int8=kv_int8, device=dev, seed=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_verify_attention(**case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pa.paged_verify_attention(**case)
    for step in range(3):
        if step:
            case["lens"][:2].add_(Sq)  # the rows grew on the device
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, pa.paged_verify_attention(**case)), step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
def test_paged_decode_kernel_long_rows(dev, dtype, kv_int8):
    """B6 over several splits a row (2047 and 1500 tokens), a row of lens 0
    (zeros); a call repeated gives the same bits."""
    case = paged_case([2047, 0, 1500, 64], 8, 2, block_size=64, dtype=dtype, kv_int8=kv_int8,
                      device=dev, seed=4)
    args = paged_decode_args(case)
    out = pa.paged_decode_attention(**args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_ref(**args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert bool((out[1] == 0).all())
    assert torch.equal(pa.paged_decode_attention(**args), out)


# ---------------------------------------------------------------------------
# split-KV B4 (the old context over runs, the new token folded in by the combine)
# ---------------------------------------------------------------------------

def _append_and_ref(case):
    """B4 on ``case`` and its plain version on a copy: (out, ref); the pools
    after the call bitwise equal outside the dummy block 0 (parked rows all
    write it, in no set order)."""
    ref_case = {k: (v.clone() if k in POOL_KEYS and v is not None else v)
                for k, v in case.items()}
    out = pa.paged_append_attention(**case)
    torch.cuda.synchronize()
    ref = pa.paged_append_attention_ref(**ref_case)
    for key in POOL_KEYS:
        if case.get(key) is not None:
            assert torch.equal(case[key][:, 1:], ref_case[key][:, 1:]), key
    return out, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(32, 32), (32, 8)], ids=["mha", "gqa"])
def test_paged_append_kernel_long_rows_and_parked(dev, dtype, kv_int8, N, Nkv):
    """B=8 rows of 2047 old tokens (16 runs a row), then rows of every kind
    with two parked rows (lens 1, dummy block 0): within the tolerance, the
    pools bitwise outside block 0, a parked row's output its v_new (times
    vsn), and a call repeated on the same pools gives the same bits."""
    tol = TOL[torch.bfloat16 if kv_int8 else dtype]
    for ctx in ([2047] * 8, [-1, 2047, 64, 0, 63, 1500, -1]):
        case = paged_case(ctx, N, Nkv, block_size=64, L=2, dtype=dtype, kv_int8=kv_int8,
                          device=dev, seed=len(ctx) + N + Nkv)
        out, ref = _append_and_ref(case)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        again = pa.paged_append_attention(**case)  # the slot it reads stays below the append
        assert torch.equal(again, out)
        for b in (b for b, c in enumerate(ctx) if c < 0):
            vn = case["v_new"][b].float()
            if kv_int8:
                vn = vn * case["v_new_scales"][b][:, None]
            want = vn.repeat_interleave(N // Nkv, 0).to(dtype)
            assert torch.equal(out[b], want), b


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_append_kernel_row_does_not_depend_on_its_batch(dev, dtype, kv_int8):
    """A row served in a batch of 5 equals, bit for bit, the same row served
    alone (the grid's split axis changes with the batch, the sums do not)."""
    ctx = [300, 1100, 64, 777, 2000]
    case = paged_case(ctx, 8, 8, block_size=64, dtype=dtype, kv_int8=kv_int8, device=dev,
                      seed=12)
    pools = {k: case[k].clone() for k in POOL_KEYS if case.get(k) is not None}
    out = pa.paged_append_attention(**case)
    for b in range(len(ctx)):
        one = dict(case, **{k: v.clone() for k, v in pools.items()})
        for key in ("q", "k_new", "v_new", "tables", "lens", "blk", "off", "k_new_scales",
                    "v_new_scales"):
            if case.get(key) is not None:
                one[key] = case[key][b:b + 1].contiguous()
        assert torch.equal(pa.paged_append_attention(**one), out[b:b + 1]), b


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_pool", "int8_pool"])
def test_paged_append_kernel_replays_in_a_cuda_graph(dev, kv_int8):
    """One B4 call captured in a CUDA graph follows lens, blk and off changed
    on the device between replays (each replay appends the next slot), and
    equals the same call made eagerly after it."""
    BS = 64
    case = paged_case([200, 900, -1], 8, 8, block_size=BS, dtype=torch.bfloat16,
                      kv_int8=kv_int8, device=dev, seed=6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_append_attention(**case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pa.paged_append_attention(**case)
    running = torch.tensor([True, True, False], device=dev)
    for step in range(4):
        if step:  # the running rows grew by one token, on the device
            lens = case["lens"] + running.int()
            slot = (lens - 1).long()
            blk = torch.gather(case["tables"].long(), 1, (slot // BS)[:, None])[:, 0]
            case["lens"].copy_(lens)
            case["blk"].copy_(torch.where(running, blk, case["blk"].long()).int())
            case["off"].copy_(torch.where(running, slot % BS, case["off"].long()).int())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, pa.paged_append_attention(**case)), step


# ---------------------------------------------------------------------------
# B3's decode form (mma.sync on the exact nibbles, one launch)
# ---------------------------------------------------------------------------

B3_SHAPES = {"7b_qkvo": (4096, 4096), "7b_gate_up": (4096, 11008), "7b_down": (11008, 4096),
             "7b_head": (4096, 49958), "13b_qkvo": (5120, 5120), "13b_gate_up": (5120, 13824),
             "13b_down": (13824, 5120), "mistral_kv": (4096, 1024),
             "mistral_gate_up": (4096, 14336), "mistral_down": (14336, 4096),
             "mistral_head": (4096, 32768)}


def _b3_decode_check(x, q, s, out_dtype):
    """The decode form against the plain version in fp32: one launch, within
    the tolerance; a repeated call gives the same bits."""
    ref = i4.int4_matmul_ref(x.float(), q, s)
    before = i4.LAUNCHES["int4_matmul_decode"]
    y = i4._launch(x, q, s, out_dtype, form="decode")
    torch.cuda.synchronize()
    assert i4.LAUNCHES["int4_matmul_decode"] == before + 1
    assert y.dtype == out_dtype and y.shape == ref.shape
    assert bool(((y.float() - ref).abs() <= 1e-2 * ref.abs().max() + 1e-2 * ref.abs()).all())
    assert torch.equal(i4._launch(x, q, s, out_dtype, form="decode"), y)
    return y


@pytest.mark.parametrize("T", [1, 2, 8, 9, 16, 32, 64])
@pytest.mark.parametrize("shape", list(B3_SHAPES))
def test_int4_decode_7b_13b_shapes(dev, shape, T):
    """The 7B, 13B and Mistral-7B text towers' shapes (gs 128; Mistral's at
    the paged pool's 32-row pass), the head written in f32; each token's
    row equals, bit for bit, the same token served alone."""
    in_dim, out = B3_SHAPES[shape]
    out_dtype = torch.float32 if shape.endswith("head") else torch.bfloat16
    x, q, s = _int4_case(dev, in_dim, out, 128, T, seed=T + out)
    y = _b3_decode_check(x, q, s, out_dtype)
    for t in {0, T - 1}:
        assert torch.equal(i4._launch(x[t:t + 1].clone(), q, s, out_dtype, form="decode"),
                           y[t:t + 1]), t


@pytest.mark.parametrize("T", [1, 9, 16, 40, 65])
@pytest.mark.parametrize("in_dim,out,gs", [(384, 250, 128), (512, 66, 64), (256, 49, 128),
                                           (768, 200, 192), (1536, 384, 64), (96, 40, 16),
                                           (96, 40, 6), (160, 66, 10), (288, 250, 18),
                                           (192, 48, 12)],
                         ids=["ragged", "gs64_ragged", "odd_out", "gs192", "gs64", "gs16", "gs6",
                              "gs10", "gs18", "gs12"])
def test_int4_decode_ragged_and_group_sizes(dev, in_dim, out, gs, T):
    """Widths not a multiple of 16 (rows copied from the 16-byte boundary
    below them), odd widths, gs 16/64/128/192, gs whose half is not a
    multiple of 8 (x copied element by element; 6, 10 and 18 put a group's
    high rows off 4 bytes), one to three token tiles."""
    for out_dtype in (torch.bfloat16, torch.float32):
        _b3_decode_check(*_int4_case(dev, in_dim, out, gs, T, seed=T + out + gs), out_dtype)
