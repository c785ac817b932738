// Grouped-int4 matmul y = x @ W4 for Hopper (sm_90a).
//
// Replaces the Pallas kernel B3 (visualcla_tpu/ops/pallas/int4_matmul.py:
// int4_matmul -> _kernel, _kernel_scratch, _kernel_scratch_tiled).
//
// Contract: x (T, in) bf16 row-major; the v2 carrier q (G, gs/2, out) uint8
// whose byte [g, r, o] holds W4[g*gs + r, o] in the low nibble and
// W4[g*gs + gs/2 + r, o] in the high nibble (signed 4-bit, two's complement);
// scale (G, out) f32.  y (T, out) = sum_g (x[:, group g] @ W4[group g]) *
// scale[g], written as f32 or bf16 (round to nearest even).
//
// Two forms, chosen by the wrapper from T and the width of the weight:
//   int4_decode_kernel (up to 64 tokens, one launch) should be bound by the
//   carrier's bytes.  The TPU kernel's per-group product, dot(x_group,
//   nibbles as bf16, fp32 accumulation) * scale[g], is a tensor-core product
//   on exact values (-8..7 are exact in bf16), so the products run as
//   mma.sync.m16n8k16 with the tokens as the rows (one, two or four 16-row
//   tiles, from T) and the nibbles as the B operand: each dequantized B
//   fragment serves every token tile, so a carrier byte is read and
//   dequantized once a call up to 64 tokens.  A pair of nibbles becomes an
//   exact bf16x2 in three instructions (a byte_perm puts the nibbles of two
//   rows of one column in place, one lop3 masks them and sets the exponent:
//   0x43nn is 128 + nn for the nibble's bits ^ 8, and a bf16x2 fma subtracts
//   136), and the mma's k order is chosen so that a byte feeds two k of one
//   column and x is read as it lies (ldmatrix).  A block is 256 columns (256
//   contiguous bytes of a carrier row) and one run of groups (a split); it
//   streams the run through a ring of 6 steps (32 carrier rows, the step's
//   x, a group's scales).  Where rows are 16-byte aligned and a step is 32
//   whole rows of a group, one thread puts a step in flight as four TMA boxes
//   (two 128-byte carrier panels, x's low and high rows; swizzled, so a
//   warp's reads meet no bank conflict) and one bulk copy of the scales;
//   else every thread copies 16-byte pieces by cp.async.  (The TMA's bulk
//   copies of single 256-byte rows, or thread-issued 16-byte pieces, held a
//   block to ~6 GB/s and the card to ~1.5 TB/s on an H100.)  The 8 warps
//   lie side by side over the columns, 32 each (the two sets of fp32 sums
//   stay within 128 registers up to 32 tokens, so an SM holds two blocks):
//   every warp walks every group of the run, runs each group's dot in fp32,
//   multiplies it by the group's scale once and adds it to its total, in
//   group order, and needs no other warp's sums.  Where the groups are split
//   over blocks, a column tile's splits (up to 16) run as one cluster and sum
//   each other's totals in split order from shared memory.  The sum order
//   depends on the shapes and the card, never on scheduling or on the token
//   count: a call repeats bit for bit, and a token's row does not depend on
//   the other tokens or on the token tile.  Launched as a programmatic
//   dependent, a call puts its first stages' carrier in flight while the
//   kernel before it finishes.  What bounds it: the dequantizing
//   instructions and mma.sync (on registers alone they reach ~2.5 TB/s of
//   carrier at 16 tokens and ~2.0 at 32 with two blocks an SM on an H100),
//   then each call's fixed path (the ring's fill, the cluster's sums).
//   int4_prefill_kernel (the prompt) is bound by the tensor cores: it does
//   T multiply-adds per weight element, and dequantizing an element costs
//   about four instructions (byte_perm and a subtraction make the nibble a
//   float exactly, a multiply applies the scale, one conversion rounds a pair
//   to bf16).  So the products run as wgmma (bf16 in, fp32 accumulate) and
//   the dequantization runs beside them on warps of its own: a block is one
//   or two product warpgroups (64 tokens x 128 columns each: the wrapper picks
//   64 or 128 tokens a block from the grid), two dequantizing warpgroups and
//   two copy warps.  One step is KC = 64 carrier rows of one group (32 where
//   gs/2 is not a multiple of 64).  The copy warps land, by TMA, the step's
//   two x panels (the KC x columns of the low nibbles and the KC of the high
//   ones, K-major A operand; 128-byte swizzle at KC 64, 64-byte at KC 32; rows
//   past T zero-filled) and its raw carrier rows (128-byte swizzle) into two
//   rings of their own, each handed back by the warps that read it.  The
//   dequantizers turn the raw rows into the bf16 W tile of the step: nibble
//   + 8 as the low byte of the float 2^23, minus 2^23 + 8, is the nibble
//   exactly; times its scale in fp32, rounded once to bf16 (the TPU's scratch
//   form); n-contiguous, read MN-major through the descriptor's transpose
//   bit; each thread owns the same 16-byte chunk of both 64-column panels, so
//   a row's stores meet no bank conflict.  Three W buffers let the
//   dequantizers work a step ahead while the products of the step before
//   still issue (with two, a buffer came back only after the next step's
//   products had issued, and the two sides ran one after the other);
//   mbarriers hand every buffer over (full: landed / written; empty: read).
//   The product warps never dequantize, so they hold only their
//   accumulators.  The epilogue writes bf16 or f32 from the accumulators,
//   ragged columns and rows masked.
//   Needs gs % 64 == 0 (every LLaMA size: gs 128); other group sizes run the
//   decode form.
#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// prefill form (tensor cores: wgmma; dequantizing warpgroups beside them)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a box of a 2-d tensor map into shared memory by the TMA, counted in bytes
// against the mbarrier ``bar``
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival on ``bar`` that also expects ``bytes`` of copies in this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the mbarrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one arrival on ``bar`` for the warp, once all its lanes got here
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}
// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// values an asynchronous wgmma writes stay in their registers up to here
__device__ __forceinline__ void keep_in_registers(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor.  K-major operand (x) under the 128-byte
// (``layout`` 1: rows of 128 bytes, 8-row groups of 1024) or 64-byte swizzle
// (``layout`` 2: rows of 64 bytes, groups of 512): ``sbo`` is the stride
// between 8-row groups, the leading offset unused.  MN-major operand (W,
// 128-byte swizzle): ``lbo`` is the stride between 64-column panels along n,
// ``sbo`` between 8-row groups along k.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t layout) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

#define VCLA_F8(d, o)                                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 128, fp32) += A (64 x 16, shared, K-major) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : VCLA_F8(d, 0), VCLA_F8(d, 8), VCLA_F8(d, 16), VCLA_F8(d, 24), VCLA_F8(d, 32),
        VCLA_F8(d, 40), VCLA_F8(d, 48), VCLA_F8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}
#undef VCLA_F8

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // each rounded to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte i of ``biased`` (a nibble + 8, in 0..15) as the float nibble, exactly:
// 0x4B0000ii is 2^23 + ii
__device__ __forceinline__ float nibble_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | i)) - 8388616.f;
}

// byte offset of 16-byte chunk ``c`` (0..7) of row ``r`` of 128-byte rows
// under the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A block is kMma warpgroups of 64 tokens each running the products (kN
// tokens x kBN = 128 columns), two warpgroups dequantizing, and two copy
// warps.  One step is KC carrier rows of one group: 2 KC rows of W (the KC low
// nibbles, then the KC high ones).  Three rings of buffers, each handed back
// by the warps that read it: the x ring (kXStages) holds a step's two x
// panels, each the KC matching x columns of kN tokens (rows of 2 KC bytes:
// 128 under the 128-byte swizzle at KC 64, 64 under the 64-byte swizzle at KC
// 32), read by the products; the raw ring (kRStages) holds its carrier rows
// (kBN bytes each, 128-byte swizzle), read by the dequantizers; the W ring
// (kWBufs = 3) holds its dequantized tile (64-row k blocks of two 64-column
// panels of 128-byte rows, 128-byte swizzle), written by the dequantizers and
// read by the products.  Three W buffers let the dequantizers run a step
// ahead while the products of the step before still issue.
template <int KC, int kMma, int kXStages, int kRStages>
struct PreTile {
  static constexpr int kN = 64 * kMma;
  static constexpr int kBN = 128;
  static constexpr int kPanelBytes = kN * 2 * KC;
  static constexpr int kXBytes = 2 * kPanelBytes;  // a multiple of 1024
  static constexpr int kRawBytes = KC * kBN;
  static constexpr int kWBytes = 2 * KC * kBN * 2;
  static constexpr int kWBufs = 3;
  static constexpr int kRawOff = kXStages * kXBytes;
  static constexpr int kWOff = kRawOff + kRStages * kRawBytes;
  // mbarriers: full and empty of each x stage, raw stage and W buffer
  static constexpr int kBarOff = kWOff + kWBufs * kWBytes;
  static constexpr int kBytes = kBarOff + 16 * (kXStages + kRStages + kWBufs) + 1024;
  static constexpr int kMmaThreads = 128 * kMma;
  static constexpr int kDeqThreads = 256;
  static constexpr int kThreads = kMmaThreads + kDeqThreads + 64;
  static constexpr int kSlices = KC / 8;  // k16 slices a step: KC / 16 low, then KC / 16 high
  static constexpr uint32_t kXSbo = 16 * KC;  // 8 rows of 2 KC bytes
  static constexpr uint64_t kXLayout = KC == 64 ? 1 : 2;
};

// 16 columns of one carrier row as 32 bf16 weights: nibble * scale in fp32,
// rounded once to bf16, into the W tile at rows ``k`` (low nibbles) and KC +
// k (high nibbles): columns 0-7 of ``b`` into 16-byte column chunk ``nc0``,
// 8-15 into ``nc1``
template <int KC>
__device__ __forceinline__ void dequant16(uint4 b, const float (&s)[16], uint8_t* w_tile, int k,
                                          int nc0, int nc1) {
  const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // 0: low nibbles, 1: high
    const int row = half * KC + k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 8 columns: one 16-byte store
      uint32_t o[4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t word = w[2 * h + p];
        const uint32_t biased = ((half ? word >> 4 : word) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const float* sc = s + 8 * h + 4 * p;
        o[2 * p] = bf16x2(__fmul_rn(nibble_f32(biased, 0), sc[0]),
                          __fmul_rn(nibble_f32(biased, 1), sc[1]));
        o[2 * p + 1] = bf16x2(__fmul_rn(nibble_f32(biased, 2), sc[2]),
                              __fmul_rn(nibble_f32(biased, 3), sc[3]));
      }
      const int c = h ? nc1 : nc0;  // column chunk 0..15: panel c / 8
      *reinterpret_cast<uint4*>(w_tile + (row / 64) * 16384 + (c / 8) * 8192 +
                                swz(row % 64, c % 8)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// x_map: x as (T, in) bf16, boxes of (kN, KC); q_map: the carrier as (G gs/2,
// out) bytes, boxes of (KC, kBN), when ``vec``.  Either zero-fills what lies
// past the tensor (tokens past T, columns past out).
template <int KC, int kMma, int kXStages, int kRStages>
__global__ void __launch_bounds__(PreTile<KC, kMma, kXStages, kRStages>::kThreads, 1)
int4_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap q_map, const uint8_t* __restrict__ qw,
                    const float* __restrict__ scale, void* __restrict__ out, int T, int G,
                    int gsh, int out_dim, int out_bf16, int vec) {
  using L = PreTile<KC, kMma, kXStages, kRStages>;
  constexpr int kW = L::kWBufs;
  extern __shared__ uint8_t pre_smem_raw[];
  uint8_t* smem = pre_smem_raw + ((1024 - (smem_u32(pre_smem_raw) & 1023)) & 1023);
  const uint32_t smem_base = smem_u32(smem);
  const uint32_t xfull = smem_base + L::kBarOff;  // + 8 * stage
  const uint32_t xempty = xfull + 8 * kXStages;
  const uint32_t rfull = xempty + 8 * kXStages;
  const uint32_t rempty = rfull + 8 * kRStages;
  const uint32_t wfull = rempty + 8 * kRStages;  // + 8 * W buffer
  const uint32_t wempty = wfull + 8 * kW;
  const int n0 = blockIdx.x * L::kBN;
  const int t0 = blockIdx.y * L::kN;
  const int gs = 2 * gsh;
  const int per_group = gsh / KC;
  const int steps = G * per_group;
  constexpr int kMmaWarps = L::kMmaThreads / 32, kDeqWarps = L::kDeqThreads / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kXStages; ++i) {
      mbar_init(xfull + 8 * i, 1);
      mbar_init(xempty + 8 * i, kMmaWarps);
    }
    for (int i = 0; i < kRStages; ++i) {
      mbar_init(rfull + 8 * i, 1);
      mbar_init(rempty + 8 * i, kDeqWarps);
    }
    for (int i = 0; i < kW; ++i) {
      mbar_init(wfull + 8 * i, kDeqWarps);
      mbar_init(wempty + 8 * i, kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::kMmaThreads + L::kDeqThreads) {
    // ---- the copy warps: one thread each puts a step's x panels (first
    // warp) or its carrier rows (second) in flight on the TMA once its stage
    // is free ----
    if (threadIdx.x % 32 != 0) return;
    const bool x_side = threadIdx.x == L::kMmaThreads + L::kDeqThreads;
    if (!x_side && !vec) return;  // the dequantizers read the carrier from memory
    const int n_st = x_side ? kXStages : kRStages;
    const uint32_t full = x_side ? xfull : rfull, empty = x_side ? xempty : rempty;
    for (int s = 0; s < steps; ++s) {
      const int st = s % n_st;
      if (s >= n_st) mbar_wait(empty + 8 * st, (s / n_st - 1) & 1);
      const int g = s / per_group, cr0 = (s % per_group) * KC;
      const uint32_t bar = full + 8 * st;
      if (x_side) {
        const uint32_t stage = smem_base + st * L::kXBytes;
        mbar_expect(bar, L::kXBytes);
        tma_load_2d(stage, &x_map, g * gs + cr0, t0, bar);
        tma_load_2d(stage + L::kPanelBytes, &x_map, g * gs + gsh + cr0, t0, bar);
      } else {
        mbar_expect(bar, L::kRawBytes);
        tma_load_2d(smem_base + L::kRawOff + st * L::kRawBytes, &q_map, n0, g * gsh + cr0, bar);
      }
    }
    return;
  }

  if (threadIdx.x >= L::kMmaThreads) {
    // ---- the dequantizers: step s's carrier rows into W buffer s % 3 once
    // the products of step s - 3 are done with it.  Thread dt owns columns
    // 8c .. 8c + 7 and 64 + 8c .. 64 + 8c + 7 (c = dt % 8: the 16-byte chunk c
    // of each W panel, so the 8 threads of a row store to 8 different bank
    // groups) of carrier rows dt / 8 + 32 i ----
    const int dt = threadIdx.x - L::kMmaThreads;
    const int c = dt % 8;
    const int col = n0 + 8 * c;
    auto tcol = [](int e) { return e < 8 ? e : 56 + e; };  // column of element e, from col
    float sc[16], sn[16];  // the scales of this step's group, and of the next step's
    auto load_scales = [&](int s, float (&dst)[16]) {
      const float* sp = scale + (size_t)(s / per_group) * out_dim + col;
      if (vec) {  // out % 16 == 0: each run of 8 columns is all in or all out
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = col + tcol(4 * i) < out_dim
                               ? __ldg(reinterpret_cast<const float4*>(sp + tcol(4 * i)))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          dst[4 * i] = v.x, dst[4 * i + 1] = v.y, dst[4 * i + 2] = v.z, dst[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = col + tcol(e) < out_dim ? __ldg(sp + tcol(e)) : 0.f;
      }
    };
    load_scales(0, sn);
    for (int s = 0; s < steps; ++s) {
      const int rs = s % kRStages, wb = s % kW;
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = sn[e];
      if (s + 1 < steps) load_scales(s + 1, sn);  // in flight under this step's work
      if (s >= kW) mbar_wait(wempty + 8 * wb, (s / kW - 1) & 1);
      if (vec) mbar_wait(rfull + 8 * rs, (s / kRStages) & 1);
      const uint8_t* raw = smem + L::kRawOff + rs * L::kRawBytes;
      uint8_t* w_tile = smem + L::kWOff + wb * L::kWBytes;
#pragma unroll
      for (int i = 0; i < KC / 32; ++i) {
        const int r = dt / 8 + 32 * i;
        uint4 b;
        if (vec) {  // 8 bytes of raw chunk c / 2, 8 of chunk 4 + c / 2
          const uint2 lo = *reinterpret_cast<const uint2*>(raw + swz(r, c / 2) + 8 * (c % 2));
          const uint2 hi = *reinterpret_cast<const uint2*>(raw + swz(r, 4 + c / 2) + 8 * (c % 2));
          b = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else {  // the ragged edge, or a width the TMA cannot take: straight from memory
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          const uint8_t* src =
              qw + ((size_t)(s / per_group) * gsh + (s % per_group) * KC + r) * out_dim + col;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (col + tcol(e) < out_dim) w[e / 4] |= (uint32_t)__ldg(src + tcol(e)) << (8 * (e % 4));
          b = make_uint4(w[0], w[1], w[2], w[3]);
        }
        dequant16<KC>(b, sc, w_tile, r, c, 8 + c);
      }
      fence_async_proxy();
      warp_arrive(wfull + 8 * wb);
      if (vec && s + kRStages < steps) warp_arrive(rempty + 8 * rs);  // its raw rows are read
    }
    return;
  }

  // ---- the products: kMma warpgroups of 64 tokens x 128 columns ----
  const int ct = threadIdx.x;
  const int wg = ct / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int xs = s % kXStages, wb = s % kW;
    mbar_wait(xfull + 8 * xs, (s / kXStages) & 1);
    mbar_wait(wfull + 8 * wb, (s / kW) & 1);
    const uint32_t x_addr = smem_base + xs * L::kXBytes + wg * 64 * 2 * KC;
    const uint32_t w_addr = smem_base + L::kWOff + wb * L::kWBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kSlices; ++kk) {
      const uint32_t a = x_addr + (kk / (KC / 16)) * L::kPanelBytes + 32 * (kk % (KC / 16));
      const uint32_t b = w_addr + (kk / 4) * 16384 + (kk % 4) * 2048;
      wgmma_ss_n128_tb(acc, wgmma_desc(a, 16, L::kXSbo, L::kXLayout),
                       wgmma_desc(b, 8192, 1024, 1));
    }
    wgmma_commit();
    // the products of step s - 1 are done: its x panels and its W buffer are free
    wgmma_wait<1>();
    if (s >= 1) {
      if (s - 1 + kXStages < steps) warp_arrive(xempty + 8 * ((s - 1) % kXStages));
      if (s - 1 + kW < steps) warp_arrive(wempty + 8 * ((s - 1) % kW));
    }
  }
  wgmma_wait<0>();
  keep_in_registers(acc);

  // epilogue from registers: acc[4i + e] is (token r0, column 8i + 2 quad + e),
  // acc[4i + 2 + e] token r0 + 8
  const int lane = ct % 32;
  const int r0 = 16 * ((ct % 128) / 32) + lane / 4;
  const bool pairs = out_dim % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + wg * 64 + r0 + 8 * h;
    if (t >= T) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const size_t o = (size_t)t * out_dim + col;
      if (pairs && col + 1 < out_dim) {
        if (out_bf16)
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) = bf16x2(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
      } else {
        if (col < out_dim) store_out(out, o, v0, out_bf16);
        if (col + 1 < out_dim) store_out(out, o + 1, v1, out_bf16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode form (tensor cores: mma.sync on the exact nibbles)
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kDecBlockCols = 256;  // columns of a block: 256 contiguous bytes of a carrier row
constexpr int kDecCols = 32;        // columns of a warp
constexpr int kDecWarps = kDecBlockCols / kDecCols;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStepRows = 32;    // carrier rows of a step: four k16 chunks of the mma
constexpr int kDecStages = 6;       // steps in flight a block
constexpr int kDecMaxSplits = 16;   // a cluster's blocks (16: a non-portable size Hopper takes)
constexpr int kDecSumStride = kDecBlockCols + 2;  // floats a token of the block's sums

// The decode form's stage of up to 16 kMT tokens.  kTma: the step's carrier
// rows as two 128-byte panels (32 rows each, the TMA's 128-byte swizzle),
// its x as two panels (the 32 low rows' bf16 and the 32 high ones of each
// token, 64 bytes a token, the 64-byte swizzle), then the group's 256 scales;
// the reads of a warp land on distinct banks.  Else (cp.async): the carrier
// rows at 272 bytes (from the 16-byte boundary at or below the row's start,
// 17 pieces), x at 144 bytes a token (low, then high rows, then 16 bytes
// that put the rows of 8 tokens on distinct banks), then the scales.
template <bool kTma, int kMT>
struct DecTile {
  static constexpr int kTokens = 16 * kMT;
  static constexpr int kRowBytes = kTma ? 128 : kDecBlockCols + 16;  // a carrier row of a panel
  static constexpr int kPanelBytes = kDecStepRows * 128;             // kTma: a carrier panel
  static constexpr int kXToken = kTma ? 2 * kDecStepRows : 4 * kDecStepRows + 16;
  static constexpr int kXOff = kTma ? 2 * kPanelBytes : kDecStepRows * kRowBytes;
  static constexpr int kXHalf = kTma ? kTokens * kXToken : 2 * kDecStepRows;  // low -> high rows
  static constexpr int kScaleOff = kXOff + (kTma ? 2 : 1) * kTokens * kXToken;
  static constexpr int kStageBytes = kScaleOff + kDecBlockCols * 4;  // kTma: a multiple of 1024
  static constexpr int kRingBytes = kDecStages * kStageBytes;
  static constexpr int kBarOff = kRingBytes;  // kTma: the full mbarrier of each stage
  static constexpr int kSumBytes = kTokens * kDecSumStride * 4;  // aliases the ring
  static constexpr int kSmemBytes =
      (kBarOff + 8 * kDecStages > kSumBytes ? kBarOff + 8 * kDecStages : kSumBytes) + 1024;
  static constexpr int kMinBlocks = kMT <= 2 ? 2 : 1;  // blocks an SM holds
  // cp.async: x pieces of 16 bytes a step (8 a token), and a thread's share
  static constexpr int kXPieces = 2 * kDecStepRows / 8 * kTokens;
  static constexpr int kXPerThread = (kXPieces + kDecThreads - 1) / kDecThreads;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// the four 8x8 bf16 matrices whose rows lanes 8i .. 8i + 7 point at, as
// registers 0-3 (an m16k16 A fragment)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// every thread of every block of the cluster gets here (release / acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}
// a float at shared address ``addr`` of the cluster's block ``rank``
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Low nibbles of byte j of u (in the low half) and of v (in the high half),
// at bits 0-3 of each half of ``t``, as an exact bf16 pair: 0x43nn is 128 +
// nn, and the nibble n (two's complement) + 8 is its bits ^ 8, so the pair
// minus 136 is n exactly.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t t) {
  uint32_t biased;  // (t & mask) ^ exponent, in one lop3
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(biased) : "r"(t), "r"(0x000F000Fu), "r"(0x43084308u));
  uint32_t r;  // biased * 1 - 136, each half (exact)
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// One k16 chunk of a warp: 8 carrier rows of one group times the x columns
// they multiply, for each live m16 token tile, into 4 n8 tiles.  The k order
// of the mma's 16 is chosen so that one byte serves two k of a column and x
// is read as it lies: k = 2q, 2q + 1 are the low nibbles of rows 2q and 2q +
// 1, k = 2q + 8, 2q + 9 their high nibbles (q = lane % 4).  Lane (g, q) holds
// the bytes of columns 4g .. 4g + 3 of rows 2q (u) and 2q + 1 (v): byte j is
// column g of n8 tile j.  Each dequantized B fragment serves every token
// tile.
template <int kMT>
__device__ __forceinline__ void decode_chunk(float (&acc)[kMT][4][4], uint32_t u, uint32_t v,
                                             const uint32_t (&a)[kMT][4], int mt_live) {
  const uint32_t uh = u >> 4, vh = v >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
    const uint32_t b0 = nibble_pair(__byte_perm(u, v, sel));
    const uint32_t b1 = nibble_pair(__byte_perm(uh, vh, sel));
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      if (kMT == 1 || m < mt_live) mma_bf16(acc[m][j], a[m], b0, b1);
  }
}

// a 1-d copy of ``bytes`` (a multiple of 16) by the TMA, counted against ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// y[t, col] = sum over groups g of (x[t, group g] @ W4[group g, col]) *
// scale[g, col] for the block's up to 16 kMT tokens (blockIdx.z) and 256
// columns (blockIdx.x: 256 contiguous bytes of each carrier row); the groups
// are cut into ``splits`` runs of ``gps`` (blockIdx.y: the blocks of one
// cluster).  The block streams its run's steps (32 carrier rows, the step's
// x, at a group's last step its scales) through one ring of kDecStages
// stages.  kTma (out % 16 == 0 and gs % 64 == 0): one thread puts a step in
// flight as four boxes of the TMA (two carrier panels, x's low and high
// rows) and one bulk copy of the scales, counted on the stage's mbarrier;
// else every thread copies its 16-byte pieces by cp.async, each row from the
// 16-byte boundary at or below its start (the TMA's 256-byte rows or
// thread-issued copies of them do not keep the card's bandwidth), and x the
// same way where gs / 2 % 8 == 0, else element by element.  The 8
// warps lie side by side over the columns, 32 each: every warp walks every
// group of the run, runs each group's dot on the tensor cores in fp32,
// multiplies it by the group's scale and adds it to its total in group
// order.  So a carrier byte is read once a call up to 64 tokens, and a warp's
// registers hold every token's sums of its columns.  The cluster's blocks sum
// the blocks' totals in split order from their shared memory: nothing is
// atomic and nothing goes through device memory but the output.  A token's
// sums do not depend on kMT or on the other tokens.  Launched as a
// programmatic dependent: the first stages' carrier and scales are put in
// flight before the kernel waits for the one before it (x is its output),
// and the kernel lets the one after it launch at once.
template <bool kTma, int kMT>
__global__ void __launch_bounds__(kDecThreads, DecTile<kTma, kMT>::kMinBlocks)
int4_decode_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap x_map, const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ qw, const float* __restrict__ scale,
                   void* __restrict__ out, int T, int in_dim, int G, int gsh, int out_dim,
                   int out_bf16, int gps) {
  using L = DecTile<kTma, kMT>;
  extern __shared__ uint8_t dec_smem_raw[];
  uint8_t* dec_smem = dec_smem_raw + ((1024 - (smem_u32(dec_smem_raw) & 1023)) & 1023);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g8 = lane / 4, q = lane % 4;
  const int cb = blockIdx.x * kDecBlockCols;  // the block's first column
  const int cw = warp * kDecCols;             // the warp's first column in the block
  const int split = blockIdx.y, splits = gridDim.y;
  const int t0 = blockIdx.z * L::kTokens;
  const int tt = min(L::kTokens, T - t0);
  const int mt_live = (tt + 15) / 16;
  const int gs = 2 * gsh;
  const int spg = (gsh + kDecStepRows - 1) / kDecStepRows;  // steps a group
  const int g_begin = split * gps;
  const int steps = max(0, min(gps, G - g_begin)) * spg;
  const size_t step_bytes = (size_t)kDecStepRows * out_dim;
  const uint32_t ring = smem_u32(dec_smem);
  const uint32_t full = ring + L::kBarOff;
  const int ncols = min(kDecBlockCols, out_dim - cb);  // columns of the block in the weight
  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kDecStages; ++i) mbar_init(full + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // kTma: thread 0 puts step i in flight, its weights (the carrier panels,
  // the scales with a group's last step) and its x, on the stage's mbarrier
  auto tma_weights = [&](int i, int grp, int st) {
    const uint32_t stage = ring + (i % kDecStages) * L::kStageBytes, bar = full + 8 * (i % kDecStages);
    const int row = grp * gsh + st * kDecStepRows;
    const bool second = ncols > 128;  // the second panel holds columns of the weight
    mbar_expect(bar, (second ? 2 : 1) * L::kPanelBytes + 2 * L::kTokens * L::kXToken +
                         (st == spg - 1 ? 4 * ncols : 0));
    tma_load_2d(stage, &q_map, cb, row, bar);
    if (second) tma_load_2d(stage + L::kPanelBytes, &q_map, cb + 128, row, bar);
    if (st == spg - 1)
      bulk_load(stage + L::kScaleOff, scale + (size_t)grp * out_dim + cb, 4 * ncols, bar);
  };
  auto tma_activations = [&](int i, int grp, int st) {
    const uint32_t stage = ring + (i % kDecStages) * L::kStageBytes, bar = full + 8 * (i % kDecStages);
    const int k0 = grp * gs + st * kDecStepRows;
    tma_load_2d(stage + L::kXOff, &x_map, k0, t0, bar);
    tma_load_2d(stage + L::kXOff + L::kXHalf, &x_map, k0 + gsh, t0, bar);
  };

  // cp.async: this thread's x pieces of a step (where gs / 2 % 8 == 0: 8
  // rows of a token, half and row block fixed), destinations and sources
  uint32_t x_dst[L::kXPerThread];
  const __nv_bfloat16* x_src[L::kXPerThread];
  int x_row[L::kXPerThread];
  if constexpr (!kTma) {
#pragma unroll
    for (int k = 0; k < L::kXPerThread; ++k) {  // piece p: token p / 8, half (p / 4) % 2, rows 8 (p % 4) ..
      const int p = tid + k * kDecThreads, tok = p / 8;
      x_dst[k] = L::kXOff + tok * L::kXToken + 16 * (p % 8);
      x_row[k] = tok < tt ? 8 * (p % 4) : -1;  // -1: past the tokens, never copied
      x_src[k] = x + (size_t)(t0 + min(tok, tt - 1)) * in_dim + ((p / 4) % 2) * gsh + 8 * (p % 4);
    }
  }
  const size_t q_bytes = (size_t)G * gsh * out_dim;
  auto cp_weights = [&](int i, int grp, int st, size_t row0) {
    const uint32_t stage = ring + (i % kDecStages) * L::kStageBytes;
    const int r0 = st * kDecStepRows;
    for (int p = tid; p < kDecStepRows * 17; p += kDecThreads) {
      const int row = p / 17, ch = p % 17;
      const size_t at = row0 + (size_t)row * out_dim;
      const size_t from = (at & ~(size_t)15) + 16 * ch;
      const int bytes = r0 + row < gsh && from < q_bytes && (ch < 16 || (at & 15))
                            ? (int)min((size_t)16, q_bytes - from)
                            : 0;
      cp_async16(stage + row * L::kRowBytes + 16 * ch, bytes ? qw + from : qw, bytes);
    }
    if (st == spg - 1) {  // the group's scales, with its last step
      const bool ok = cb + tid < out_dim;
      cp_async4(stage + L::kScaleOff + 4 * tid,
                ok ? scale + (size_t)grp * out_dim + cb + tid : scale, ok ? 4 : 0);
    }
  };
  auto cp_activations = [&](int i, int grp, int st) {
    const uint32_t stage = ring + (i % kDecStages) * L::kStageBytes;
    const int r0 = st * kDecStepRows;
    const size_t off = (size_t)grp * gs + r0;
    if (gsh % 8 == 0) {
#pragma unroll
      for (int k = 0; k < L::kXPerThread; ++k) {
        if (x_row[k] < 0) continue;  // (a zero-byte copy still fills its 16 bytes)
        const bool ok = r0 + x_row[k] < gsh;
        cp_async16(stage + x_dst[k], ok ? x_src[k] + off : x, ok ? 16 : 0);
      }
    } else {  // element k: token k / 2R, half (k / R) % 2, row k % R, loaded and stored
      constexpr int R = kDecStepRows;  // (an odd gs / 2 puts the high rows off 4 bytes)
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
          dec_smem + (i % kDecStages) * L::kStageBytes + L::kXOff);
      for (int k = tid; k < 2 * R * tt; k += kDecThreads) {
        const int rr = k % R, h = (k / R) % 2, tok = k / (2 * R);
        xs[(tok * L::kXToken + L::kXHalf * h) / 2 + rr] =
            r0 + rr < gsh ? x[(size_t)(t0 + tok) * in_dim + off + h * gsh + rr]
                          : __float2bfloat16(0.f);
      }
    }
  };

  // the first stages: their weights need nothing of the kernel before this
  // one, then (after it) their x
  int igrp = g_begin, ist = 0;
  size_t irow = (size_t)g_begin * gsh * out_dim + cb;
  auto advance = [&]() {
    irow += step_bytes;
    if (++ist == spg) {
      ist = 0;
      irow = (size_t)++igrp * gsh * out_dim + cb;
    }
  };
  const int head = min(steps, kDecStages - 1);
  {
    int grp = igrp, st = ist;
    size_t row0 = irow;
    for (int i = 0; i < head; ++i) {
      if constexpr (kTma) {
        if (tid == 0) tma_weights(i, grp, st);
      } else {
        cp_weights(i, grp, st, row0);
      }
      row0 += step_bytes;
      if (++st == spg) {
        st = 0;
        row0 = (size_t)++grp * gsh * out_dim + cb;
      }
    }
  }
  if constexpr (!kTma) cp_async_commit();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x is the kernel before's output
#pragma unroll 1
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < head) {
      if constexpr (kTma) {
        if (tid == 0) tma_activations(i, igrp, ist);
      } else {
        cp_activations(i, igrp, ist);
      }
      advance();
    }
    if constexpr (!kTma) cp_async_commit();  // an empty group past the last step keeps the count
  }

  float total[kMT][4][4], acc[kMT][4][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[m][j][e] = acc[m][j][e] = 0.f;
  // ldmatrix: lane l points at token 16 m + tl, tl = l % 8 + 8 ((l / 8) % 2),
  // its low (l < 16) or high x rows of the chunk
  const int tl = lane % 8 + 8 * ((lane / 8) % 2);
  const uint32_t x_lane = (uint32_t)(tl * L::kXToken + L::kXHalf * (lane / 16));
  const int x_swz = (tl >> 1) & 3;  // kTma: the 64-byte swizzle of the lane's token rows
  const int col_off = cw + 4 * g8;  // lane (g8, q): columns col_off .. + 3
  // kTma: the lane's bytes of row r lie in panel col_off / 128 at chunk
  // (col_off % 128 / 16) ^ (r % 8)
  const uint32_t q_lane = (uint32_t)((col_off / 128) * L::kPanelBytes + (col_off % 16));
  const int q_chunk = (col_off % 128) / 16;
  size_t crow = (size_t)g_begin * gsh * out_dim + cb;  // the step's first row (unaligned reads)
  int cst = 0;
  for (int i = 0; i < steps; ++i) {
    if constexpr (kTma) {
      __syncthreads();  // every warp is done with step i - 1's stage
      if (tid == 0 && i + kDecStages - 1 < steps) {
        tma_weights(i + kDecStages - 1, igrp, ist);
        tma_activations(i + kDecStages - 1, igrp, ist);
      }
      if (i + kDecStages - 1 < steps) advance();
      mbar_wait(full + 8 * (i % kDecStages), (i / kDecStages) & 1);
    } else {
      cp_async_wait<kDecStages - 2>();
      __syncthreads();  // step i landed; every warp is done with step i - 1's stage
      if (i + kDecStages - 1 < steps) {
        cp_weights(i + kDecStages - 1, igrp, ist, irow);
        cp_activations(i + kDecStages - 1, igrp, ist);
        advance();
      }
      cp_async_commit();
    }
    const uint8_t* stage = dec_smem + (i % kDecStages) * L::kStageBytes;
    const uint32_t xs = ring + (i % kDecStages) * L::kStageBytes + L::kXOff + x_lane;
#pragma unroll
    for (int c = 0; c < kDecStepRows / 8; ++c) {  // the step's k16 chunks
      uint32_t uv[2];  // rows 8c + 2q (u), 8c + 2q + 1 (v)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * c + 2 * q + h;
        if constexpr (kTma) {
          uv[h] = *reinterpret_cast<const uint32_t*>(stage + q_lane + row * 128 +
                                                     ((q_chunk ^ (row % 8)) << 4));
        } else {  // from its copy's start
          const int o = (int)((crow + (size_t)row * out_dim) & 15) + col_off;
          const uint32_t* w =
              reinterpret_cast<const uint32_t*>(stage + row * L::kRowBytes + (o & ~3));
          uv[h] = __funnelshift_r(w[0], w[1], 8 * (o & 3));
        }
      }
      uint32_t a[kMT][4];  // A: tokens of tile m, x rows 8c + 2q, + 1: low, then high
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (kMT == 1 || m < mt_live)
          ldmatrix_x4(a[m], xs + 16 * m * L::kXToken + 16 * (kTma ? c ^ x_swz : c));
      decode_chunk<kMT>(acc, uv[0], uv[1], a, mt_live);
    }
    if (++cst == spg) {  // the group's dot times its scale, into the total
      cst = 0;
      // columns 8q + j (e even) and 8q + 4 + j (e odd) of the warp
      const float4* sp = reinterpret_cast<const float4*>(stage + L::kScaleOff) + (cw + 8 * q) / 4;
      const float4 s0 = sp[0], s1 = sp[1];
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (kMT == 1 || m < mt_live) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[m][j][e] = fmaf(acc[m][j][e], sc[4 * (e % 2) + j], total[m][j][e]);
              acc[m][j][e] = 0.f;
            }
          }
        }
      if constexpr (!kTma) crow = (size_t)(g_begin + (i + 1) / spg) * gsh * out_dim + cb;
    } else if constexpr (!kTma) {
      crow += step_bytes;
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the block's sums now

  // total[m][j][e] of lane (g8, q): token 16m + g8 (e < 2) or + 8, column 8q
  // + 4 (e % 2) + j of the warp
  float* block_sum = reinterpret_cast<float*>(dec_smem);  // (token, column)
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * m + g8 + 8 * (e / 2);
        if (t < tt) block_sum[t * kDecSumStride + cw + 8 * q + 4 * (e % 2) + j] = total[m][j][e];
      }
  __syncthreads();
  const int n = tt * kDecBlockCols;
  if (splits == 1) {
    for (int i = tid; i < n; i += kDecThreads) {
      const int t = i / kDecBlockCols, col = cb + i % kDecBlockCols;
      if (col < out_dim)
        store_out(out, (size_t)(t0 + t) * out_dim + col,
                  block_sum[t * kDecSumStride + i % kDecBlockCols], out_bf16);
    }
    return;
  }
  // the cluster's blocks are the splits of this tile, rank = split: each sums
  // its share of the tile's outputs over the blocks' sums, in split order,
  // then every block may leave.  A thread puts all its remote loads in flight
  // before it adds (it issues in order: a sum load by load would wait out
  // each one).
  cluster_sync();
  const int share = (n + splits - 1) / splits;
  for (int i = split * share + tid; i < min(n, (split + 1) * share); i += kDecThreads) {
    const int t = i / kDecBlockCols, col = cb + i % kDecBlockCols;
    const uint32_t addr = smem_u32(block_sum + t * kDecSumStride + i % kDecBlockCols);
    float part[kDecMaxSplits];
#pragma unroll
    for (int s = 0; s < kDecMaxSplits; ++s) part[s] = s < splits ? ld_cluster(addr, s) : 0.f;
    float sum = part[0];
#pragma unroll
    for (int s = 1; s < kDecMaxSplits; ++s)
      if (s < splits) sum += part[s];
    if (col < out_dim) store_out(out, (size_t)(t0 + t) * out_dim + col, sum, out_bf16);
  }
  cluster_sync();  // every block is done reading the others' shared memory
}

template <bool kTma, int kMT>
cudaError_t configure_decode() {
  cudaError_t err = cudaFuncSetAttribute(int4_decode_kernel<kTma, kMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DecTile<kTma, kMT>::kSmemBytes);
  if (err == cudaSuccess)  // all of an SM's shared memory: blocks side by side
    err = cudaFuncSetAttribute(int4_decode_kernel<kTma, kMT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int4_decode_kernel<kTma, kMT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The decode form's launch: a column tile's splits as one cluster, as a
// programmatic dependent of the kernel before it on the stream.  kTma: the
// tensor maps of the carrier (boxes of 128 bytes x 32 rows, 128-byte
// swizzle) and of x (32 rows' bf16 x the block's tokens, 64-byte swizzle;
// tokens past T zero-filled).
template <bool kTma, int kMT>
cudaError_t launch_decode(const void* x, const void* qw, const void* scale, void* out, int T,
                          int in_dim, int G, int gsh, int out_dim, int out_bf16, int splits,
                          int gps, cudaStream_t stream) {
  using L = DecTile<kTma, kMT>;
  CUtensorMap q_map = {}, x_map = {};
  if constexpr (kTma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint32_t ones[2] = {1, 1};
    const cuuint64_t q_dims[2] = {(cuuint64_t)out_dim, (cuuint64_t)G * gsh};
    const cuuint64_t q_strides[1] = {(cuuint64_t)out_dim};
    const cuuint32_t q_box[2] = {128, (cuuint32_t)kDecStepRows};
    const cuuint64_t x_dims[2] = {(cuuint64_t)in_dim, (cuuint64_t)T};
    const cuuint64_t x_strides[1] = {(cuuint64_t)in_dim * 2};
    const cuuint32_t x_box[2] = {(cuuint32_t)kDecStepRows, (cuuint32_t)L::kTokens};
    if (encode(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw), q_dims, q_strides,
               q_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims,
               x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_dim + kDecBlockCols - 1) / kDecBlockCols, splits,
                     (T + L::kTokens - 1) / L::kTokens);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, int4_decode_kernel<kTma, kMT>, q_map, x_map,
                            static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
                            static_cast<const float*>(scale), out, T, in_dim, G, gsh, out_dim,
                            out_bf16, gps);
}

// the block's token tile from T: 16, 32, then 64 tokens (over several blocks
// past 64)
template <bool kTma>
cudaError_t decode_for_tokens(const void* x, const void* qw, const void* scale, void* out, int T,
                              int in_dim, int G, int gsh, int out_dim, int out_bf16, int splits,
                              int gps, cudaStream_t st) {
#define VCLA_DEC_ARGS x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16, splits, gps, st
  if (T <= 16) return launch_decode<kTma, 1>(VCLA_DEC_ARGS);
  if (T <= 32) return launch_decode<kTma, 2>(VCLA_DEC_ARGS);
  return launch_decode<kTma, 4>(VCLA_DEC_ARGS);
#undef VCLA_DEC_ARGS
}

template <int KC, int kMma, int kXStages, int kRStages>
cudaError_t launch_prefill(const void* x, const void* qw, const void* scale, void* out, int T,
                           int in_dim, int G, int gsh, int out_dim, int out_bf16,
                           cudaStream_t stream) {
  using L = PreTile<KC, kMma, kXStages, kRStages>;
  static_assert(L::kBytes <= 232448, "more shared memory than a block may have");
  static bool configured = false;  // once per instance: keeps the call out of graph capture
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(int4_prefill_kernel<KC, kMma, kXStages, kRStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // the TMA takes the carrier (and the dequantizers the scales 16 at a time)
  // where their rows are 16-byte aligned
  const int vec = out_dim % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(qw) | reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  CUtensorMap x_map, q_map = {};
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)in_dim, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)in_dim * 2};
  const cuuint32_t x_box[2] = {(cuuint32_t)KC, (cuuint32_t)L::kN};
  if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims, x_strides,
             x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (vec) {
    const cuuint64_t q_dims[2] = {(cuuint64_t)out_dim, (cuuint64_t)G * gsh};
    const cuuint64_t q_strides[1] = {(cuuint64_t)out_dim};
    const cuuint32_t q_box[2] = {(cuuint32_t)L::kBN, (cuuint32_t)KC};
    if (encode(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw), q_dims, q_strides,
               q_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const dim3 grid((out_dim + L::kBN - 1) / L::kBN, (T + L::kN - 1) / L::kN);
  int4_prefill_kernel<KC, kMma, kXStages, kRStages><<<grid, L::kThreads, L::kBytes, stream>>>(
      x_map, q_map, static_cast<const uint8_t*>(qw), static_cast<const float*>(scale), out, T,
      G, gsh, out_dim, out_bf16, vec);
  return cudaGetLastError();
}

// the block tiling: 1 = 64 tokens, 2 = 128 tokens (128 columns either way);
// KC 64 carrier rows a step where gs/2 allows it, else 32
template <int KC>
cudaError_t prefill_for_tile(int tile, const void* x, const void* qw, const void* scale,
                             void* out, int T, int in_dim, int G, int gsh, int out_dim,
                             int out_bf16, cudaStream_t st) {
#define VCLA_PRE_ARGS x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16, st
  switch (tile) {
    case 1: return launch_prefill<KC, 1, 4, 4>(VCLA_PRE_ARGS);
    case 2: return launch_prefill<KC, 2, 3, 4>(VCLA_PRE_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef VCLA_PRE_ARGS
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// ``stream`` is a cudaStream_t.  Returns a cudaError_t (0 = launched).
extern "C" {

// The decode form: one launch.  The caller picks ``splits`` (<= 16) runs of
// ``gps`` groups; each column tile's splits run as one cluster.
int vcla_int4_matmul_decode(const void* x, const void* qw, const void* scale, void* out, int T,
                            int in_dim, int G, int gsh, int out_dim, int out_bf16, int splits,
                            int gps, void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (gsh <= 0 || G * 2 * gsh != in_dim || splits < 1 || splits > kDecMaxSplits ||
      gps < 1 || (splits - 1) * gps >= G || splits * gps < G ||
      (reinterpret_cast<uintptr_t>(qw) & 15) || (xa & (gsh % 8 == 0 ? 15 : 1)) ||
      (reinterpret_cast<uintptr_t>(scale) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  // every instance at once, at the first call: keeps the calls out of graph capture
  static const cudaError_t configured = [] {
    cudaError_t err = configure_decode<true, 1>();
    if (err == cudaSuccess) err = configure_decode<true, 2>();
    if (err == cudaSuccess) err = configure_decode<true, 4>();
    if (err == cudaSuccess) err = configure_decode<false, 1>();
    if (err == cudaSuccess) err = configure_decode<false, 2>();
    if (err == cudaSuccess) err = configure_decode<false, 4>();
    return err;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the TMA takes the carrier and x where rows are 16-byte aligned and every
  // step is 32 whole rows of one group
  if (out_dim % 16 == 0 && gsh % kDecStepRows == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0)
    return decode_for_tokens<true>(x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16,
                                   splits, gps, st);
  return decode_for_tokens<false>(x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16,
                                  splits, gps, st);
}

int vcla_int4_matmul_prefill(const void* x, const void* qw, const void* scale, void* out, int T,
                             int in_dim, int G, int gsh, int out_dim, int out_bf16, int tile,
                             void* stream) {
  if (gsh % 32 != 0 || G * 2 * gsh != in_dim) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gsh % 64 == 0)
    return prefill_for_tile<64>(tile, x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
  return prefill_for_tile<32>(tile, x, qw, scale, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
}

const char* vcla_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
