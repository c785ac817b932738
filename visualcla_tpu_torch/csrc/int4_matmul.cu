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
//   int4_decode_kernel (few tokens) is bound by the carrier's bytes: at T = 1
//   it does 4 multiply-adds per byte read.  A block owns 32 * VEC output
//   columns (VEC = 4, 2 or 1 neighbouring bytes per lane, as out allows) and
//   four groups, one per warp, so a warp reads 128 neighbouring bytes of a
//   carrier row at once and the groups are split over the blocks as well as
//   the columns: a 4096 x 4096 weight runs as 256 blocks.  Each warp issues
//   the loads of 16 carrier rows before it uses them, accumulates its group
//   in fp32 from the exact nibble values and multiplies by the group's scale
//   once, as the TPU's per-group form does.  The block sums its warps in
//   shared memory and writes one partial per group split; int4_reduce_kernel
//   sums the splits in a fixed order (no atomics: the result does not depend
//   on scheduling).  The x columns of the block's groups (up to 8 tokens)
//   are staged in shared memory.
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

__device__ __forceinline__ int lo_nibble(uint32_t b) { return (int)(b << 28) >> 28; }
__device__ __forceinline__ int hi_nibble(uint32_t b) { return (int)(b << 24) >> 28; }

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// decode form
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;  // groups per block: one per warp
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecRows = 16;  // carrier rows loaded ahead per warp

// VEC neighbouring carrier bytes (columns) of one row, as one load
template <int VEC>
__device__ __forceinline__ uint32_t load_cols(const uint8_t* p) {
  if constexpr (VEC == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  else if constexpr (VEC == 2) return __ldg(reinterpret_cast<const unsigned short*>(p));
  else return __ldg(p);
}

// partial[split, t, col] = sum over the block's groups g of
// (x[t, group g] @ W4[group g, col]) * scale[g, col]; split = blockIdx.y
template <int TT, int VEC>
__global__ void __launch_bounds__(kDecThreads)
int4_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                   const float* __restrict__ scale, float* __restrict__ partial, int T,
                   int in_dim, int G, int gsh, int out_dim) {
  constexpr int kCols = 32 * VEC;  // columns per block
  __shared__ float red[kDecWarps * TT * kCols];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  // TT x (kDecWarps * gs): the columns of x this block's groups read
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn_smem);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * kCols + lane * VEC;
  const int g0 = blockIdx.y * kDecWarps;
  const int t0 = blockIdx.z * TT;
  const int gs = 2 * gsh;
  const int span = kDecWarps * gs;
  const int n_x = min(kDecWarps, G - g0) * gs;

  for (int i = threadIdx.x; i < TT * span; i += kDecThreads) {
    const int t = i / span, k = i % span;
    xs[i] = (t0 + t < T && k < n_x) ? x[(size_t)(t0 + t) * in_dim + (size_t)g0 * gs + k]
                                    : __float2bfloat16(0.f);
  }
  __syncthreads();

  float acc[TT][VEC];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[t][c] = 0.f;

  const int g = g0 + warp;
  if (g < G && col < out_dim) {  // VEC divides out_dim: a lane's columns are all in or out
    const uint8_t* base = qw + (size_t)g * gsh * out_dim + col;
    const __nv_bfloat16* xg = xs + warp * gs;
    int r = 0;
    for (; r + kDecRows <= gsh; r += kDecRows) {
      uint32_t b[kDecRows];
#pragma unroll
      for (int k = 0; k < kDecRows; ++k) b[k] = load_cols<VEC>(base + (size_t)(r + k) * out_dim);
#pragma unroll
      for (int k = 0; k < kDecRows; ++k) {
        float xl[TT], xh[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          xl[t] = __bfloat162float(xg[t * span + r + k]);
          xh[t] = __bfloat162float(xg[t * span + gsh + r + k]);
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const uint32_t byte = b[k] >> (8 * c);
          const float lo = (float)lo_nibble(byte), hi = (float)hi_nibble(byte);
#pragma unroll
          for (int t = 0; t < TT; ++t) acc[t][c] = fmaf(xh[t], hi, fmaf(xl[t], lo, acc[t][c]));
        }
      }
    }
    for (; r < gsh; ++r) {  // groups of fewer than kDecRows rows per half
      const uint32_t b = load_cols<VEC>(base + (size_t)r * out_dim);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const uint32_t byte = b >> (8 * c);
        const float lo = (float)lo_nibble(byte), hi = (float)hi_nibble(byte);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          acc[t][c] = fmaf(__bfloat162float(xg[t * span + gsh + r]), hi,
                           fmaf(__bfloat162float(xg[t * span + r]), lo, acc[t][c]));
      }
    }
    // the group's partial times its scale, as the TPU's per-group form
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float s = __ldg(scale + (size_t)g * out_dim + col + c);
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t][c] *= s;
    }
  }
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < VEC; ++c) red[(warp * TT + t) * kCols + lane * VEC + c] = acc[t][c];
  __syncthreads();
  // the warps' partials summed in warp order: the same bits on every run
  for (int i = threadIdx.x; i < TT * kCols; i += kDecThreads) {
    const int t = i / kCols, c = blockIdx.x * kCols + i % kCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) sum += red[(w * TT + t) * kCols + i % kCols];
    if (c < out_dim && t0 + t < T)
      partial[((size_t)blockIdx.y * T + t0 + t) * out_dim + c] = sum;
  }
}

// out[i] = sum over the splits of partial[split, i], in split order
__global__ void int4_reduce_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                   int splits, size_t n, int out_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int k = 0; k < splits; ++k) sum += partial[(size_t)k * n + i];
  store_out(out, i, sum, out_bf16);
}

template <int TT, int VEC>
cudaError_t launch_decode(const void* x, const void* qw, const void* scale, float* partial,
                          void* out, int T, int in_dim, int G, int gsh, int out_dim,
                          int out_bf16, cudaStream_t stream) {
  const int splits = (G + kDecWarps - 1) / kDecWarps;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)TT * kDecWarps * 2 * gsh;
  const dim3 grid((out_dim + 32 * VEC - 1) / (32 * VEC), splits, (T + TT - 1) / TT);
  int4_decode_kernel<TT, VEC><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(scale), partial, T, in_dim, G, gsh, out_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)T * out_dim;
  int4_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, splits, n,
                                                                      out_bf16);
  return cudaGetLastError();
}

template <int TT>
cudaError_t launch_decode_vec(const void* x, const void* qw, const void* scale, float* partial,
                              void* out, int T, int in_dim, int G, int gsh, int out_dim,
                              int out_bf16, cudaStream_t stream) {
  if (out_dim % 4 == 0)
    return launch_decode<TT, 4>(x, qw, scale, partial, out, T, in_dim, G, gsh, out_dim, out_bf16, stream);
  if (out_dim % 2 == 0)
    return launch_decode<TT, 2>(x, qw, scale, partial, out, T, in_dim, G, gsh, out_dim, out_bf16, stream);
  return launch_decode<TT, 1>(x, qw, scale, partial, out, T, in_dim, G, gsh, out_dim, out_bf16, stream);
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

int vcla_int4_matmul_decode(const void* x, const void* qw, const void* scale, void* partial,
                            void* out, int T, int in_dim, int G, int gsh, int out_dim,
                            int out_bf16, int tokens_per_block, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  if (gsh <= 0 || G * 2 * gsh != in_dim) return static_cast<int>(cudaErrorInvalidValue);
  switch (tokens_per_block) {
    case 1: return launch_decode_vec<1>(x, qw, scale, ws, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
    case 2: return launch_decode_vec<2>(x, qw, scale, ws, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
    case 4: return launch_decode_vec<4>(x, qw, scale, ws, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
    case 8: return launch_decode_vec<8>(x, qw, scale, ws, out, T, in_dim, G, gsh, out_dim, out_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
