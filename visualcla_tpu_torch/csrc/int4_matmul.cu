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
// Two forms, chosen by the wrapper from T:
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
//   int4_prefill_kernel (the prompt) is bound by flops: it does 2T
//   multiply-adds per carrier nibble.  A block computes a 128-token x
//   128-column tile on the tensor cores (wmma, bf16 in, fp32 accumulate; 8
//   warps of 64 x 32).  Each k-step takes 32 carrier rows of one group (64
//   rows of W: 32 low and 32 high nibbles), dequantizes them into shared
//   memory as bf16 (nibble * scale in fp32, rounded once: the TPU's scratch
//   form) beside the 64 matching x columns, and runs four 16-deep mma steps.
//   Two shared-memory stages: the next k-step's global loads are issued into
//   registers before the current step computes, and stored into the other
//   stage after it, so a block waits at one barrier per k-step.  Needs
//   gs % 64 == 0 (every LLaMA size: gs 128); other group sizes run the
//   decode form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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
// prefill form (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // tokens per block
constexpr int kBN = 128;        // columns per block
constexpr int kKB = 32;         // carrier rows per k-step (a slice of one group's half)
constexpr int kBK = 2 * kKB;    // rows of W per k-step: kKB low + kKB high nibbles
constexpr int kLdx = kBK + 8;   // padded leading dims (bf16 elements)
constexpr int kLdw = kBN + 8;
constexpr int kLdc = kBN + 4;   // f32 epilogue tile
constexpr int kPreThreads = 256;  // 8 warps: 2 (tokens) x 4 (columns), 64 x 32 each
constexpr int kXTile = kBM * kLdx;  // bf16 elements
constexpr int kWTile = kBK * kLdw;
constexpr int kStageBytes = 2 * (kXTile + kWTile);
constexpr int kPreSmemBytes = 2 * kStageBytes > kBM * kLdc * 4 ? 2 * kStageBytes : kBM * kLdc * 4;

// This thread's share of one k-step, in registers: four 16-byte pieces of x
// and 16 carrier bytes (16 columns of one row) with their scales.
struct PrefillRegs {
  uint4 xv[4];
  uint4 wv;
  float s[16];
};

__device__ __forceinline__ void prefill_load(PrefillRegs& R, const __nv_bfloat16* x,
                                             const uint8_t* qw, const float* scale, int step,
                                             int T, int in_dim, int gsh, int out_dim, int t0,
                                             int n0) {
  const int per_group = gsh / kKB;
  const int g = step / per_group;
  const int rr0 = (step % per_group) * kKB;
  const int tid = threadIdx.x;
  // x: row m, 8 columns (half: low / high rows of the group; sub: which 8)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + kPreThreads * i;
    const int m = idx / 8, half = (idx % 8) / 4, sub = idx % 4;
    if (t0 + m < T) {
      const size_t off = (size_t)(t0 + m) * in_dim + (size_t)g * 2 * gsh + half * gsh + rr0 + sub * 8;
      R.xv[i] = __ldg(reinterpret_cast<const uint4*>(x + off));
    } else {
      R.xv[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // carrier: row rr0 + tid / 8, 16 columns from (tid % 8) * 16
  const int row = tid / 8, c0 = n0 + (tid % 8) * 16;
  const uint8_t* src = qw + ((size_t)g * gsh + rr0 + row) * out_dim + c0;
  const float* sc = scale + (size_t)g * out_dim + c0;
  if (c0 + 16 <= out_dim && out_dim % 16 == 0) {
    R.wv = __ldg(reinterpret_cast<const uint4*>(src));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(sc) + i);
      R.s[4 * i] = v.x, R.s[4 * i + 1] = v.y, R.s[4 * i + 2] = v.z, R.s[4 * i + 3] = v.w;
    }
  } else {  // the ragged edge, or a width the vector loads cannot take
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool in = c0 + i < out_dim;
      w[i / 4] |= (in ? (uint32_t)__ldg(src + i) : 0u) << (8 * (i % 4));
      R.s[i] = in ? __ldg(sc + i) : 0.f;
    }
    R.wv = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // each rounded to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void prefill_store(const PrefillRegs& R, __nv_bfloat16* xs,
                                              __nv_bfloat16* ws) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + kPreThreads * i;
    const int m = idx / 8, half = (idx % 8) / 4, sub = idx % 4;
    *reinterpret_cast<uint4*>(xs + m * kLdx + half * kKB + sub * 8) = R.xv[i];
  }
  // dequantize: nibble * scale in fp32, rounded once to bf16
  const int row = tid / 8, c0 = (tid % 8) * 16;
  const uint32_t w[4] = {R.wv.x, R.wv.y, R.wv.z, R.wv.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // 8 columns at a time: one 16-byte store per half
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = 8 * h + 2 * p;
      const uint32_t b0 = w[c / 4] >> (8 * (c % 4)), b1 = w[(c + 1) / 4] >> (8 * ((c + 1) % 4));
      lo[p] = bf16x2((float)lo_nibble(b0) * R.s[c], (float)lo_nibble(b1) * R.s[c + 1]);
      hi[p] = bf16x2((float)hi_nibble(b0) * R.s[c], (float)hi_nibble(b1) * R.s[c + 1]);
    }
    *reinterpret_cast<uint4*>(ws + row * kLdw + c0 + 8 * h) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(ws + (kKB + row) * kLdw + c0 + 8 * h) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

__global__ void __launch_bounds__(kPreThreads)
int4_prefill_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
                    const float* __restrict__ scale, void* __restrict__ out, int T, int in_dim,
                    int G, int gsh, int out_dim, int out_bf16) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char pre_smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(pre_smem);  // 2 x (x tile, W tile)
  float* cs = reinterpret_cast<float*>(pre_smem);  // the output tile, after the last step
  const int n0 = blockIdx.x * kBN;
  const int t0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int steps = G * (gsh / kKB);
  PrefillRegs R;
  prefill_load(R, x, qw, scale, 0, T, in_dim, gsh, out_dim, t0, n0);
  prefill_store(R, stage, stage + kXTile);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const bool more = step + 1 < steps;
    // the next step's global loads are in flight while this one computes
    if (more) prefill_load(R, x, qw, scale, step + 1, T, in_dim, gsh, out_dim, t0, n0);
    const __nv_bfloat16* xs = stage + (step % 2) * (kXTile + kWTile);
    const __nv_bfloat16* ws = xs + kXTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 64 + i * 16) * kLdx + kk, kLdx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * kLdw + wn * 32 + j * 16, kLdw);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (more) {
      __nv_bfloat16* nx = stage + ((step + 1) % 2) * (kXTile + kWTile);
      prefill_store(R, nx, nx + kXTile);  // the buffer every warp finished a step ago
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 64 + i * 16) * kLdc + wn * 32 + j * 16, acc[i][j],
                              kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kPreThreads) {
    const int m = i / kBN, n = i % kBN;
    if (t0 + m < T && n0 + n < out_dim)
      store_out(out, (size_t)(t0 + m) * out_dim + n0 + n, cs[m * kLdc + n], out_bf16);
  }
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
                             int in_dim, int G, int gsh, int out_dim, int out_bf16,
                             void* stream) {
  if (gsh % kKB != 0 || in_dim % 8 != 0 || G * 2 * gsh != in_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // once per process: keeps the call out of graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((out_dim + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  int4_prefill_kernel<<<grid, kPreThreads, kPreSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(scale), out, T, in_dim, G, gsh, out_dim, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

const char* vcla_int4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
