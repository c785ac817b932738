// Kernel B7: the grouped int4 products of a mixture of experts, y = x_e @ W4_e
// for every expert e over the tokens routed to it, in one launch.
//
// Replaces no TPU kernel: the JAX package has no experts.  It is added for
// the Jamba text tower (models/jamba.py), whose MoE layers hold 16 experts
// of 4096 -> 14336 -> 4096 at the int4 tier.
//
// Contract: xp (A, K) bf16, the routed tokens' inputs in expert order, each
// row's groups of 128 interleaved as 64 bf16 pairs (x[r], x[64 + r]) (the
// wrapper lays them out); the experts' v2 carriers q (E, G, 64, N) uint8
// (byte [e, g, r, o] holds W4_e[g*128 + r, o] in the low nibble and
// W4_e[g*128 + 64 + r, o] in the high one) and scales (E, G, N) f32;
// offsets (E + 1) int32 on the device: expert e's rows are
// [offsets[e], offsets[e + 1]).  y (A, N) = sum_g (x[:, group g] @
// W4_e[group g]) * scale_e[g], bf16 (round to nearest even) or f32; rows
// past offsets[E] (tokens routed to no expert) are not written.
//
// What bounds it: at decode (a pool of 32 rows, 64 assignments) each expert
// sees a few tokens and the kernel reads the carriers of the experts hit,
// ~29 MB an expert and projection: bytes.  At an admission (256-512 tokens,
// 512-1024 assignments, ~32-64 an expert) it does that many multiply-adds a
// weight and the products take over.  The design: a block is one expert,
// one tile of its tokens (16 rows at decode, 64 at admissions) and 128
// columns; blocks whose tile lies past the expert's count exit at once, so
// no expert computes a token that was not routed to it and the grid needs
// no host read of the counts (the launch replays inside CUDA graphs).  Each
// group of 128 rows is a stage of a 4-deep cp.async ring (the tokens' 128
// inputs, 64 carrier rows of 128 bytes, 128 scales); the products run as
// mma.sync.m16n8k16 on exact nibbles: the mma's k order pairs the low and
// the high nibble of one byte (hence the interleaved inputs), a pair becomes
// an exact bf16x2 in a few integer instructions (0x43nn is 128 + nn for the
// nibble's bits ^ 8, and a subtraction of 136 leaves the signed nibble), and
// the columns of a warp's four n-tiles interleave so that one 32-bit shared
// load gives a thread its byte of all four.  Each group's dot is summed in
// fp32, multiplied by its scale once and added to the total in group order,
// B3's order: a token's row does not depend on the other tokens.  Kernel
// names avoid B3's (``int4_decode_kernel`` / ``int4_prefill_kernel``).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;         // columns a block
constexpr int kGsh = 64;           // carrier rows a group (group size 128)
constexpr int kStages = 4;         // cp.async ring depth, in groups
constexpr int kXWords = 64 + 4;    // a token's group in shared: 64 bf16x2 words, padded
constexpr int kQRow = kCols + 32;  // a carrier row in shared, padded (bytes)

template <int WM, int MT>  // warps along the tokens; m16 tiles a warp
struct Tile {
  static constexpr int M = 16 * MT * WM;  // tokens a block
  static constexpr int kThreads = WM * 4 * 32;
  static constexpr int kXBytes = M * kXWords * 4;
  static constexpr int kQBytes = kGsh * kQRow;
  static constexpr int kStage = kXBytes + kQBytes + kCols * 4;
  static constexpr int kSmem = kStages * kStage;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; ``bytes`` 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// byte ``v`` of a carrier -> bf16x2 {low nibble, high nibble}, signed, exact
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  const uint32_t biased = (((v & 0xFu) | ((v & 0xF0u) << 12)) ^ 0x00080008u) | 0x43004300u;
  const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 r = __hsub2(w, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int WM, int MT>
__global__ void __launch_bounds__(Tile<WM, MT>::kThreads)
    moe_int4_grouped_kernel(const __nv_bfloat16* __restrict__ xp, const uint8_t* __restrict__ q,
                            const float* __restrict__ scale, const int* __restrict__ offsets,
                            void* __restrict__ out, int K, int N, int G, int out_bf16) {
  using T = Tile<WM, MT>;
  const int e = blockIdx.z;
  const int row0 = offsets[e] + blockIdx.y * T::M;
  const int row_end = offsets[e + 1];
  if (row0 >= row_end) return;  // a tile past this expert's tokens
  const int col0 = blockIdx.x * kCols;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // the warp's token slab and 32-column slab
  const int gq = lane / 4, qq = lane % 4;
  const uint8_t* qe = q + (size_t)e * G * kGsh * N;
  const float* se = scale + (size_t)e * G * N;

  auto load_stage = [&](int g, int slot) {
    uint8_t* st = smem + slot * T::kStage;
    uint8_t* qs = st + T::kXBytes;
    float* ss = reinterpret_cast<float*>(qs + T::kQBytes);
    for (int c = tid; c < T::M * 16; c += T::kThreads) {  // tokens: 16 chunks a row
      const int r = c / 16, k = c % 16;
      const bool ok = row0 + r < row_end;
      const __nv_bfloat16* src = xp + (size_t)(ok ? row0 + r : 0) * K + g * 128 + k * 8;
      cp_async16(smem_u32(st + (r * kXWords + k * 4) * 4), src, ok ? 16 : 0);
    }
    for (int c = tid; c < kGsh * 8; c += T::kThreads) {  // carrier: 8 chunks a row
      const int r = c / 8, k = c % 8;
      cp_async16(smem_u32(qs + r * kQRow + k * 16), qe + ((size_t)g * kGsh + r) * N + col0 + k * 16,
                 16);
    }
    for (int c = tid; c < kCols / 4; c += T::kThreads)
      cp_async16(smem_u32(ss + c * 4), se + (size_t)g * N + col0 + c * 4, 16);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < G) load_stage(s, s);
    cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // group g landed; every thread is done with group g - 1's slot
    if (g + kStages - 1 < G) load_stage(g + kStages - 1, (g + kStages - 1) % kStages);
    cp_async_commit();
    const uint8_t* st = smem + (g % kStages) * T::kStage;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(st);
    const uint8_t* qs = st + T::kXBytes;
    const float* ss = reinterpret_cast<const float*>(qs + T::kQBytes);
    float part[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {  // 16 k a step: carrier rows 8 ks .. 8 ks + 7
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(qs + (8 * ks + qq) * kQRow + wn * 32 + 4 * gq);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(qs + (8 * ks + qq + 4) * kQRow + wn * 32 + 4 * gq);
      uint32_t b[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        b[n][0] = nibbles_bf16x2((w0 >> (8 * n)) & 0xFFu);
        b[n][1] = nibbles_bf16x2((w1 >> (8 * n)) & 0xFFu);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = (wm * MT + m) * 16 + gq;
        const uint32_t a0 = xs[r * kXWords + 8 * ks + qq];
        const uint32_t a1 = xs[(r + 8) * kXWords + 8 * ks + qq];
        const uint32_t a2 = xs[r * kXWords + 8 * ks + qq + 4];
        const uint32_t a3 = xs[(r + 8) * kXWords + 8 * ks + qq + 4];
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(part[m][n], a0, a1, a2, a3, b[n][0], b[n][1]);
      }
    }
    // the thread's columns: wn * 32 + 8 qq + t; t < 4 is n-tile t's c0 / c2,
    // t >= 4 n-tile t - 4's c1 / c3
    const float4 s_lo = *reinterpret_cast<const float4*>(ss + wn * 32 + 8 * qq);
    const float4 s_hi = *reinterpret_cast<const float4*>(ss + wn * 32 + 8 * qq + 4);
    const float sc[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[m][n][0] += part[m][n][0] * sc[n];
        acc[m][n][1] += part[m][n][1] * sc[n + 4];
        acc[m][n][2] += part[m][n][2] * sc[n];
        acc[m][n][3] += part[m][n][3] * sc[n + 4];
      }
  }
  cp_async_wait<0>();

  const int c = col0 + wn * 32 + 8 * qq;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r and r + 8
      const int row = row0 + (wm * MT + m) * 16 + gq + 8 * h;
      if (row >= row_end) continue;
      float v[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = acc[m][n][2 * h];
        v[n + 4] = acc[m][n][2 * h + 1];
      }
      if (out_bf16) {
        uint4 pk;
        uint32_t* p = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
          p[i] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * N + c) = pk;
      } else {
        float* o = static_cast<float*>(out) + (size_t)row * N + c;
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

template <int WM, int MT>
int launch(const void* xp, const void* q, const void* scale, const void* offsets, void* out,
           int K, int N, int G, int E, int tiles, int out_bf16, cudaStream_t stream) {
  using T = Tile<WM, MT>;
  auto kern = moe_int4_grouped_kernel<WM, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / kCols, tiles, E);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<const int*>(offsets), out, K, N, G, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ``tile_rows`` 16 (decode) or 64 (admissions); ``max_rows`` bounds the rows
// of one expert (the tokens: an expert takes a token at most once), so the
// grid's token tiles are ceil(max_rows / tile_rows).
int vcla_moe_int4_matmul(const void* xp, const void* q, const void* scale, const void* offsets,
                         void* out, int K, int N, int E, int max_rows, int tile_rows,
                         int out_bf16, void* stream) {
  if (K % 128 || N % kCols || max_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = K / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows == 16)
    return launch<1, 1>(xp, q, scale, offsets, out, K, N, G, E, (max_rows + 15) / 16, out_bf16,
                        s);
  if (tile_rows == 64)
    return launch<2, 2>(xp, q, scale, offsets, out, K, N, G, E, (max_rows + 63) / 64, out_bf16,
                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vcla_moe_int4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
