// Flash attention for Hopper (sm_90a): decode over one layer of the stacked KV
// cache, and the online-softmax attention of many queries over K/V in any
// (row, slot, head) layout.
//
// Replaces the Pallas kernels of visualcla_tpu/ops/pallas/flash_attention.py:
//   flash_decode_kernel <- _flash_decode_stacked -> _decode_kernel        (B1, Sq == 1)
//   flash_attention_kernel<causal> <- _flash_stacked -> _flash_kernel(stacked=True)
//                                                     (B2: one layer of the stacked cache)
//   flash_attention_kernel<causal or not> <- _flash_attention_jit -> _flash_kernel(stacked=False)
//                                                     (B2u: unstacked bsnh or bnsh K/V)
// B2 and B2u are one template: B2 passes one layer of the cache as bnsh K/V.
//
// Contract (every kernel, the TPU kernels' own):
//   q (B, Sq, N, HD); k, v (B, S, Nkv, HD) "bsnh" or (B, Nkv, S, HD) "bnsh",
//   read in place through their (row, slot, head) strides (the head-dim axis
//   is contiguous), in q's type or in int8 with f32 scales ks, vs indexed by
//   (row, slot, kv head) through their own strides.  The int8 scales fold in
//   after the dots (flash_attention.py:77-108, 165-200): the score is
//   (q . k_int8) * ks[j], and p is multiplied by vs[j] before p @ V (the
//   softmax denominator sums the unscaled p);
//   kv_valid (B, S) uint8; slots (B,) int32 = slot of each row's first query.
//   Query i of row b sees kv slot j iff kv_valid[b, j] and, when causal,
//   j <= slots[b] + i.  Query head n reads kv head n / (N / Nkv) (GQA).  q is
//   scaled in fp32 after the upcast, K and V are upcast to fp32, scores, p
//   and the online softmax stay fp32 (p is not rounded to q's type before
//   p @ V), masked scores are -1e30, p is masked so that a fully masked
//   query row has l == 0 and emits zeros.  Output is (B, Sq, N, HD) in q's
//   type.  HD is 64 (the ViT and the resampler) or 128 (LLaMA).
//
// What bounds them on the card, and what the design does about it:
//   decode reads the cache: bytes (int8 K/V halve them).  One block per (row, kv head) streams that
//   head's K and V once, only up to the row's slot, and serves all N / Nkv
//   query heads of the group from it.  Each thread loads its share of the
//   next 32-slot tile into registers while the current one is computed, so a
//   block waits on memory about once per tile and not once per slot.  At
//   B = 1 and 32 kv heads this is only 32 blocks, so a block's latency, not
//   the card's bandwidth, sets the time; splitting the kv axis across blocks
//   (flash-decoding) is later work.
//   flash_attention_kernel does Sq x S x HD multiply-adds twice: operations
//   in principle, but with plain fp32 FMAs (no tensor cores yet) it runs far
//   below the bf16 tensor-core rate the bound is taken at.  One block per
//   (row, head, 64-query tile) stages 64-slot K/V tiles in shared memory in
//   fp32 and register-tiles the two products.  With causal on, kv tiles
//   wholly past the tile's last query slot are skipped, so a short prompt in
//   a long cache reads only the slots it can see; with causal off every tile
//   is visited.  At the ViT's shape (257 tokens, 16 heads) the grid is only
//   5 x 16 x B blocks, under one wave of the 132 SMs at B = 1, so each
//   block's serial walk over the 5 kv tiles sets the time there; wgmma/TMA
//   tiles and a split of the kv axis across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// the cache is int8 with per-slot scales, or in q's type without them
template <typename KV>
constexpr bool kQuantKV = sizeof(KV) == 1;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in torch/XLA
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// B1: decode, Sq == 1
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeTile = 32;  // kv slots per tile: one per lane in the softmax step
constexpr int kSlotsPerWarp = kDecodeTile / kDecodeWarps;

// This thread's share of one kv tile, in registers: the HD / 32 elements of
// each K row its warp scores, and the V column ``threadIdx.x`` for every slot.
// All loads of a tile are issued together, one tile ahead of the compute.
template <typename KV, int HD>
__device__ __forceinline__ void load_decode_tile(const KV* k_head, const KV* v_head, int j0,
                                                 int S, float (&kr)[kSlotsPerWarp][HD / 32],
                                                 float (&vr)[kDecodeTile]) {
  constexpr int kPerLane = HD / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) {
    const int j = j0 + warp + kDecodeWarps * i;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      kr[i][e] = j < S ? to_f32(k_head[(size_t)j * HD + lane * kPerLane + e]) : 0.f;
  }
  const int d = threadIdx.x;
#pragma unroll
  for (int jj = 0; jj < kDecodeTile; ++jj) {
    const int j = j0 + jj;
    vr[jj] = (d < HD && j < S) ? to_f32(v_head[(size_t)j * HD + d]) : 0.f;
  }
}

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const uint8_t* __restrict__ kv_valid,
                    const int* __restrict__ slots, T* __restrict__ out, int N,
                    int Nkv, int S, float scale) {
  static_assert(HD % 32 == 0 && HD <= kDecodeThreads, "one V column per thread");
  constexpr int kPerLane = HD / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = N / Nkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_sh = smem;                      // rep x HD, scaled
  float* acc_sh = q_sh + rep * HD;         // rep x HD
  float* p_sh = acc_sh + rep * HD;         // rep x kDecodeTile: scores, then p
  float* m_sh = p_sh + rep * kDecodeTile;  // rep
  float* l_sh = m_sh + rep;                // rep
  float* alpha_sh = l_sh + rep;            // rep

  const T* q_grp = q + ((size_t)b * N + (size_t)kvh * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += kDecodeThreads) {
    q_sh[i] = to_f32(q_grp[i]) * scale;
    acc_sh[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rep; r += kDecodeThreads) {
    m_sh[r] = kNegInf;
    l_sh[r] = 0.f;
  }
  __syncthreads();

  const int slot = slots[b];
  const int last = min(slot, S - 1);  // last visible slot
  const int n_tiles = slot < 0 ? 0 : last / kDecodeTile + 1;
  const size_t head_off = ((size_t)b * Nkv + kvh) * (size_t)S * HD;
  const KV* k_head = k + head_off;
  const KV* v_head = v + head_off;
  const size_t scale_off = ((size_t)b * Nkv + kvh) * (size_t)S;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

  float k_cur[kSlotsPerWarp][kPerLane], v_cur[kDecodeTile];
  if (n_tiles > 0) load_decode_tile<KV, HD>(k_head, v_head, 0, S, k_cur, v_cur);
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kDecodeTile;
    const bool more = t + 1 < n_tiles;
    float k_nxt[kSlotsPerWarp][kPerLane], v_nxt[kDecodeTile];
    if (more) load_decode_tile<KV, HD>(k_head, v_head, j0 + kDecodeTile, S, k_nxt, v_nxt);
    // scores: warp w takes slots j0 + w, j0 + w + kDecodeWarps, ...; each
    // lane holds HD / 32 contiguous elements of the K row
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      const int jj = warp + kDecodeWarps * i;
      for (int r = 0; r < rep; ++r) {
        const float* qr = q_sh + r * HD + lane * kPerLane;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot = fmaf(qr[e], k_cur[i][e], dot);
        dot = warp_sum(dot);
        if (lane == 0) p_sh[r * kDecodeTile + jj] = dot;
      }
    }
    __syncthreads();
    // online softmax: warp w takes query heads w, w + kDecodeWarps, ...;
    // lane = slot within the tile
    {
      const int j = j0 + lane;
      const bool ok = j <= last && ok_row[j] != 0;
      float k_sc = 1.f, v_sc = 1.f;
      if (kQuantKV<KV> && ok) {
        k_sc = ks[scale_off + j];
        v_sc = vs[scale_off + j];
      }
      for (int r = warp; r < rep; r += kDecodeWarps) {
        const float s = ok ? p_sh[r * kDecodeTile + lane] * k_sc : kNegInf;
        const float m_old = m_sh[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        p_sh[r * kDecodeTile + lane] = p * v_sc;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          m_sh[r] = m_new;
          l_sh[r] = l_sh[r] * alpha + sum;
          alpha_sh[r] = alpha;
        }
      }
    }
    __syncthreads();
    // p @ v: thread d owns head-dim column d
    const int d = threadIdx.x;
    if (d < HD) {
      for (int r = 0; r < rep; ++r) {
        float a = acc_sh[r * HD + d] * alpha_sh[r];
#pragma unroll
        for (int jj = 0; jj < kDecodeTile; ++jj)
          a = fmaf(p_sh[r * kDecodeTile + jj], v_cur[jj], a);
        acc_sh[r * HD + d] = a;
      }
    }
    __syncthreads();
    if (more) {
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) k_cur[i][e] = k_nxt[i][e];
#pragma unroll
      for (int jj = 0; jj < kDecodeTile; ++jj) v_cur[jj] = v_nxt[jj];
    }
  }

  T* o_grp = out + ((size_t)b * N + (size_t)kvh * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += kDecodeThreads) {
    const float l = l_sh[i / HD];
    o_grp[i] = from_f32<T>(acc_sh[i] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// B2 / B2u: Sq queries a row, causal or not
// ---------------------------------------------------------------------------

constexpr int kPrefillThreads = 256;  // 16 x 16
constexpr int kBQ = 64;               // queries per block
constexpr int kBK = 64;               // kv slots per tile
constexpr int kRows = kBQ / 16;       // query rows per thread
constexpr int kSCols = kBK / 16;      // score columns per thread

// element strides of an operand along (row, slot, head); its last axis is
// contiguous.  The slot stride is 32-bit (at most Nkv * HD): with a 64-bit one
// B2's int8 form ran 27 % slower on the card (315 against 248 us a call).
struct Strides {
  long long b;
  int s;
  long long h;
};

template <int HD>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1)    // q tile, scaled
                          + (size_t)HD * (kBK + 1)  // K tile, transposed
                          + (size_t)kBK * HD        // V tile
                          + (size_t)kBQ * (kBK + 1) // p tile
                          + 3 * kBK);               // slot validity, k and v scales
}

// at least 2 blocks an SM: the register budget (128) at which every instance
// measured fastest on the card (HD 64 fits 3 blocks of shared memory, HD 128 1)
template <typename T, typename KV, int HD, bool kCausal>
__global__ void __launch_bounds__(kPrefillThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs, const uint8_t* __restrict__ kv_valid,
                       const int* __restrict__ slots, T* __restrict__ out, int Sq, int N,
                       int Nkv, int S, Strides qs, Strides kst, Strides vst, Strides sc,
                       float scale) {
  constexpr int kOCols = HD / 16;  // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / Nkv);
  // thread (ty, tx) owns query rows ty + 16 i, score columns tx + 16 c and
  // output columns tx + 16 c; the 16 lanes of one ty sit in one half-warp
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* q_sh = smem;
  float* kt_sh = q_sh + kBQ * (HD + 1);
  float* v_sh = kt_sh + HD * (kBK + 1);
  float* p_sh = v_sh + kBK * HD;
  float* ok_sh = p_sh + kBQ * (kBK + 1);
  float* ks_sh = ok_sh + kBK;
  float* vs_sh = ks_sh + kBK;

  const T* q_head = q + b * qs.b + n * qs.h;
  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kPrefillThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    q_sh[r * (HD + 1) + d] = qi < Sq ? to_f32(q_head[qi * qs.s + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  const int slot0 = slots[b];
  int n_tiles = (S + kBK - 1) / kBK;
  if (kCausal) {
    const int q_last = slot0 + min(q0 + kBQ, Sq) - 1;  // slot of the tile's last query
    n_tiles = q_last < 0 ? 0 : min(n_tiles, q_last / kBK + 1);
  }
  const KV* k_head = k + b * kst.b + kvh * kst.h;
  const KV* v_head = v + b * vst.b + kvh * vst.h;
  const long long scale_off = b * sc.b + kvh * sc.h;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // q tile written / previous tile consumed
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kPrefillThreads) {
      const int j = idx / HD, d = idx % HD;
      const bool in = j0 + j < S;
      kt_sh[d * (kBK + 1) + j] = in ? to_f32(k_head[(j0 + j) * kst.s + d]) : 0.f;
      v_sh[j * HD + d] = in ? to_f32(v_head[(j0 + j) * vst.s + d]) : 0.f;
    }
    for (int j = threadIdx.x; j < kBK; j += kPrefillThreads) {
      const bool in = j0 + j < S;
      ok_sh[j] = (in && ok_row[j0 + j] != 0) ? 1.f : 0.f;
      ks_sh[j] = (kQuantKV<KV> && in) ? ks[scale_off + (j0 + j) * sc.s] : 1.f;
      vs_sh[j] = (kQuantKV<KV> && in) ? vs[scale_off + (j0 + j) * sc.s] : 1.f;
    }
    __syncthreads();

    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kSCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kSCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_sh[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kSCols; ++c) kv[c] = kt_sh[d * (kBK + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kSCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_slot = slot0 + q0 + ty + 16 * i;
      bool ok[kSCols];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        const int jj = tx + 16 * c;
        ok[c] = ok_sh[jj] != 0.f && (!kCausal || j0 + jj <= q_slot);
        s[i][c] = ok[c] ? s[i][c] * ks_sh[jj] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        p_sh[(ty + 16 * i) * (kBK + 1) + tx + 16 * c] = p * vs_sh[tx + 16 * c];
        sum += p;
      }
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kOCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[kOCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_sh[(ty + 16 * i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kOCols; ++c) vv[c] = v_sh[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* o_row = out + (((size_t)b * Sq + qi) * N + n) * HD;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) o_row[tx + 16 * c] = from_f32<T>(acc[i][c] / safe_l);
  }
}

template <typename T, typename KV, int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, const void* kv_valid, const void* slots, void* out,
                          int B, int N, int Nkv, int S, float scale, cudaStream_t stream) {
  const int rep = N / Nkv;
  const size_t smem = sizeof(float) * (2 * (size_t)rep * HD + (size_t)rep * kDecodeTile + 3 * rep);
  static size_t allowed = 48 * 1024;  // raised once per size: stays out of graph capture
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, KV, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  flash_decode_kernel<T, KV, HD><<<dim3(Nkv, B), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<T*>(out), N, Nkv, S, scale);
  return cudaGetLastError();
}

template <typename T, typename KV, int HD, bool kCausal>
cudaError_t launch_attention(const void* q, const void* k, const void* v, const void* ks,
                             const void* vs, const void* kv_valid, const void* slots, void* out,
                             int B, int Sq, int N, int Nkv, int S, Strides qs, Strides kst,
                             Strides vst, Strides sc, float scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  static bool configured = false;  // once per instance: keeps the call out of graph capture
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_kernel<T, KV, HD, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, N, B);
  flash_attention_kernel<T, KV, HD, kCausal><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<T*>(out), Sq, N, Nkv, S, qs, kst, vst, sc, scale);
  return cudaGetLastError();
}

// the instance for a head dim, a causal flag, q's type and the K/V type
template <typename T, typename KV>
cudaError_t attention_for(int head_dim, bool causal, const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* kv_valid,
                          const void* slots, void* out, int B, int Sq, int N, int Nkv, int S,
                          Strides qs, Strides kst, Strides vst, Strides sc, float scale,
                          cudaStream_t st) {
#define VCLA_ATTENTION(HD, C)                                                                  \
  launch_attention<T, KV, HD, C>(q, k, v, ks, vs, kv_valid, slots, out, B, Sq, N, Nkv, S, qs, \
                                 kst, vst, sc, scale, st)
  if (head_dim == 64) return causal ? VCLA_ATTENTION(64, true) : VCLA_ATTENTION(64, false);
  if (head_dim == 128) return causal ? VCLA_ATTENTION(128, true) : VCLA_ATTENTION(128, false);
#undef VCLA_ATTENTION
  return cudaErrorInvalidValue;
}

template <typename T, typename KV>
cudaError_t decode_for(int head_dim, const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* kv_valid, const void* slots, void* out,
                       int B, int N, int Nkv, int S, float scale, cudaStream_t st) {
  if (head_dim == 64)
    return launch_decode<T, KV, 64>(q, k, v, ks, vs, kv_valid, slots, out, B, N, Nkv, S, scale, st);
  if (head_dim == 128)
    return launch_decode<T, KV, 128>(q, k, v, ks, vs, kv_valid, slots, out, B, N, Nkv, S, scale,
                                     st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// ``stream`` is a cudaStream_t.  Returns a cudaError_t (0 = launched).
extern "C" {

// B1 over one layer (B, Nkv, S, HD) of the cache, q's type (ks, vs unused)
// or int8 K/V with per-slot scales (B, Nkv, S)
int vcla_flash_decode(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* kv_valid, const void* slots, void* out, int B,
                      int N, int Nkv, int S, int head_dim, int is_bf16, int kv_int8, float scale,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return kv_int8 ? decode_for<__nv_bfloat16, int8_t>(head_dim, q, k, v, ks, vs, kv_valid, slots,
                                                        out, B, N, Nkv, S, scale, st)
                   : decode_for<__nv_bfloat16, __nv_bfloat16>(head_dim, q, k, v, ks, vs, kv_valid,
                                                              slots, out, B, N, Nkv, S, scale, st);
  return kv_int8 ? decode_for<float, int8_t>(head_dim, q, k, v, ks, vs, kv_valid, slots, out, B,
                                             N, Nkv, S, scale, st)
                 : decode_for<float, float>(head_dim, q, k, v, ks, vs, kv_valid, slots, out, B, N,
                                            Nkv, S, scale, st);
}

// B2u: q (B, Sq, N, HD) and k, v, ks, vs through their (row, slot, head)
// strides; B2 is this call on one layer of the cache (bnsh strides, causal)
int vcla_flash_attention(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* kv_valid, const void* slots, void* out,
                         int B, int Sq, int N, int Nkv, int S, int head_dim, int is_bf16,
                         int kv_int8, int causal, long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, long long sc_sb, long long sc_ss,
                         long long sc_sh, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, (int)q_ss, q_sh}, kst{k_sb, (int)k_ss, k_sh},
      vst{v_sb, (int)v_ss, v_sh}, sc{sc_sb, (int)sc_ss, sc_sh};
  const bool c = causal != 0;
  if (is_bf16)
    return kv_int8 ? attention_for<__nv_bfloat16, int8_t>(head_dim, c, q, k, v, ks, vs, kv_valid,
                                                           slots, out, B, Sq, N, Nkv, S, qs, kst,
                                                           vst, sc, scale, st)
                   : attention_for<__nv_bfloat16, __nv_bfloat16>(
                         head_dim, c, q, k, v, ks, vs, kv_valid, slots, out, B, Sq, N, Nkv, S, qs,
                         kst, vst, sc, scale, st);
  return kv_int8 ? attention_for<float, int8_t>(head_dim, c, q, k, v, ks, vs, kv_valid, slots,
                                                out, B, Sq, N, Nkv, S, qs, kst, vst, sc, scale, st)
                 : attention_for<float, float>(head_dim, c, q, k, v, ks, vs, kv_valid, slots, out,
                                               B, Sq, N, Nkv, S, qs, kst, vst, sc, scale, st);
}

const char* vcla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
