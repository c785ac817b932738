// Paged attention over a block-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the paged serving engine
// (visualcla_tpu/ops/pallas/paged_attention.py):
//   paged_append_kernel  <- paged_append_attention -> _append_kernel   (B4)
//   paged_verify_kernel<kAppend=true>  <- paged_verify_attention
//                                          -> _verify_kernel           (B5)
//   paged_verify_kernel<kAppend=false, kExact=true>
//                        <- paged_decode_attention -> _paged_kernel    (B6)
//
// B4 is described first; B5 and B6 share one kernel, described above it.
//
// Contract (the TPU kernel's):
//   q (B, N, HD); k_new, v_new (B, Nkv, HD) in the pool's type; the pools
//   k_pool, v_pool (L, NB, BS, Nkv * HD), in q's type or int8 with f32 scales
//   ks_pool, vs_pool (L, NB, BS, Nkv) and the new token's scales ksn, vsn
//   (B, Nkv); tables (B, max_blocks), lens, blk, off (B,) int32.  Row b
//   attends over its lens[b] - 1 old tokens (token j in pool block
//   tables[b, j / BS] at offset j % BS of layer ``layer``) and the new token,
//   whose K/V (and scales) the kernel writes into pool[layer, blk[b], off[b]]
//   in place.  Query head n reads kv head n / (N / Nkv).  The numerics follow
//   the TPU kernel: the compute type is the pool's type for a float pool and
//   bf16 for an int8 pool, and q * scale and p (times the V scale) are rounded
//   to it before their products; int8 scales fold in after the dots (score *
//   ks[j], p * vs[j] before p @ V, the denominator sums the unscaled p); the
//   new token is one analytic online-softmax term; the softmax is fp32.
//
// What bounds it on the card, and what the design does about it:
//   decode attention reads every old K/V byte of the rows once and does two
//   multiply-adds per byte pair: it is bound by bytes.  One block per
//   (kv head, row) walks the row's block table and streams that head's K and
//   V slices (HD contiguous elements of each token's pool row) once, serving
//   all N / Nkv query heads of the group from them (GQA reads each tile
//   once).  Tokens go 32 to a tile; each lane looks up one token's pool row
//   and the warps share it by shuffle; K rows load as 4-element vectors per
//   lane, and each thread loads its share of the next tile while the current
//   one is computed.  The TPU kernel's block-diagonal query matrix, its
//   sequential grid carrying m/l/acc, and scalar prefetch are answers to the
//   TPU and are not carried over.  At B rows and Nkv kv heads the grid has
//   B * Nkv blocks; splitting the context across blocks, cp.async/TMA and
//   CUDA graphs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens per tile: one per lane in the softmax step
constexpr int kTokensPerWarp = kTile / kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in torch/XLA
}

// the compute type: the pool's type for a float pool, bf16 for an int8 pool
template <typename KV>
__device__ __forceinline__ float round_compute(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float round_compute<float>(float x) { return x; }

template <typename KV>
constexpr bool kQuantKV = sizeof(KV) == 1;

// four contiguous elements (aligned to four) as floats, in one vector load
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The pool row (token index within layer 0's row space) of old-context token
// j0 + lane of row ``table``, or -1 past the context.
__device__ __forceinline__ long long token_row(const int* table, int j0, int ctx, int BS,
                                               long long layer_rows) {
  const int j = j0 + threadIdx.x % 32;
  if (j >= ctx) return -1;
  return layer_rows + (long long)table[j / BS] * BS + j % BS;
}

// This thread's share of one tile, in registers: the four elements of each K
// row its warp scores, and V column ``threadIdx.x`` of every token.
template <typename KV, int HD>
__device__ __forceinline__ void load_tile(const KV* k_pool, const KV* v_pool, long long my_row,
                                          int KVL, int kvh,
                                          float (&kr)[kTokensPerWarp][HD / 32],
                                          float (&vr)[kTile]) {
  static_assert(HD / 32 == 4, "four elements of a K row per lane");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kTokensPerWarp; ++i) {
    const long long row = __shfl_sync(0xffffffffu, my_row, warp + kWarps * i);
    if (row >= 0) {
      load4(k_pool + row * KVL + (long long)kvh * HD + lane * 4, kr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kr[i][e] = 0.f;
    }
  }
  const int d = threadIdx.x;
#pragma unroll
  for (int jj = 0; jj < kTile; ++jj) {
    const long long row = __shfl_sync(0xffffffffu, my_row, jj);
    vr[jj] = (d < HD && row >= 0) ? to_f32(v_pool[row * KVL + (long long)kvh * HD + d]) : 0.f;
  }
}

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                    const KV* __restrict__ v_new, KV* __restrict__ k_pool,
                    KV* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lens, const int* __restrict__ blk,
                    const int* __restrict__ off, const float* __restrict__ ksn,
                    const float* __restrict__ vsn, float* __restrict__ ks_pool,
                    float* __restrict__ vs_pool, T* __restrict__ out, int N, int Nkv,
                    int NB, int BS, int max_blocks, int layer, float scale) {
  static_assert(HD % 32 == 0 && HD <= kThreads, "one V column per thread");
  constexpr int kPerLane = HD / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = N / Nkv;
  const int KVL = Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_sh = smem;                  // rep x HD: q * scale in the compute type
  float* acc_sh = q_sh + rep * HD;     // rep x HD
  float* p_sh = acc_sh + rep * HD;     // rep x kTile: scores, then p * vs
  float* m_sh = p_sh + rep * kTile;    // rep
  float* l_sh = m_sh + rep;            // rep
  float* alpha_sh = l_sh + rep;        // rep
  float* pn_sh = alpha_sh + rep;       // rep: the new token's p * vs

  const T* q_grp = q + ((size_t)b * N + (size_t)kvh * rep) * HD;
  for (int i = threadIdx.x; i < rep * HD; i += kThreads) {
    q_sh[i] = round_compute<KV>(to_f32(q_grp[i]) * scale);
    acc_sh[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    m_sh[r] = kNegInf;
    l_sh[r] = 0.f;
  }
  __syncthreads();

  const int ctx = lens[b] - 1;  // the pool holds the old context only
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;
  const int n_tiles = ctx > 0 ? (ctx + kTile - 1) / kTile : 0;

  float k_cur[kTokensPerWarp][kPerLane], v_cur[kTile];
  long long row_cur = -1;
  if (n_tiles > 0) {
    row_cur = token_row(table, 0, ctx, BS, layer_rows);
    load_tile<KV, HD>(k_pool, v_pool, row_cur, KVL, kvh, k_cur, v_cur);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const bool more = t + 1 < n_tiles;
    float k_nxt[kTokensPerWarp][kPerLane], v_nxt[kTile];
    long long row_nxt = -1;
    if (more) {
      row_nxt = token_row(table, j0 + kTile, ctx, BS, layer_rows);
      load_tile<KV, HD>(k_pool, v_pool, row_nxt, KVL, kvh, k_nxt, v_nxt);
    }
    // scores: warp w takes tokens j0 + w, j0 + w + kWarps, ...
#pragma unroll
    for (int i = 0; i < kTokensPerWarp; ++i) {
      const int jj = warp + kWarps * i;
      for (int r = 0; r < rep; ++r) {
        const float* qr = q_sh + r * HD + lane * kPerLane;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot = fmaf(qr[e], k_cur[i][e], dot);
        dot = warp_sum(dot);
        if (lane == 0) p_sh[r * kTile + jj] = dot;
      }
    }
    __syncthreads();
    // online softmax: warp w takes query heads w, w + kWarps, ...; lane = token
    {
      const bool ok = row_cur >= 0;
      float k_sc = 1.f, v_sc = 1.f;
      if (kQuantKV<KV> && ok) {
        k_sc = ks_pool[row_cur * Nkv + kvh];
        v_sc = vs_pool[row_cur * Nkv + kvh];
      }
      for (int r = warp; r < rep; r += kWarps) {
        const float s = ok ? p_sh[r * kTile + lane] * k_sc : kNegInf;
        const float m_old = m_sh[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        p_sh[r * kTile + lane] = round_compute<KV>(p * v_sc);
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
        for (int jj = 0; jj < kTile; ++jj) a = fmaf(p_sh[r * kTile + jj], v_cur[jj], a);
        acc_sh[r * HD + d] = a;
      }
    }
    __syncthreads();
    if (more) {
#pragma unroll
      for (int i = 0; i < kTokensPerWarp; ++i)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) k_cur[i][e] = k_nxt[i][e];
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) v_cur[jj] = v_nxt[jj];
      row_cur = row_nxt;
    }
  }

  // the new token: one analytic online-softmax term per query head
  const size_t new_off = ((size_t)b * Nkv + kvh) * HD;
  const float k_sc_new = kQuantKV<KV> ? ksn[(size_t)b * Nkv + kvh] : 1.f;
  const float v_sc_new = kQuantKV<KV> ? vsn[(size_t)b * Nkv + kvh] : 1.f;
  for (int r = warp; r < rep; r += kWarps) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int dd = lane * kPerLane + e;
      dot = fmaf(q_sh[r * HD + dd], to_f32(k_new[new_off + dd]), dot);
    }
    const float sn = warp_sum(dot) * k_sc_new;
    if (lane == 0) {
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, sn);
      const float pn = expf(sn - m_new);
      const float alpha = expf(m_old - m_new);
      l_sh[r] = l_sh[r] * alpha + pn;
      alpha_sh[r] = alpha;
      pn_sh[r] = pn * v_sc_new;
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < HD) {
    const float vn = to_f32(v_new[new_off + d]);
    T* o_grp = out + ((size_t)b * N + (size_t)kvh * rep) * HD;
    for (int r = 0; r < rep; ++r) {
      const float a = acc_sh[r * HD + d] * alpha_sh[r] + pn_sh[r] * vn;
      const float l = l_sh[r];
      o_grp[r * HD + d] = from_f32<T>(a / (l == 0.f ? 1.f : l));
    }
    // the append: this block's kv-head slice of the new token's pool row
    const long long row = layer_rows + (long long)blk[b] * BS + off[b];
    k_pool[row * KVL + (long long)kvh * HD + d] = k_new[new_off + d];
    v_pool[row * KVL + (long long)kvh * HD + d] = v_new[new_off + d];
    if (kQuantKV<KV> && d == 0) {
      ks_pool[row * Nkv + kvh] = k_sc_new;
      vs_pool[row * Nkv + kvh] = v_sc_new;
    }
  }
}

template <typename T, typename KV, int HD>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
                   void* v_pool, const void* tables, const void* lens, const void* blk,
                   const void* off, const void* ksn, const void* vsn, void* ks_pool,
                   void* vs_pool, void* out, int B, int N, int Nkv, int NB, int BS,
                   int max_blocks, int layer, float scale, cudaStream_t stream) {
  const int rep = N / Nkv;
  const size_t smem = sizeof(float) * (2 * (size_t)rep * HD + (size_t)rep * kTile + 4 * rep);
  static size_t allowed = 48 * 1024;  // raised once per size: stays out of graph capture
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_append_kernel<T, KV, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  paged_append_kernel<T, KV, HD><<<dim3(Nkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_new), static_cast<const KV*>(v_new),
      static_cast<KV*>(k_pool), static_cast<KV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const int*>(blk),
      static_cast<const int*>(off), static_cast<const float*>(ksn),
      static_cast<const float*>(vsn), static_cast<float*>(ks_pool),
      static_cast<float*>(vs_pool), static_cast<T*>(out), N, Nkv, NB, BS, max_blocks, layer,
      scale);
  return cudaGetLastError();
}

// B5, the speculative verify step: Sq new tokens a row.  Contract (the TPU
// kernel's): q (B, Sq, N, HD); k_new, v_new (B, Sq, Nkv, HD) in the pool's
// type (int8 with f32 scales ksn, vsn (B, Sq, Nkv)); pools and tables as B4;
// lens (B,) the context length INCLUDING the Sq new tokens.  New token j of
// row b goes to slot base + j, base = lens[b] - Sq (block tables[b, slot /
// BS], offset slot % BS; a slot past the table goes to dummy block 0, offset
// 0), and query j attends over the slots <= base + j.  The numerics follow
// the TPU kernel: the new tokens go through the same path as the old ones
// (they are part of the block content there), so their probabilities are
// rounded to the compute type too, unlike B4's analytic new-token term.
//
// B6, decode without an append: Sq = 1, one layer's pool, lens counting every
// token (query 0 attends over the slots <= lens - 1), and kExact: all
// arithmetic in f32, q * scale and p not rounded.
//
// The design is B4's: one block per (kv head, row), 32-token tiles of the
// row's table, K rows as 4-element vectors, the next tile loaded while the
// current one is computed.  All (N / Nkv) * Sq query rows of the group are
// served from one read of each tile (row r is query r / rep of head r % rep).
// The append comes first: each block writes only its own kv-head slice of
// the Sq new tokens (and their scales), then __syncthreads() makes those
// writes visible to its own threads, and the attention reads them like any
// other token.  No other block reads that slice (each (row, kv head) pair is
// one block), so there is no race; only parked rows share bytes (dummy block
// 0), and their outputs are dropped.  The TPU kernel's block-diagonal query
// matrix, its selection matmuls (pick_rows, substituted), its two-block
// output index map and scalar prefetch answer the TPU and are not carried
// over.  What bounds it on the card: the bytes of the rows' context, as B4.
template <typename T, typename KV, int HD, bool kAppend, bool kExact>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                    const KV* __restrict__ v_new, KV* k_pool, KV* v_pool,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    const float* __restrict__ ksn, const float* __restrict__ vsn,
                    float* ks_pool, float* vs_pool, T* __restrict__ out, int N, int Nkv,
                    int Sq, int NB, int BS, int max_blocks, int layer, float scale) {
  static_assert(HD % 32 == 0 && HD <= kThreads, "one V column per thread");
  constexpr int kPerLane = HD / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = N / Nkv;
  const int R = rep * Sq;  // query rows of the group
  const int KVL = Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = threadIdx.x;

  extern __shared__ float smem[];
  float* q_sh = smem;                // R x HD: q * scale (rounded unless kExact)
  float* acc_sh = q_sh + R * HD;     // R x HD
  float* p_sh = acc_sh + R * HD;     // R x kTile: scores, then p * vs
  float* m_sh = p_sh + R * kTile;    // R
  float* l_sh = m_sh + R;            // R
  float* alpha_sh = l_sh + R;        // R

  const int length = lens[b];
  const int base = length - Sq;  // slot of new token 0
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;

  if (kAppend) {
    // this block's kv-head slice of the Sq new tokens, into the pool
    for (int j = 0; j < Sq; ++j) {
      const int slot = base + j;
      const bool in_table = slot >= 0 && slot / BS < max_blocks;
      const long long row =
          layer_rows + (in_table ? (long long)table[slot / BS] * BS + slot % BS : 0);
      const size_t src = ((size_t)(b * Sq + j) * Nkv + kvh);
      if (d < HD) {
        k_pool[row * KVL + (long long)kvh * HD + d] = k_new[src * HD + d];
        v_pool[row * KVL + (long long)kvh * HD + d] = v_new[src * HD + d];
      }
      if (kQuantKV<KV> && d == 0) {
        ks_pool[row * Nkv + kvh] = ksn[src];
        vs_pool[row * Nkv + kvh] = vsn[src];
      }
    }
  }
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, e = i % HD;
    const int j = r / rep, h = r % rep;
    const float x = to_f32(q[((size_t)(b * Sq + j) * N + kvh * rep + h) * HD + e]) * scale;
    q_sh[i] = kExact ? x : round_compute<KV>(x);
    acc_sh[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_sh[r] = kNegInf;
    l_sh[r] = 0.f;
  }
  __syncthreads();  // the append is visible to every thread of the block

  const int ctx = min(length, max_blocks * BS);  // the slots the table covers
  const int n_tiles = ctx > 0 ? (ctx + kTile - 1) / kTile : 0;

  float k_cur[kTokensPerWarp][kPerLane], v_cur[kTile];
  long long row_cur = -1;
  if (n_tiles > 0) {
    row_cur = token_row(table, 0, ctx, BS, layer_rows);
    load_tile<KV, HD>(k_pool, v_pool, row_cur, KVL, kvh, k_cur, v_cur);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const bool more = t + 1 < n_tiles;
    float k_nxt[kTokensPerWarp][kPerLane], v_nxt[kTile];
    long long row_nxt = -1;
    if (more) {
      row_nxt = token_row(table, j0 + kTile, ctx, BS, layer_rows);
      load_tile<KV, HD>(k_pool, v_pool, row_nxt, KVL, kvh, k_nxt, v_nxt);
    }
    // scores: warp w takes tokens j0 + w, j0 + w + kWarps, ...
#pragma unroll
    for (int i = 0; i < kTokensPerWarp; ++i) {
      const int jj = warp + kWarps * i;
      for (int r = 0; r < R; ++r) {
        const float* qr = q_sh + r * HD + lane * kPerLane;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot = fmaf(qr[e], k_cur[i][e], dot);
        dot = warp_sum(dot);
        if (lane == 0) p_sh[r * kTile + jj] = dot;
      }
    }
    __syncthreads();
    // online softmax: warp w takes rows w, w + kWarps, ...; lane = token;
    // query j sees the slots <= base + j
    {
      const int slot = j0 + lane;
      float k_sc = 1.f, v_sc = 1.f;
      if (kQuantKV<KV> && row_cur >= 0) {
        k_sc = ks_pool[row_cur * Nkv + kvh];
        v_sc = vs_pool[row_cur * Nkv + kvh];
      }
      for (int r = warp; r < R; r += kWarps) {
        const bool ok = row_cur >= 0 && slot <= base + r / rep;
        const float s = ok ? p_sh[r * kTile + lane] * k_sc : kNegInf;
        const float m_old = m_sh[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        p_sh[r * kTile + lane] = kExact ? p * v_sc : round_compute<KV>(p * v_sc);
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
    if (d < HD) {
      for (int r = 0; r < R; ++r) {
        float a = acc_sh[r * HD + d] * alpha_sh[r];
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) a = fmaf(p_sh[r * kTile + jj], v_cur[jj], a);
        acc_sh[r * HD + d] = a;
      }
    }
    __syncthreads();
    if (more) {
#pragma unroll
      for (int i = 0; i < kTokensPerWarp; ++i)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) k_cur[i][e] = k_nxt[i][e];
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) v_cur[jj] = v_nxt[jj];
      row_cur = row_nxt;
    }
  }

  if (d < HD) {
    for (int r = 0; r < R; ++r) {
      const int j = r / rep, h = r % rep;
      const float l = l_sh[r];
      out[((size_t)(b * Sq + j) * N + kvh * rep + h) * HD + d] =
          from_f32<T>(acc_sh[r * HD + d] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, typename KV, int HD, bool kAppend, bool kExact>
cudaError_t launch_verify(const void* q, const void* k_new, const void* v_new, void* k_pool,
                          void* v_pool, const void* tables, const void* lens, const void* ksn,
                          const void* vsn, void* ks_pool, void* vs_pool, void* out, int B,
                          int Sq, int N, int Nkv, int NB, int BS, int max_blocks, int layer,
                          float scale, cudaStream_t stream) {
  const size_t R = (size_t)(N / Nkv) * Sq;
  const size_t smem = sizeof(float) * (2 * R * HD + R * kTile + 3 * R);
  static size_t allowed = 48 * 1024;  // raised once per size: stays out of graph capture
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_verify_kernel<T, KV, HD, kAppend, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  paged_verify_kernel<T, KV, HD, kAppend, kExact><<<dim3(Nkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_new), static_cast<const KV*>(v_new),
      static_cast<KV*>(k_pool), static_cast<KV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const float*>(ksn),
      static_cast<const float*>(vsn), static_cast<float*>(ks_pool),
      static_cast<float*>(vs_pool), static_cast<T*>(out), N, Nkv, Sq, NB, BS, max_blocks,
      layer, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer
// (the four scale pointers are null for a float pool); ``stream`` is a
// cudaStream_t.  Returns a cudaError_t (0 = launched).
extern "C" {

int vcla_paged_append(const void* q, const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const void* tables, const void* lens, const void* blk,
                      const void* off, const void* ksn, const void* vsn, void* ks_pool,
                      void* vs_pool, void* out, int B, int N, int Nkv, int NB, int BS,
                      int max_blocks, int layer, int head_dim, int is_bf16, int kv_int8,
                      float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
#define VCLA_PAGED_ARGS                                                                  \
  q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, ksn, vsn, ks_pool, vs_pool, out, \
      B, N, Nkv, NB, BS, max_blocks, layer, scale, st
  if (kv_int8)
    return is_bf16 ? launch<__nv_bfloat16, int8_t, 128>(VCLA_PAGED_ARGS)
                   : launch<float, int8_t, 128>(VCLA_PAGED_ARGS);
  return is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, 128>(VCLA_PAGED_ARGS)
                 : launch<float, float, 128>(VCLA_PAGED_ARGS);
#undef VCLA_PAGED_ARGS
}

// B5: the pools are (L, NB, BS, Nkv * head_dim) and updated in place.
int vcla_paged_verify(const void* q, const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const void* tables, const void* lens, const void* ksn,
                      const void* vsn, void* ks_pool, void* vs_pool, void* out, int B, int Sq,
                      int N, int Nkv, int NB, int BS, int max_blocks, int layer, int head_dim,
                      int is_bf16, int kv_int8, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
#define VCLA_VERIFY_ARGS                                                                   \
  q, k_new, v_new, k_pool, v_pool, tables, lens, ksn, vsn, ks_pool, vs_pool, out, B, Sq, N, \
      Nkv, NB, BS, max_blocks, layer, scale, st
  if (kv_int8)
    return is_bf16 ? launch_verify<__nv_bfloat16, int8_t, 128, true, false>(VCLA_VERIFY_ARGS)
                   : launch_verify<float, int8_t, 128, true, false>(VCLA_VERIFY_ARGS);
  return is_bf16 ? launch_verify<__nv_bfloat16, __nv_bfloat16, 128, true, false>(VCLA_VERIFY_ARGS)
                 : launch_verify<float, float, 128, true, false>(VCLA_VERIFY_ARGS);
#undef VCLA_VERIFY_ARGS
}

// B6: one layer's pools (NB, BS, Nkv, head_dim), read only.
int vcla_paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                      const void* lens, const void* ks_pool, const void* vs_pool, void* out,
                      int B, int N, int Nkv, int NB, int BS, int max_blocks, int head_dim,
                      int is_bf16, int kv_int8, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  void* kp = const_cast<void*>(k_pool);  // never written without the append
  void* vp = const_cast<void*>(v_pool);
  void* ks = const_cast<void*>(ks_pool);
  void* vs = const_cast<void*>(vs_pool);
#define VCLA_DECODE_ARGS \
  q, nullptr, nullptr, kp, vp, tables, lens, nullptr, nullptr, ks, vs, out, B, 1, N, Nkv, NB, \
      BS, max_blocks, 0, scale, st
  if (kv_int8)
    return is_bf16 ? launch_verify<__nv_bfloat16, int8_t, 128, false, true>(VCLA_DECODE_ARGS)
                   : launch_verify<float, int8_t, 128, false, true>(VCLA_DECODE_ARGS);
  return is_bf16 ? launch_verify<__nv_bfloat16, __nv_bfloat16, 128, false, true>(VCLA_DECODE_ARGS)
                 : launch_verify<float, float, 128, false, true>(VCLA_DECODE_ARGS);
#undef VCLA_DECODE_ARGS
}

const char* vcla_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
