// Paged attention over a block-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the paged serving engine
// (visualcla_tpu/ops/pallas/paged_attention.py):
//   paged_append_kernel  <- paged_append_attention -> _append_kernel   (B4)
//   paged_verify_mma_kernel (bf16 and int8 pools) or paged_verify_fma_kernel
//   <kAppend=true> (f32 pools), then paged_combine_kernel
//                        <- paged_verify_attention -> _verify_kernel   (B5)
//   paged_verify_fma_kernel<kAppend=false, kExact=true>, then
//   paged_combine_kernel <- paged_decode_attention -> _paged_kernel    (B6)
//
// B4 is described first; B5 and B6 share one split-KV structure, described
// above its kernels.
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
//   B * Nkv blocks; splitting the context across blocks (B5 and B6 below
//   have it), cp.async/TMA and CUDA graphs are later work for B4.
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
// 0), and query j attends over the slots <= base + j that the table covers.
// The numerics follow the TPU kernel: the new tokens go through the same path
// as the old ones (they are part of the block content there), so their
// probabilities are rounded to the compute type too, unlike B4's analytic
// new-token term.
//
// B6, decode without an append: Sq = 1, one layer's pool, lens counting every
// token (query 0 attends over the slots <= lens - 1), and kExact: all
// arithmetic in f32, q * scale and p not rounded.
//
// Split-KV, B1's pattern: the grid is (kv head x query tile, row, split); a
// split takes a fixed run of kVerifyRun slots of its row's table and serves
// the query rows of its tile (row r of the group is query r / rep of head r %
// rep, rep = N / Nkv) from one read of them.  The split count is a function
// of the table width (max_blocks * BS) alone, never of lens, which live on
// the device: a captured call stays valid as rows grow, and a split whose run
// starts past the row's context leaves at once.  Each split writes its
// partial (acc, m, l) per query row to fp32 scratch, and paged_combine_kernel
// (a programmatic dependent launch) merges the row's active splits in split
// order: nothing is atomic, so a call repeats bit for bit and a row does not
// depend on the batch it sits in.
// The append without a race: every split takes the slots >= base from k_new
// / v_new (and ksn / vsn), never from the pool (the TPU kernel's
// ``substituted``); split 0 of query tile 0 alone writes the row's kv-head
// slice of the new tokens into the pool; so no block reads a pool slot that
// any block writes.  Parked rows (lens Sq, a zeroed table) write dummy block
// 0, and their outputs are dropped.
//
// Two split kernels.  paged_verify_mma_kernel (B5 on bf16 and int8 pools):
// the compute type is bf16, so both products run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with no change of numerics:
// q * scale rounded to bf16 is the A operand of Q K^T, p * vs rounded to bf16
// the A operand of P V; the rep * Sq query rows of a group fill m16 tiles
// (one tile a block; MHA at Sq 5 uses 5 of its 16 rows: wgmma's m64 would
// waste more).  Each warp gathers its own 32-slot chunks of the run through
// the table by 16-byte cp.async into shared memory (all chunks of the run in
// flight at once; a token's head slice is 256 contiguous bytes), int8 chunks
// are converted exactly to bf16 there, K feeds ldmatrix, V ldmatrix.trans;
// the warps run their own online softmax and merge in warp order.  int8: ks
// scales the fp32 score after the dot, vs the p before its rounding, the
// denominator sums the unscaled p.  paged_verify_fma_kernel (B5 on f32 pools,
// and B6): fp32 FMAs (TF32 would break the 1e-4 checks), 32-token tiles of
// the run, one token per lane in the softmax.  What bounds them on the card:
// the bytes of the rows' context, as B4.
#ifndef VCLA_VERIFY_RUN
#define VCLA_VERIFY_RUN 128
#endif
constexpr int kVerifyRun = VCLA_VERIFY_RUN;  // kv slots a split
constexpr int kChunk = 32;                   // slots a warp gathers at once
static_assert(kVerifyRun % kChunk == 0, "a run is whole 32-slot chunks");
constexpr int kRunChunks = kVerifyRun / kChunk;  // chunk i of a run goes to warp i % kWarps
constexpr int kChunksPerWarp = (kRunChunks + kWarps - 1) / kWarps;

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The append: the row's kv-head slice of its Sq new tokens (and their
// scales) into the pool, 16 bytes a thread at a time.
template <typename KV, int HD>
__device__ __forceinline__ void append_new_tokens(const KV* k_new, const KV* v_new, KV* k_pool,
                                                  KV* v_pool, const int* table, const float* ksn,
                                                  const float* vsn, float* ks_pool,
                                                  float* vs_pool, int b, int kvh, int base,
                                                  int Sq, int Nkv, int BS, int max_blocks,
                                                  long long layer_rows) {
  constexpr int kVec = 16 / sizeof(KV);  // elements of a 16-byte piece
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < Sq * kPieces; i += kThreads) {
    const int j = i / kPieces, e = (i % kPieces) * kVec;
    const int slot = base + j;
    const bool in_table = slot >= 0 && slot / BS < max_blocks;
    const long long row =
        layer_rows + (in_table ? (long long)table[slot / BS] * BS + slot % BS : 0);
    const size_t src = ((size_t)(b * Sq + j) * Nkv + kvh);
    const long long dst = row * Nkv * HD + (long long)kvh * HD + e;
    *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src * HD + e);
    *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src * HD + e);
    if (kQuantKV<KV> && e == 0) {
      ks_pool[row * Nkv + kvh] = ksn[src];
      vs_pool[row * Nkv + kvh] = vsn[src];
    }
  }
}

// Where slot ``j`` of row b's context lives for kv head kvh: the pool row
// (>= 0) or new token n as -2 - n (slots >= base, with the append).
__device__ __forceinline__ long long slot_source(const int* table, int j, int base, int BS,
                                                 long long layer_rows, bool substitute) {
  if (substitute && j >= base) return -2 - (long long)(j - base);
  return layer_rows + (long long)table[j / BS] * BS + j % BS;
}

// Shared memory of the mma kernel: a query tile of 16 rows (bf16), then per
// warp the K and V of its chunks in bf16 (rows padded to 272 bytes, so
// ldmatrix's eight rows fall in distinct banks), int8 chunks as they land
// (rows of 144 bytes), and per chunk slot the int8 scales.
template <typename KV, int HD>
struct VerifySmem {
  static constexpr bool kQuant = kQuantKV<KV>;
  static constexpr int kRowBytes = HD * 2 + 16;
  static constexpr int kRawRow = HD + 16;
  static constexpr int kQBytes = 16 * kRowBytes;
  static constexpr int kChunkBytes = 2 * kChunk * kRowBytes;  // K then V, bf16
  static constexpr int kRawChunkBytes = kQuant ? 2 * kChunk * kRawRow : 0;
  static constexpr int kScaleBytes = kQuant ? 2 * kChunk * 4 : 0;
  static constexpr int kWarpBytes = (kQuant ? 1 : kChunksPerWarp) * kChunkBytes +
                                    kChunksPerWarp * (kRawChunkBytes + kScaleBytes);
  static constexpr int kBytes = kQBytes + kWarps * kWarpBytes;
  static constexpr int kMergeBytes = kWarps * 16 * (HD + 2) * 4;
  static constexpr int kAlloc = kBytes > kMergeBytes ? kBytes : kMergeBytes;
};

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
paged_verify_mma_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                        const KV* __restrict__ v_new, KV* k_pool, KV* v_pool,
                        const int* __restrict__ tables, const int* __restrict__ lens,
                        const float* __restrict__ ksn, const float* __restrict__ vsn,
                        float* ks_pool, float* vs_pool, float* __restrict__ part, int N,
                        int Nkv, int Sq, int NB, int BS, int max_blocks, int layer, int splits,
                        float scale) {
  using L = VerifySmem<KV, HD>;
  constexpr int kKSteps = HD / 16;
  launch_dependents();
  const int rep = N / Nkv;
  const int R = rep * Sq;
  const int tiles = (R + 15) / 16;
  const int kvh = blockIdx.x / tiles, mt = blockIdx.x % tiles;
  const int b = blockIdx.y, split = blockIdx.z;
  const int length = lens[b];
  const int base = length - Sq;
  const int ctx = min(length, max_blocks * BS);  // the slots the table covers
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;
  const int j_begin = split * kVerifyRun;
  if (split == 0 && mt == 0)
    append_new_tokens<KV, HD>(k_new, v_new, k_pool, v_pool, table, ksn, vsn, ks_pool, vs_pool, b,
                              kvh, base, Sq, Nkv, BS, max_blocks, layer_rows);
  if (j_begin >= ctx) return;

  extern __shared__ __align__(16) uint8_t vsmem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, quad = lane % 4;
  const int KVL = Nkv * HD;
  uint8_t* wsm = vsmem + L::kQBytes + warp * L::kWarpBytes;
  uint8_t* raw = wsm + (L::kQuant ? 1 : kChunksPerWarp) * L::kChunkBytes;  // int8 chunks, scales

  // this warp's chunks: its c-th covers slots j_begin + (warp + kWarps c) * 32 ...
  for (int c = 0; c < kChunksPerWarp; ++c) {
    const int ci = warp + kWarps * c;
    const int j0 = j_begin + ci * kChunk;
    const int j = j0 + lane;
    const bool in = ci < kRunChunks && j < ctx;
    const long long src = in ? slot_source(table, j, base, BS, layer_rows, true) : 0;
    const KV* k_src = src >= 0 ? k_pool + src * KVL + (long long)kvh * HD
                               : k_new + ((size_t)(b * Sq) + (-2 - src)) * KVL + (size_t)kvh * HD;
    const KV* v_src = src >= 0 ? v_pool + src * KVL + (long long)kvh * HD
                               : v_new + ((size_t)(b * Sq) + (-2 - src)) * KVL + (size_t)kvh * HD;
    constexpr int kPieces = HD * sizeof(KV) / 16;  // 16-byte pieces of a token's head slice
    constexpr int kTokensAtOnce = 32 / kPieces;
    const uint32_t dst = smem_u32(L::kQuant ? raw + c * (L::kRawChunkBytes + L::kScaleBytes)
                                            : wsm + c * L::kChunkBytes);
    constexpr int kDstRow = L::kQuant ? L::kRawRow : L::kRowBytes;
    constexpr int kVOff = kChunk * kDstRow;
#pragma unroll 4
    for (int t0 = 0; t0 < kChunk; t0 += kTokensAtOnce) {
      const int t = t0 + lane / kPieces, p = lane % kPieces;
      const bool ok = __shfl_sync(0xffffffffu, in, t);
      const KV* ks = reinterpret_cast<const KV*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(k_src), t));
      const KV* vs = reinterpret_cast<const KV*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(v_src), t));
      cp_async16(dst + t * kDstRow + p * 16, reinterpret_cast<const uint8_t*>(ks) + p * 16, ok);
      cp_async16(dst + kVOff + t * kDstRow + p * 16, reinterpret_cast<const uint8_t*>(vs) + p * 16,
                 ok);
    }
    if (L::kQuant) {  // the slot's scales, next to the chunk
      float* sc = reinterpret_cast<float*>(raw + c * (L::kRawChunkBytes + L::kScaleBytes) +
                                           L::kRawChunkBytes);
      float kscale = 0.f, vscale = 0.f;
      if (in) {
        const size_t si = src >= 0 ? (size_t)src * Nkv + kvh
                                   : ((size_t)(b * Sq) + (-2 - src)) * Nkv + kvh;
        kscale = src >= 0 ? ks_pool[si] : ksn[si];
        vscale = src >= 0 ? vs_pool[si] : vsn[si];
      }
      sc[lane] = kscale;
      sc[kChunk + lane] = vscale;
    }
    cp_async_commit();
  }

  // the query tile: q * scale rounded to bf16; rows past R are zeros
  for (int i = threadIdx.x; i < 16 * (HD / 2); i += kThreads) {
    const int r = i / (HD / 2), e = (i % (HD / 2)) * 2;
    const int rr = mt * 16 + r;
    uint32_t v = 0u;
    if (rr < R) {
      const T* qp = q + ((size_t)(b * Sq + rr / rep) * N + kvh * rep + rr % rep) * HD + e;
      v = bf16x2(to_f32(qp[0]) * scale, to_f32(qp[1]) * scale);
    }
    *reinterpret_cast<uint32_t*>(vsmem + r * L::kRowBytes + e * 2) = v;
  }
  __syncthreads();
  uint32_t qa[kKSteps][4];  // A fragments of Q, all of hd
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(vsmem + ((lane / 8) % 2 * 8 + lane % 8) * L::kRowBytes +
                                 (kk * 16 + (lane / 16) * 8) * 2));

  // this thread's rows g and g + 8 of the tile: the last slot each may see
  const int r_lo = mt * 16 + g, r_hi = r_lo + 8;
  const int see_lo = r_lo < R ? min(base + r_lo / rep, ctx - 1) : -1;
  const int see_hi = r_hi < R ? min(base + r_hi / rep, ctx - 1) : -1;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int c = 0; c < kChunksPerWarp; ++c) {
    const int ci = warp + kWarps * c;
    const int j0 = j_begin + ci * kChunk;
    // every chunk's copies were issued up front: wait for this one's group
    if (kChunksPerWarp == 1) cp_async_wait<0>();
    else if (c == 0) cp_async_wait<kChunksPerWarp - 1>();
    else cp_async_wait<0>();
    __syncwarp();
    if (ci >= kRunChunks || j0 >= ctx) break;  // uniform over the warp
    uint8_t* tile = wsm + (L::kQuant ? 0 : c * L::kChunkBytes);
    const float* sc = nullptr;
    if constexpr (L::kQuant) {  // int8 -> bf16 (exact) into the operand rows
      const uint8_t* rc = raw + c * (L::kRawChunkBytes + L::kScaleBytes);
      sc = reinterpret_cast<const float*>(rc + L::kRawChunkBytes);
      for (int i = lane; i < 2 * kChunk * (HD / 16); i += 32) {
        const int row = i / (HD / 16), p = i % (HD / 16);  // row < 32: K, else V
        const uint4 in = *reinterpret_cast<const uint4*>(rc + row * L::kRawRow + p * 16);
        const uint32_t w[4] = {in.x, in.y, in.z, in.w};
        uint32_t outw[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t word = w[e / 2] >> (16 * (e % 2));
          outw[e] = bf16x2((float)(int8_t)(word & 0xff), (float)(int8_t)((word >> 8) & 0xff));
        }
        uint8_t* d = tile + row * L::kRowBytes + p * 32;
        *reinterpret_cast<uint4*>(d) = make_uint4(outw[0], outw[1], outw[2], outw[3]);
        *reinterpret_cast<uint4*>(d + 16) = make_uint4(outw[4], outw[5], outw[6], outw[7]);
      }
      __syncwarp();
    }
    const uint32_t k_base = smem_u32(tile);
    const uint32_t v_base = k_base + kChunk * L::kRowBytes;

    // S = Q K^T: 16 rows x 32 slots, four n8 tiles
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2) {
        uint32_t kb[4];  // (slots 8 nt .., hd 16 kk ..): b0 b1 of kk, then of kk + 1
        ldmatrix_x4(kb, k_base + (nt * 8 + lane % 8) * L::kRowBytes + (kk * 16 + (lane / 8) * 8) * 2);
        mma_bf16(s[nt], qa[kk], kb[0], kb[1]);
        mma_bf16(s[nt], qa[kk + 1], kb[2], kb[3]);
      }
    }
    // s[nt][e] is (row g, slot 8 nt + 2 quad + e), s[nt][2 + e] row g + 8
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * quad + e;
        const int j = j0 + col;
        const float ksc = L::kQuant ? sc[col] : 1.f;
        s[nt][e] = j <= see_lo ? s[nt][e] * ksc : kNegInf;
        s[nt][2 + e] = j <= see_hi ? s[nt][2 + e] * ksc : kNegInf;
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
    uint32_t pa[2][4];  // P as the A operand of P V: k-step ks covers slots 16 ks ..
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * quad + e;
        const int j = j0 + col;
        p[e] = j <= see_lo ? expf(s[nt][e] - m_lo) : 0.f;
        p[2 + e] = j <= see_hi ? expf(s[nt][2 + e] - m_hi) : 0.f;
        l_lo += p[e];
        l_hi += p[2 + e];
        if (L::kQuant) {
          const float vsc = sc[kChunk + col];
          p[e] *= vsc;
          p[2 + e] *= vsc;
        }
      }
      pa[nt / 2][2 * (nt % 2)] = bf16x2(p[0], p[1]);      // row g
      pa[nt / 2][2 * (nt % 2) + 1] = bf16x2(p[2], p[3]);  // row g + 8
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= a_lo;
      o[i][1] *= a_lo;
      o[i][2] *= a_hi;
      o[i][3] *= a_hi;
    }
    // O += P V: two k-steps of 16 slots, HD / 8 n8 tiles, V through ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; nt += 2) {
        uint32_t vb[4];  // b0 b1 of hd tile nt, then of nt + 1
        ldmatrix_x4_trans(vb, v_base + (ks * 16 + (lane / 8) % 2 * 8 + lane % 8) * L::kRowBytes +
                                  (nt * 8 + (lane / 16) * 8) * 2);
        mma_bf16(o[nt], pa[ks], vb[0], vb[1]);
        mma_bf16(o[nt + 1], pa[ks], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();  // a warp that left its chunks early still has copies in flight
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

  // merge the warps in warp order through shared memory, write the partial
  __syncthreads();  // every warp is done with its tiles
  float* mg = reinterpret_cast<float*>(vsmem) + warp * 16 * (HD + 2);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + 2 * quad;
    mg[g * (HD + 2) + col] = o[i][0];
    mg[g * (HD + 2) + col + 1] = o[i][1];
    mg[(g + 8) * (HD + 2) + col] = o[i][2];
    mg[(g + 8) * (HD + 2) + col + 1] = o[i][3];
  }
  if (quad == 0) {
    mg[g * (HD + 2) + HD] = m_lo;
    mg[g * (HD + 2) + HD + 1] = l_lo;
    mg[(g + 8) * (HD + 2) + HD] = m_hi;
    mg[(g + 8) * (HD + 2) + HD + 1] = l_hi;
  }
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(vsmem);
  for (int i = threadIdx.x; i < 16 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int rr = mt * 16 + r;
    if (rr >= R) break;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, all[(w * 16 + r) * (HD + 2) + HD]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* src = all + (w * 16 + r) * (HD + 2);
      const float c = expf(src[HD] - m_all);
      l_all += src[HD + 1] * c;
      a_all += src[d] * c;
    }
    float* dst = part + ((((size_t)b * Nkv + kvh) * R + rr) * splits + split) * (HD + 2);
    dst[d] = a_all;
    if (d == 0) {
      dst[HD] = m_all;
      dst[HD + 1] = l_all;
    }
  }
}

// The FMA split kernel (B5 on f32 pools; B6 on every pool): B4's tile walk
// over the split's run, all R query rows of the group in one block.
template <typename T, typename KV, int HD, bool kAppend, bool kExact>
__global__ void __launch_bounds__(kThreads)
paged_verify_fma_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                        const KV* __restrict__ v_new, KV* k_pool, KV* v_pool,
                        const int* __restrict__ tables, const int* __restrict__ lens,
                        const float* __restrict__ ksn, const float* __restrict__ vsn,
                        float* ks_pool, float* vs_pool, float* __restrict__ part, int N,
                        int Nkv, int Sq, int NB, int BS, int max_blocks, int layer, int splits,
                        float scale) {
  static_assert(HD == 128, "four elements of a K row a lane, one V column a thread");
  constexpr int kPerLane = HD / 32;
  launch_dependents();
  const int kvh = blockIdx.x;
  const int b = blockIdx.y, split = blockIdx.z;
  const int rep = N / Nkv;
  const int R = rep * Sq;  // query rows of the group
  const int KVL = Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = threadIdx.x;

  const int length = lens[b];
  const int base = length - Sq;  // slot of new token 0
  const int ctx = min(length, max_blocks * BS);
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;
  const int j_begin = split * kVerifyRun;
  if (kAppend && split == 0)
    append_new_tokens<KV, HD>(k_new, v_new, k_pool, v_pool, table, ksn, vsn, ks_pool, vs_pool, b,
                              kvh, base, Sq, Nkv, BS, max_blocks, layer_rows);
  if (j_begin >= ctx) return;
  const int j_end = min(ctx, j_begin + kVerifyRun);

  extern __shared__ float smem[];
  float* q_sh = smem;                // R x HD: q * scale (rounded unless kExact)
  float* acc_sh = q_sh + R * HD;     // R x HD
  float* p_sh = acc_sh + R * HD;     // R x kTile: scores, then p * vs
  float* m_sh = p_sh + R * kTile;    // R
  float* l_sh = m_sh + R;            // R
  float* alpha_sh = l_sh + R;        // R

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
  __syncthreads();

  // token j0 + lane's source: a pool row, a new token (-2 - n), or -1 past the run
  auto source = [&](int j0) -> long long {
    const int j = j0 + lane;
    return j < j_end ? slot_source(table, j, base, BS, layer_rows, kAppend) : -1;
  };
  auto k_row = [&](long long src) -> const KV* {
    return src >= 0 ? k_pool + src * KVL + (long long)kvh * HD
                    : k_new + ((size_t)(b * Sq) + (-2 - src)) * KVL + (size_t)kvh * HD;
  };
  auto v_row = [&](long long src) -> const KV* {
    return src >= 0 ? v_pool + src * KVL + (long long)kvh * HD
                    : v_new + ((size_t)(b * Sq) + (-2 - src)) * KVL + (size_t)kvh * HD;
  };
  auto load = [&](long long my_src, float (&kr)[kTokensPerWarp][kPerLane], float (&vr)[kTile]) {
#pragma unroll
    for (int i = 0; i < kTokensPerWarp; ++i) {
      const long long src = __shfl_sync(0xffffffffu, my_src, warp + kWarps * i);
      if (src != -1) {
        load4(k_row(src) + lane * 4, kr[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const long long src = __shfl_sync(0xffffffffu, my_src, jj);
      vr[jj] = (d < HD && src != -1) ? to_f32(v_row(src)[d]) : 0.f;
    }
  };

  const int n_tiles = (j_end - j_begin + kTile - 1) / kTile;
  float k_cur[kTokensPerWarp][kPerLane], v_cur[kTile];
  long long src_cur = source(j_begin);
  load(src_cur, k_cur, v_cur);
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = j_begin + t * kTile;
    const bool more = t + 1 < n_tiles;
    float k_nxt[kTokensPerWarp][kPerLane], v_nxt[kTile];
    long long src_nxt = -1;
    if (more) {
      src_nxt = source(j0 + kTile);
      load(src_nxt, k_nxt, v_nxt);
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
      if (kQuantKV<KV> && src_cur != -1) {
        const size_t si = src_cur >= 0 ? (size_t)src_cur * Nkv + kvh
                                       : ((size_t)(b * Sq) + (-2 - src_cur)) * Nkv + kvh;
        k_sc = src_cur >= 0 ? ks_pool[si] : ksn[si];
        v_sc = src_cur >= 0 ? vs_pool[si] : vsn[si];
      }
      for (int r = warp; r < R; r += kWarps) {
        const bool ok = src_cur != -1 && slot <= base + r / rep;
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
      src_cur = src_nxt;
    }
  }

  for (int r = 0; r < R; ++r) {
    float* dst = part + ((((size_t)b * Nkv + kvh) * R + r) * splits + split) * (HD + 2);
    if (d < HD) dst[d] = acc_sh[r * HD + d];
    if (d == 0) {
      dst[HD] = m_sh[r];
      dst[HD + 1] = l_sh[r];
    }
  }
}

// One (query j, head n) of row b: the row's active splits combined in split
// order (a row with nothing to attend over gives zeros).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ lens,
                     T* __restrict__ out, int N, int Nkv, int Sq, int BS, int max_blocks,
                     int splits) {
  const int jn = blockIdx.x;  // j * N + n
  const int j = jn / N, n = jn % N;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int rep = N / Nkv;
  const int kvh = n / rep, r = j * rep + n % rep;
  const int ctx = min(lens[b], max_blocks * BS);
  const int active = ctx <= 0 ? 0 : (ctx - 1) / kVerifyRun + 1;
  const float* p0 = part + ((((size_t)b * Nkv + kvh) * (rep * Sq) + r) * splits) * (HD + 2);
  wait_for_primary();
  float m_all = kNegInf;
  for (int s = 0; s < active; ++s) m_all = fmaxf(m_all, p0[s * (HD + 2) + HD]);
  float l_all = 0.f, a_all = 0.f;
  for (int s = 0; s < active; ++s) {
    const float* p = p0 + s * (HD + 2);
    const float c = expf(p[HD] - m_all);
    l_all += p[HD + 1] * c;
    a_all += p[d] * c;
  }
  out[((size_t)b * Sq * N + jn) * HD + d] = from_f32<T>(a_all / (l_all == 0.f ? 1.f : l_all));
}

// the split kernel for (T, KV, kAppend, kExact): tensor cores for B5 on a
// bf16 or int8 pool, fp32 FMAs otherwise
template <typename T, typename KV, int HD, bool kAppend, bool kExact>
cudaError_t launch_split(const void* q, const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, const void* tables, const void* lens, const void* ksn,
                         const void* vsn, void* ks_pool, void* vs_pool, void* out, float* part,
                         int B, int Sq, int N, int Nkv, int NB, int BS, int max_blocks,
                         int layer, int splits, float scale, cudaStream_t stream) {
  constexpr bool kTensor = kAppend && !kExact && sizeof(KV) <= 2;
  const int rep = N / Nkv;
  const int R = rep * Sq;
  auto kernel = [] {
    if constexpr (kTensor) return paged_verify_mma_kernel<T, KV, HD>;
    else return paged_verify_fma_kernel<T, KV, HD, kAppend, kExact>;
  }();
  size_t smem;
  if constexpr (kTensor) smem = VerifySmem<KV, HD>::kAlloc;
  else smem = sizeof(float) * (2 * (size_t)R * HD + (size_t)R * kTile + 3 * R);
  static size_t allowed = 48 * 1024;  // raised once per size: stays out of graph capture
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(kTensor ? Nkv * ((R + 15) / 16) : Nkv, B, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_new), static_cast<const KV*>(v_new),
      static_cast<KV*>(k_pool), static_cast<KV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const float*>(ksn),
      static_cast<const float*>(vsn), static_cast<float*>(ks_pool),
      static_cast<float*>(vs_pool), part, N, Nkv, Sq, NB, BS, max_blocks, layer, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the combine's launch overlaps the split kernel (it waits inside for its partials)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Sq * N, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, HD>, static_cast<const float*>(part),
                            static_cast<const int*>(lens), static_cast<T*>(out), N, Nkv, Sq, BS,
                            max_blocks, splits);
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

// kv slots a B5 / B6 split: a table max_blocks * BS slots wide makes
// ceil(width / run) splits, and the caller allocates scratch (B, Nkv,
// N / Nkv * Sq, splits, head_dim + 2) f32
int vcla_paged_run() { return kVerifyRun; }

// B5: the pools are (L, NB, BS, Nkv * head_dim) and updated in place; two
// launches (splits, combine)
int vcla_paged_verify(const void* q, const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const void* tables, const void* lens, const void* ksn,
                      const void* vsn, void* ks_pool, void* vs_pool, void* out, void* scratch,
                      int B, int Sq, int N, int Nkv, int NB, int BS, int max_blocks, int layer,
                      int head_dim, int is_bf16, int kv_int8, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int splits = (max_blocks * BS + kVerifyRun - 1) / kVerifyRun;
  float* part = static_cast<float*>(scratch);
#define VCLA_VERIFY_ARGS                                                                        \
  q, k_new, v_new, k_pool, v_pool, tables, lens, ksn, vsn, ks_pool, vs_pool, out, part, B, Sq, \
      N, Nkv, NB, BS, max_blocks, layer, splits, scale, st
  if (kv_int8)
    return is_bf16 ? launch_split<__nv_bfloat16, int8_t, 128, true, false>(VCLA_VERIFY_ARGS)
                   : launch_split<float, int8_t, 128, true, false>(VCLA_VERIFY_ARGS);
  return is_bf16 ? launch_split<__nv_bfloat16, __nv_bfloat16, 128, true, false>(VCLA_VERIFY_ARGS)
                 : launch_split<float, float, 128, true, false>(VCLA_VERIFY_ARGS);
#undef VCLA_VERIFY_ARGS
}

// B6: one layer's pools (NB, BS, Nkv, head_dim), read only; two launches
int vcla_paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                      const void* lens, const void* ks_pool, const void* vs_pool, void* out,
                      void* scratch, int B, int N, int Nkv, int NB, int BS, int max_blocks,
                      int head_dim, int is_bf16, int kv_int8, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int splits = (max_blocks * BS + kVerifyRun - 1) / kVerifyRun;
  float* part = static_cast<float*>(scratch);
  void* kp = const_cast<void*>(k_pool);  // never written without the append
  void* vp = const_cast<void*>(v_pool);
  void* ks = const_cast<void*>(ks_pool);
  void* vs = const_cast<void*>(vs_pool);
#define VCLA_DECODE_ARGS                                                                      \
  q, nullptr, nullptr, kp, vp, tables, lens, nullptr, nullptr, ks, vs, out, part, B, 1, N, Nkv, \
      NB, BS, max_blocks, 0, splits, scale, st
  if (kv_int8)
    return is_bf16 ? launch_split<__nv_bfloat16, int8_t, 128, false, true>(VCLA_DECODE_ARGS)
                   : launch_split<float, int8_t, 128, false, true>(VCLA_DECODE_ARGS);
  return is_bf16 ? launch_split<__nv_bfloat16, __nv_bfloat16, 128, false, true>(VCLA_DECODE_ARGS)
                 : launch_split<float, float, 128, false, true>(VCLA_DECODE_ARGS);
#undef VCLA_DECODE_ARGS
}

const char* vcla_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
