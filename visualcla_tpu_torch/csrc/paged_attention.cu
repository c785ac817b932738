// Paged attention over a block-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the paged serving engine
// (visualcla_tpu/ops/pallas/paged_attention.py):
//   paged_verify_mma_kernel<kAppendDecode> (bf16 and int8 pools) or
//   paged_verify_fma_kernel<kAppendDecode> (f32 pools), then
//   paged_append_combine_kernel
//                        <- paged_append_attention -> _append_kernel   (B4)
//   paged_verify_mma_kernel<kVerify> (bf16 and int8 pools) or
//   paged_verify_fma_kernel<kVerify> (f32 pools), then paged_combine_kernel
//                        <- paged_verify_attention -> _verify_kernel   (B5)
//   paged_verify_fma_kernel<kDecode>, then
//   paged_combine_kernel <- paged_decode_attention -> _paged_kernel    (B6)
//
// The three share one split-KV structure, described above the kernels.
//
// B4's contract (the TPU kernel's):
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
//   new token is one analytic online-softmax term in fp32 (its p * v not
//   rounded); the softmax is fp32.
//
// What bounds it on the card, and what the design does about it: decode
// attention reads every old K/V byte of the rows once and does two
// multiply-adds per byte pair: it is bound by bytes.  B4 is B5's split
// kernel at one query a row over the old context (lens - 1 slots, none
// taken from k_new): the context is cut into runs over many blocks, each
// warp gathers 32-slot chunks by 16-byte cp.async, the products run on the
// tensor cores (bf16 and int8 pools), and the combine launch merges the runs
// in split order and then folds in the new token's analytic term, so a row
// with no old context (a parked row, lens 1) gives v_new.  The append goes
// where blk / off say (never through the table); one block of the row and
// kv head writes it, and no block reads that slot (every read is below
// lens - 1), so the append races with no read.  The TPU kernel's
// block-diagonal query matrix, its sequential grid carrying m/l/acc, and
// scalar prefetch are answers to the TPU and are not carried over.
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
// B4 (kAppendDecode), decode with the append: Sq = 1 over the lens - 1 old
// slots, none taken from k_new; the new token is appended at blk / off and
// folded in by paged_append_combine_kernel as one analytic fp32 term.
//
// Split-KV, B1's pattern: the grid is (kv head x query tile, row, split
// block); a split takes a fixed run of kVerifyRun slots of its row's table
// and serves the query rows of its tile (row r of the group is query r / rep
// of head r % rep, rep = N / Nkv) from one read of them.  The split count is
// a function of the table width (max_blocks * BS) alone, never of lens,
// which live on the device: a captured call stays valid as rows grow.  The
// grid's third axis holds at most enough blocks to fill the card a few
// times over (from the table width, the rows and the SMs, never lens): block
// z takes splits z, z + gridDim.z, ... in turn and leaves at the first whose
// run starts past its row's context, so a wide table with short rows (the
// serving pool: 2048 slots, rows of a few hundred) does not launch a block
// for every empty run.  Each split writes its partial (acc, m, l) per query
// row to fp32 scratch, and the combine (a programmatic dependent launch)
// merges the row's active splits in split order: nothing is atomic, so a
// call repeats bit for bit and a row does not depend on the batch it sits in.
// The append without a race: B5's splits take the slots >= base from k_new /
// v_new (and ksn / vsn), never from the pool (the TPU kernel's
// ``substituted``), B4's read only slots below lens - 1; split 0 of query
// tile 0 alone writes the row's kv-head slice of the new tokens into the
// pool; so no block reads a pool slot that any block writes.  Parked rows
// (B5: lens Sq, a zeroed table; B4: lens 1, blk 0) write dummy block 0, and
// their outputs are dropped.
//
// Two split kernels.  paged_verify_mma_kernel (B4 and B5 on bf16 and int8
// pools): the compute type is bf16, so both products run on the tensor cores
// as mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with no change of numerics:
// q * scale rounded to bf16 is the A operand of Q K^T, p * vs rounded to bf16
// the A operand of P V; the rep * Sq query rows of a group fill m16 tiles
// (one tile a block; MHA at Sq 5 uses 5 of its 16 rows, B4 at MHA 1: the
// kernel is bound by bytes, and wgmma's m64 would waste more).  Each warp
// gathers its own 32-slot chunks of the run through the table by 16-byte
// cp.async into shared memory (all chunks of the run in flight at once; a
// token's head slice is 256 contiguous bytes), int8 chunks are converted
// exactly to bf16 there, K feeds ldmatrix, V ldmatrix.trans; the warps run
// their own online softmax and merge in warp order.  int8: ks scales the
// fp32 score after the dot, vs the p before its rounding, the denominator
// sums the unscaled p.  paged_verify_fma_kernel (B4 and B5 on f32 pools, and
// B6): fp32 FMAs (TF32 would break the 1e-4 checks), 32-token tiles of the
// run, one token per lane in the softmax; on an f32 pool B4's arithmetic is
// B6's over lens - 1 slots (rounding to f32 changes nothing), so the f32
// parity path shares this kernel instead of keeping one of its own.  What
// bounds them on the card: the bytes of the rows' context.
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

// What a split kernel computes: B5 (Sq new tokens among the slots, appended
// through the table), B6 (no append, all f32) or B4 (the lens - 1 old slots;
// the new token appended at blk / off and folded in by the combine).
enum Mode { kVerify, kDecode, kAppendDecode };

// The append: the row's kv-head slice of its Sq new tokens (and their
// scales) into the pool, 16 bytes a thread at a time: B5's at slots base + j
// of the table (a slot past it at dummy block 0, offset 0), B4's (Sq 1) at
// blk[b], off[b].
template <typename KV, int HD, Mode M>
__device__ __forceinline__ void append_new_tokens(const KV* k_new, const KV* v_new, KV* k_pool,
                                                  KV* v_pool, const int* table, const int* blk,
                                                  const int* off, const float* ksn,
                                                  const float* vsn, float* ks_pool,
                                                  float* vs_pool, int b, int kvh, int base,
                                                  int Sq, int Nkv, int BS, int max_blocks,
                                                  long long layer_rows) {
  constexpr int kVec = 16 / sizeof(KV);  // elements of a 16-byte piece
  constexpr int kPieces = HD / kVec;
  for (int i = threadIdx.x; i < Sq * kPieces; i += kThreads) {
    const int j = i / kPieces, e = (i % kPieces) * kVec;
    long long row;
    if constexpr (M == kAppendDecode) {
      row = layer_rows + (long long)blk[b] * BS + off[b];
    } else {
      const int slot = base + j;
      const bool in_table = slot >= 0 && slot / BS < max_blocks;
      row = layer_rows + (in_table ? (long long)table[slot / BS] * BS + slot % BS : 0);
    }
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

template <typename T, typename KV, int HD, Mode M>
__global__ void __launch_bounds__(kThreads)
paged_verify_mma_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                        const KV* __restrict__ v_new, KV* k_pool, KV* v_pool,
                        const int* __restrict__ tables, const int* __restrict__ lens,
                        const int* __restrict__ blk, const int* __restrict__ off,
                        const float* __restrict__ ksn, const float* __restrict__ vsn,
                        float* ks_pool, float* vs_pool, float* __restrict__ part, int N,
                        int Nkv, int Sq, int NB, int BS, int max_blocks, int layer, int splits,
                        float scale) {
  static_assert(M != kDecode, "B6 runs on the FMA kernel");
  using L = VerifySmem<KV, HD>;
  constexpr int kKSteps = HD / 16;
  launch_dependents();
  const int rep = N / Nkv;
  const int R = rep * Sq;
  const int tiles = (R + 15) / 16;
  const int kvh = blockIdx.x / tiles, mt = blockIdx.x % tiles;
  const int b = blockIdx.y;
  // B4 attends over the old context only; B5's last Sq slots are its new tokens
  const int length = lens[b] - (M == kAppendDecode ? 1 : 0);
  const int base = M == kAppendDecode ? length : length - Sq;
  const int ctx = min(length, max_blocks * BS);  // the slots the table covers
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;
  if (blockIdx.z == 0 && mt == 0)
    append_new_tokens<KV, HD, M>(k_new, v_new, k_pool, v_pool, table, blk, off, ksn, vsn, ks_pool,
                                 vs_pool, b, kvh, base, Sq, Nkv, BS, max_blocks, layer_rows);

  extern __shared__ __align__(16) uint8_t vsmem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, quad = lane % 4;
  const int KVL = Nkv * HD;
  uint8_t* wsm = vsmem + L::kQBytes + warp * L::kWarpBytes;
  uint8_t* raw = wsm + (L::kQuant ? 1 : kChunksPerWarp) * L::kChunkBytes;  // int8 chunks, scales
  // this thread's rows g and g + 8 of the tile: the last slot each may see
  const int r_lo = mt * 16 + g, r_hi = r_lo + 8;
  const int see_lo = r_lo < R ? min(base + r_lo / rep, ctx - 1) : -1;
  const int see_hi = r_hi < R ? min(base + r_hi / rep, ctx - 1) : -1;
  uint32_t qa[kKSteps][4];  // A fragments of Q, all of hd

  for (int split = blockIdx.z; split < splits; split += gridDim.z) {
  const int j_begin = split * kVerifyRun;
  if (j_begin >= ctx) break;  // uniform over the block; later splits start further on

  // this warp's chunks: its c-th covers slots j_begin + (warp + kWarps c) * 32 ...
  for (int c = 0; c < kChunksPerWarp; ++c) {
    const int ci = warp + kWarps * c;
    const int j0 = j_begin + ci * kChunk;
    const int j = j0 + lane;
    const bool in = ci < kRunChunks && j < ctx;
    const long long src = in ? slot_source(table, j, base, BS, layer_rows, M == kVerify) : 0;
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

  // the query tile (the block's first split): q * scale rounded to bf16; rows
  // past R are zeros
  if (split == (int)blockIdx.z) {
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
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(vsmem + ((lane / 8) % 2 * 8 + lane % 8) * L::kRowBytes +
                                 (kk * 16 + (lane / 16) * 8) * 2));
  }

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
  __syncthreads();  // the merge area holds the next split's chunks
  }
}

// The FMA split kernel (B4 and B5 on f32 pools; B6 on every pool): a walk
// over the split's run in 32-token tiles, all R query rows of the group in
// one block.
template <typename T, typename KV, int HD, Mode M>
__global__ void __launch_bounds__(kThreads)
paged_verify_fma_kernel(const T* __restrict__ q, const KV* __restrict__ k_new,
                        const KV* __restrict__ v_new, KV* k_pool, KV* v_pool,
                        const int* __restrict__ tables, const int* __restrict__ lens,
                        const int* __restrict__ blk, const int* __restrict__ off,
                        const float* __restrict__ ksn, const float* __restrict__ vsn,
                        float* ks_pool, float* vs_pool, float* __restrict__ part, int N,
                        int Nkv, int Sq, int NB, int BS, int max_blocks, int layer, int splits,
                        float scale) {
  static_assert(HD == 128, "four elements of a K row a lane, one V column a thread");
  constexpr int kPerLane = HD / 32;
  constexpr bool kExact = M == kDecode;
  launch_dependents();
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = N / Nkv;
  const int R = rep * Sq;  // query rows of the group
  const int KVL = Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = threadIdx.x;

  const int length = lens[b] - (M == kAppendDecode ? 1 : 0);
  const int base = M == kAppendDecode ? length : length - Sq;  // slot of new token 0
  const int ctx = min(length, max_blocks * BS);
  const int* table = tables + (size_t)b * max_blocks;
  const long long layer_rows = (long long)layer * NB * BS;
  if (M != kDecode && blockIdx.z == 0)
    append_new_tokens<KV, HD, M>(k_new, v_new, k_pool, v_pool, table, blk, off, ksn, vsn, ks_pool,
                                 vs_pool, b, kvh, base, Sq, Nkv, BS, max_blocks, layer_rows);
  if ((int)blockIdx.z * kVerifyRun >= ctx) return;

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
  }

  for (int split = blockIdx.z; split < splits; split += gridDim.z) {
  const int j_begin = split * kVerifyRun;
  if (j_begin >= ctx) break;  // uniform over the block
  const int j_end = min(ctx, j_begin + kVerifyRun);
  for (int i = threadIdx.x; i < R * HD; i += kThreads) acc_sh[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_sh[r] = kNegInf;
    l_sh[r] = 0.f;
  }
  __syncthreads();

  // token j0 + lane's source: a pool row, a new token (-2 - n), or -1 past the run
  auto source = [&](int j0) -> long long {
    const int j = j0 + lane;
    return j < j_end ? slot_source(table, j, base, BS, layer_rows, M == kVerify) : -1;
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
  __syncthreads();  // the next split starts from fresh acc / m / l
  }
}

// The active splits' partials of one query row (p0: its first split's
// entry) merged in split order, for head-dim column d: (m, l, acc[d]).
template <int HD>
__device__ __forceinline__ void merge_splits(const float* p0, int active, int d, float& m_all,
                                             float& l_all, float& a_all) {
  m_all = kNegInf;
  for (int s = 0; s < active; ++s) m_all = fmaxf(m_all, p0[s * (HD + 2) + HD]);
  l_all = 0.f;
  a_all = 0.f;
  for (int s = 0; s < active; ++s) {
    const float* p = p0 + s * (HD + 2);
    const float c = expf(p[HD] - m_all);
    l_all += p[HD + 1] * c;
    a_all += p[d] * c;
  }
}

// the splits of a context of ctx slots that hold any of it
__device__ __forceinline__ int active_splits(int ctx) {
  return ctx <= 0 ? 0 : (ctx - 1) / kVerifyRun + 1;
}

// B5 / B6: one (query j, head n) of row b, the row's active splits combined
// in split order (a row with nothing to attend over gives zeros).
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
  const int active = active_splits(min(lens[b], max_blocks * BS));
  const float* p0 = part + ((((size_t)b * Nkv + kvh) * (rep * Sq) + r) * splits) * (HD + 2);
  wait_for_primary();
  float m_all, l_all, a_all;
  merge_splits<HD>(p0, active, d, m_all, l_all, a_all);
  out[((size_t)b * Sq * N + jn) * HD + d] = from_f32<T>(a_all / (l_all == 0.f ? 1.f : l_all));
}

// B4: head n of row b, the row's active splits of its old context combined
// in split order, then the new token as one analytic online-softmax term in
// fp32 (the plain version's order): sn = sum_d qs[d] kn[d] (times ksn), pn =
// exp(sn - m), the denominator takes the unscaled pn, the output pn * vsn *
// vn unrounded.  A row with no old context (lens 1: parked rows) gives
// v_new (times vsn).  q, k_new and v_new are read before the wait: the split
// kernel does not write them.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(HD)
paged_append_combine_kernel(const float* __restrict__ part, const T* __restrict__ q,
                            const KV* __restrict__ k_new, const KV* __restrict__ v_new,
                            const float* __restrict__ ksn, const float* __restrict__ vsn,
                            const int* __restrict__ lens, T* __restrict__ out, int N, int Nkv,
                            int BS, int max_blocks, int splits, float scale) {
  static_assert(HD % 32 == 0 && HD / 32 <= 32, "a block of whole warps");
  __shared__ float dot_sh[HD / 32];
  const int n = blockIdx.x, b = blockIdx.y;
  const int d = threadIdx.x;
  const int rep = N / Nkv;
  const int kvh = n / rep;
  const size_t kv = (size_t)b * Nkv + kvh;
  const float qs = round_compute<KV>(to_f32(q[((size_t)b * N + n) * HD + d]) * scale);
  const float vn = to_f32(v_new[kv * HD + d]);
  // the score's dot: a warp's lanes in butterfly order, then the warps in order
  const float dot = warp_sum(qs * to_f32(k_new[kv * HD + d]));
  if (d % 32 == 0) dot_sh[d / 32] = dot;
  __syncthreads();
  float sn = 0.f;
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) sn += dot_sh[w];
  float v_sc = 1.f;
  if (kQuantKV<KV>) {
    sn *= ksn[kv];
    v_sc = vsn[kv];
  }
  const int active = active_splits(min(lens[b] - 1, max_blocks * BS));
  const float* p0 = part + ((kv * rep + n % rep) * splits) * (HD + 2);
  wait_for_primary();
  float m_all, l_all, a_all;
  merge_splits<HD>(p0, active, d, m_all, l_all, a_all);
  const float m_new = fmaxf(m_all, sn);
  const float pn = expf(sn - m_new);
  const float alpha = expf(m_all - m_new);
  const float l = l_all * alpha + pn;
  const float a = a_all * alpha + (pn * v_sc) * vn;
  out[((size_t)b * N + n) * HD + d] = from_f32<T>(a / (l == 0.f ? 1.f : l));
}

int sm_count() {
  static int sms = 0;  // read once: stays out of graph capture
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The split kernel for (T, KV, M): tensor cores for B4 and B5 on a bf16 or
// int8 pool, fp32 FMAs otherwise; then the combine as a programmatic
// dependent launch (B4's adds the new token).  The grid's third axis:
// splits, cut to about kSplitBlocksPerSm blocks an SM in all (each block
// then walks every gridDim.z-th split).
constexpr int kSplitBlocksPerSm = 4;

template <typename T, typename KV, int HD, Mode M>
cudaError_t launch_split(const void* q, const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, const void* tables, const void* lens, const void* blk,
                         const void* off, const void* ksn, const void* vsn, void* ks_pool,
                         void* vs_pool, void* out, float* part, int B, int Sq, int N, int Nkv,
                         int NB, int BS, int max_blocks, int layer, int splits, float scale,
                         cudaStream_t stream) {
  constexpr bool kTensor = M != kDecode && sizeof(KV) <= 2;
  const int rep = N / Nkv;
  const int R = rep * Sq;
  auto kernel = [] {
    if constexpr (kTensor) return paged_verify_mma_kernel<T, KV, HD, M>;
    else return paged_verify_fma_kernel<T, KV, HD, M>;
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
  const int gx = kTensor ? Nkv * ((R + 15) / 16) : Nkv;
  const int per_z = gx * B;
  const int gz = min(splits, max(1, (kSplitBlocksPerSm * sm_count() + per_z - 1) / per_z));
  kernel<<<dim3(gx, B, gz), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_new), static_cast<const KV*>(v_new),
      static_cast<KV*>(k_pool), static_cast<KV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const int*>(blk), static_cast<const int*>(off),
      static_cast<const float*>(ksn), static_cast<const float*>(vsn),
      static_cast<float*>(ks_pool), static_cast<float*>(vs_pool), part, N, Nkv, Sq, NB, BS,
      max_blocks, layer, splits, scale);
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
  if constexpr (M == kAppendDecode)
    return cudaLaunchKernelEx(&cfg, paged_append_combine_kernel<T, KV, HD>,
                              static_cast<const float*>(part), static_cast<const T*>(q),
                              static_cast<const KV*>(k_new), static_cast<const KV*>(v_new),
                              static_cast<const float*>(ksn), static_cast<const float*>(vsn),
                              static_cast<const int*>(lens), static_cast<T*>(out), N, Nkv, BS,
                              max_blocks, splits, scale);
  else
    return cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, HD>, static_cast<const float*>(part),
                              static_cast<const int*>(lens), static_cast<T*>(out), N, Nkv, Sq,
                              BS, max_blocks, splits);
}

template <Mode M>
int launch_for_types(int is_bf16, int kv_int8, const void* q, const void* k_new,
                     const void* v_new, void* k_pool, void* v_pool, const void* tables,
                     const void* lens, const void* blk, const void* off, const void* ksn,
                     const void* vsn, void* ks_pool, void* vs_pool, void* out, void* scratch,
                     int B, int Sq, int N, int Nkv, int NB, int BS, int max_blocks, int layer,
                     float scale, cudaStream_t st) {
  if (B == 0) return 0;
  const int splits = (max_blocks * BS + kVerifyRun - 1) / kVerifyRun;
  float* part = static_cast<float*>(scratch);
#define VCLA_SPLIT_ARGS                                                                      \
  q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, ksn, vsn, ks_pool, vs_pool, out, \
      part, B, Sq, N, Nkv, NB, BS, max_blocks, layer, splits, scale, st
  if (kv_int8)
    return is_bf16 ? launch_split<__nv_bfloat16, int8_t, 128, M>(VCLA_SPLIT_ARGS)
                   : launch_split<float, int8_t, 128, M>(VCLA_SPLIT_ARGS);
  return is_bf16 ? launch_split<__nv_bfloat16, __nv_bfloat16, 128, M>(VCLA_SPLIT_ARGS)
                 : launch_split<float, float, 128, M>(VCLA_SPLIT_ARGS);
#undef VCLA_SPLIT_ARGS
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer
// (the four scale pointers are null for a float pool); ``stream`` is a
// cudaStream_t.  Returns a cudaError_t (0 = launched).  Each call is two
// launches (splits, combine); the caller allocates the splits' scratch
// (B, Nkv, N / Nkv * Sq, splits, head_dim + 2) f32, Sq = 1 for B4 and B6.
extern "C" {

// kv slots a split: a table max_blocks * BS slots wide makes ceil(width /
// run) splits
int vcla_paged_run() { return kVerifyRun; }

// B4: the pools are (L, NB, BS, Nkv * head_dim) and updated in place
int vcla_paged_append(const void* q, const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const void* tables, const void* lens, const void* blk,
                      const void* off, const void* ksn, const void* vsn, void* ks_pool,
                      void* vs_pool, void* out, void* scratch, int B, int N, int Nkv, int NB,
                      int BS, int max_blocks, int layer, int head_dim, int is_bf16, int kv_int8,
                      float scale, void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_types<kAppendDecode>(is_bf16, kv_int8, q, k_new, v_new, k_pool, v_pool,
                                         tables, lens, blk, off, ksn, vsn, ks_pool, vs_pool, out,
                                         scratch, B, 1, N, Nkv, NB, BS, max_blocks, layer, scale,
                                         static_cast<cudaStream_t>(stream));
}

// B5: the pools are (L, NB, BS, Nkv * head_dim) and updated in place
int vcla_paged_verify(const void* q, const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const void* tables, const void* lens, const void* ksn,
                      const void* vsn, void* ks_pool, void* vs_pool, void* out, void* scratch,
                      int B, int Sq, int N, int Nkv, int NB, int BS, int max_blocks, int layer,
                      int head_dim, int is_bf16, int kv_int8, float scale, void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_types<kVerify>(is_bf16, kv_int8, q, k_new, v_new, k_pool, v_pool, tables,
                                   lens, nullptr, nullptr, ksn, vsn, ks_pool, vs_pool, out,
                                   scratch, B, Sq, N, Nkv, NB, BS, max_blocks, layer, scale,
                                   static_cast<cudaStream_t>(stream));
}

// B6: one layer's pools (NB, BS, Nkv, head_dim), read only
int vcla_paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                      const void* lens, const void* ks_pool, const void* vs_pool, void* out,
                      void* scratch, int B, int N, int Nkv, int NB, int BS, int max_blocks,
                      int head_dim, int is_bf16, int kv_int8, float scale, void* stream) {
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  // never written without the append
  return launch_for_types<kDecode>(is_bf16, kv_int8, q, nullptr, nullptr,
                                   const_cast<void*>(k_pool), const_cast<void*>(v_pool), tables,
                                   lens, nullptr, nullptr, nullptr, nullptr,
                                   const_cast<void*>(ks_pool), const_cast<void*>(vs_pool), out,
                                   scratch, B, 1, N, Nkv, NB, BS, max_blocks, 0, scale,
                                   static_cast<cudaStream_t>(stream));
}

const char* vcla_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
