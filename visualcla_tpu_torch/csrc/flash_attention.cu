// Flash attention for Hopper (sm_90a): decode over one layer of the stacked KV
// cache, and the online-softmax attention of many queries over K/V in any
// (row, slot, head) layout.
//
// Replaces the Pallas kernels of visualcla_tpu/ops/pallas/flash_attention.py:
//   flash_decode_split_kernel + flash_decode_combine_kernel
//                       <- _flash_decode_stacked -> _decode_kernel        (B1, Sq == 1)
//   flash_attention_wgmma_kernel / flash_attention_fma_kernel, causal
//                       <- _flash_stacked -> _flash_kernel(stacked=True)
//                                         (B2: one layer of the stacked cache)
//   the same two, causal or not
//                       <- _flash_attention_jit -> _flash_kernel(stacked=False)
//                                         (B2u: unstacked bsnh or bnsh K/V)
// B2 and B2u are one template: B2 passes one layer of the cache as bnsh K/V.
// Which instance is which: q in bf16 (the main path's type) takes
// flash_attention_wgmma_kernel (tensor cores), q in f32 (the type of the
// identity checks) takes flash_attention_fma_kernel (fp32 FMAs: TF32 would keep
// three digits).  B1 is one design for both types.
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
//   j <= slots[b] + i.  Query head n reads kv head n / (N / Nkv) (GQA).
//   Scores, p and the online softmax stay fp32 (p is not rounded to q's type
//   once before p @ V), masked scores are -1e30, p is masked so that a fully
//   masked query row has l == 0 and emits zeros.  Output is (B, Sq, N, HD) in
//   q's type.  HD is 64 (the ViT and the resampler) or 128 (LLaMA).
//   Where the softmax scale goes: B1 and the fp32 kernel scale q in fp32 after
//   the upcast, as the TPU kernel does.  The tensor-core kernel multiplies
//   bf16 q and bf16 (or int8, exact in bf16) K as they are (their products are
//   exact in the fp32 accumulator) and scales the fp32 score after the dot,
//   before the int8 ks fold: the same value up to the last bit of the score.
//
// What bounds them on the card, and what the design does about it:
//   B1 reads the cache: bytes (int8 K/V halve them), 2.6 us' worth at B = 1
//   and 528 slots, so what matters is how many loads are in flight on how many
//   SMs.  Flash-decoding: the grid is (kv head, row, split); a block takes a
//   fixed run of kDecodeRun kv slots of its head and serves the N / Nkv query
//   heads of the group from it.  The number of splits is a function of S alone
//   (never of the slots, which live on the device): a block whose run starts
//   past the row's slot leaves at once.  A K/V row is read as 16-byte loads of
//   neighbouring lanes (16 lanes a bf16 row of 128); each lane group keeps up
//   to 8 rows of K and of V in flight, runs its own online softmax, and the
//   groups merge by shuffles, then through shared memory in warp order.  The
//   partial (m, l, acc) of each split goes to fp32 scratch, and a second small
//   kernel combines the row's active splits in split order: nothing is atomic,
//   so a result repeats bit for bit and does not depend on the batch a row
//   sits in.  The combine is a programmatic dependent launch: its blocks are
//   scheduled while the splits run and wait inside for the partials, which
//   took 1.1 of 8.8 us off a call on the H100.  With N / Nkv == 1 there is
//   nothing for a tensor core to do.
//   B2 / B2u do Sq x S x HD multiply-adds twice: operations.  The bf16 kernel
//   gives both products to the tensor cores (wgmma.mma_async m64nNk16, fp32
//   accumulators in registers), one warpgroup per 64 query rows.  Q, K and V
//   tiles sit in shared memory in bf16 under the 128-byte swizzle: K feeds
//   S = Q K^T K-major, and V, (slot, hd) row-major, feeds O += P V MN-major
//   through the descriptor's transpose bit, so nothing is transposed by hand.
//   K/V tiles of 64 slots arrive by 16-byte cp.async into a ring, the next
//   tile in flight while the present one is multiplied; int8 tiles land raw
//   and one pass converts them to bf16 (exact) into the operand buffers.  P
//   feeds P V from registers in two bf16 terms, p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi), so p carries about 16 bits into the product instead of 8.
//   Sq and S that are no multiple of the tile are zero-filled and masked by
//   the kernel.  With causal on, kv tiles wholly past the block's last query
//   slot are skipped, and the blocks with the most tiles are scheduled first.
//   A kv tile that every query of the warpgroup sees whole skips the mask
//   arithmetic, exponentials are one ex2.approx each on log2-domain scores, and
//   the accumulator is rescaled only when a running max moved.  A block is one
//   warpgroup (64 query rows); or two (128 rows) with int8 K/V, where both share
//   the tile's conversion pass; or, where the grid would not fill the card (the
//   ViT and resampler at B = 1, the speculative verify), two warpgroups that
//   share 64 query rows and split each 128-slot stage of the kv axis between
//   them, merged in a fixed order at the end: what measured faster on the H100
//   (the wrapper picks; ops/cuda/bench_flash.py times all three).  What still
//   holds it from the bound: softmax and the two products of a warpgroup run
//   one after the other (no overlap inside a warpgroup), and at Sq <= 16 (the
//   speculative verify) a 64-row tile is mostly padding; at the ViT's shape
//   (257 tokens, 16 heads: 80 blocks of 5 tiles) the time is one block's
//   latency.  Both are accepted and measured.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// 16 bytes of K or V as fp32 values
template <typename KV>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<int8_t> {
  static constexpr int kN = 16;
  __device__ static void unpack(const uint4& r, float (&f)[16]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[4 * i + c] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * c)) >> 24);
  }
};

// ---------------------------------------------------------------------------
// B1: decode, Sq == 1, split over the kv axis
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
#ifndef VCLA_DECODE_RUN
#define VCLA_DECODE_RUN 128
#endif
constexpr int kDecodeRun = VCLA_DECODE_RUN;  // kv slots a block; splits = ceil(S / kDecodeRun)

// Programmatic dependent launch: the split kernel lets the combine kernel's
// blocks be scheduled while it still runs; they wait here until the split
// kernel has finished and its partials are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One (kv head, row, split): REP query heads of the group over the run's
// slots.  Writes the split's (acc[HD], m, l) per query head to
// part (B, N, splits, HD + 2); a split wholly past the row's slot writes
// nothing, and the combine kernel never reads it.
template <typename T, typename KV, int HD, int REP>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                          const KV* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const uint8_t* __restrict__ kv_valid,
                          const int* __restrict__ slots, float* __restrict__ part, int N,
                          int Nkv, int S, int splits, float scale) {
  constexpr int EPT = Chunk<KV>::kN;                // elements of a 16-byte load
  constexpr int LPR = HD / EPT;                     // lanes a K/V row
  constexpr int GROUPS = kDecodeThreads / LPR;      // rows loaded side by side
  constexpr int SPG = kDecodeRun / GROUPS;          // slots a lane group
  constexpr int BATCH = SPG < 8 ? SPG : 8;          // rows of K and of V in flight a lane
  static_assert(LPR <= 32 && kDecodeRun % GROUPS == 0 && SPG % BATCH == 0, "run layout");
  launch_dependents();
  const int rep = N / Nkv;
  const int chunks = (rep + REP - 1) / REP;
  const int kvh = blockIdx.x / chunks;
  const int r_base = (blockIdx.x % chunks) * REP;  // first head of the group served here
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int slot = slots[b];
  const int last = min(slot, S - 1);  // last visible slot
  const int j_begin = split * kDecodeRun;
  if (slot < 0 || j_begin > last) return;
  const int g = threadIdx.x / LPR;
  const int ln = threadIdx.x % LPR;
  const int warp = threadIdx.x / 32;
  const int head0 = kvh * rep + r_base;

  float qr[REP][EPT];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const bool live = r_base + r < rep;
    const T* q_row = q + ((size_t)b * N + head0 + (live ? r : 0)) * HD + ln * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) qr[r][e] = live ? to_f32(q_row[e]) * scale : 0.f;
  }
  float m[REP], l[REP], acc[REP][EPT];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[r][e] = 0.f;
  }

  const size_t head_off = ((size_t)b * Nkv + kvh) * (size_t)S;
  const KV* k_head = k + head_off * HD + ln * EPT;
  const KV* v_head = v + head_off * HD + ln * EPT;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

#pragma unroll
  for (int i0 = 0; i0 < SPG; i0 += BATCH) {
    // all loads of the batch first: neighbouring lane groups take
    // neighbouring slots, so a warp's load covers whole rows side by side
    uint4 kraw[BATCH], vraw[BATCH];
    float k_sc[BATCH], v_sc[BATCH];
    bool ok[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j_begin + g + GROUPS * (i0 + u);
      const bool in = j <= last;
      const int jc = in ? j : last;
      kraw[u] = __ldg(reinterpret_cast<const uint4*>(k_head + (size_t)jc * HD));
      vraw[u] = __ldg(reinterpret_cast<const uint4*>(v_head + (size_t)jc * HD));
      ok[u] = in && ok_row[jc] != 0;
      if (kQuantKV<KV>) {
        k_sc[u] = ks[head_off + jc];
        v_sc[u] = vs[head_off + jc];
      } else {
        k_sc[u] = v_sc[u] = 1.f;
      }
    }
    float s[REP][BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      float kf[EPT];
      Chunk<KV>::unpack(kraw[u], kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        s[r][u] = dot;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int u = 0; u < BATCH; ++u) s[r][u] += __shfl_xor_sync(0xffffffffu, s[r][u], o);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        s[r][u] = ok[u] ? s[r][u] * k_sc[u] : kNegInf;
        m_new = fmaxf(m_new, s[r][u]);
      }
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float p = ok[u] ? expf(s[r][u] - m_new) : 0.f;
        l[r] += p;
        s[r][u] = p * v_sc[u];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      float vf[EPT];
      Chunk<KV>::unpack(vraw[u], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[r][e] = fmaf(s[r][u], vf[e], acc[r][e]);
    }
  }

  // merge the lane groups of a warp by shuffles (lanes 0 .. LPR-1 end up with
  // the warp's state), then the warps through shared memory in warp order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = expf(m[r] - m_new), c = expf(m_o - m_new);
      m[r] = m_new;
      l[r] = l[r] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * c;
    }
  }
  __shared__ float warp_sh[kDecodeWarps][REP][HD + 2];
  if (threadIdx.x % 32 < LPR) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) warp_sh[warp][r][ln * EPT + e] = acc[r][e];
      if (ln == 0) {
        warp_sh[warp][r][HD] = m[r];
        warp_sh[warp][r][HD + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < REP * HD; idx += kDecodeThreads) {
    const int r = idx / HD, d = idx % HD;
    if (r_base + r >= rep) break;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) m_all = fmaxf(m_all, warp_sh[w][r][HD]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(warp_sh[w][r][HD] - m_all);
      l_all += warp_sh[w][r][HD + 1] * c;
      a_all += warp_sh[w][r][d] * c;
    }
    float* dst = part + (((size_t)b * N + head0 + r) * splits + split) * (HD + 2);
    dst[d] = a_all;
    if (d == 0) {
      dst[HD] = m_all;
      dst[HD + 1] = l_all;
    }
  }
}

// One (query head, row): the row's active splits combined in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ slots,
                            T* __restrict__ out, int N, int S, int splits) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int slot = slots[b];
  const int active = slot < 0 ? 0 : min(slot, S - 1) / kDecodeRun + 1;
  const float* base = part + ((size_t)b * N + n) * splits * (HD + 2);
  wait_for_primary();
  float m_all = kNegInf;
  for (int s = 0; s < active; ++s) m_all = fmaxf(m_all, base[s * (HD + 2) + HD]);
  float l_all = 0.f, a_all = 0.f;
  for (int s = 0; s < active; ++s) {
    const float* p = base + s * (HD + 2);
    const float c = expf(p[HD] - m_all);
    l_all += p[HD + 1] * c;
    a_all += p[d] * c;
  }
  out[((size_t)b * N + n) * HD + d] = from_f32<T>(a_all / (l_all == 0.f ? 1.f : l_all));
}

// ---------------------------------------------------------------------------
// B2 / B2u: Sq queries a row, causal or not
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // queries per block (fp32 kernel) or per warpgroup (bf16 kernel)
constexpr int kBK = 64;  // kv slots per tile

// element strides of an operand along (row, slot, head); its last axis is
// contiguous.  The slot stride is 32-bit (at most Nkv * HD).
struct Strides {
  long long b;
  int s;
  long long h;
};

// ---- q in bf16: tensor cores ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when ``pred`` is false
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
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void keep_in_registers(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a tile under the 128-byte swizzle (rows of
// 128 bytes, 8-row groups of 1024 bytes, tile base 1024-byte aligned).
// K-major operand (Q, K): ``sbo`` is the stride between 8-row groups and the
// leading offset is unused.  MN-major operand (V): ``lbo`` is the stride
// between 64-element panels along hd, ``sbo`` between 8-slot groups.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

#define VCLA_F8(d, o)                                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64, fp32) = or += A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : VCLA_F8(d, 0), VCLA_F8(d, 8), VCLA_F8(d, 16), VCLA_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VCLA_F8(d, 0), VCLA_F8(d, 8), VCLA_F8(d, 16), VCLA_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VCLA_F8(d, 0), VCLA_F8(d, 8), VCLA_F8(d, 16), VCLA_F8(d, 24), VCLA_F8(d, 32),
        VCLA_F8(d, 40), VCLA_F8(d, 48), VCLA_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef VCLA_F8

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// 2^x in one instruction (relative error 2^-22; -1e30 gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) rounded to bf16 in one register, a in the low half
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of the bf16 kernel.  A bf16 tile of 64 rows is HD / 64 panels
// of 64 x 64 elements (rows of 128 bytes), 16-byte chunk c of row r stored at
// chunk c ^ (r % 8): the 128-byte swizzle.  A block's kWG warpgroups take 64
// query rows each over the same kv tiles, or (kSplit) share 64 query rows and
// take one 64-slot half each of a ring stage of 128 slots.
template <typename KV, int HD, int kWG, bool kSplit>
struct WgSmem {
  static constexpr bool kQuant = kQuantKV<KV>;
  // K/V stages in flight; hd 128 in bf16 keeps two so that two blocks fit an SM
  static constexpr int kStages = (HD == 128 && !kQuant) ? 2 : 3;
  static constexpr int kOperandStages = kQuant ? 1 : kStages;  // bf16 stages wgmma reads
  static constexpr int kHalves = kSplit ? kWG : 1;   // 64-slot tiles of a ring stage
  static constexpr int kSlots = kBK * kHalves;       // kv slots of a ring stage
  static constexpr int kQTiles = kSplit ? 1 : kWG;   // 64-row query tiles of a block
  static constexpr int kPanelBytes = 64 * 128;
  static constexpr int kTileBytes = kBK * HD * 2;    // one bf16 tile of 64 rows
  static constexpr int kStageBytes = kHalves * kTileBytes;   // K (or V) of one stage
  static constexpr int kRawBytes = kQuant ? kSlots * HD : 0;  // int8 K (or V) as it lands
  static constexpr int kFlags = kSlots / 32;  // a stage's "all slots valid", one a loading warp
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQTiles * kTileBytes;
  static constexpr int kVOff = kKOff + kOperandStages * kStageBytes;
  static constexpr int kRawOff = kVOff + kOperandStages * kStageBytes;
  static constexpr int kMetaOff = kRawOff + kStages * 2 * kRawBytes;  // ok, ks, vs per slot
  static constexpr int kFlagOff = kMetaOff + kStages * 3 * kSlots * 4;
  static constexpr int kBytes = kFlagOff + kStages * kFlags * 4 + 1024;  // + alignment slack
};

// byte offset of 16-byte chunk ``c`` of row ``r`` in a swizzled bf16 tile
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <typename KV, int HD, bool kCausal, int kWG, bool kSplit>
__global__ void __launch_bounds__(128 * kWG, 1)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                             const KV* __restrict__ v, const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const uint8_t* __restrict__ kv_valid,
                             const int* __restrict__ slots, __nv_bfloat16* __restrict__ out,
                             int Sq, int N, int Nkv, int S, Strides qs, Strides kst,
                             Strides vst, Strides sc, float scale) {
  using L = WgSmem<KV, HD, kWG, kSplit>;
  static_assert(!kSplit || kWG == 2, "the kv split is over two warpgroups");
  constexpr bool kQuant = L::kQuant;
  constexpr int kSlots = L::kSlots;
  constexpr int kThreads = 128 * kWG;
  constexpr int kStages = L::kStages;
  constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one multiplied
  constexpr int kChunks = HD / 8;      // 16-byte chunks of a bf16 row
  constexpr int kRawChunks = HD / 16;  // of an int8 row
  constexpr int kOAcc = HD / 2;        // fp32 output accumulators a thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t smem_base = smem_u32(smem);
  float* meta = reinterpret_cast<float*>(smem + L::kMetaOff);
  float* flags = reinterpret_cast<float*>(smem + L::kFlagOff);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kBQ * L::kQTiles);  // most kv tiles first
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / Nkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  // this thread's two rows of its warpgroup's 64: r0 and r0 + 8
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;
  const int wq0 = q0 + (kSplit ? 0 : kBQ * wg);  // the warpgroup's first query
  const int half = kSplit ? wg : 0;              // its 64-slot tile of a ring stage

  const int slot0 = slots[b];
  int n_tiles = (S + kSlots - 1) / kSlots;  // ring stages to walk
  int wg_last = wq0 < Sq ? S - 1 : -1;      // the last kv slot the warpgroup's queries may see
  if (kCausal) {
    const int blk_last = slot0 + min(q0 + kBQ * L::kQTiles, Sq) - 1;  // the block's last query
    n_tiles = blk_last < 0 ? 0 : min(n_tiles, blk_last / kSlots + 1);
    wg_last = min(wg_last, slot0 + min(wq0 + kBQ, Sq) - 1);
  }

  const __nv_bfloat16* q_head = q + b * qs.b + n * qs.h;
  const KV* k_head = k + b * kst.b + kvh * kst.h;
  const KV* v_head = v + b * vst.b + kvh * vst.h;
  const long long scale_off = b * sc.b + kvh * sc.h;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

  // K/V slots t * kSlots ... into ring stage ``t % kStages`` (rows past S are zeros)
  auto fetch_tile = [&](int t) {
    const int j0 = t * kSlots;
    const int stage = t % kStages;
    if (kQuant) {
      const uint32_t k_dst = smem_base + L::kRawOff + stage * 2 * L::kRawBytes;
      const uint32_t v_dst = k_dst + L::kRawBytes;
      for (int idx = tid; idx < kSlots * kRawChunks; idx += kThreads) {
        const int r = idx / kRawChunks, c = idx % kRawChunks;
        const bool in = j0 + r < S;
        const int j = in ? j0 + r : 0;
        cp_async16(k_dst + r * HD + c * 16, k_head + j * kst.s + c * 16, in);
        cp_async16(v_dst + r * HD + c * 16, v_head + j * vst.s + c * 16, in);
      }
    } else {
      const uint32_t k_dst = smem_base + L::kKOff + stage * L::kStageBytes;
      const uint32_t v_dst = smem_base + L::kVOff + stage * L::kStageBytes;
      for (int idx = tid; idx < kSlots * kChunks; idx += kThreads) {
        const int r = idx / kChunks, c = idx % kChunks;
        const bool in = j0 + r < S;
        const int j = in ? j0 + r : 0;
        const int off = (r / kBK) * L::kTileBytes + swizzled(r % kBK, c);
        cp_async16(k_dst + off, k_head + j * kst.s + c * 8, in);
        cp_async16(v_dst + off, v_head + j * vst.s + c * 8, in);
      }
    }
  };
  // per-slot validity and int8 scales of stage ``t``, loaded by the first
  // kSlots threads into registers (stored to the ring later, off the load's latency)
  float meta_ok = 0.f, meta_ks = 1.f, meta_vs = 1.f;
  auto load_meta = [&](int t) {
    const int j = t * kSlots + tid;
    if (tid < kSlots) {
      const bool in = j < S;
      meta_ok = (in && ok_row[in ? j : 0] != 0) ? 1.f : 0.f;
      if (kQuant) {
        meta_ks = in ? ks[scale_off + (long long)j * sc.s] : 1.f;
        meta_vs = in ? vs[scale_off + (long long)j * sc.s] : 1.f;
      }
    }
  };
  auto store_meta = [&](int t) {
    if (tid < kSlots) {
      float* mt = meta + (t % kStages) * 3 * kSlots;
      mt[tid] = meta_ok;
      mt[kSlots + tid] = meta_ks;
      mt[2 * kSlots + tid] = meta_vs;
      // the stage's flags: each loading warp's vote, written by its lane 0
      const bool all = __all_sync(0xffffffffu, meta_ok != 0.f);
      if (lane == 0) flags[(t % kStages) * L::kFlags + tid / 32] = all ? 1.f : 0.f;
    }
  };

  // prologue: the q tile (rows past Sq are zeros) with kv tile 0, then the
  // tiles ahead; one commit group a tile, empty past the last
  for (int idx = tid; idx < kBQ * L::kQTiles * kChunks; idx += kThreads) {
    const int row = idx / kChunks, c = idx % kChunks;
    const bool in = q0 + row < Sq;
    const int qi = in ? q0 + row : 0;
    cp_async16(smem_base + L::kQOff + (row / kBQ) * L::kTileBytes + swizzled(row % kBQ, c),
               q_head + qi * qs.s + c * 8, in);
  }
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < n_tiles) {
      fetch_tile(t);
      load_meta(t);
      store_meta(t);
    }
    cp_async_commit();
  }

  float o[kOAcc];
#pragma unroll
  for (int i = 0; i < kOAcc; ++i) o[i] = 0.f;
  // running max (in units of log2: scores carry log2(e)) and this thread's
  // share of the denominator, for rows r0 and r0 + 8
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int q_slot0 = slot0 + wq0 + r0;
  const int q_slot1 = q_slot0 + 8;
  const float scale2 = scale * kLog2e;
  const uint32_t q_addr = smem_base + L::kQOff + (kSplit ? 0 : wg) * L::kTileBytes;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kSlots + half * kBK;  // the warpgroup's first slot of the stage
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile t have landed
    if (!kQuant) fence_async_proxy();
    __syncthreads();  // tile t is whole; every warp is done with tile t - 1
    const bool more = t + kAhead < n_tiles;
    if (more) {
      fetch_tile(t + kAhead);
      load_meta(t + kAhead);
    }
    cp_async_commit();
    uint32_t k_addr = smem_base + L::kKOff + half * L::kTileBytes;
    uint32_t v_addr = smem_base + L::kVOff + half * L::kTileBytes;
    if (kQuant) {
      // int8 -> bf16 (exact) into the one operand stage
      const uint8_t* raw = smem + L::kRawOff + (t % kStages) * 2 * L::kRawBytes;
      for (int idx = tid; idx < 2 * kSlots * kRawChunks; idx += kThreads) {
        const int which = idx / (kSlots * kRawChunks);  // 0: K, 1: V
        const int r = (idx / kRawChunks) % kSlots, c = idx % kRawChunks;
        const uint4 in = *reinterpret_cast<const uint4*>(raw + which * L::kRawBytes + r * HD +
                                                         c * 16);
        float f[16];
        Chunk<int8_t>::unpack(in, f);
        uint4 lo, hi;
        lo.x = pack_bf16(__float2bfloat16(f[0]), __float2bfloat16(f[1]));
        lo.y = pack_bf16(__float2bfloat16(f[2]), __float2bfloat16(f[3]));
        lo.z = pack_bf16(__float2bfloat16(f[4]), __float2bfloat16(f[5]));
        lo.w = pack_bf16(__float2bfloat16(f[6]), __float2bfloat16(f[7]));
        hi.x = pack_bf16(__float2bfloat16(f[8]), __float2bfloat16(f[9]));
        hi.y = pack_bf16(__float2bfloat16(f[10]), __float2bfloat16(f[11]));
        hi.z = pack_bf16(__float2bfloat16(f[12]), __float2bfloat16(f[13]));
        hi.w = pack_bf16(__float2bfloat16(f[14]), __float2bfloat16(f[15]));
        uint8_t* dst = smem + (which ? L::kVOff : L::kKOff) + (r / kBK) * L::kTileBytes;
        *reinterpret_cast<uint4*>(dst + swizzled(r % kBK, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + swizzled(r % kBK, 2 * c + 1)) = hi;
      }
      fence_async_proxy();
      __syncthreads();
    } else {
      k_addr += (t % kStages) * L::kStageBytes;
      v_addr += (t % kStages) * L::kStageBytes;
    }

    if (j0 <= wg_last) {  // uniform over the warpgroup
      // S = Q K^T: 64 queries x 64 slots, HD / 16 steps of k16
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kPanelBytes + (kk % 4) * 32;
        wgmma_ss_n64(s, wgmma_desc(q_addr + off, 16, 1024), wgmma_desc(k_addr + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      keep_in_registers(s);

      // s[4i + e] is (row r0, slot 8i + 2 quad + e), s[4i + 2 + e] row r0 + 8.
      // Scores become log2-domain values s * scale2 (* ks); masked ones -1e30.
      const float* mt = meta + (t % kStages) * 3 * kSlots + half * kBK;
      // a tile every query of the warpgroup sees whole needs no mask
      const float* flag = flags + (t % kStages) * L::kFlags + half * (kBK / 32);
      const bool whole = flag[0] != 0.f && flag[1] != 0.f &&
                         (!kCausal || j0 + kBK - 1 <= slot0 + wq0);
      uint32_t seen = 0xffffffffu;  // bit 4i + e (+ 2): the query sees the slot
      float mx0 = kNegInf, mx1 = kNegInf;
      if (whole) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float2 c2 = make_float2(scale2, scale2);
          if (kQuant) {
            const float2 k2 = *reinterpret_cast<const float2*>(mt + kSlots + 8 * i + 2 * quad);
            c2.x *= k2.x;
            c2.y *= k2.y;
          }
          s[4 * i] *= c2.x;
          s[4 * i + 1] *= c2.y;
          s[4 * i + 2] *= c2.x;
          s[4 * i + 3] *= c2.y;
          mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
      } else {
        seen = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * quad + e;
            const bool okc = mt[col] != 0.f;
            const float c2 = kQuant ? scale2 * mt[kSlots + col] : scale2;
            const bool see0 = okc && (!kCausal || j0 + col <= q_slot0);
            const bool see1 = okc && (!kCausal || j0 + col <= q_slot1);
            seen |= (see0 ? 1u : 0u) << (4 * i + e) | (see1 ? 1u : 0u) << (4 * i + 2 + e);
            s[4 * i + e] = see0 ? s[4 * i + e] * c2 : kNegInf;
            s[4 * i + 2 + e] = see1 ? s[4 * i + 2 + e] * c2 : kNegInf;
            mx0 = fmaxf(mx0, s[4 * i + e]);
            mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
          }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float m0n = fmaxf(m0, mx0), m1n = fmaxf(m1, mx1);
      const float alpha0 = fast_exp2(m0 - m0n), alpha1 = fast_exp2(m1 - m1n);
      m0 = m0n;
      m1 = m1n;
      l0 *= alpha0;
      l1 *= alpha1;
      // p in two bf16 terms, as the A operand of P V: step kc covers slots
      // 16 kc .. 16 kc + 15, registers (r0, lo cols), (r0 + 8, lo), (r0, hi), (r0 + 8, hi)
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float2 v2 = make_float2(1.f, 1.f);
        if (kQuant) v2 = *reinterpret_cast<const float2*>(mt + 2 * kSlots + 8 * i + 2 * quad);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // h = 0: row r0, 1: row r0 + 8
          const int idx = 4 * i + 2 * h;
          const float mh = h ? m1 : m0;
          float pa = fast_exp2(s[idx] - mh), pb = fast_exp2(s[idx + 1] - mh);
          if (!whole) {  // a masked p is 0 even where the whole row is masked (s - m == 0)
            pa = (seen >> idx & 1u) ? pa : 0.f;
            pb = (seen >> (idx + 1) & 1u) ? pb : 0.f;
          }
          if (h) l1 += pa + pb; else l0 += pa + pb;
          if (kQuant) {
            pa *= v2.x;
            pb *= v2.y;
          }
          const uint32_t hi = bf16x2(pa, pb);
          p_hi[i / 2][2 * (i % 2) + h] = hi;
          p_lo[i / 2][2 * (i % 2) + h] = bf16x2(pa - __uint_as_float(hi << 16),
                                               pb - __uint_as_float(hi & 0xffff0000u));
        }
      }
      // the accumulator is rescaled only when a running max moved (uniform over the warp)
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < kOAcc / 4; ++i) {
          o[4 * i] *= alpha0;
          o[4 * i + 1] *= alpha0;
          o[4 * i + 2] *= alpha1;
          o[4 * i + 3] *= alpha1;
        }
      }
      // O += P V: V is (slot, hd) row-major, the MN-major B operand
      keep_in_registers(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        const uint64_t dv = wgmma_desc(v_addr + kc * 16 * 128, L::kPanelBytes, 1024);
        wgmma_rs(o, p_hi[kc], dv);
        wgmma_rs(o, p_lo[kc], dv);
      }
      wgmma_commit();
      wgmma_wait();
      keep_in_registers(o);
    }
    if (more) store_meta(t + kAhead);
  }

  if constexpr (kSplit) {
    // The two warpgroups hold (m, l, O) of the same 64 rows over their halves
    // of the kv axis, thread i of each the same (row, column) positions: the
    // second hands its state over through the K/V operand tiles' memory and
    // the first merges, thread by thread, in that fixed order.
    static_assert((kOAcc + 4) * 128 * 4 <= 2 * L::kOperandStages * L::kStageBytes,
                  "the merge buffer fits the operand tiles");
    float* mg = reinterpret_cast<float*>(smem + L::kKOff) + tid % 128;
    __syncthreads();  // every tile has been read, no copy is in flight
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kOAcc; ++i) mg[i * 128] = o[i];
      mg[kOAcc * 128] = m0;
      mg[(kOAcc + 1) * 128] = m1;
      mg[(kOAcc + 2) * 128] = l0;
      mg[(kOAcc + 3) * 128] = l1;
    }
    __syncthreads();
    if (wg == 1) return;
    const float mb0 = mg[kOAcc * 128], mb1 = mg[(kOAcc + 1) * 128];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float a0 = fast_exp2(m0 - mn0), b0 = fast_exp2(mb0 - mn0);
    const float a1 = fast_exp2(m1 - mn1), b1 = fast_exp2(mb1 - mn1);
    l0 = l0 * a0 + mg[(kOAcc + 2) * 128] * b0;
    l1 = l1 * a1 + mg[(kOAcc + 3) * 128] * b1;
#pragma unroll
    for (int i = 0; i < kOAcc / 4; ++i) {
      o[4 * i] = o[4 * i] * a0 + mg[(4 * i) * 128] * b0;
      o[4 * i + 1] = o[4 * i + 1] * a0 + mg[(4 * i + 1) * 128] * b0;
      o[4 * i + 2] = o[4 * i + 2] * a1 + mg[(4 * i + 2) * 128] * b1;
      o[4 * i + 3] = o[4 * i + 3] * a1 + mg[(4 * i + 3) * 128] * b1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = wq0 + r0 + 8 * h;
    if (qi >= Sq) continue;
    __nv_bfloat16* o_row = out + (((size_t)b * Sq + qi) * N + n) * HD + 2 * quad;
    const float den = h ? d1 : d0;
#pragma unroll
    for (int i = 0; i < kOAcc / 4; ++i)
      *reinterpret_cast<uint32_t*>(o_row + 8 * i) =
          pack_bf16(__float2bfloat16(o[4 * i + 2 * h] / den),
                    __float2bfloat16(o[4 * i + 2 * h + 1] / den));
  }
}

// ---- q in f32: fp32 FMAs ----------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kSCols = kBK / 16;  // score columns per thread

template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1)    // q tile, scaled
                          + (size_t)HD * (kBK + 1)  // K tile, transposed
                          + (size_t)kBK * HD        // V tile
                          + (size_t)kBQ * (kBK + 1) // p tile
                          + 3 * kBK);               // slot validity, k and v scales
}

// One block per (row, head, 64-query tile): 64-slot K/V tiles staged in shared
// memory in fp32, both products register-tiled.  At least 2 blocks an SM: the
// register budget (128) at which every instance measured fastest on the card
// (HD 64 fits 3 blocks of shared memory, HD 128 1).
template <typename T, typename KV, int HD, bool kCausal>
__global__ void __launch_bounds__(kFmaThreads, 2)
flash_attention_fma_kernel(const T* __restrict__ q, const KV* __restrict__ k,
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
  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kFmaThreads) {
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
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kFmaThreads) {
      const int j = idx / HD, d = idx % HD;
      const bool in = j0 + j < S;
      kt_sh[d * (kBK + 1) + j] = in ? to_f32(k_head[(j0 + j) * kst.s + d]) : 0.f;
      v_sh[j * HD + d] = in ? to_f32(v_head[(j0 + j) * vst.s + d]) : 0.f;
    }
    for (int j = threadIdx.x; j < kBK; j += kFmaThreads) {
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, typename KV, int HD, int REP>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, const void* kv_valid, const void* slots, void* out,
                          void* part, int B, int N, int Nkv, int S, float scale,
                          cudaStream_t stream) {
  const int splits = (S + kDecodeRun - 1) / kDecodeRun;
  const int chunks = (N / Nkv + REP - 1) / REP;
  flash_decode_split_kernel<T, KV, HD, REP>
      <<<dim3(Nkv * chunks, B, splits), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
          static_cast<float*>(part), N, Nkv, S, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the combine's launch overlaps the split kernel (it waits inside for its partials)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T, HD>,
                            static_cast<const float*>(part), static_cast<const int*>(slots),
                            static_cast<T*>(out), N, S, splits);
}

template <typename T, typename KV>
cudaError_t decode_for(int head_dim, const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* kv_valid, const void* slots, void* out,
                       void* part, int B, int N, int Nkv, int S, float scale, cudaStream_t st) {
#define VCLA_DECODE(HD, REP)                                                                   \
  launch_decode<T, KV, HD, REP>(q, k, v, ks, vs, kv_valid, slots, out, part, B, N, Nkv, S, \
                                scale, st)
  const bool grouped = N != Nkv;  // GQA: four query heads of a group a block
  if (head_dim == 64) return grouped ? VCLA_DECODE(64, 4) : VCLA_DECODE(64, 1);
  if (head_dim == 128) return grouped ? VCLA_DECODE(128, 4) : VCLA_DECODE(128, 1);
#undef VCLA_DECODE
  return cudaErrorInvalidValue;
}

template <typename KV, int HD, bool kCausal, int kWG, bool kSplit>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* kv_valid, const void* slots, void* out,
                         int B, int Sq, int N, int Nkv, int S, Strides qs, Strides kst,
                         Strides vst, Strides sc, float scale, cudaStream_t stream) {
  using L = WgSmem<KV, HD, kWG, kSplit>;
  constexpr int smem = L::kBytes;
  static bool configured = false;  // once per instance: keeps the call out of graph capture
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_wgmma_kernel<KV, HD, kCausal, kWG, kSplit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int rows = kBQ * L::kQTiles;
  const dim3 grid((Sq + rows - 1) / rows, N, B);
  flash_attention_wgmma_kernel<KV, HD, kCausal, kWG, kSplit><<<grid, 128 * kWG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<__nv_bfloat16*>(out), Sq, N, Nkv, S, qs, kst, vst, sc, scale);
  return cudaGetLastError();
}

template <typename T, typename KV, int HD, bool kCausal>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* kv_valid, const void* slots, void* out, int B,
                       int Sq, int N, int Nkv, int S, Strides qs, Strides kst, Strides vst,
                       Strides sc, float scale, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_fma_kernel<T, KV, HD, kCausal>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, N, B);
  flash_attention_fma_kernel<T, KV, HD, kCausal><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<T*>(out), Sq, N, Nkv, S, qs, kst, vst, sc, scale);
  return cudaGetLastError();
}

// the instance for q's type, a head dim, a causal flag, the K/V type and (bf16)
// the block's tiling: 1 = one warpgroup (64 query rows), 2 = two warpgroups
// (128 query rows), 3 = two warpgroups splitting the kv axis (64 query rows)
template <typename T, typename KV>
cudaError_t attention_for(int head_dim, bool causal, int tiling, const void* q,
                          const void* k, const void* v, const void* ks, const void* vs,
                          const void* kv_valid, const void* slots, void* out, int B, int Sq,
                          int N, int Nkv, int S, Strides qs, Strides kst, Strides vst,
                          Strides sc, float scale, cudaStream_t st) {
#define VCLA_ARGS q, k, v, ks, vs, kv_valid, slots, out, B, Sq, N, Nkv, S, qs, kst, vst, sc, scale, st
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (head_dim == 64)
      return causal ? launch_fma<T, KV, 64, true>(VCLA_ARGS)
                    : launch_fma<T, KV, 64, false>(VCLA_ARGS);
    return causal ? launch_fma<T, KV, 128, true>(VCLA_ARGS)
                  : launch_fma<T, KV, 128, false>(VCLA_ARGS);
  } else {
#define VCLA_WG(HD, C)                                             \
  (tiling == 3   ? launch_wgmma<KV, HD, C, 2, true>(VCLA_ARGS)    \
   : tiling == 2 ? launch_wgmma<KV, HD, C, 2, false>(VCLA_ARGS)   \
                 : launch_wgmma<KV, HD, C, 1, false>(VCLA_ARGS))
    if (head_dim == 64) return causal ? VCLA_WG(64, true) : VCLA_WG(64, false);
    return causal ? VCLA_WG(128, true) : VCLA_WG(128, false);
#undef VCLA_WG
  }
#undef VCLA_ARGS
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// ``stream`` is a cudaStream_t.  Returns a cudaError_t (0 = launched).
extern "C" {

// the number of kv splits B1 makes of a cache of S slots: the caller allocates
// scratch (B, N, splits, head_dim + 2) f32
int vcla_flash_decode_splits(int S) { return (S + kDecodeRun - 1) / kDecodeRun; }

// B1 over one layer (B, Nkv, S, HD) of the cache, q's type (ks, vs unused)
// or int8 K/V with per-slot scales (B, Nkv, S); two launches (splits, combine)
int vcla_flash_decode(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* kv_valid, const void* slots, void* out,
                      void* scratch, int B, int N, int Nkv, int S, int head_dim, int is_bf16,
                      int kv_int8, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return kv_int8 ? decode_for<__nv_bfloat16, int8_t>(head_dim, q, k, v, ks, vs, kv_valid, slots,
                                                        out, scratch, B, N, Nkv, S, scale, st)
                   : decode_for<__nv_bfloat16, __nv_bfloat16>(head_dim, q, k, v, ks, vs, kv_valid,
                                                              slots, out, scratch, B, N, Nkv, S,
                                                              scale, st);
  return kv_int8 ? decode_for<float, int8_t>(head_dim, q, k, v, ks, vs, kv_valid, slots, out,
                                             scratch, B, N, Nkv, S, scale, st)
                 : decode_for<float, float>(head_dim, q, k, v, ks, vs, kv_valid, slots, out,
                                            scratch, B, N, Nkv, S, scale, st);
}

// B2u: q (B, Sq, N, HD) and k, v, ks, vs through their (row, slot, head)
// strides; B2 is this call on one layer of the cache (bnsh strides, causal).
// ``tiling`` picks the bf16 kernel's block: 1 = one warpgroup (64 query rows),
// 2 = two (128 query rows), 3 = two splitting the kv axis (64 query rows).
int vcla_flash_attention(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* kv_valid, const void* slots, void* out,
                         int B, int Sq, int N, int Nkv, int S, int head_dim, int is_bf16,
                         int kv_int8, int causal, int tiling, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh, long long sc_sb,
                         long long sc_ss, long long sc_sh, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, (int)q_ss, q_sh}, kst{k_sb, (int)k_ss, k_sh},
      vst{v_sb, (int)v_ss, v_sh}, sc{sc_sb, (int)sc_ss, sc_sh};
  const bool c = causal != 0;
  if (is_bf16)
    return kv_int8 ? attention_for<__nv_bfloat16, int8_t>(head_dim, c, tiling, q, k, v, ks,
                                                           vs, kv_valid, slots, out, B, Sq, N,
                                                           Nkv, S, qs, kst, vst, sc, scale, st)
                   : attention_for<__nv_bfloat16, __nv_bfloat16>(
                         head_dim, c, tiling, q, k, v, ks, vs, kv_valid, slots, out, B, Sq, N,
                         Nkv, S, qs, kst, vst, sc, scale, st);
  return kv_int8 ? attention_for<float, int8_t>(head_dim, c, tiling, q, k, v, ks, vs,
                                                kv_valid, slots, out, B, Sq, N, Nkv, S, qs, kst,
                                                vst, sc, scale, st)
                 : attention_for<float, float>(head_dim, c, tiling, q, k, v, ks, vs, kv_valid,
                                               slots, out, B, Sq, N, Nkv, S, qs, kst, vst, sc,
                                               scale, st);
}

const char* vcla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
