// Flash attention over one layer of the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels on the LLM's cached-attention path
// (visualcla_tpu/ops/pallas/flash_attention.py):
//   flash_decode_kernel   <- _flash_decode_stacked -> _decode_kernel   (B1, Sq == 1)
//   flash_prefill_kernel  <- _flash_stacked -> _flash_kernel(stacked)  (B2, Sq > 1)
//
// Contract (both kernels, same as the TPU kernels):
//   q (B, Sq, N, HD); one layer of the cache k, v (B, Nkv, S, HD), passed as a
//   pointer into the stacked (L, B, Nkv, S, HD) buffer (no slice is copied);
//   kv_valid (B, S) uint8; slots (B,) int32 = cache slot of each row's first
//   query.  Query i of row b sits at slot slots[b] + i and sees kv slot j iff
//   kv_valid[b, j] and j <= slots[b] + i.  Query head n reads kv head
//   n / (N / Nkv) (GQA).  q is scaled in fp32 after the upcast, scores and the
//   online softmax are fp32, masked scores are -1e30, p is masked so that a
//   fully masked query row has l == 0 and emits zeros.  Output is q's dtype.
//
// What bounds them on the card, and what the design does about it:
//   decode reads the cache: bytes.  One block per (row, kv head) streams that
//   head's K and V once, only up to the row's slot, and serves all N / Nkv
//   query heads of the group from it.  Each thread loads its share of the
//   next 32-slot tile into registers while the current one is computed, so a
//   block waits on memory about once per tile and not once per slot.  At
//   B = 1 and 32 kv heads this is only 32 blocks, so a block's latency, not
//   the card's bandwidth, sets the time; splitting the kv axis across blocks
//   (flash-decoding) is later work.
//   prefill does Sq x S x HD multiply-adds: flops.  One block per (row, head,
//   64-query tile) stages 64-slot K/V tiles in shared memory in fp32 and
//   register-tiles the two products with plain FMAs (no tensor cores yet).
//   Kv tiles wholly past the tile's last query slot are skipped, so a short
//   prompt in a long cache reads only the slots it can see.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
template <typename T, int HD>
__device__ __forceinline__ void load_decode_tile(const T* k_head, const T* v_head, int j0,
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

template <typename T, int HD>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ kv_valid,
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
  const T* k_head = k + head_off;
  const T* v_head = v + head_off;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

  float k_cur[kSlotsPerWarp][kPerLane], v_cur[kDecodeTile];
  if (n_tiles > 0) load_decode_tile<T, HD>(k_head, v_head, 0, S, k_cur, v_cur);
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kDecodeTile;
    const bool more = t + 1 < n_tiles;
    float k_nxt[kSlotsPerWarp][kPerLane], v_nxt[kDecodeTile];
    if (more) load_decode_tile<T, HD>(k_head, v_head, j0 + kDecodeTile, S, k_nxt, v_nxt);
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
      for (int r = warp; r < rep; r += kDecodeWarps) {
        const float s = ok ? p_sh[r * kDecodeTile + lane] : kNegInf;
        const float m_old = m_sh[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        p_sh[r * kDecodeTile + lane] = p;
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
// B2: prefill, Sq > 1
// ---------------------------------------------------------------------------

constexpr int kPrefillThreads = 256;  // 16 x 16
constexpr int kBQ = 64;               // queries per block
constexpr int kBK = 64;               // kv slots per tile
constexpr int kRows = kBQ / 16;       // query rows per thread
constexpr int kSCols = kBK / 16;      // score columns per thread

template <int HD>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1)    // q tile, scaled
                          + (size_t)HD * (kBK + 1)  // K tile, transposed
                          + (size_t)kBK * HD        // V tile
                          + (size_t)kBQ * (kBK + 1) // p tile
                          + kBK);                   // slot validity
}

template <typename T, int HD>
__global__ void __launch_bounds__(kPrefillThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                     const int* __restrict__ slots, T* __restrict__ out, int Sq,
                     int N, int Nkv, int S, float scale) {
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

  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kPrefillThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    q_sh[r * (HD + 1) + d] =
        qi < Sq ? to_f32(q[(((size_t)b * Sq + qi) * N + n) * HD + d]) * scale : 0.f;
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
  const int q_last = slot0 + min(q0 + kBQ, Sq) - 1;  // slot of the tile's last query
  const int n_tiles = q_last < 0 ? 0 : min((S + kBK - 1) / kBK, q_last / kBK + 1);
  const size_t head_off = ((size_t)b * Nkv + kvh) * (size_t)S * HD;
  const T* k_head = k + head_off;
  const T* v_head = v + head_off;
  const uint8_t* ok_row = kv_valid + (size_t)b * S;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // q tile written / previous tile consumed
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kPrefillThreads) {
      const int j = idx / HD, d = idx % HD;
      const bool in = j0 + j < S;
      kt_sh[d * (kBK + 1) + j] = in ? to_f32(k_head[(size_t)(j0 + j) * HD + d]) : 0.f;
      v_sh[j * HD + d] = in ? to_f32(v_head[(size_t)(j0 + j) * HD + d]) : 0.f;
    }
    for (int j = threadIdx.x; j < kBK; j += kPrefillThreads)
      ok_sh[j] = (j0 + j < S && ok_row[j0 + j] != 0) ? 1.f : 0.f;
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
        ok[c] = ok_sh[jj] != 0.f && j0 + jj <= q_slot;
        s[i][c] = ok[c] ? s[i][c] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        p_sh[(ty + 16 * i) * (kBK + 1) + tx + 16 * c] = p;
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

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* kv_valid, const void* slots, void* out, int B,
                          int N, int Nkv, int S, float scale, cudaStream_t stream) {
  const int rep = N / Nkv;
  const size_t smem = sizeof(float) * (2 * (size_t)rep * HD + (size_t)rep * kDecodeTile + 3 * rep);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<T, HD><<<dim3(Nkv, B), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<T*>(out), N, Nkv, S, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* kv_valid, const void* slots, void* out, int B,
                           int Sq, int N, int Nkv, int S, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  static bool configured = false;  // once per process: keeps the call out of graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, N, B);
  flash_prefill_kernel<T, HD><<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(slots),
      static_cast<T*>(out), Sq, N, Nkv, S, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer is a device pointer;
// ``stream`` is a cudaStream_t.  Returns a cudaError_t (0 = launched).
extern "C" {

int vcla_flash_decode(const void* q, const void* k, const void* v, const void* kv_valid,
                      const void* slots, void* out, int B, int N, int Nkv, int S,
                      int head_dim, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return is_bf16 ? launch_decode<__nv_bfloat16, 128>(q, k, v, kv_valid, slots, out, B, N, Nkv, S, scale, st)
                   : launch_decode<float, 128>(q, k, v, kv_valid, slots, out, B, N, Nkv, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int vcla_flash_prefill(const void* q, const void* k, const void* v, const void* kv_valid,
                       const void* slots, void* out, int B, int Sq, int N, int Nkv, int S,
                       int head_dim, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return is_bf16 ? launch_prefill<__nv_bfloat16, 128>(q, k, v, kv_valid, slots, out, B, Sq, N, Nkv, S, scale, st)
                   : launch_prefill<float, 128>(q, k, v, kv_valid, slots, out, B, Sq, N, Nkv, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* vcla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
