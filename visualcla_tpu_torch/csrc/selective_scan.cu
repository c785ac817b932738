// Kernel B8: Mamba-1's causal depthwise convolution and selective scan, in a
// chunk form (admissions) and a step form (decode).
//
// Replaces no TPU kernel: the JAX package has no state-space layers.  It is
// added for the Jamba text tower (models/jamba.py), whose Mamba mixers are
// transformers' ``JambaMambaMixer.slow_forward`` (modeling_jamba.py:725-808):
//   u = silu(conv1d(x) + bias)   (4 taps, depthwise, causal)
//   s_t = exp(A dt_t) s_{t-1} + (dt_t B_t) u_t,  A = -exp(A_log),
//   dt_t = softplus(dt_proj(...)_t + dt_bias), the bias added in f32
//   y_t = (C_t . s_t + D u_t) silu(z_t)
// with the conv state (the last 3 inputs, bf16) and the SSM state (D x N,
// f32) carried between calls.
//
// Contract (D channels, N = 16 states a channel; rows B):
//   selective_conv_chunk_kernel: x (B, W, ·) bf16 (strided: the in_proj
//   output's first half), weight (D, 4), bias (D) bf16, the conv state in
//   (B, D, 3) and out (another buffer), lens (B) int32: u (B, W, D) bf16 =
//   silu(conv) at t < lens[b], 0 past it; the state out holds the last 3
//   inputs before lens[b] (the state in where fewer).
//   selective_conv_step_kernel: one token a row, x (B, 1, ·), the state in
//   place, updated only for rows with run[b] != 0 (u is 0 for the others).
//   selective_scan_kernel: u, dt (B, W, D) bf16 (dt_proj's product without
//   its bias), dt_bias (D), A_log (D, N), B and C (B, W, N), the skip D (D)
//   bf16, z (B, W, ·) strided, the state (B, D, N) f32 in place, lens (B):
//   y (B, W, D) bf16; positions t >= lens[b] take dt = 0, so they leave the
//   state as it was.  The step form is this kernel at W = 1 with lens the
//   pass's run vector (kStep: a row that does not run reads and writes no
//   state, and its y is 0).
//
// What bounds it: the recurrence is sequential in t and tiny a channel (16
// multiply-adds and 16 exponentials a token), so the chunk form is bound by
// latency, and the step form by the f32 state it reads and writes (512 KB a
// row and layer at D 8192, N 16).  The design: one thread a (row, channel,
// state), so a warp holds two channels and their 16 states in registers for
// the whole chunk, the loads of a token (u, dt, z: one a channel; B, C: one
// a state) do not depend on the state and are loaded ahead of it, C . s is a
// 16-lane shuffle tree (a fixed order: a call repeats bit for bit).  The
// convolution is one thread a (row, position, channel), with no sequential
// dependence at all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;  // states a channel

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float softplus(float v) {  // torch's, threshold 20
  return v > 20.f ? v : log1pf(expf(v));
}

__global__ void selective_conv_chunk_kernel(const __nv_bfloat16* __restrict__ x, long sb, long st,
                                            const __nv_bfloat16* __restrict__ w,
                                            const __nv_bfloat16* __restrict__ bias,
                                            const __nv_bfloat16* __restrict__ state_in,
                                            __nv_bfloat16* __restrict__ state_out,
                                            const int* __restrict__ lens,
                                            __nv_bfloat16* __restrict__ u, int W, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const int len = lens[b];
  const __nv_bfloat16* xb = x + b * sb + d;
  const __nv_bfloat16* sin = state_in + ((size_t)b * D + d) * 3;
  auto xin = [&](int p) { return p >= 0 ? bf(xb[p * st]) : bf(sin[3 + p]); };
  float y = 0.f;
  if (t < len) {
    y = bias ? bf(bias[d]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) y += bf(w[d * 4 + j]) * xin(t - 3 + j);
    y = silu(y);
  }
  u[((size_t)b * W + t) * D + d] = __float2bfloat16(y);
  if (t == 0) {
    __nv_bfloat16* so = state_out + ((size_t)b * D + d) * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) so[j] = __float2bfloat16(xin(len - 3 + j));
  }
}

__global__ void selective_conv_step_kernel(const __nv_bfloat16* __restrict__ x, long sb,
                                           const __nv_bfloat16* __restrict__ w,
                                           const __nv_bfloat16* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ state,
                                           const int* __restrict__ run,
                                           __nv_bfloat16* __restrict__ u, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  if (!run[b]) {
    u[(size_t)b * D + d] = __float2bfloat16(0.f);
    return;
  }
  __nv_bfloat16* s = state + ((size_t)b * D + d) * 3;
  const __nv_bfloat16 s0 = s[0], s1 = s[1], s2 = s[2], xt = x[b * sb + d];
  float y = bias ? bf(bias[d]) : 0.f;
  y += bf(w[d * 4 + 0]) * bf(s0) + bf(w[d * 4 + 1]) * bf(s1) + bf(w[d * 4 + 2]) * bf(s2) +
       bf(w[d * 4 + 3]) * bf(xt);
  u[(size_t)b * D + d] = __float2bfloat16(silu(y));
  s[0] = s1;
  s[1] = s2;
  s[2] = xt;
}

template <bool kStep>
__global__ void __launch_bounds__(128)
    selective_scan_kernel(const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ dt,
                          const __nv_bfloat16* __restrict__ dt_bias,
                          const __nv_bfloat16* __restrict__ A_log,
                          const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                          const __nv_bfloat16* __restrict__ Dsk, const __nv_bfloat16* __restrict__ z,
                          long zb, long zt, float* __restrict__ state,
                          const int* __restrict__ lens, __nv_bfloat16* __restrict__ y, int W,
                          int D) {
  const int n = threadIdx.x % kN;
  const int d = blockIdx.x * (blockDim.x / kN) + threadIdx.x / kN;
  const int b = blockIdx.y;
  const bool live = d < D;  // every lane takes part in the shuffles
  const int dd = live ? d : 0;
  const int len = lens[b];
  if (kStep && len == 0) {  // a row that does not run: no state read, y 0
    if (n == 0 && live) y[(size_t)b * D + dd] = __float2bfloat16(0.f);
    return;
  }
  const float a = -expf(bf(A_log[dd * kN + n]));
  const float dskip = bf(Dsk[dd]), bias = bf(dt_bias[dd]);
  float* sp = state + ((size_t)b * D + dd) * kN + n;
  float s = *sp;
  const size_t row = (size_t)b * W;
#pragma unroll 4
  for (int t = 0; t < W; ++t) {
    const size_t i = (row + t) * D + dd;
    const float uu = bf(u[i]);
    const float raw = bf(dt[i]);
    const float zz = bf(z[b * zb + t * zt + dd]);
    const float bn = bf(Bm[(row + t) * kN + n]);
    const float cn = bf(Cm[(row + t) * kN + n]);
    const float dtv = t < len ? softplus(raw + bias) : 0.f;
    s = expf(a * dtv) * s + (dtv * bn) * uu;
    float p = s * cn;
#pragma unroll
    for (int off = kN / 2; off > 0; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (n == 0 && live) y[i] = __float2bfloat16((p + dskip * uu) * silu(zz));
  }
  if (live) *sp = s;
}

int status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int vcla_selective_conv_chunk(const void* x, long sb, long st, const void* w, const void* bias,
                              const void* state_in, void* state_out, const void* lens, void* u,
                              int B, int W, int D, void* stream) {
  dim3 grid((D + 127) / 128, W, B);
  selective_conv_chunk_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), sb, st, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(state_in),
      static_cast<__nv_bfloat16*>(state_out), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(u), W, D);
  return status();
}

int vcla_selective_conv_step(const void* x, long sb, const void* w, const void* bias, void* state,
                             const void* run, void* u, int B, int D, void* stream) {
  dim3 grid((D + 127) / 128, B);
  selective_conv_step_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), sb, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(state),
      static_cast<const int*>(run), static_cast<__nv_bfloat16*>(u), D);
  return status();
}

int vcla_selective_scan(const void* u, const void* dt, const void* dt_bias, const void* A_log,
                        const void* Bm,
                        const void* Cm, const void* Dsk, const void* z, long zb, long zt,
                        void* state, const void* lens, void* y, int B, int W, int D, int N,
                        int step, void* stream) {
  if (N != kN) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + 7) / 8, B);
  auto kern = step ? selective_scan_kernel<true> : selective_scan_kernel<false>;
  kern<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(dt_bias), static_cast<const __nv_bfloat16*>(A_log),
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const __nv_bfloat16*>(Dsk),
      static_cast<const __nv_bfloat16*>(z), zb, zt, static_cast<float*>(state),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(y), W, D);
  return status();
}

const char* vcla_selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
