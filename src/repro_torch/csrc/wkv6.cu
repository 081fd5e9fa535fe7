// The RWKV-6 (Finch) WKV recurrence, carrying its state (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6` in src/repro/kernels/rwkv6.py
// (body `_wkv6_kernel`), called by the RWKV time mix in prefill and
// training (models/rwkv.py):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// per (batch, head), with r/k/v [B, H, T, N] (f32 or bf16), the decay w
// [B, H, T, N] f32 in (0, 1), the bonus u [H, N] f32 and the state S
// [B, H, N, N] f32 (row i = key channel, column j = value channel); y in
// r's type, the final state f32.
//
// What bounds it: the bytes, on paper.  It reads r, k, v, w once and
// writes y once (plus the state): at rwkv6-1.6b's prefill (B 8, H 32,
// T 2,048, N 64) that is 679 MB, ~0.20 ms at 3.35 TB/s, against 4 * N^2
// flops per step and head (34 GFLOP, ~0.5 ms at 67 TFLOP/s f32 on paper,
// but the T steps of a head are sequential).  In practice the step-serial
// dependency bounds it: B * H = 256 independent heads are all the
// parallelism there is, two 32-thread warps each.
//
// Design.  The TPU kernel re-blocks time into chunks of C steps, does the
// intra-chunk part as [C, C, N] matrix products and carries S in VMEM
// scratch across the sequential time axis of its grid (and asserts
// T % C == 0).  Here one block owns one (b, h) with one thread per value
// channel j (N <= 128): thread j keeps column j of S in registers for the
// whole sequence, so the state never leaves the SM, and a loop over T
// inside the block takes the place of the TPU's sequential grid axis, so
// any T is taken.  At each step the threads put r_t, k_t, w_t and u*k_t
// in shared memory (double-buffered: one barrier a step) and thread j
// computes y_t[j] = sum_i r_i (S_ij + u_i k_i v_j) and S_ij <- w_i S_ij +
// k_i v_j, reading the staged vectors as float4 broadcasts, with four
// partial sums to break the add chain.  The next step's inputs are loaded
// while this one computes.  The exact step recurrence needs no log or exp
// of the decay, where the chunked form does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// NMAX threads; thread j < N owns value channel j, the rest stage zeros
template <typename T, int NMAX>
__global__ void __launch_bounds__(NMAX)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int H, int steps,
            int N) {
  __shared__ __align__(16) float sh[2][4][NMAX];  // r, k, w, u*k of a step
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x;
  const bool live = j < N;
  const int64_t base = static_cast<int64_t>(bh) * steps * N;
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;

  float S[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
    S[i] = (s0 != nullptr && live && i < N) ? s0[sbase + i * N + j] : 0.f;
  const float uj = live ? u[h * N + j] : 0.f;

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (live && steps > 0) {
    rn = ld(r + base + j);
    kn = ld(k + base + j);
    vn = ld(v + base + j);
    wn = w[base + j];
  }
  for (int t = 0; t < steps; ++t) {
    const float vj = vn;
    float(*buf)[NMAX] = sh[t & 1];
    buf[0][j] = rn;
    buf[1][j] = kn;
    buf[2][j] = wn;
    buf[3][j] = uj * kn;
    if (live && t + 1 < steps) {  // the next step's inputs, in flight now
      const int64_t nx = base + static_cast<int64_t>(t + 1) * N + j;
      rn = ld(r + nx);
      kn = ld(k + nx);
      vn = ld(v + nx);
      wn = w[nx];
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NMAX; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&buf[0][i]);
      const float4 k4 = *reinterpret_cast<const float4*>(&buf[1][i]);
      const float4 w4 = *reinterpret_cast<const float4*>(&buf[2][i]);
      const float4 uk4 = *reinterpret_cast<const float4*>(&buf[3][i]);
      acc[0] = fmaf(r4.x, fmaf(uk4.x, vj, S[i]), acc[0]);
      acc[1] = fmaf(r4.y, fmaf(uk4.y, vj, S[i + 1]), acc[1]);
      acc[2] = fmaf(r4.z, fmaf(uk4.z, vj, S[i + 2]), acc[2]);
      acc[3] = fmaf(r4.w, fmaf(uk4.w, vj, S[i + 3]), acc[3]);
      S[i] = fmaf(w4.x, S[i], k4.x * vj);
      S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
      S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
      S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
    }
    if (live)
      st(y + base + static_cast<int64_t>(t) * N + j,
         (acc[0] + acc[1]) + (acc[2] + acc[3]));
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      if (i < N) s_out[sbase + i * N + j] = S[i];
  }
}

template <typename T, int NMAX>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int H, int steps, int N,
                   cudaStream_t stream) {
  wkv6_kernel<T, NMAX><<<B * H, NMAX, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), H, steps, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_out, int B, int H, int steps, int N,
                     cudaStream_t s) {
  if (N <= 32)
    return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, H, steps, N, s);
  if (N <= 64)
    return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, H, steps, N, s);
  return launch<T, 128>(r, k, v, w, u, s0, y, s_out, B, H, steps, N, s);
}

}  // namespace

// dtype of r/k/v/y: 0 = f32, 1 = bf16; w, u, the states are f32.  s0 may be
// null (a zero initial state).  Returns the launch's cudaError_t; the
// caller raises on anything but 0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* y,
                    void* s_out, int B, int H, int steps, int N, int dtype,
                    void* stream) {
  if (static_cast<int64_t>(B) * H == 0 || N == 0) return 0;
  if (B < 0 || H < 0 || steps < 0 || N < 0 || N > 128 ||
      static_cast<int64_t>(B) * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, y, s_out, B, H, steps, N, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, steps,
                                   N, s);
  return cudaErrorInvalidValue;
}
