// Fused candidate gather + dequant + query dot + squared norm (sm_90a).
//
// Replaces the Pallas TPU kernel `gather_norm_dot` in
// src/repro/kernels/gather_distance.py (body `_slab_kernel`), called once
// per hop of the serving loop (`_hop_body` in core/device_search.py):
//
//   dots[b, k] = < deq(table[clip(ids[b, k])]), q[b] >
//   v2[b, k]   = | deq(table[clip(ids[b, k])]) |^2
//
// with deq = identity (f32), upcast (bf16) or upcast * scales[id] (int8).
// Both outputs are f32[B, K]; clip is to [0, n-1].
//
// What bounds it: the row bytes.  It moves B*K*(D*itemsize + 8 + 8) + B*D*4
// bytes (rows, int64 ids, two f32 outputs, queries) and does 4*B*K*D flops,
// about 1 flop per byte, far below the card's balance point.  At the
// serving shape (B = 256, K = 17, D = 128, f32) that is ~2.4 MB, ~0.7 us
// at 3.35 TB/s, so at serving shapes the launch (a few us) is the bound.
//
// Design.  The TPU kernel scalar-prefetches the ids and double-buffers row
// DMAs into VMEM slabs; none of that carries over.  Here one warp owns one
// (b, k) candidate row: it reads the id itself, clips it, and each lane
// reads 16 bytes of the row per step (f32: 4 values, bf16: 8, int8: 16), so
// a warp covers 512 bytes per step with fully coalesced loads and only the
// quantized bytes leave device memory.  The row is upcast and scaled in
// registers (the int8 scale is read directly at scales[id]; the TPU
// wrapper pre-gathers it), multiplied by the query read through the
// read-only cache, and both sums are reduced with warp shuffles.  No
// [B, K, D] tensor is written.  A D that is not a multiple of the vector
// width, or an unaligned base pointer, takes the scalar loop instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // candidate rows per block

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ float upcast(float x) { return x; }
__device__ __forceinline__ float upcast(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float upcast(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_norm_dot_kernel(const T* __restrict__ table,
                       const float* __restrict__ scales,
                       const int64_t* __restrict__ ids,
                       const float* __restrict__ q,
                       float* __restrict__ dots, float* __restrict__ v2,
                       int B, int K, int D, int64_t n, int nvec) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<int64_t>(B) * K) return;
  const int64_t b = row / K;
  int64_t id = ids[row];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* v = table + id * D;
  const float* qb = q + b * D;
  const float s = scales != nullptr ? scales[id] : 1.0f;

  constexpr int N = Vec16<T>::N;
  float dot = 0.0f;
  float sq = 0.0f;
  for (int c = lane; c < nvec; c += 32) {
    float x[N];
    Vec16<T>::load(v + c * N, x);
    float qf[N];
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 qv = __ldg(reinterpret_cast<const float4*>(qb + c * N) + j);
      qf[4 * j] = qv.x;
      qf[4 * j + 1] = qv.y;
      qf[4 * j + 2] = qv.z;
      qf[4 * j + 3] = qv.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xi = x[i] * s;
      dot = fmaf(xi, qf[i], dot);
      sq = fmaf(xi, xi, sq);
    }
  }
  for (int d = nvec * N + lane; d < D; d += 32) {  // scalar path / tail
    const float xi = upcast(v[d]) * s;
    dot = fmaf(xi, __ldg(qb + d), dot);
    sq = fmaf(xi, xi, sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) {
    dots[row] = dot;
    v2[row] = sq;
  }
}

template <typename T>
cudaError_t launch(const void* table, const float* scales, const int64_t* ids,
                   const float* q, float* dots, float* v2, int B, int K,
                   int D, int64_t n, cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const bool aligned =
      D % N == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int nvec = aligned ? D / N : 0;
  const int64_t rows = static_cast<int64_t>(B) * K;
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  gather_norm_dot_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), scales, ids, q, dots, v2, B, K, D, n,
      nvec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8 (scales required).  Returns the
// launch's cudaError_t; the caller raises on anything but 0.
extern "C" int gather_norm_dot(const void* table, int dtype,
                               const void* scales, const void* ids,
                               const void* q, void* dots, void* v2, int B,
                               int K, int D, int64_t n, void* stream) {
  if (static_cast<int64_t>(B) * K == 0) return 0;
  const float* sc = static_cast<const float*>(scales);
  const int64_t* id = static_cast<const int64_t*>(ids);
  const float* qf = static_cast<const float*>(q);
  float* d = static_cast<float*>(dots);
  float* v = static_cast<float*>(v2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, nullptr, id, qf, d, v, B, K, D, n, st);
    case 1:
      return launch<__nv_bfloat16>(table, nullptr, id, qf, d, v, B, K, D, n,
                                   st);
    case 2:
      if (sc == nullptr) return cudaErrorInvalidValue;
      return launch<int8_t>(table, sc, id, qf, d, v, B, K, D, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
