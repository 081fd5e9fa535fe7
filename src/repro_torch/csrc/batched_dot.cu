// Batched matvec over already-gathered candidate rows (sm_90a).
//
// Replaces the Pallas TPU kernel `batched_dot` in
// src/repro/kernels/distance.py (body `_dot_kernel`), called once per hop of
// the reference hop pipeline (`eval_materialized` in core/hop_reference.py)
// and once per construction search of that pipeline:
//
//   out[b, k] = < v[b, k, :], q[b, :] >      v f32[B, K, D], q f32[B, D]
//
// What bounds it: the candidate bytes.  It reads B*K*D*4 bytes of rows and
// B*D*4 of queries, writes B*K*4, and does 2*B*K*D flops: a quarter of a
// flop per byte, far below the card's balance point.  At the serving shape
// (B = 256, K = 17, D = 128) that is ~2.4 MB, ~0.71 us at 3.35 TB/s, so at
// serving shapes the launch itself (a few us) is the bound.
//
// Design.  The TPU kernel tiles (B, K) into (bB, bK) VMEM blocks padded to
// the MXU's tile and contracts D on the matrix unit; none of that carries
// over (a matvec has no reuse for tensor cores, and padding K = 17 to 128
// would read 7x the bytes).  Here a block owns one query b and up to
// kWarps of its K rows: the query row is staged once into shared memory,
// then one warp per (b, k) row reads the row in 16-byte float4 loads
// (coalesced: a warp covers 512 contiguous bytes per step), multiplies
// against the staged query and reduces with warp shuffles.  A D that is
// not a multiple of 4, or an unaligned base pointer, takes the scalar
// loop instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // candidate rows per block
constexpr int kMaxD = 12288;  // D*4 bytes of staged query <= 48 KB

__global__ void __launch_bounds__(kWarps * 32)
batched_dot_kernel(const float* __restrict__ v, const float* __restrict__ q,
                   float* __restrict__ out, int K, int D, int kchunks,
                   int vec4) {
  extern __shared__ __align__(16) float qs[];
  const int b = blockIdx.x / kchunks;
  const int k = (blockIdx.x % kchunks) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const float* qb = q + static_cast<int64_t>(b) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = __ldg(qb + d);
  __syncthreads();
  if (k >= K) return;
  const float* row = v + (static_cast<int64_t>(b) * K + k) * D;
  float acc = 0.0f;
  int d0 = 0;
  if (vec4) {
    const int nv = D >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int c = lane; c < nv; c += 32) {
      const float4 x = __ldg(r4 + c);
      const float4 y = q4[c];
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
    d0 = nv << 2;
  }
  for (int d = d0 + lane; d < D; d += 32) {  // scalar path / tail
    acc = fmaf(__ldg(row + d), qs[d], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[static_cast<int64_t>(b) * K + k] = acc;
}

}  // namespace

// Returns the launch's cudaError_t; the caller raises on anything but 0.
extern "C" int batched_dot(const void* v, const void* q, void* out, int B,
                           int K, int D, void* stream) {
  if (static_cast<int64_t>(B) * K == 0) return 0;
  if (B < 0 || K < 0 || D < 0 || D > kMaxD) return cudaErrorInvalidValue;
  const float* vf = static_cast<const float*>(v);
  const float* qf = static_cast<const float*>(q);
  const int vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(vf) % 16 == 0;
  const int kchunks = (K + kWarps - 1) / kWarps;
  const int64_t grid = static_cast<int64_t>(B) * kchunks;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  batched_dot_kernel<<<static_cast<unsigned>(grid), kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      vf, qf, static_cast<float*>(out), K, D, kchunks, vec4);
  return cudaGetLastError();
}
