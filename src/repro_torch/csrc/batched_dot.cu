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
// serving shapes the launch and the chain of dependent steps of one warp
// (index arithmetic, loads, reduction, store) are what it takes.
//
// Design.  The TPU kernel tiles (B, K) into (bB, bK) VMEM blocks padded to
// the MXU's tile and contracts D on the matrix unit; none of that carries
// over (a matvec has no reuse for tensor cores, and padding K = 17 to 128
// would read 7x the bytes).  Here a group of G lanes owns a row (b, k):
// G = 8 for D <= kQuadMax, 16 for D <= kPairMax, else 32, so that a warp
// packs 32 / G consecutive rows and its lanes stay busy at small D (D =
// 24: 4 rows a warp, 24 of 32 lanes loading, where one row a warp kept 6).
// A group reads its row flat: 16-byte loads over the row's 16-byte-aligned
// middle, going round the G lanes (4 loads in flight a lane), and 4-byte
// loads for the at most 3 floats at each end (lanes 0-2 and 4-6), so the
// load width depends neither on D % 4 nor on the base pointer.  The
// query's floats that meet a float4 come as 16-byte loads too: the aligned
// float4 at or below them and, where they start m floats past a 16-byte
// boundary, the next one, shifted by m.  Every load of a lane is issued
// before any is used, a butterfly over the group leaves the row's sum at
// its first lane, and nothing waits on another warp: no shared memory, no
// barrier, no atomic.  The warp's first query is (r0 + 1/2) / K in f32
// (exact while B K < 2^22, else an integer division), and the query steps
// along with the row from there.
// Measured on an H100 (tools/kernel_sweep.py batched_dot, 20 launches
// captured as a CUDA graph, replayed in turns with torch.bmm's on the same
// inputs): 0.89-0.90x torch.bmm's time at the serving shape (B 256, K 17,
// D 128), 0.91-0.93x at K 48, 0.91x at B 8, 0.80-0.82x at D 24 and
// 0.88-0.90x at D 33.  What it takes above the bound is the launch and one
// group's chain of dependent steps: a query staged behind a barrier, an
// integer division per float4, or four 4-byte query loads a float4 where
// the query's floats are not 16-byte aligned (D 33), each cost more.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // warps a block
constexpr int kQuadMax = 48;    // the widest row that takes 8 lanes
constexpr int kPairMax = 128;   // the widest row that takes 16 lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int misalign(const float* p) {  // floats past 16 B
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// The 4 floats from float m (0-3) on of the 8 in lo, hi.
__device__ __forceinline__ float4 shift4(float4 lo, float4 hi, int m) {
  const bool m1 = m == 1, m2 = m == 2, m3 = m == 3;
  return make_float4(m1 ? lo.y : m2 ? lo.z : m3 ? lo.w : lo.x,
                     m1 ? lo.z : m2 ? lo.w : m3 ? hi.x : lo.y,
                     m1 ? lo.w : m2 ? hi.x : m3 ? hi.y : lo.z,
                     m1 ? hi.x : m2 ? hi.y : m3 ? hi.z : lo.w);
}

// This lane's products of one row (b, k) that G lanes share (lane lg of
// them): D floats at vb against the query row at qb.  The float4s of the
// row's 16-byte-aligned middle go round the G lanes; lanes 0-2 take the
// floats before it, lanes 4-6 those after it.  The query's floats that
// meet a float4 start m floats past a 16-byte boundary: they come as the
// aligned float4 there and, if m > 0, the next one, shifted by m (a
// 16-byte-aligned float4 that holds a float of q lies inside q's
// allocation).
template <int G>
__device__ __forceinline__ float row_part(const float* vb, const float* qb,
                                          int D, int lg) {
  const int head = min((4 - misalign(vb)) & 3, D);
  const int n4 = (D - head) >> 2;
  const int tail = head + 4 * n4;
  float sum = 0.f;
  if (lg < head) sum = __ldg(vb + lg) * __ldg(qb + lg);
  if (lg >= 4 && lg - 4 < D - tail)
    sum = __ldg(vb + tail + lg - 4) * __ldg(qb + tail + lg - 4);
  const float4* v4 = reinterpret_cast<const float4*>(vb + head);
  const int m = misalign(qb + head);
  const float4* q4 = reinterpret_cast<const float4*>(qb + head - m);
#pragma unroll 4
  for (int i = lg; i < n4; i += G) {
    const float4 lo = __ldg(q4 + i);
    const float4 hi = m ? __ldg(q4 + i + 1) : lo;
    sum += dot4(__ldg(v4 + i), shift4(lo, hi, m));
  }
  return sum;
}

// 32 / G rows from r0 (whose query is b0, k0), G lanes a row: their
// butterfly leaves the row's sum at the group's first lane.
template <int G>
__device__ __forceinline__ void group_rows(const float* vb,
                                           const float* __restrict__ q,
                                           float* __restrict__ out, int rows,
                                           int K, int D, int r0, int b0,
                                           int k0, int lane) {
  const int g = lane / G, lg = lane % G;
  float s = 0.f;
  if (r0 + g < rows) {
    int b = b0, k = k0 + g;
    while (k >= K) k -= K, ++b;
    s = row_part<G>(vb + g * D, q + static_cast<int64_t>(b) * D, D, lg);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  if (lg == 0 && r0 + g < rows) out[r0 + g] = s;
}

__global__ void __launch_bounds__(kWarps * 32)
batched_dot_kernel(const float* __restrict__ v, const float* __restrict__ q,
                   float* __restrict__ out, int rows, int K, int D, int R,
                   float inv_k) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  if (r0 >= rows) return;  // the whole warp
  // the query of row r0 ((r0 + 1/2) / K in f32 is exact while rows < 2^22)
  const int b0 = rows < (1 << 22)
                     ? static_cast<int>((static_cast<float>(r0) + 0.5f) * inv_k)
                     : r0 / K;
  const int k0 = r0 - b0 * K;
  const float* vb = v + static_cast<int64_t>(r0) * D;
  if (D > kPairMax)
    group_rows<32>(vb, q, out, rows, K, D, r0, b0, k0, lane);
  else if (D > kQuadMax)
    group_rows<16>(vb, q, out, rows, K, D, r0, b0, k0, lane);
  else
    group_rows<8>(vb, q, out, rows, K, D, r0, b0, k0, lane);
}

}  // namespace

// Returns the launch's cudaError_t; the caller raises on anything but 0.
extern "C" int batched_dot(const void* v, const void* q, void* out, int B,
                           int K, int D, void* stream) {
  if (static_cast<int64_t>(B) * K == 0) return 0;
  if (B < 0 || K < 0 || D < 0 || static_cast<int64_t>(B) * K > INT_MAX)
    return cudaErrorInvalidValue;
  const int rows = B * K;
  if (D == 0) return cudaMemsetAsync(out, 0, sizeof(float) * rows,
                                     static_cast<cudaStream_t>(stream));
  const int R = D <= kQuadMax ? 4 : D <= kPairMax ? 2 : 1;  // rows a warp
  const int64_t warps = (static_cast<int64_t>(rows) + R - 1) / R;
  const int64_t grid = (warps + kWarps - 1) / kWarps;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  batched_dot_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(q),
      static_cast<float*>(out), rows, K, D, R, 1.0f / K);
  return cudaGetLastError();
}
