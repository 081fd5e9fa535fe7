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
// at 3.35 TB/s, so at serving shapes the launch and the chain of dependent
// steps of one row (id, row address, row loads, sums, store) are the bound.
//
// Design.  The TPU kernel scalar-prefetches the ids and double-buffers row
// DMAs into VMEM slabs; none of that carries over.  Here a group of G lanes
// owns one (b, k) row and a warp packs 32 / G consecutive rows.  A lane
// takes the row a word at a time: 4 values (16 bytes of f32, 8 of bf16, 4
// of int8) against one float4 of the query, the words going round the
// group, so the group's row loads and its query loads are both contiguous
// whatever the type.  (Loads of 16 row bytes a lane need 16 query floats a
// lane for int8, 64-byte strided, and measured slower.)  G is sized to the
// row's words: 8 lanes up to kMax8 values, 16 up to kMax16, else 32, so a
// lane has one to a few words and an int8 or bf16 row costs no more
// instructions than an f32 one, only fewer bytes.  The query's floats do
// not need the id, so a lane issues their loads first, then the id's: the
// group's lanes read the same 8 bytes (one request for the warp's ids),
// clip them and, for int8, read scales[id], which scales the row's two
// sums once at the end.  Then every row load of the lane (kSlots words)
// before its first FMA, the int8 values converted without I2F (2^23 + v +
// 128 as an f32, less 2^23 + 128).  Rows or queries off their word
// boundary (a table base past one, such as a row slice, or D % 4 != 0)
// take word loads over each row's aligned middle and narrow loads for the
// at most 3 values at each end, with the query's float4s realigned to the
// middle.  A butterfly over the group leaves both sums at its first lane,
// which stores them.  Nothing waits on another warp: no shared memory, no
// barrier, no atomic, no division per row.  The warp's first query is
// (r0 + 1/2) / K in f32 (exact while B K < 2^22, else one integer division
// a warp).
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_sweep.py gather, 20
// launches on 20 id sets captured as one CUDA graph, replayed in turns with
// the previous version's, one row a warp): at the serving shape (n 32,768,
// B 256, K 17, D 128) 2.26-2.37 us f32, 2.23-2.34 bf16, 2.23-2.38 int8,
// against 2.62-2.76, 2.78-2.89 and 2.93-3.08; from a 2^21-row table (B 128,
// K 48), L2 evicted before each replay, 4.44-4.57, 3.72-4.00 and 3.68-3.83
// against 4.88-5.00, 3.94-4.21 and 3.97-4.00; at B 8 as before (1.9-2.1
// us).  The same grid returning at once takes 1.2-1.9 us: the launch floor
// of a replayed graph, which every time above includes.  A programmatic
// dependent launch behind a torch op measured 0.03-0.1 us slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kMax8 = 48;    // the widest row, in values, that takes 8 lanes
constexpr int kMax16 = 128;  // the widest row, in values, that takes 16 lanes
constexpr int kSlots = 2;    // words a lane loads before its first FMA
constexpr unsigned kFull = 0xffffffffu;

// A word: 4 values of T, loaded as Raw and unpacked to floats.
template <typename T>
struct Word;

template <>
struct Word<float> {
  using Raw = uint4;
  static constexpr bool kScaled = false;
  __device__ static void unpack(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ static float upcast(float v) { return v; }
};

template <>
struct Word<__nv_bfloat16> {
  using Raw = uint2;
  static constexpr bool kScaled = false;
  __device__ static void unpack(uint2 r, float* x) {
    x[0] = __uint_as_float(r.x << 16);  // a bf16 is the top half of an f32
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static float upcast(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <>
struct Word<int8_t> {
  using Raw = unsigned;
  static constexpr bool kScaled = true;
  __device__ static void unpack(unsigned r, float* x) {
    const unsigned u = r ^ 0x80808080u;  // each byte v + 128
#pragma unroll
    for (int i = 0; i < 4; ++i)  // 2^23 + v + 128, less 2^23 + 128: exact
      x[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + i)) -
             8388736.0f;
  }
  __device__ static float upcast(int8_t v) { return static_cast<float>(v); }
};

__device__ __forceinline__ int misalign(const float* p) {  // floats past 16 B
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The 4 floats from float m (0-3) on of the 8 in lo, hi.
__device__ __forceinline__ float4 shift4(float4 lo, float4 hi, int m) {
  const bool m1 = m == 1, m2 = m == 2, m3 = m == 3;
  return make_float4(m1 ? lo.y : m2 ? lo.z : m3 ? lo.w : lo.x,
                     m1 ? lo.z : m2 ? lo.w : m3 ? hi.x : lo.y,
                     m1 ? lo.w : m2 ? hi.x : m3 ? hi.y : lo.z,
                     m1 ? hi.x : m2 ? hi.y : m3 ? hi.z : lo.w);
}

// The query floats of this lane's words i = base + s G: 4 floats from
// qm + 4 i, where qm lies m floats past a 16-byte boundary.  They come as
// the aligned float4 there and, if m > 0, the next one, shifted by m (a
// 16-byte-aligned float4 that holds a float of q lies inside q's
// allocation).
template <int G>
__device__ __forceinline__ void load_query(const float* qm, int m, int nw,
                                           int base, bool live,
                                           float4 (&qw)[kSlots]) {
  const float4* q4 = reinterpret_cast<const float4*>(qm - m);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = base + s * G;
    if (!live || i >= nw) continue;
    const float4 lo = __ldg(q4 + i);
    qw[s] = m ? shift4(lo, __ldg(q4 + i + 1), m) : lo;
  }
}

template <typename Raw, int G>
__device__ __forceinline__ void load_row(const Raw* vw, int nw, int base,
                                         bool live, Raw (&raw)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = base + s * G;
    if (live && i < nw) raw[s] = __ldg(vw + i);
  }
}

template <typename T, int G>
__device__ __forceinline__ void accumulate(
    typename Word<T>::Raw (&raw)[kSlots], float4 (&qw)[kSlots], int nw,
    int base, bool live, float (&dot)[2], float (&sq)[2]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (!live || base + s * G >= nw) continue;
    float x[4];
    Word<T>::unpack(raw[s], x);
    dot[0] = fmaf(x[0], qw[s].x, fmaf(x[1], qw[s].y, dot[0]));
    dot[1] = fmaf(x[2], qw[s].z, fmaf(x[3], qw[s].w, dot[1]));
    sq[0] = fmaf(x[0], x[0], fmaf(x[1], x[1], sq[0]));
    sq[1] = fmaf(x[2], x[2], fmaf(x[3], x[3], sq[1]));
  }
}

// kAligned: every row starts on a word boundary and every query row on a
// 16-byte one, and D % 4 == 0 (the launch checks the base pointers and D).
template <typename T, int G, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
gather_norm_dot_kernel(const T* __restrict__ table,
                       const float* __restrict__ scales,
                       const int64_t* __restrict__ ids,
                       const float* __restrict__ q, float* __restrict__ dots,
                       float* __restrict__ v2, int rows, int K, int D,
                       int64_t n, float inv_k) {
  using Raw = typename Word<T>::Raw;
  constexpr int R = 32 / G;  // rows a warp
  const int lane = threadIdx.x & 31, g = lane / G, lg = lane % G;
  const int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  if (r0 >= rows) return;  // the whole warp
  const bool live = r0 + g < rows;

  // the group's query ((r0 + 1/2) / K in f32 is exact while rows < 2^22)
  const int b0 = rows < (1 << 22)
                     ? static_cast<int>((static_cast<float>(r0) + 0.5f) * inv_k)
                     : r0 / K;
  int b = b0;
  if (live)
    for (int k = r0 - b0 * K + g; k >= K; k -= K) ++b;
  const float* qb = q + static_cast<int64_t>(b) * D;
  float4 qw[kSlots];
  Raw raw[kSlots];
  float dot[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
  if (kAligned)  // issued before the id's load: they do not need it
    load_query<G>(qb, 0, D / 4, lg, live, qw);

  // the group's row: its lanes read the same id (one request a warp)
  int64_t id = 0;
  if (live) {
    id = __ldg(ids + r0 + g);
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  }
  float s = 1.f;
  if (Word<T>::kScaled && live) s = __ldg(scales + id);
  const T* vb = table + id * D;

  int nw = D / 4;  // the row's words
  const T* vm = vb;  // the first of them
  const float* qm = qb;  // its query floats
  int m = 0;  // floats past a 16-byte boundary of qm
  if (!kAligned) {
    constexpr int kWordBytes = 4 * sizeof(T);
    const int head = min(static_cast<int>(
        (kWordBytes - reinterpret_cast<uintptr_t>(vb) % kWordBytes) %
        kWordBytes / sizeof(T)), D);
    nw = (D - head) / 4;
    vm = vb + head;
    qm = qb + head;
    m = misalign(qm);
    const int tail = head + 4 * nw;  // at most 3 values at each end
    if (live && lg < head) {
      const float x = Word<T>::upcast(vb[lg]);
      dot[0] = x * __ldg(qb + lg);
      sq[0] = x * x;
    }
    if (live && lg >= 4 && lg - 4 < D - tail) {
      const float x = Word<T>::upcast(vb[tail + lg - 4]);
      dot[1] = x * __ldg(qb + tail + lg - 4);
      sq[1] = x * x;
    }
  }
  const Raw* vw = reinterpret_cast<const Raw*>(vm);
  for (int base = lg; base < nw; base += kSlots * G) {
    if (!kAligned || base != lg) load_query<G>(qm, m, nw, base, live, qw);
    load_row<Raw, G>(vw, nw, base, live, raw);
    accumulate<T, G>(raw, qw, nw, base, live, dot, sq);
  }

  float d = dot[0] + dot[1], e = sq[0] + sq[1];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    d += __shfl_xor_sync(kFull, d, off);
    e += __shfl_xor_sync(kFull, e, off);
  }
  if (lg == 0 && live) {
    dots[r0 + g] = d * s;
    v2[r0 + g] = e * (s * s);
  }
}

template <typename T>
using Kernel = void (*)(const T*, const float*, const int64_t*, const float*,
                        float*, float*, int, int, int, int64_t, float);

template <typename T, int G>
Kernel<T> pick(bool aligned) {
  return aligned ? gather_norm_dot_kernel<T, G, true>
                 : gather_norm_dot_kernel<T, G, false>;
}

template <typename T>
cudaError_t launch(const void* table, const float* scales, const int64_t* ids,
                   const float* q, float* dots, float* v2, int rows, int K,
                   int D, int64_t n, cudaStream_t stream) {
  const uintptr_t word = 4 * sizeof(T);  // a word's bytes
  const bool aligned = D % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(table) % word == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int G = D <= kMax8 ? 8 : D <= kMax16 ? 16 : 32;
  const Kernel<T> kern = G == 8    ? pick<T, 8>(aligned)
                         : G == 16 ? pick<T, 16>(aligned)
                                   : pick<T, 32>(aligned);
  const int R = 32 / G;  // rows a warp
  const int64_t warps = (static_cast<int64_t>(rows) + R - 1) / R;
  const int64_t grid = (warps + kWarps - 1) / kWarps;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(grid), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), scales, ids, q, dots, v2, rows, K, D, n,
      1.0f / K);
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
  if (B < 0 || K < 0 || D < 0 || n < 1 ||
      static_cast<int64_t>(B) * K > INT_MAX)
    return cudaErrorInvalidValue;
  const int rows = B * K;
  const float* sc = static_cast<const float*>(scales);
  const int64_t* id = static_cast<const int64_t*>(ids);
  const float* qf = static_cast<const float*>(q);
  float* d = static_cast<float*>(dots);
  float* v = static_cast<float*>(v2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(table, nullptr, id, qf, d, v, rows, K, D, n, st);
    case 1:
      return launch<__nv_bfloat16>(table, nullptr, id, qf, d, v, rows, K, D,
                                   n, st);
    case 2:
      if (sc == nullptr) return cudaErrorInvalidValue;
      return launch<int8_t>(table, sc, id, qf, d, v, rows, K, D, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
