// Causal GQA attention with an online softmax (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`), called by
// the LM's prefill and training attention (models/attention.py):
//
//   o[b, t, h] = sum_s softmax_s(q[b, t, h] . k[b, s, h / G] * scale)
//                      v[b, s, h / G]
//
// over the keys s that the mask lets row t see: s <= t + q_offset when
// causal, s > t + q_offset - window with a window.  q [B, Tq, Hq, D],
// k/v [B, Tk, Hkv, D], f32 or bf16, G = Hq / Hkv; arithmetic in f32, the
// output in q's type.
//
// What bounds it: the operations.  A causal prefill does
// 4 * B * Hq * D * Tq * Tk / 2 flops on B * (Tq * Hq + 2 * Tk * Hkv) * D
// elements: at qwen2-7b's shape (B 8, T 2,048, Hq 28, Hkv 4, D 128) that
// is 240 GFLOP on 88 MB, ~2,700 flops a byte, far above the card's
// balance.  In f32 the product runs on the CUDA cores (67 TFLOP/s; TF32
// would change the results), so the bound is ~3.6 ms there.
//
// Design.  The TPU kernel walks a (B*Hq, Tq/bq, Tk/bk) grid with the KV
// axis sequential and keeps the running max, sum and accumulator in VMEM
// scratch across grid steps; on Hopper blocks run in no order, so here
// one block owns one (b, query head, tile of 64 query rows) and loops
// over the 64-key tiles itself, keeping every row's running max, sum and
// accumulator in registers.  The Q tile stays in shared memory for the
// whole loop; each K tile, then the V tile over it, comes into one
// shared buffer (bf16 converted to f32 on load; rows past Tk are zeros).
// 256 threads: thread (rg, cg) = (tid / 16, tid % 16) holds rows
// 4 rg .. 4 rg + 3, the score columns cg + 16 j of a tile and the output
// columns 4 cg .. 4 cg + 3 and 64 + 4 cg .. 64 + 4 cg + 3 (so D <= 128,
// D % 4 == 0); a row's 16 threads share one half-warp and reduce its max
// and sum with shuffles.  Rows are padded to D + 4 floats in shared
// memory so the 16-byte reads of a K column hit distinct banks.  Only
// the tiles that the causal mask and the window let some row of the
// block see are visited, which skips every fully masked tile; the ragged
// ends of Tq and Tk are masked here, so any length is taken (the Pallas
// kernel asserts Tq and Tk are block multiples).  Tensor cores, wgmma and
// TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kLdp = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows [0, 64) of a tensor whose rows are `stride` elements apart -> an
// f32 tile [64][ldd] in shared memory; rows at or past `nvalid` are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int nvalid, int D,
                                          int ldd) {
  const int per_row = D >> 2;
  for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) x = load4(src + r * stride + c);
    store4(dst + r * ldd + c, x);
  }
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float get(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Tq,
                       int Tk, int Hq, int Hkv, int D, float scale,
                       int causal, int window, int q_offset) {
  extern __shared__ __align__(16) float smem[];
  const int ldd = D + 4;
  float* qs = smem;              // [64][ldd]  Q tile, whole loop
  float* kvs = qs + kBQ * ldd;   // [64][ldd]  K tile, then V tile
  float* ps = kvs + kBK * ldd;   // [64][kLdp] probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, Tq - q0);
  const int64_t qstride = static_cast<int64_t>(Hq) * D;
  const int64_t kstride = static_cast<int64_t>(Hkv) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * Tq + q0) * qstride +
                       static_cast<int64_t>(h) * D;
  const int64_t koff = static_cast<int64_t>(b) * Tk * kstride +
                       static_cast<int64_t>(hk) * D;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4 rg .. 4 rg + 3
  const int cg = tid & 15;  // score columns cg + 16 j
  const int d0 = cg << 2;   // output columns d0 .. d0 + 3
  const int d1 = 64 + d0;   // and d1 .. d1 + 3
  const bool has0 = d0 < D;
  const bool has1 = d1 < D;

  load_tile(qs, q + qoff, qstride, nq, D, ldd);

  // the key span that some row of this block may see
  const int qmin = q0 + q_offset;
  const int qmax = q0 + nq - 1 + q_offset;
  const int k_end = causal ? min(Tk, qmax + 1) : Tk;
  const int k_begin = window > 0 ? max(0, qmin - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    const int nk = min(kBK, Tk - k0);
    __syncthreads();  // the last tile's V reads are done
    load_tile(kvs, k + koff + k0 * kstride, kstride, nk, D, ldd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (rg * 4 + i) * ldd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(kvs + (cg + 16 * j) * ldd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fma4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
      const int qpos = q0 + row + q_offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg + 16 * j;
        const int kpos = k0 + col;
        ok[j] = row < nq && col < nk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[row * kLdp + cg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();  // scores have read K; P is written
    load_tile(kvs, v + koff + k0 * kstride, kstride, nk, D, ldd);
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(ps + (rg * 4 + i) * kLdp + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kvs + (c + cc) * ldd;
        const float4 v0 = has0 ? load4(vrow + d0) : make_float4(0, 0, 0, 0);
        const float4 v1 = has1 ? load4(vrow + d1) : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = get(pv[i], cc);
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg * 4 + i;
    if (row >= nq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + qoff + row * qstride;
    if (has0)
      store4(orow + d0, make_float4(acc[i][0] / den, acc[i][1] / den,
                                    acc[i][2] / den, acc[i][3] / den));
    if (has1)
      store4(orow + d1, make_float4(acc[i][4] / den, acc[i][5] / den,
                                    acc[i][6] / den, acc[i][7] / den));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hkv, int D, float scale,
                   int causal, int window, int q_offset,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (D + 4) + kBQ * kLdp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, Hq, Hkv, D, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0 means none.  Returns the launch's
// cudaError_t; the caller raises on anything but 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Tq, int Tk, int Hq,
                               int Hkv, int D, int dtype, float scale,
                               int causal, int window, int q_offset,
                               void* stream) {
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  if (B < 0 || Tq < 0 || Tk < 0 || Hkv <= 0 || Hq % Hkv || D <= 0 ||
      D > kMaxD || D % 4 || Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Tq, Tk, Hq, Hkv, D, scale, causal,
                         window, q_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, Hq, Hkv, D, scale,
                                 causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}
