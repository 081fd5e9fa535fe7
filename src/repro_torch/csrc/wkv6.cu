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
// What bounds it.  It reads r, k, v, w once and writes y once (plus the
// state): at rwkv6-1.6b's prefill (B 8, H 32, T 2,048, N 64) that is
// 679 MB, ~0.20 ms at 3.35 TB/s.  The arithmetic is close behind: y_t[j]
// = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i) and S_ij <- w_i S_ij + k_i v_j
// are three FP32-pipe instructions per (i, j) and step, 8.6 G at that
// shape, ~0.21 ms on 132 SMs x 128 lanes at 1.83 GHz; and every operand
// a thread reads from shared memory costs one of the SM's 32 words a
// clock.  The T steps of a head are sequential, but only through
// S_ij <- w_i S_ij + k_i v_j, one FMA of latency: every column j of S
// evolves on its own (S_ij and y_t[j] read only column j and v_j), and
// the i-sum of y_t[j] splits over rows.
//
// Design.  The TPU kernel re-blocks time into chunks of C steps, does the
// intra-chunk part as [C, C, N] matrix products and carries S in VMEM
// scratch across the sequential time axis of its grid (and asserts
// T % C == 0).  Here the exact step recurrence runs in registers: one
// block per (b, h) of 2 N threads (N rounded up to 32, 64 or 128), a
// thread owning a 4-column x N / 8-row block of S (rows in groups of 4 at
// 4 (g + 8 m) for its row group g), so a step costs it 3 N / 2 FMAs
// against N / 8 * 3 + 4 words read, and 8 threads share a column.  The
// block stages C = 16 steps (8 at N = 128) of r, k, w and v in shared
// memory, double-buffered: f32 through cp.async issued a chunk ahead
// (16-byte copies where rows are 16-byte aligned, else 4-byte; zero fill
// past N and T), bf16 through registers a chunk ahead, converted when
// stored; b_t = sum_i r_i u_i k_i is formed once a step when its chunk
// lands.  Each step reads its operands one step ahead (float4
// broadcasts) and writes the thread's partial sums of y_t[j] to shared
// memory; after the chunk one pass adds the 8 row groups' partials and
// v_j b_t and writes y along j.  Two barriers a chunk; no shuffle in the
// step loop (adding the partials there with a 4-shuffle reduce-scatter
// was slower on an H100, though the pass here takes ~13% of the time:
// the sweep's no_ypass probe).
// The layout was chosen on the card by tools/wkv6_sweep.py, whose probes
// (a step loop without its FP work, without its shared-memory reads,
// without steps) show the step loop near both the FP32 issue rate and
// the shared-memory word rate.  Any T is taken (the last chunk is short);
// the exact step form needs no log or exp of the decay, where the chunked
// form does.
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

// The thread layout (tools/wkv6_sweep.py times others on the card):
constexpr int kGroups = 8;  // row groups: threads that share a column
constexpr int kCols = 4;    // value columns of a thread

// the threads of a block over NMAX rows and columns, the steps of a chunk
template <int NMAX>
constexpr int kBlockThreads = NMAX / kCols * kGroups;
template <int NMAX>
constexpr int kChunk = 1024 / (NMAX < 64 ? 64 : NMAX);

// shared memory of a block: double-buffered r, k, w, v and b_t of a
// chunk, u, and every thread's partial sums of y for a chunk
template <int NMAX>
constexpr int smem_bytes() {
  constexpr int C = kChunk<NMAX>;
  return (2 * 4 * C * NMAX + 2 * C + NMAX + C * kGroups * (NMAX + 4)) * 4;
}

// 4 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One block per (b, h) over NMAX rows and columns: thread (column group
// q, row group g), tid = kGroups q + g, owns columns j0 .. j0 + kCols - 1
// and rows 4 (g + kGroups m) .. + 3 of them.
template <typename T, int NMAX>
__global__ void __launch_bounds__(kBlockThreads<NMAX>)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int H, int steps,
            int N) {
  constexpr int kThreads = kBlockThreads<NMAX>;
  constexpr int C = kChunk<NMAX>;         // steps a chunk
  constexpr int R = NMAX / kGroups;       // rows a thread
  constexpr int PR = C * NMAX / kThreads;  // staged values a thread, each
  constexpr int TPS = kThreads / C;       // threads forming one b_t
  constexpr int LDP = NMAX + 4;           // row of partial sums, padded
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(R % 4 == 0 && kCols % 4 == 0 && TPS >= 1 && TPS <= 32,
                "thread layout");
  extern __shared__ __align__(16) float smem[];
  float(*sr)[C][NMAX] = reinterpret_cast<float(*)[C][NMAX]>(smem);
  float(*sk)[C][NMAX] = sr + 2;  // [buffer][step][row]
  float(*sw)[C][NMAX] = sk + 2;
  float(*sv)[C][NMAX] = sw + 2;
  float(*sp)[kGroups][LDP] =  // [step][row group][column] partial y
      reinterpret_cast<float(*)[kGroups][LDP]>(sv + 2);
  float(*sb)[C] = reinterpret_cast<float(*)[C]>(sp + C);  // b_t
  float* su = sb[2];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int g = tid % kGroups;
  const int j0 = kCols * (tid / kGroups);
  const int64_t base = static_cast<int64_t>(bh) * steps * N;
  const int64_t sbase = static_cast<int64_t>(bh) * N * N;
  // f32 rows that start 16-byte aligned go in 16-byte copies
  const bool vec =
      N % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;

  for (int i = tid; i < NMAX; i += kThreads)
    su[i] = i < N ? u[h * N + i] : 0.f;
  float S[R][kCols];
#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (g + kGroups * m) + e;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        S[4 * m + e][c] = (s0 != nullptr && row < N && j0 + c < N)
                              ? s0[sbase + row * N + j0 + c]
                              : 0.f;
    }

  // Chunk c's r, k, w, v into buffer c & 1 (zeros past N and past T),
  // started by `fetch` and completed by `land`: f32 through cp.async,
  // bf16 (r, k, v) through registers, converted when stored.
  float pr[kF32 ? 1 : PR], pk[kF32 ? 1 : PR], pv[kF32 ? 1 : PR],
      pw[kF32 ? 1 : PR];
  auto fetch = [&](int c) {
    const int t0 = c * C, b = c & 1;
    if constexpr (kF32) {
      if (vec) {
#pragma unroll
        for (int e = 0; e < PR / 4; ++e) {
          const int idx = 4 * (tid + e * kThreads);
          const int t = idx / NMAX, i = idx % NMAX;
          const bool ok = i < N && t0 + t < steps;
          const int64_t off =
              ok ? base + static_cast<int64_t>(t0 + t) * N + i : 0;
          cp_async16(&sr[b][t][i], reinterpret_cast<const float*>(r) + off,
                     ok);
          cp_async16(&sk[b][t][i], reinterpret_cast<const float*>(k) + off,
                     ok);
          cp_async16(&sw[b][t][i], w + off, ok);
          cp_async16(&sv[b][t][i], reinterpret_cast<const float*>(v) + off,
                     ok);
        }
      } else {
#pragma unroll
        for (int e = 0; e < PR; ++e) {
          const int idx = tid + e * kThreads;
          const int t = idx / NMAX, i = idx % NMAX;
          const bool ok = i < N && t0 + t < steps;
          const int64_t off =
              ok ? base + static_cast<int64_t>(t0 + t) * N + i : 0;
          cp_async4(&sr[b][t][i], reinterpret_cast<const float*>(r) + off,
                    ok);
          cp_async4(&sk[b][t][i], reinterpret_cast<const float*>(k) + off,
                    ok);
          cp_async4(&sw[b][t][i], w + off, ok);
          cp_async4(&sv[b][t][i], reinterpret_cast<const float*>(v) + off,
                    ok);
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    } else {
#pragma unroll
      for (int e = 0; e < PR; ++e) {
        const int idx = tid + e * kThreads;
        const int t = idx / NMAX, i = idx % NMAX;
        const bool ok = i < N && t0 + t < steps;
        const int64_t off = base + static_cast<int64_t>(t0 + t) * N + i;
        pr[e] = ok ? ld(r + off) : 0.f;
        pk[e] = ok ? ld(k + off) : 0.f;
        pw[e] = ok ? w[off] : 0.f;
        pv[e] = ok ? ld(v + off) : 0.f;
      }
    }
  };
  auto land = [&](int b) {
    if constexpr (kF32) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    } else {
#pragma unroll
      for (int e = 0; e < PR; ++e) {
        const int idx = tid + e * kThreads;
        sr[b][idx / NMAX][idx % NMAX] = pr[e];
        sk[b][idx / NMAX][idx % NMAX] = pk[e];
        sw[b][idx / NMAX][idx % NMAX] = pw[e];
        sv[b][idx / NMAX][idx % NMAX] = pv[e];
      }
    }
  };
  // b_t = sum_i r_i u_i k_i for the steps of buffer `b`
  auto bonus = [&](int b) {
    const int t = tid / TPS;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < NMAX / TPS; ++m) {
      const int i = tid % TPS + m * TPS;
      part = fmaf(sr[b][t][i] * su[i], sk[b][t][i], part);
    }
#pragma unroll
    for (int off = TPS / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % TPS == 0) sb[b][t] = part;
  };
  // step t's operands of this thread: its rows' r, k, w, its columns' v
  struct Operands {
    float4 r[R / 4], k[R / 4], w[R / 4], v[kCols / 4];
  };
  auto operands = [&](int b, int t, Operands& o) {
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {
      const int row = 4 * (g + kGroups * m);
      o.r[m] = *reinterpret_cast<const float4*>(&sr[b][t][row]);
      o.k[m] = *reinterpret_cast<const float4*>(&sk[b][t][row]);
      o.w[m] = *reinterpret_cast<const float4*>(&sw[b][t][row]);
    }
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      o.v[q] = *reinterpret_cast<const float4*>(&sv[b][t][j0 + 4 * q]);
  };

  // Two barriers a chunk: after the steps (the partial sums are in) and
  // after the y pass and the next chunk's landing; b_t is formed after
  // the second and read only after the next chunk's first.
  const int chunks = (steps + C - 1) / C;
  if (chunks > 0) {
    fetch(0);
    land(0);
    __syncthreads();
    bonus(0);
  }
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < chunks) fetch(c + 1);  // in flight while chunk c computes
    const int n = min(C, steps - c * C);
    Operands cur;
    operands(b, 0, cur);
    // the steps: nothing but S's own FMA links one to the next; step
    // t + 1's operands are read while step t multiplies
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      Operands nxt;
      operands(b, min(t + 1, n - 1), nxt);
      float vv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; q += 4) {
        vv[q] = cur.v[q / 4].x;
        vv[q + 1] = cur.v[q / 4].y;
        vv[q + 2] = cur.v[q / 4].z;
        vv[q + 3] = cur.v[q / 4].w;
      }
      float acc[kCols][2] = {};  // two partial sums a column
#pragma unroll
      for (int m = 0; m < R / 4; ++m) {
        const float rr[4] = {cur.r[m].x, cur.r[m].y, cur.r[m].z, cur.r[m].w};
        const float kk[4] = {cur.k[m].x, cur.k[m].y, cur.k[m].z, cur.k[m].w};
        const float ww[4] = {cur.w[m].x, cur.w[m].y, cur.w[m].z, cur.w[m].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            float& s = S[4 * m + e][q];
            acc[q][e & 1] = fmaf(rr[e], s, acc[q][e & 1]);
            s = fmaf(ww[e], s, kk[e] * vv[q]);
          }
      }
#pragma unroll
      for (int q = 0; q < kCols; q += 4)
        *reinterpret_cast<float4*>(&sp[t][g][j0 + q]) = make_float4(
            acc[q][0] + acc[q][1], acc[q + 1][0] + acc[q + 1][1],
            acc[q + 2][0] + acc[q + 2][1], acc[q + 3][0] + acc[q + 3][1]);
      cur = nxt;
    }
    __syncthreads();  // the chunk's partial sums are in
    // y_t[j .. j + 3] = sums over the row groups + v_j b_t
    for (int idx = tid; idx < n * (NMAX / 4); idx += kThreads) {
      const int t = idx / (NMAX / 4), j = 4 * (idx % (NMAX / 4));
      if (j >= N) continue;
      const float bt = sb[b][t];
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[b][t][j]);
      float yj[4] = {v4.x * bt, v4.y * bt, v4.z * bt, v4.w * bt};
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sp[t][gg][j]);
        yj[0] += p4.x;
        yj[1] += p4.y;
        yj[2] += p4.z;
        yj[3] += p4.w;
      }
      T* yt = y + base + static_cast<int64_t>(c * C + t) * N + j;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < N) st(yt + e, yj[e]);
    }
    if (c + 1 < chunks) land(b ^ 1);  // buffer b^1 was last read in c - 1
    __syncthreads();
    if (c + 1 < chunks) bonus(b ^ 1);
  }

#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (g + kGroups * m) + e;
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (row < N && j0 + q < N)
          s_out[sbase + row * N + j0 + q] = S[4 * m + e][q];
    }
}

template <typename T, int NMAX>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int H, int steps, int N,
                   cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<NMAX>());
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, NMAX><<<static_cast<int>(blocks), kBlockThreads<NMAX>,
                         smem_bytes<NMAX>(), stream>>>(
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
  if (B < 0 || H < 0 || steps < 0 || N < 0 || N > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, y, s_out, B, H, steps, N, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, steps,
                                   N, s);
  return cudaErrorInvalidValue;
}
