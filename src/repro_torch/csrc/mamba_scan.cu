// The Mamba-1 selective scan, carrying its state (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba_scan` in
// src/repro/kernels/mamba_scan.py (body `_mamba_kernel`), called by the
// Mamba mixer in prefill and training (models/mamba.py::mamba_train):
//
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t
//   y_t = C_t . h_t
//
// per (batch b, channel d), with A [di, N] (negative), dt and x
// [B, T, di], Bm and Cm [B, T, N], the initial state h0 [B, di, N]; y
// [B, T, di] and the final state h_T [B, di, N].  Everything is f32.
//
// What bounds it.  It reads dt and x and writes y once (12 bytes per
// (b, t, d)), plus the small Bm, Cm, A, h0 and h_T: at Jamba's prefill
// (B 8, T 2,048, di 16,384, N 16) 3.24 GB, 0.968 ms at 3.35 TB/s.  Beside
// the bytes, each of the B * T * di * N = 4.29 G elements takes one
// exponential and four FP32 instructions (dt * a, dx * B_n, the h FMA and
// the y FMA).  An exponential on the SFUs (MUFU.EX2) costs one issue slot
// but the SFUs retire 16 a clock per SM: 4.29 G alone take ~1.03 ms on
// 132 SMs at 1.98 GHz.  Guarding it close to 1 (below) costs five more
// FP32 slots.  So the scan meets three limits of about the same size: the
// bytes, the SFUs and the issue slots.
//
// Design.  The TPU kernel tiles di by 256, carries h in a VMEM scratch
// across a sequential time-chunk axis of its grid, and asserts
// di % 256 == 0.  CUDA blocks run in no order, so here the time loop is
// inside the block and h lives in registers for the whole sequence.
//  - Exponentials on the SFUs, guarded close to 1.  A is pre-scaled by
//    log2(e) in registers, so each exponential is 2^x, x = dt * a', and
//    `ex2.approx.ftz.f32` (MUFU.EX2) takes it in one issue slot.  Its
//    relative error is up to 2^-22 (the PTX ISA), and an error that keeps
//    its sign builds up in h over ~1 / (1 - 2^x) steps: where dt * |A|
//    stays small, as with Mamba's init (A = -(1..N), dt log-uniform on
//    [1e-3, 1e-1]), the SFU alone at that bound misses the rule (the CPU
//    study below).  So where x > -kNear the kernel takes 2^x from p(x) = 1
//    + x q(x) instead (`ex2_guarded`), a polynomial exact at 0 whose error
//    scales with 1 - 2^x, so that it cannot build up; where x <= -kNear
//    the SFU's errors fade within ~1 / (1 - 2^-kNear) = 12 steps.  Each
//    exponential computes both and selects: a branch would split warps,
//    whose lanes hold channels with different dt.
//    tests/test_torch_mamba_exp_rounding.py emulates it on the CPU (the
//    SFU at its documented error, random or one-signed) and holds it to
//    the scan's 2e-5 + 2e-5 |ref| against an f64 scan.  dt >= 0 and A < 0
//    keep x <= 0; results below 2^-126 flush to 0, which h never feels.
//  - Two channels a thread (for N <= 16; one for N 32 and 64, whose state
//    fills the registers), channels tid and tid + 128 of a block of 128
//    threads: each broadcast of B_t and C_t from shared memory serves both,
//    and a step has 2 N independent chains.  A block covers 256 channels
//    of one b: at Jamba's prefill a grid of 64 x 8 = 512 blocks, ~3.9 per
//    SM, all resident at once (4 a SM fit by registers, 128 a thread, and
//    by shared memory, 52 KB a block), so there is one wave and the
//    busiest SMs hold 4 blocks against a mean of 3.88.
//  - dt and x staged through shared memory kSteps steps at a time in a
//    ring of kStages buffers: chunk k + kStages - 1 is brought by cp.async
//    (16-byte copies where rows are 16-byte aligned, else 4-byte; zero
//    fill past di and T) while chunk k computes, with the chunk's Bm and
//    Cm [kSteps, N].  Each step reads its dt and x from shared memory and
//    writes y[b, t, d] coalesced across the block's threads.
// Measured on an H100 (tools/kernel_sweep.py mamba; PERF.md, PR 17): 1.96
// ms at Jamba's prefill, 2.03x the byte bound.  The step loop is 326
// instructions (32 MUFU.EX2) a warp-step of 32 exponentials a lane, ~0.67
// of one instruction a clock per scheduler, beside an SFU bound of 1.03
// ms; without device-memory reads it takes as long, the staging alone
// 0.70 ms: it is bound by issue and the SFUs together.  The guard costs
// ~0.44 ms (1.52 without it).  Other rings, channels a thread, register
// caps and unrolling measured as long or longer, and exponentials moved
// to the FP32 pipe (a degree-5 polynomial, ~11 issue slots) no faster.
// N is a template parameter (NMAX in {4, 8, 16, 32, 64}); a smaller N
// runs in the next template with zero-padded B/C and A, whose padded
// states stay 0.  Any T and di (the last chunk is short, the tail
// channels are masked).  No tensor cores: the scan has no matrix product.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kSteps = 8;       // time steps per staged chunk
constexpr int kStages = 3;      // chunks in the ring of staging buffers
constexpr int kChanSmall = 2;   // channels a thread for N <= 16
constexpr int kSmWarps = 16;    // warps an SM holds at N <= 16: 128 registers
constexpr float kLog2e = 1.4426950408889634f;
// Decays close to 1 take no SFU exponential: 2^x comes from the SFU only
// where x <= -kNear.
constexpr float kNear = 0.125f;

__host__ __device__ constexpr int channels_per_thread(int nmax) {
  return nmax <= 16 ? kChanSmall : 1;
}

// 2^x on the SFU: relative error <= 2^-22, flushes results below 2^-126
__device__ __forceinline__ float ex2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x from the SFU where x <= -kNear, else from p(x) = 1 + x (c1 + x (c2
// + x c3)) (a minimax fit of (2^x - 1) / x on [-1/8, 0] in relative error,
// 8.4e-7): exact at 0, so close to 1 the error scales with 1 - 2^x.
__device__ __forceinline__ float ex2_guarded(float x) {
  const float m = ex2_mufu(x);
  float q = fmaf(0x1.b82b62p-5f, x, 0x1.ebd066p-3f);
  q = fmaf(q, x, 0x1.62e41cp-1f);
  const float p = fmaf(q, x, 1.f);
  return x > -kNear ? p : m;
}

// 4 or 16 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Shared memory of a block, in floats: dt and x [kStages][kSteps][CH],
// then Bm and Cm [kStages][kSteps][NMAX].
template <int NMAX>
constexpr int smem_floats() {
  return 2 * kStages * kSteps * (kThreads * channels_per_thread(NMAX) + NMAX);
}

// The steps of one staged chunk: h and y for len steps from the chunk's
// dt, x (sdt, sx [kSteps][CH]), Bm and Cm (sB, sC [kSteps][NMAX]).
template <int NMAX>
__device__ __forceinline__ void scan_chunk(
    float (&h)[channels_per_thread(NMAX)][NMAX],
    const float (&a)[channels_per_thread(NMAX)][NMAX],
    const float (*sdt)[kThreads * channels_per_thread(NMAX)],
    const float (*sx)[kThreads * channels_per_thread(NMAX)],
    const float (*sB)[NMAX], const float (*sC)[NMAX], int len, int tid,
    const bool (&live)[channels_per_thread(NMAX)], float* __restrict__ y,
    int64_t at, int di) {
  constexpr int CPT = channels_per_thread(NMAX);
#pragma unroll 1
  for (int s = 0; s < len; ++s, at += di) {
    float dtv[CPT], dx[CPT], acc[CPT][4];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dtv[c] = sdt[s][c * kThreads + tid];
      dx[c] = dtv[c] * sx[s][c * kThreads + tid];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
    }
#pragma unroll
    for (int n0 = 0; n0 < NMAX; n0 += 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(&sB[s][n0]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sC[s][n0]);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j;
          const float e = ex2_guarded(dtv[c] * a[c][n]);
          h[c][n] = fmaf(e, h[c][n], dx[c] * bb[j]);
          acc[c][j] = fmaf(h[c][n], cc[j], acc[c][j]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (live[c])
        y[at + c * kThreads] = (acc[c][0] + acc[c][1]) +
                               (acc[c][2] + acc[c][3]);
    }
  }
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads,
                  channels_per_thread(NMAX) * NMAX <= 32
                      ? kSmWarps * 32 / kThreads
                      : 1)
mamba_scan_kernel(const float* __restrict__ A, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ x, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int steps,
                  int di, int N, int vec) {
  constexpr int CPT = channels_per_thread(NMAX);
  constexpr int CH = kThreads * CPT;  // channels of the block
  extern __shared__ __align__(16) float smem[];
  constexpr int RING = kStages * kSteps;  // rows of a ring
  auto sdt = reinterpret_cast<float (*)[kSteps][CH]>(smem);
  auto sx = reinterpret_cast<float (*)[kSteps][CH]>(smem + RING * CH);
  auto sB = reinterpret_cast<float (*)[kSteps][NMAX]>(smem + 2 * RING * CH);
  auto sC = reinterpret_cast<float (*)[kSteps][NMAX]>(
      smem + 2 * RING * CH + RING * NMAX);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;

  // a' = A log2(e)
  float a[CPT][NMAX], h[CPT][NMAX];
  bool live[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = d0 + c * kThreads + tid;
    const int64_t srow = (static_cast<int64_t>(b) * di + d) * N;
    live[c] = d < di;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const bool in = live[c] && n < N;
      a[c][n] = in ? A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
      h[c][n] = in ? h0[srow + n] : 0.f;
    }
  }
  const int64_t seq = static_cast<int64_t>(b) * steps;  // row of (b, t=0)

  // Chunk k's dt, x, Bm and Cm into buffer k % kStages (zeros past di, N,
  // T), as one cp.async group
  auto fetch = [&](int k) {
    const int t0 = k * kSteps, buf = k % kStages;
    const int len = min(kSteps, steps - t0);
    if (vec) {  // di % 4 == 0 and 16-byte aligned rows
      for (int i = tid; i < kSteps * CH / 4; i += kThreads) {
        const int s = i / (CH / 4), col = (i % (CH / 4)) * 4;
        const bool ok = s < len && d0 + col < di;
        const int64_t off = ok ? (seq + t0 + s) * di + d0 + col : 0;
        cp_async16(&sdt[buf][s][col], dt + off, ok);
        cp_async16(&sx[buf][s][col], x + off, ok);
      }
    } else {
      for (int i = tid; i < kSteps * CH; i += kThreads) {
        const int s = i / CH, col = i % CH;
        const bool ok = s < len && d0 + col < di;
        const int64_t off = ok ? (seq + t0 + s) * di + d0 + col : 0;
        cp_async4(&sdt[buf][s][col], dt + off, ok);
        cp_async4(&sx[buf][s][col], x + off, ok);
      }
    }
    for (int i = tid; i < kSteps * NMAX; i += kThreads) {
      const int s = i / NMAX, n = i % NMAX;
      const bool ok = s < len && n < N;
      const int64_t off = ok ? (seq + t0 + s) * N + n : 0;
      cp_async4(&sB[buf][s][n], Bm + off, ok);
      cp_async4(&sC[buf][s][n], Cm + off, ok);
    }
  };

  // kStages - 1 chunks in flight ahead of the one computing; a group is
  // committed every time, empty past the last chunk, so that waiting for
  // all but the newest kStages - 1 groups always means chunk k
  const int chunks = (steps + kSteps - 1) / kSteps;
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks) fetch(k);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    if (k + kStages - 1 < chunks) fetch(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk k has landed for every thread
    const int buf = k % kStages, t0 = k * kSteps;
    const int len = min(kSteps, steps - t0);
    scan_chunk<NMAX>(h, a, sdt[buf], sx[buf], sB[buf], sC[buf], len, tid,
                     live, y, (seq + t0) * di + d0 + tid, di);
    __syncthreads();  // buffer k % kStages is free for chunk k + kStages
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (!live[c]) continue;
    const int d = d0 + c * kThreads + tid;
    const int64_t srow = (static_cast<int64_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hT[srow + n] = h[c][n];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NMAX>
cudaError_t launch(const void* A, const void* dt, const void* Bm,
                   const void* Cm, const void* x, const void* h0, void* y,
                   void* hT, int B, int steps, int di, int N,
                   cudaStream_t stream) {
  constexpr int CH = kThreads * channels_per_thread(NMAX);
  constexpr size_t smem = smem_floats<NMAX>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec = di % 4 == 0 && aligned16(dt) && aligned16(x);
  const dim3 grid((di + CH - 1) / CH, B);
  mamba_scan_kernel<NMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(x), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), steps, di, N, vec);
  return cudaGetLastError();
}

}  // namespace

// All tensors f32 and contiguous; N <= 64.  Returns the launch's
// cudaError_t; the caller raises on anything but 0.
extern "C" int mamba_scan(const void* A, const void* dt, const void* Bm,
                          const void* Cm, const void* x, const void* h0,
                          void* y, void* hT, int B, int steps, int di, int N,
                          void* stream) {
  if (B == 0 || di == 0 || N == 0) return 0;
  if (B < 0 || steps < 0 || di < 0 || N < 0 || N > 64 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(A, dt, Bm, Cm, x, h0, y, hT, B, steps, di, N, s);
  if (N <= 8) return launch<8>(A, dt, Bm, Cm, x, h0, y, hT, B, steps, di, N, s);
  if (N <= 16)
    return launch<16>(A, dt, Bm, Cm, x, h0, y, hT, B, steps, di, N, s);
  if (N <= 32)
    return launch<32>(A, dt, Bm, Cm, x, h0, y, hT, B, steps, di, N, s);
  return launch<64>(A, dt, Bm, Cm, x, h0, y, hT, B, steps, di, N, s);
}
