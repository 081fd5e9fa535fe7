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
// What bounds it: on paper the bytes.  It reads dt and x and writes y
// once (12 bytes per (b, t, d)), plus the small Bm, Cm, A, h0 and h_T: at
// Jamba's prefill (B 8, T 2,048, di 16,384, N 16) 3.22 GB, 0.96 ms at
// 3.35 TB/s.  The arithmetic is close behind: B * T * di * N = 4.29 G
// exponentials (expf: one MUFU ex2 plus a few FMAs; the SFUs retire 16
// a clock per SM, ~1 ms on 132 SMs) and 3 FMAs each for the update and
// the output, so the exponentials and the FMA pipe, not the bytes, are
// likely what this simple design runs into (measured on an H100: 2.7 ms
// against the 0.97 ms byte bound).
//
// Design.  The TPU kernel tiles di by 256, carries h in a VMEM scratch
// across a sequential time-chunk axis of its grid, and asserts
// di % 256 == 0.  CUDA blocks run in no order, so here the time loop is
// inside the block: one thread owns one (b, d) and keeps h[0..N) and its
// row A[d, 0..N) in registers for the whole sequence, so the state never
// leaves the SM.  A block is 128 consecutive channels of one b (grid
// B x ceil(di / 128); the tail channels are masked, so any di works).
// Per step, dt[b, t, d] and x[b, t, d] are read and y[b, t, d] written
// coalesced across the block's threads, and the next step's dt and x are
// loaded while this one computes.  Bm[b, t, :] and Cm[b, t, :] are the
// same for every thread of the block: they are staged in shared memory
// 64 steps at a time and read as broadcasts.  N is a template parameter
// (NMAX in {4, 8, 16, 32, 64}); a smaller N runs in the next template
// with zero-padded B/C and A, whose padded states stay 0.  Any T.  expf,
// not __expf, so the kernel stays within f32 rounding of the plain
// version.  No tensor cores, TMA or wgmma.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // channels (threads) per block
constexpr int kChunk = 64;   // time steps of Bm/Cm staged at a time

template <int NMAX>
__global__ void __launch_bounds__(kBlock)
mamba_scan_kernel(const float* __restrict__ A, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ x, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int steps,
                  int di, int N) {
  __shared__ __align__(16) float sB[kChunk][NMAX];
  __shared__ __align__(16) float sC[kChunk][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kBlock + threadIdx.x;
  const bool live = d < di;
  const int64_t srow = (static_cast<int64_t>(b) * di + d) * N;  // h0, h_T

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool in = live && n < N;
    a[n] = in ? A[static_cast<int64_t>(d) * N + n] : 0.f;
    h[n] = in ? h0[srow + n] : 0.f;
  }
  const int64_t seq = static_cast<int64_t>(b) * steps;  // row of (b, t=0)
  const float* bm = Bm + seq * N;
  const float* cm = Cm + seq * N;

  for (int t0 = 0; t0 < steps; t0 += kChunk) {
    const int len = min(kChunk, steps - t0);
    __syncthreads();  // the previous chunk's B/C are no longer read
    for (int i = threadIdx.x; i < kChunk * NMAX; i += kBlock) {
      const int s = i / NMAX, n = i % NMAX;
      const bool in = s < len && n < N;
      const int64_t off = static_cast<int64_t>(t0 + s) * N + n;
      sB[s][n] = in ? bm[off] : 0.f;
      sC[s][n] = in ? cm[off] : 0.f;
    }
    __syncthreads();
    int64_t at = (seq + t0) * di + d;  // (b, t0, d) in dt, x and y
    float dtn = 0.f, xn = 0.f;
    if (live) {
      dtn = dt[at];
      xn = x[at];
    }
    for (int s = 0; s < len; ++s, at += di) {
      const float dtv = dtn, dx = dtn * xn;
      if (live && s + 1 < len) {  // the next step's inputs, in flight now
        dtn = dt[at + di];
        xn = x[at + di];
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        h[n] = fmaf(expf(dtv * a[n]), h[n], dx * sB[s][n]);
        acc[n & 3] = fmaf(h[n], sC[s][n], acc[n & 3]);
      }
      if (live) y[at] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hT[srow + n] = h[n];
  }
}

template <int NMAX>
cudaError_t launch(const void* A, const void* dt, const void* Bm,
                   const void* Cm, const void* x, const void* h0, void* y,
                   void* hT, int B, int steps, int di, int N,
                   cudaStream_t stream) {
  const dim3 grid((di + kBlock - 1) / kBlock, B);
  mamba_scan_kernel<NMAX><<<grid, kBlock, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(x), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), steps, di, N);
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
