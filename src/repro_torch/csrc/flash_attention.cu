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
// k/v [B, Tk, Hkv, D], f32 or bf16, G = Hq / Hkv; the output in q's type,
// 0 for a row that sees no key.  Any Tq and Tk: the ragged tails are
// masked here (the Pallas kernel asserts Tq and Tk are block multiples).
//
// What bounds it: the operations.  A causal prefill does
// 4 * B * Hq * D * Tq * Tk / 2 flops on B * (Tq * Hq + 2 * Tk * Hkv) * D
// elements: at qwen2-7b's shape (B 8, T 2,048, Hq 28, Hkv 4, D 128) that
// is 240 GFLOP on 88 MB (f32), ~2,700 flops a byte, far above the card's
// balance.  Hence two kernels behind one entry point:
//
// bf16 (`flash_attention_bf16_kernel`): the tensor cores, 989 TFLOP/s
// (a 0.243 ms bound at qwen2-7b's shape).  The work is cut into items of
// (b, query head, 128 query rows); one block per SM walks its share of
// them, longest causal rows first, so short items fill the tail.  A block
// is a producer warpgroup and two consumer warpgroups of 64 rows each.
// One producer thread brings each item's Q, then its 128-key K and V
// tiles, through TMA into 128-byte-swizzled shared memory, over a 4-D
// tensor map (D, H, T, B) of the [B, T, H, D] tensor, so rows past Tq or
// Tk and columns past D (D = 120, or D <= 64 in a 64-column tile) arrive
// as zeros; a ring of two K/V stages keeps tile t + 1 in flight while
// tile t is multiplied (full/empty mbarriers, K and V apart, so S = Q K^T
// starts before V lands), and the next item's Q and first tiles load
// while the consumers finish the last one.  Each consumer runs
// S = Q K^T as wgmma m64n128k16 with Q and K from shared memory (both
// K-major), the online softmax in registers (scores scaled by
// log2(e) / sqrt(D), ex2.approx, each row's max and sum over the four
// threads that hold it; l summed from the f32 probabilities), then
// O += P V as wgmma with P converted in registers from the S accumulator
// to bf16 A fragments (the layouts match) and V read MN-major through the
// descriptor's transpose bit.  The softmax rivals the products for time
// (a consumer's 8,192 exponentials a tile take about half as long on the
// SM's 16 exponential units a clock as its 4.2 MFLOP on the tensor
// cores), so it is hidden twice: a consumer issues tile i's scores
// together with tile i - 1's P V and runs tile i's softmax while P V is
// on the tensor cores, and the two consumers take turns to issue (named
// barriers), so one's softmax overlaps the other's products.  Only the
// tiles that hold the causal diagonal, a window edge or the ragged end of
// Tk are masked; tiles hidden from every row of an item are not visited
// (one hidden from a consumer's 64 rows only is masked whole).  The
// epilogue divides by max(l, 1e-20), writes bf16 into a staging buffer in
// the swizzled layout, and a TMA store clips rows past Tq and columns
// past D.  setmaxnreg gives the consumers 240 registers and the producer
// 24.  Rounding P to bf16 for the product is what every tensor-core
// attention does; the error it adds scales with sum_j p_j |v_j| / l, not
// with the output (ref.py `mha_tolerance`).
//
// f32 (`flash_attention_tf32_kernel`): the tensor cores too, in TF32, which
// keeps 10 of f32's 23 mantissa bits: one TF32 product would move the output by
// ~1e-3, five times the f32 rule (2e-4).  So every operand x is split as hi = x
// rounded to TF32 and lo = x - hi (exact in f32; K's and V's rounded in turn by
// the pre-pass, Q's and P's read to their top 19 bits), and a product a b is
// taken as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), ~2^-21 relative, the small
// terms first (the tensor cores align each step's sum to its largest term and
// drop the bits below, so small terms added to a large sum lose theirs): three
// TF32 products for each f32 one, on both S = Q K^T and O += P V
// (tests/test_torch_flash_tf32_rounding.py emulates this on the CPU: TF32 alone
// on either product misses 2e-4, three terms give ~1e-6).  At 495 TFLOP/s dense
// that bounds qwen2-7b's shape at 3 x 240.6 GFLOP / 495 TFLOP/s = 1.458 ms,
// against 3.59 ms for f32 on the CUDA cores.  TF32 wgmma takes both operands
// K-major (its transpose bit is for 16-bit types only), so V must reach shared
// memory transposed.  A pre-pass (`tf32_split_kv`) writes K's hi and lo ([B,
// Tk, Hkv, D]) and V^T's hi and lo ([B, Hkv, D, Tk rounded up to 8]) once a
// call into a workspace the caller allocates (4 B Tk Hkv D floats, 0.13 GB at
// qwen2-7b's shape), rather than once for each of the G query heads and query
// tiles that read them; within each 8 keys V^T holds keys 0 2 4 6 1 3 5 7, so
// that P's A fragments come straight from the S accumulator (a thread holds
// keys 2t and 2t + 1 of its rows; the TF32 A fragment wants columns t and t +
// 4).  The main kernel has the bf16 kernel's structure with other tiles: items
// of (b, query head, 128 rows), one block per SM walking them longest causal
// rows first, a TMA producer and two 64-row consumer warpgroups taking turns to
// issue their products (a consumer waits for its own scores before P V: the
// registers hold no second tile).  Shared memory decides the tiles: Q for 128
// rows is 64 KB, a 64-key tile of K's hi and lo 64 KB and of V^T's hi and lo 64
// KB, so 192 KB of the 227 KB with one stage each (a 128-key tile, or a second
// stage, would need 256 KB).  K and V have their own full/empty barriers, so
// K's next tile loads while P V runs and V's while the scores run.  A consumer
// splits its Q rows once an item: hi into registers (the A fragments of hi(Q)
// hi(K) and hi(Q) lo(K), 64 registers at D = 128), lo back over Q in shared
// memory (A of lo(Q) hi(K)), then per tile issues the 3 x D / 8 score products
// (m64n64k8), runs the online softmax (log2 units, ex2.approx; masks only on
// diagonal, window-edge and ragged tiles; hidden tiles skipped), splits P in
// registers and issues the 3 x 8 P V products (m64n128k8, or n64 for D <= 64).
// D is padded to 64 or 128 by TMA's zero fill, so D = 12, 60 or 120 multiply
// zeros; the epilogue writes f32 straight from registers (no staging buffer
// fits).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;

// ---- bf16: wgmma on the tensor cores, fed by TMA ----------------------

constexpr int kRows = 64;        // query rows of one consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups: 128 rows a block
constexpr int kKeys = 128;       // keys per K/V tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kWgThreads = 128;  // a warpgroup
constexpr int kBf16Threads = kWgThreads * (1 + kConsumers);
constexpr int kRowBytes = 128;   // one swizzle row: 64 bf16 columns
constexpr int kQBox = kRows * kRowBytes;  // a 64-row x 64-column box
constexpr int kKVBox = kKeys * kRowBytes;  // a 128-row x 64-column box
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map (coordinates innermost first) -> shared
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-column boxes), stride byte offset 1,024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define WG_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]^T, A and B K-major in shared
// memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (bf16 pairs), B
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> packed bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// NCH = 64-column boxes per row: 1 for D <= 64, 2 for D <= 128.  Thread
// layout of a wgmma accumulator (m64nN, f32): lane l of warp w holds rows
// 16 w + l / 4 and that + 8, columns 8 j + 2 (l % 4) and + 1 for every
// 8-column group j, as d[4 j + 2 * half + e].

// S = Q K^T for one tile: 16 columns of D a step, Q and K K-major
template <int NCH>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_base,
                                             uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < 4 * NCH; ++kk)
    wgmma_ss_n128(sc, smem_desc(q_base + (kk / 4) * kQBox + (kk % 4) * 32, 16),
                  smem_desc(k_base + (kk / 4) * kKVBox + (kk % 4) * 32, 16),
                  kk > 0);
}

// O += P V for one tile: 16 keys a step, P's bf16 pairs from registers
// (the S accumulator's layout is the A fragment's), V MN-major
template <int NCH>
__device__ __forceinline__ void issue_pv(float (&o)[32 * NCH],
                                         const uint32_t (&p)[32],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t vd = smem_desc(v_base + kk * 16 * kRowBytes, kKVBox);
    if constexpr (NCH == 2)
      wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    vd);
    else
      wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                   vd);
  }
}

// one tile's online softmax over this thread's two rows, in place: the
// scores become f32 probabilities (log2 units, ex2.approx), m and l move
// on, alpha is what the accumulator must be scaled by.  A masked tile
// (the causal diagonal, a window edge, the ragged end of Tk) sets the
// hidden scores to -inf first; the others skip that arithmetic.
__device__ __forceinline__ void online_softmax(
    float (&sc)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, bool masked, int k0, int qpos0, int cq, int Tk,
    int causal, int window) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + cq + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's four threads: lanes 4 g .. 4 g + 3
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
    alpha[r] = ex2(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -base[r]));
      l[r] += sc[4 * j + e];  // l from the f32 p; P goes to bf16 after
    }
}

// the probabilities as the bf16 A fragments of P V: pair i = (2 i, 2 i + 1)
__device__ __forceinline__ void to_bf16(uint32_t (&p)[32],
                                        const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// One work item: a (b, query head, 128-row tile), the tiles of 128 keys
// that some row of it may see being [t_begin, t_begin + n_tiles).  Items
// are numbered longest causal rows first: a block takes items blockIdx.x,
// + gridDim.x, ... so the short ones fill the tail.
struct Item {
  int q0, h, b, t_begin, n_tiles;
};

__device__ __forceinline__ Item item_at(int L, int Tq, int Tk, int Hq, int B,
                                        int causal, int window,
                                        int q_offset) {
  const int n_qt = (Tq + kRows * kConsumers - 1) / (kRows * kConsumers);
  Item it;
  const int r = L % (Hq * B);
  it.q0 = (n_qt - 1 - L / (Hq * B)) * kRows * kConsumers;
  it.h = r % Hq;
  it.b = r / Hq;
  const int qmin = it.q0 + q_offset;
  const int qmax = min(it.q0 + kRows * kConsumers, Tq) - 1 + q_offset;
  const int k_end = causal ? min(Tk, qmax + 1) : Tk;
  const int k_begin = window > 0 ? max(0, qmin - window + 1) : 0;
  it.t_begin = k_begin / kKeys;
  it.n_tiles = k_end > k_begin ? (k_end + kKeys - 1) / kKeys - it.t_begin : 0;
  return it;
}

template <int NCH>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o, int B,
                            int Tq, int Tk, int Hq, int Hkv, float scale_log2,
                            int causal, int window, int q_offset) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1,024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                           // [consumer][box] Q
  uint8_t* so = sq + kConsumers * NCH * kQBox;  // [consumer][box] O
  uint8_t* sk = so + kConsumers * NCH * kQBox;  // [stage][box]
  uint8_t* sv = sk + kStages * NCH * kKVBox;    // [stage][box]
  const uint32_t bars = smem_u32(sv + kStages * NCH * kKVBox);
  const uint32_t q_full = bars;  // mbarriers, 8 bytes each
  const uint32_t q_empty = bars + 8;
  const uint32_t k_full = bars + 16;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const int n_items =
      (Tq + kRows * kConsumers - 1) / (kRows * kConsumers) * Hq * B;
  const int group = Hq / Hkv;

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);  // one arrival a consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers * 4);
      mbar_init(v_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      int tiles = 0, qs = 0;  // ring slots and Q buffers used so far
      for (int L = blockIdx.x; L < n_items; L += gridDim.x) {
        const Item w = item_at(L, Tq, Tk, Hq, B, causal, window, q_offset);
        if (w.n_tiles == 0) continue;
        mbar_wait(q_empty, (qs++ & 1) ^ 1);  // the first round passes
        mbar_expect_tx(q_full, kConsumers * NCH * kQBox);
        for (int c = 0; c < kConsumers * NCH; ++c)
          tma_load(&tm_q, smem_u32(sq + c * kQBox), q_full, 64 * (c % NCH),
                   w.h, w.q0 + (c / NCH) * kRows, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++tiles) {
          const int s = tiles % kStages;
          const uint32_t phase = (tiles / kStages) & 1;
          const int k0 = (w.t_begin + i) * kKeys;
          mbar_wait(k_empty + 8 * s, phase ^ 1);
          mbar_expect_tx(k_full + 8 * s, NCH * kKVBox);
          for (int c = 0; c < NCH; ++c)
            tma_load(&tm_k, smem_u32(sk + (s * NCH + c) * kKVBox),
                     k_full + 8 * s, 64 * c, w.h / group, k0, w.b);
          mbar_wait(v_empty + 8 * s, phase ^ 1);
          mbar_expect_tx(v_full + 8 * s, NCH * kKVBox);
          for (int c = 0; c < NCH; ++c)
            tma_load(&tm_v, smem_u32(sv + (s * NCH + c) * kKVBox),
                     v_full + 8 * s, 64 * c, w.h / group, k0, w.b);
        }
      }
    }
  } else {  // consumer warpgroup cw: rows q0 + 64 cw .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - wg * kWgThreads;
    const int warp = ltid / 32;
    const int lane = ltid % 32;
    const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);          // columns 8 j + cq, + 1
    // The two consumers take turns to issue their products (named
    // barriers 3 and 4), so one's softmax overlaps the other's wgmma.
    const int my_turn = 3 + cw;
    const int their_turn = 4 - cw;
    constexpr int kPair = kConsumers * kWgThreads;
    if (cw == 1) bar_arrive(3, kPair);  // consumer 0 goes first
    const uint32_t q_base = smem_u32(sq + cw * NCH * kQBox);
    const uint32_t k_base = smem_u32(sk);
    const uint32_t v_base = smem_u32(sv);
    uint8_t* my_o = so + cw * NCH * kQBox;
    constexpr int kOut = 32 * NCH;  // accumulator floats: 64 x 64 NCH
    int tiles = 0, qs = 0;  // as the producer counts them

    for (int L = blockIdx.x; L < n_items; L += gridDim.x) {
      const Item w = item_at(L, Tq, Tk, Hq, B, causal, window, q_offset);
      const int n = w.n_tiles;
      const int row0 = w.q0 + cw * kRows;
      const int qpos0 = row0 + r_lo + q_offset;
      const int wq_min = row0 + q_offset;  // positions of this
      const int wq_max = min(row0 + kRows, Tq) - 1 + q_offset;  // wg's rows
      // a tile needs the mask where some key is hidden from some row
      auto masked = [&](int k0) {
        return (causal && k0 + kKeys - 1 > wq_min) ||
               (window > 0 && k0 <= wq_max - window) || k0 + kKeys > Tk;
      };
      float o[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l[2] = {0.f, 0.f};  // this thread's share of the running sum
      float alpha[2];
      float sc[64];    // scores, then probabilities, of the newest tile
      uint32_t p[32];  // the tile before's probabilities as bf16 pairs

      // The steady loop below is straight-line (tile 0's scores and the
      // last tile's P V are peeled off), so ptxas can see which wgmma
      // group each wait retires and keeps the products asynchronous.
      if (n > 0) {
        const int s = tiles % kStages;
        mbar_wait(q_full, qs++ & 1);
        mbar_wait(k_full + 8 * s, (tiles / kStages) & 1);
        bar_sync(my_turn, kPair);
        wgmma_fence();
        issue_scores<NCH>(sc, q_base, k_base + s * NCH * kKVBox);
        wgmma_commit();
        bar_arrive(their_turn, kPair);
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) mbar_arrive(k_empty + 8 * s);
        const int k0 = w.t_begin * kKeys;
        online_softmax(sc, m, l, alpha, scale_log2, masked(k0), k0, qpos0,
                       cq, Tk, causal, window);
        to_bf16(p, sc);  // O is still 0: nothing to rescale
      }
      // tile i's scores go out with tile i - 1's P V, and tile i's
      // softmax runs while that product is on the tensor cores
      for (int i = 1; i < n; ++i) {
        const int s = (tiles + i) % kStages;
        const uint32_t ph = ((tiles + i) / kStages) & 1;
        const int sp = (tiles + i - 1) % kStages;
        const uint32_t php = ((tiles + i - 1) / kStages) & 1;
        mbar_wait(k_full + 8 * s, ph);
        mbar_wait(v_full + 8 * sp, php);
        bar_sync(my_turn, kPair);
        wgmma_fence();
        issue_scores<NCH>(sc, q_base, k_base + s * NCH * kKVBox);
        wgmma_commit();
        issue_pv<NCH>(o, p, v_base + sp * NCH * kKVBox);
        wgmma_commit();
        bar_arrive(their_turn, kPair);
        wgmma_wait<1>();  // the scores
        fence_regs(sc);
        if (lane == 0) mbar_arrive(k_empty + 8 * s);
        const int k0 = (w.t_begin + i) * kKeys;
        online_softmax(sc, m, l, alpha, scale_log2, masked(k0), k0, qpos0,
                       cq, Tk, causal, window);
        wgmma_wait<0>();  // P V
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
        to_bf16(p, sc);
#pragma unroll
        for (int j = 0; j < kOut / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      }
      if (n > 0) {  // Q is free for the next item; the last tile's P V
        if (lane == 0) mbar_arrive(q_empty);
        const int sp = (tiles + n - 1) % kStages;
        mbar_wait(v_full + 8 * sp, ((tiles + n - 1) / kStages) & 1);
        bar_sync(my_turn, kPair);
        wgmma_fence();
        issue_pv<NCH>(o, p, v_base + sp * NCH * kKVBox);
        wgmma_commit();
        bar_arrive(their_turn, kPair);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
        tiles += n;
      }

      if (row0 < Tq) {
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          inv[r] = 1.f / fmaxf(l[r], 1e-20f);
        }
        // the last item's store has read the O buffer
        if (ltid == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bar_sync(1 + cw, kWgThreads);
        // O in bf16, swizzled as TMA reads it
#pragma unroll
        for (int j = 0; j < kOut / 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r_lo + 8 * r;
            const int slot = (j % 8) ^ (row % 8);
            *reinterpret_cast<uint32_t*>(my_o + (j / 8) * kQBox +
                                         row * kRowBytes + slot * 16 +
                                         cq * 2) =
                pack_bf16(o[4 * j + 2 * r] * inv[r],
                          o[4 * j + 2 * r + 1] * inv[r]);
          }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + cw, kWgThreads);
        if (ltid == 0) {
          for (int c = 0; c < NCH; ++c)
            tma_store(&tm_o, smem_u32(my_o + c * kQBox), 64 * c, w.h, row0,
                      w.b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
    }
    if (ltid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime, so the
// library links only the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the [B, T, H, D] bf16 tensor at `base` as a 4-D map (D, H, T, B), boxes
// of 64 columns x `rows` rows of one head, 128-byte swizzled; reads past
// an extent are zeros, writes past it are dropped
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B,
              int T, int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Tq, int Tk, int Hq, int Hkv, int D,
                        float scale, int causal, int window, int q_offset,
                        cudaStream_t stream) {
  if (Tk == 0)  // no key: every row gives 0
    return cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * Tq * Hq * D * 2, stream);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(encode, &tq, q, B, Tq, Hq, D, kRows) ||
      !make_map(encode, &tk, k, B, Tk, Hkv, D, kKeys) ||
      !make_map(encode, &tv, v, B, Tk, Hkv, D, kKeys) ||
      !make_map(encode, &to, o, B, Tq, Hq, D, kRows))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + 2 * kConsumers * NCH * kQBox +
                      2 * kStages * NCH * kKVBox + 8 * (2 + 4 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // one block an SM, each walking its items
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((Tq + kRows * kConsumers - 1) /
                             (kRows * kConsumers)) * Hq * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_attention_bf16_kernel<NCH><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, to, B, Tq, Tk, Hq, Hkv, scale * kLog2e, causal, window,
      q_offset);
  return cudaGetLastError();
}

// ---- f32: 3xTF32 on wgmma, fed by TMA ---------------------------------

constexpr int kTKeys = 64;  // keys per K/V tile
constexpr int kTf32Threads = kWgThreads * (1 + kConsumers);
constexpr int kTBox = kTKeys * kRowBytes;  // 64 rows x 32 f32 columns
constexpr int kSplitKeys = 32;             // keys per pre-pass block

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + (x - hi) exactly, hi rounded to TF32; lo = x - hi, which the
// tensor cores read to its top 19 bits (an error of 2^-21 of x), or
// rounded to TF32 in turn where that costs nothing (2^-22)
template <bool kRoundLo>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  const float rest = x - __uint_as_float(hi);
  lo = kRoundLo ? tf32(rest) : __float_as_uint(rest);
}

// the slot of key r of an 8-key group in V^T: keys 0 2 4 6 1 3 5 7
__device__ __forceinline__ int vt_key(int slot) {
  return slot < 4 ? 2 * slot : 2 * (slot - 4) + 1;
}

// K -> hi, lo in K's layout [B, Tk, Hkv, D]; V -> hi, lo of V^T
// [B, Hkv, D, Tk8], keys permuted within each 8 (zeros past Tk)
__global__ void __launch_bounds__(256)
tf32_split_kv(const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ khi, float* __restrict__ klo,
              float* __restrict__ vhi, float* __restrict__ vlo, int Tk,
              int Tk8, int Hkv, int D) {
  __shared__ float tile[kSplitKeys][kMaxD + 1];  // V rows of this block
  const int key0 = blockIdx.x * kSplitKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t kstride = static_cast<int64_t>(Hkv) * D;
  const int64_t base = static_cast<int64_t>(b) * Tk * kstride +
                       static_cast<int64_t>(hk) * D;
  for (int idx = threadIdx.x; idx < kSplitKeys * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int key = key0 + r;
    float vv = 0.f;
    if (key < Tk) {
      const int64_t off = base + key * kstride + c;
      uint32_t hi, lo;
      tf32_split<true>(k[off], hi, lo);
      khi[off] = __uint_as_float(hi);
      klo[off] = __uint_as_float(lo);
      vv = v[off];
    }
    tile[r][c] = vv;
  }
  __syncthreads();
  const int64_t vbase = (static_cast<int64_t>(b) * Hkv + hk) * D * Tk8;
  for (int idx = threadIdx.x; idx < kSplitKeys * D; idx += blockDim.x) {
    const int d = idx / kSplitKeys;
    const int p = idx - d * kSplitKeys;
    if (key0 + p >= Tk8) continue;
    uint32_t hi, lo;
    tf32_split<true>(tile[(p & ~7) | vt_key(p & 7)][d], hi, lo);
    const int64_t off = vbase + static_cast<int64_t>(d) * Tk8 + key0 + p;
    vhi[off] = __uint_as_float(hi);
    vlo[off] = __uint_as_float(lo);
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in TF32, A's fragment in
// registers (a[0..3]), B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t* a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t* a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in TF32, both K-major in shared
// memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// NB = 32-column boxes of D: 2 for D <= 64, 4 for D <= 128.  K-major
// tiles advance 32 bytes (8 TF32 values) a k-step within a box.

// S = lo(Q) hi(K) + hi(Q) lo(K) + hi(Q) hi(K) for one 64-key tile, the
// small terms first: the tensor cores align each step's sum to its
// largest term, so small terms added to a large sum lose their low bits
template <int NB>
__device__ __forceinline__ void issue_scores_tf32(
    float (&sc)[32], const uint32_t (&qh)[16 * NB], uint32_t q_lo,
    uint32_t k_hi, uint32_t k_lo) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_tf32_ss_n64(sc,
                      smem_desc(q_lo + (kk / 4) * kQBox + (kk % 4) * 32, 16),
                      smem_desc(k_hi + (kk / 4) * kTBox + (kk % 4) * 32, 16),
                      kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_tf32_rs_n64(sc, &qh[4 * kk],
                      smem_desc(k_lo + (kk / 4) * kTBox + (kk % 4) * 32, 16),
                      1);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_tf32_rs_n64(sc, &qh[4 * kk],
                      smem_desc(k_hi + (kk / 4) * kTBox + (kk % 4) * 32, 16),
                      1);
}

// O += lo(P) hi(V) + hi(P) lo(V) + hi(P) hi(V) for one 64-key tile (small
// terms first), P's fragments from registers, V^T in two 32-key boxes of
// 32 NB rows
template <int NB>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[16 * NB],
                                              const uint32_t (&ph)[32],
                                              const uint32_t (&pl)[32],
                                              uint32_t v_hi, uint32_t v_lo) {
  constexpr int kVBox = 32 * NB * kRowBytes;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int kk = 0; kk < kTKeys / 8; ++kk) {
      const uint64_t vd = smem_desc(
          (t == 1 ? v_lo : v_hi) + (kk / 4) * kVBox + (kk % 4) * 32, 16);
      const uint32_t* a = t == 0 ? &pl[4 * kk] : &ph[4 * kk];
      if constexpr (NB == 4)
        wgmma_tf32_rs_n128(o, a, vd);
      else
        wgmma_tf32_rs_n64(o, a, vd, 1);
    }
}

// one tile's online softmax over this thread's two rows (as
// `online_softmax`, for 64 keys)
__device__ __forceinline__ void softmax_tf32(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, bool masked, int k0, int qpos0, int cq, int Tk,
    int causal, int window) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + cq + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -base[r]));
      l[r] += sc[4 * j + e];
    }
}

// the probabilities as hi and lo A fragments of P V: k-step j's fragment
// is rows (g, g + 8) x slots (t, t + 4) = keys 8 j + 2 t and + 1, which
// are accumulator elements 4 j + {0, 2, 1, 3}
__device__ __forceinline__ void split_p(uint32_t (&ph)[32],
                                        uint32_t (&pl)[32],
                                        const float (&sc)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tf32_split<false>(sc[4 * j + ((e & 1) << 1) + (e >> 1)],
                        ph[4 * j + e], pl[4 * j + e]);
}

// as `item_at`, with tiles of `keys` keys
__device__ __forceinline__ Item item_with(int L, int Tq, int Tk, int Hq,
                                          int B, int causal, int window,
                                          int q_offset, int keys) {
  const int n_qt = (Tq + kRows * kConsumers - 1) / (kRows * kConsumers);
  Item it;
  const int r = L % (Hq * B);
  it.q0 = (n_qt - 1 - L / (Hq * B)) * kRows * kConsumers;
  it.h = r % Hq;
  it.b = r / Hq;
  const int qmin = it.q0 + q_offset;
  const int qmax = min(it.q0 + kRows * kConsumers, Tq) - 1 + q_offset;
  const int k_end = causal ? min(Tk, qmax + 1) : Tk;
  const int k_begin = window > 0 ? max(0, qmin - window + 1) : 0;
  it.t_begin = k_begin / keys;
  it.n_tiles = k_end > k_begin ? (k_end + keys - 1) / keys - it.t_begin : 0;
  return it;
}

template <int NB>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_khi,
                            const __grid_constant__ CUtensorMap tm_klo,
                            const __grid_constant__ CUtensorMap tm_vhi,
                            const __grid_constant__ CUtensorMap tm_vlo,
                            float* __restrict__ out, int B, int Tq, int Tk,
                            int Hq, int Hkv, int D, float scale_log2,
                            int causal, int window, int q_offset) {
  constexpr int kVBox = 32 * NB * kRowBytes;  // 32 keys x 32 NB rows of d
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                          // [consumer][box] Q, then lo
  uint8_t* sk = sq + kConsumers * NB * kQBox;  // [hi, lo][box]
  uint8_t* sv = sk + 2 * NB * kTBox;           // [hi, lo][32-key box]
  const uint32_t bars = smem_u32(sv + 4 * kVBox);
  const uint32_t q_full = bars;  // mbarriers, 8 bytes each
  const uint32_t q_empty = bars + 8;
  const uint32_t k_full = bars + 16;
  const uint32_t k_empty = bars + 24;
  const uint32_t v_full = bars + 32;
  const uint32_t v_empty = bars + 40;
  const int n_items =
      (Tq + kRows * kConsumers - 1) / (kRows * kConsumers) * Hq * B;
  const int group = Hq / Hkv;

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(q_empty, kConsumers * 4);  // one arrival a consumer warp
    mbar_init(k_empty, kConsumers * 4);
    mbar_init(v_empty, kConsumers * 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      int tiles = 0, qs = 0;  // tiles and Q buffers used so far
      for (int L = blockIdx.x; L < n_items; L += gridDim.x) {
        const Item w = item_with(L, Tq, Tk, Hq, B, causal, window, q_offset,
                                 kTKeys);
        if (w.n_tiles == 0) continue;
        const int hk = w.h / group;
        mbar_wait(q_empty, (qs++ & 1) ^ 1);  // the first round passes
        mbar_expect_tx(q_full, kConsumers * NB * kQBox);
        for (int c = 0; c < kConsumers * NB; ++c)
          tma_load(&tm_q, smem_u32(sq + c * kQBox), q_full, 32 * (c % NB),
                   w.h, w.q0 + (c / NB) * kRows, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++tiles) {
          const uint32_t phase = tiles & 1;
          const int k0 = (w.t_begin + i) * kTKeys;
          mbar_wait(k_empty, phase ^ 1);
          mbar_expect_tx(k_full, 2 * NB * kTBox);
          for (int c = 0; c < NB; ++c) {
            tma_load(&tm_khi, smem_u32(sk + c * kTBox), k_full, 32 * c, hk,
                     k0, w.b);
            tma_load(&tm_klo, smem_u32(sk + (NB + c) * kTBox), k_full,
                     32 * c, hk, k0, w.b);
          }
          mbar_wait(v_empty, phase ^ 1);
          mbar_expect_tx(v_full, 4 * kVBox);
          for (int c = 0; c < 2; ++c) {
            tma_load(&tm_vhi, smem_u32(sv + c * kVBox), v_full, k0 + 32 * c,
                     0, hk, w.b);
            tma_load(&tm_vlo, smem_u32(sv + (2 + c) * kVBox), v_full,
                     k0 + 32 * c, 0, hk, w.b);
          }
        }
      }
    }
  } else {  // consumer warpgroup cw: rows q0 + 64 cw .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int ltid = tid - wg * kWgThreads;
    const int warp = ltid / 32;
    const int lane = ltid % 32;
    const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
    const int tq = lane % 4;
    const int cq = 2 * tq;  // accumulator columns 8 j + cq, + 1
    const int my_turn = 3 + cw;  // the consumers take turns to issue
    const int their_turn = 4 - cw;
    constexpr int kPair = kConsumers * kWgThreads;
    if (cw == 1) bar_arrive(3, kPair);  // consumer 0 goes first
    uint8_t* my_q = sq + cw * NB * kQBox;
    const uint32_t q_lo = smem_u32(my_q);
    const uint32_t k_hi = smem_u32(sk);
    const uint32_t k_lo = smem_u32(sk + NB * kTBox);
    const uint32_t v_hi = smem_u32(sv);
    const uint32_t v_lo = smem_u32(sv + 2 * kVBox);
    constexpr int kOut = 16 * NB;  // accumulator floats: 64 x 32 NB
    int tiles = 0, qs = 0;  // as the producer counts them

    for (int L = blockIdx.x; L < n_items; L += gridDim.x) {
      const Item w = item_with(L, Tq, Tk, Hq, B, causal, window, q_offset,
                               kTKeys);
      const int n = w.n_tiles;
      const int row0 = w.q0 + cw * kRows;
      const int qpos0 = row0 + r_lo + q_offset;
      const int wq_min = row0 + q_offset;
      const int wq_max = min(row0 + kRows, Tq) - 1 + q_offset;
      auto masked = [&](int k0) {
        return (causal && k0 + kTKeys - 1 > wq_min) ||
               (window > 0 && k0 <= wq_max - window) || k0 + kTKeys > Tk;
      };
      float o[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l[2] = {0.f, 0.f};  // this thread's share of the running sum
      uint32_t qh[4 * 4 * NB];  // hi(Q) A fragments, k-step kk at 4 kk
      if (n > 0) {
        // split this consumer's Q rows: hi into registers, lo in place.
        // Fragment element e of k-step kk is row r_lo + 8 (e & 1),
        // column 8 kk + tq + 4 (e >> 1), in its swizzled 32-column box.
        mbar_wait(q_full, qs++ & 1);
#pragma unroll
        for (int kk = 0; kk < 4 * NB; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r_lo + 8 * (e & 1);
            const int col = 8 * (kk % 4) + tq + 4 * (e >> 1);  // in box
            float* p = reinterpret_cast<float*>(
                my_q + (kk / 4) * kQBox + row * kRowBytes +
                (((col / 4) ^ (row % 8)) * 16) + (col % 4) * 4);
            uint32_t lo;
            tf32_split<false>(*p, qh[4 * kk + e], lo);
            *p = __uint_as_float(lo);
          }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + cw, kWgThreads);
      }
      for (int i = 0; i < n; ++i) {
        const uint32_t ph_bar = (tiles + i) & 1;
        const int k0 = (w.t_begin + i) * kTKeys;
        float sc[32];
        mbar_wait(k_full, ph_bar);
        bar_sync(my_turn, kPair);
        wgmma_fence();
        issue_scores_tf32<NB>(sc, qh, q_lo, k_hi, k_lo);
        wgmma_commit();
        bar_arrive(their_turn, kPair);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(qh);
        if (lane == 0) {
          mbar_arrive(k_empty);
          if (i == n - 1) mbar_arrive(q_empty);  // Q is free for the next
        }
        float alpha[2];
        softmax_tf32(sc, m, l, alpha, scale_log2, masked(k0), k0, qpos0, cq,
                     Tk, causal, window);
#pragma unroll
        for (int j = 0; j < kOut / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
        uint32_t ph[32], pl[32];
        split_p(ph, pl, sc);
        mbar_wait(v_full, ph_bar);
        bar_sync(my_turn, kPair);
        wgmma_fence();
        issue_pv_tf32<NB>(o, ph, pl, v_hi, v_lo);
        wgmma_commit();
        bar_arrive(their_turn, kPair);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        if (lane == 0) mbar_arrive(v_empty);
      }
      tiles += n;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-20f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r_lo + 8 * r;
        if (row >= Tq) continue;
        float* orow = out + ((static_cast<int64_t>(w.b) * Tq + row) * Hq +
                             w.h) * D;
#pragma unroll
        for (int j = 0; j < kOut / 4; ++j) {
          const int col = 8 * j + cq;
          if (col < D)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(o[4 * j + 2 * r] * inv[r],
                            o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// a row-major f32 tensor of extents dims (innermost first) as a 4-D map
// with boxes of box[] elements, 128-byte swizzled (box[0] = 32 columns);
// reads past an extent are zeros
bool make_map_f32(EncodeTiled encode, CUtensorMap* map, const void* base,
                  const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                 dims[0] * dims[1] * dims[2] * 4};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        void* ws, int B, int Tq, int Tk, int Hq, int Hkv,
                        int D, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream) {
  if (Tk == 0)  // no key: every row gives 0
    return cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * Tq * Hq * D * 4, stream);
  if (ws == nullptr) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int Tk8 = (Tk + 7) / 8 * 8;
  const size_t nk = static_cast<size_t>(B) * Tk * Hkv * D;
  const size_t nv = static_cast<size_t>(B) * Hkv * D * Tk8;
  float* khi = static_cast<float*>(ws);
  float* klo = khi + nk;
  float* vhi = klo + nk;
  float* vlo = vhi + nv;
  const dim3 split_grid((Tk8 + kSplitKeys - 1) / kSplitKeys, Hkv, B);
  tf32_split_kv<<<split_grid, 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), khi, klo,
      vhi, vlo, Tk, Tk8, Hkv, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 dq[4] = {u64(D), u64(Hq), u64(Tq), u64(B)};
  const u64 dk[4] = {u64(D), u64(Hkv), u64(Tk), u64(B)};
  const u64 dv[4] = {u64(Tk8), u64(D), u64(Hkv), u64(B)};
  const u32 bq[4] = {32, 1, u32(kRows), 1};
  const u32 bk[4] = {32, 1, u32(kTKeys), 1};
  const u32 bv[4] = {32, u32(32 * NB), 1, 1};
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!make_map_f32(encode, &tq, q, dq, bq) ||
      !make_map_f32(encode, &tkh, khi, dk, bk) ||
      !make_map_f32(encode, &tkl, klo, dk, bk) ||
      !make_map_f32(encode, &tvh, vhi, dv, bv) ||
      !make_map_f32(encode, &tvl, vlo, dv, bv))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + kConsumers * NB * kQBox + 2 * NB * kTBox +
                      4 * 32 * NB * kRowBytes + 8 * 6;
  err = cudaFuncSetAttribute(flash_attention_tf32_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // one block an SM, each walking its items
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((Tq + kRows * kConsumers - 1) /
                             (kRows * kConsumers)) * Hq * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_attention_tf32_kernel<NB><<<grid, kTf32Threads, smem, stream>>>(
      tq, tkh, tkl, tvh, tvl, static_cast<float*>(o), B, Tq, Tk, Hq, Hkv, D,
      scale * kLog2e, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32 (`ws`: a workspace of 2 B Hkv D (Tk + Tk8) floats, Tk8 = Tk
// rounded up to 8), 1 = bf16 (D % 8 == 0: TMA strides are 16-byte multiples;
// `ws` unused).  window <= 0 means none.  Returns the launch's cudaError_t; the
// caller raises on anything but 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* ws, int B, int Tq, int Tk,
                               int Hq, int Hkv, int D, int dtype, float scale,
                               int causal, int window, int q_offset,
                               void* stream) {
  if (B == 0 || Tq == 0 || Hq == 0) return 0;
  if (B < 0 || Tq < 0 || Tk < 0 || Hkv <= 0 || Hq % Hkv || D <= 0 ||
      D > kMaxD || D % 4 || Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch_tf32<2>(q, k, v, o, ws, B, Tq, Tk, Hq, Hkv, D,
                                    scale, causal, window, q_offset, s)
                   : launch_tf32<4>(q, k, v, o, ws, B, Tq, Tk, Hq, Hkv, D,
                                    scale, causal, window, q_offset, s);
  if (dtype == 1 && D % 8 == 0)
    return D <= 64 ? launch_bf16<1>(q, k, v, o, B, Tq, Tk, Hq, Hkv, D, scale,
                                    causal, window, q_offset, s)
                   : launch_bf16<2>(q, k, v, o, B, Tq, Tk, Hq, Hkv, D, scale,
                                    causal, window, q_offset, s);
  return cudaErrorInvalidValue;
}

