// Blocked online-softmax attention, forward only (prefill and the train
// and tune steps' forward).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd / _attn_kernel, pallas_call at :108).  Layout is
// the public one, q (B, Sq, H, D) and k/v (B, Sk, KH, D), read in place:
// query head h reads kv head h / (H / KH), so GQA needs no repeated K/V
// copy.  Semantics as the reference's: scale 1/sqrt(D) on the f32 scores
// after Q K^T, softcap tanh(s/c)*c, causal positions from 0 for q and k,
// window kp > qp - window, denominator clamped at 1e-30, one rounding to
// the output type.  The TPU's sequential k grid axis becomes a loop inside
// the block over key tiles; tiles entirely above the causal diagonal or
// left of every query's window are never visited, and the ragged Sq/Sk
// edges are masked here (the TPU wrapper pads them instead).
//
// What bounds it: causal attention at prefill shapes does 4*D flops per
// visible (query, key) pair (2*D for Q K^T, 2*D for P V) on 2 bytes of
// q/k/v/o per element, so on the H100 it is bound by operations at the
// bf16 tensor-core rate.  The split of P below does P V twice: 2*D more
// flops per pair that the bound does not credit.
//
// bf16 (flash_fwd_tc_kernel): tensor cores, mma.sync + cp.async.
//  - 4 warps a block, 64 query rows a block (16 a warp), key tiles of 64
//    (32 at D = 256, for shared memory and registers).  q, k and v stay
//    bf16 in shared memory, rows padded by 16 bytes so ldmatrix has no
//    bank conflicts; D is padded to the mma depth of 16 with zero columns
//    (D = 24 -> 32, in q and k, so the padding adds 0 to every score).
//  - K and V tiles go through a two-stage cp.async ring of 16-byte
//    copies: tile t+1 is in flight while tile t is computed.  The Q tile
//    is loaded once; at D <= 64 its fragments stay in registers, above
//    that they are re-read from shared memory each depth step.
//  - S = Q K^T by mma.sync m16n8k16 (bf16 x bf16 products are exact in
//    f32 and summed in f32, so only the summation order differs from the
//    reference).  Scale, softcap and mask act on the f32 accumulator
//    fragments.  Each row of an m16n8 fragment lies in four lanes, so the
//    row max and sum take two quad shuffles.  A masked score gives p = 0
//    exactly (a row may have no visible key yet).
//  - O += P V with P split into two bf16 terms, hi = bf16(p) and
//    lo = bf16(p - hi), reused as A operands straight from the score
//    registers (V by ldmatrix.trans); the denominator sums the unrounded
//    f32 p.  The comment at the split says why P is not rounded once.
//  - Softcap and mask are each tested once a tile, never per element; the
//    mask is applied only on tiles that cross the causal diagonal, the
//    window edge or the ragged Sk edge.  Per-element tests of values
//    uniform over the block left a branch and a reconvergence point on
//    each of a thread's 32 scores a tile.
//  - The grid stays (Sq/64, B*H), but blocks take their work in the order
//    they start (linear index, x fastest) as (q tile from the last to the
//    first, then b*H + h): every head's longest causal rows start first
//    and the short tiles fill the tail.
//  PERF.md holds the times (chip_smoke.py).
//  Per-D registers a thread and shared memory a block (nvcc -Xptxas -v,
//  sm_90a, CUDA 12.8, no spills; chip_smoke.py prints them at build):
//    D      16   24   32   64   96  112  128  256
//    regs  112  128  128  163  167  183  186  255
//    KB     15   25   25   45   65   75   85   99
//
// f32 (flash_fwd_kernel<float, D>): the first version on CUDA cores,
// kept for f32 models.  One 256-thread block per (tile of 64 query rows,
// b*H + h); 64-key tiles staged in shared memory; Q K^T and P V as 4x4
// register tiles per thread; the running max and denominator in shared
// memory, the accumulator in registers (D/4 values a thread).  A thread
// owns output columns tx + 16 j; where D is not a multiple of 16 (D = 24)
// the V tile is padded with zero columns.  At D = 256 its shared tiles
// take 214.5 KB, under the 227 KB a block may opt in to.
//
// The head dims built are listed in dispatch_d: every one a config of the
// repository uses (16, 24, 32, 64, 96, 112, 128, 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1.0e30f;
constexpr float MASKED = -0.5e30f;  // scores below this are masked
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// output columns per thread, and the V tile's row stride (zero-padded)
template <int D>
__host__ __device__ constexpr int col_tiles() {
  return (D + 15) / 16;
}
template <int D>
__host__ __device__ constexpr int v_stride() {
  return 16 * col_tiles<D>();
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // sQ, sK (padded rows), sV (zero-padded columns), sS (padded rows), m,
  // l, corr
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * v_stride<D>() +
                          BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KH, int causal, int window, float softcap,
                 float scale) {
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, <= 256");
  static_assert(smem_bytes<D>() <= 232448, "shared tiles over 227 KB");
  constexpr int DP = D + 1;   // padded row stride: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int DJ = col_tiles<D>();  // output columns per thread
  constexpr int DV = v_stride<D>();
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * DV;
  float* sM = sS + BQ * SP;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    sQ[r * DP + d] =
        s < Sq ? to_f32(q[(((size_t)b * Sq + s) * H + h) * D + d]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // key range any query of this tile can see
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // last tile's P V is done with sK/sV/sS
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, d = i % DV, s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < Sk && d < D) {
        const size_t off = (((size_t)b * Sk + s) * KH + kh) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      if (d < D) sK[r * DP + d] = kv;
      sV[r * DV + d] = vv;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16i, keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sS[r * SP + c] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring lanes share one row, 16 keys each.
    // Masked entries get probability 0, not exp(0) (a row may have no
    // visible key in this tile yet).
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = sS + r * SP + part * 16;
      const float m_prev = sM[r];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float s = row[c];
        const float p = s > MASKED ? expf(s - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: thread owns rows ty + 16i, cols tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], va[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) va[j] = sV[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= Sq) continue;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    T* dst = o + (((size_t)b * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < D) dst[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tc {
  static constexpr int DP = (D + 15) / 16 * 16;  // padded to the mma depth
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per tile
  static constexpr int DS = DP + 8;              // row stride: +16 bytes
  static constexpr int CH = D / 8;               // 16-byte chunks a row
  static constexpr bool Q_IN_REGS = DP <= 64;
  static constexpr int STAGES = 2;  // the K/V cp.async ring
  // sQ, then the stages of sK and of sV
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * DS * (BQ + 2 * STAGES * BK);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below 2^-126 to 0 (p that small adds nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> the two bf16 terms of P packed as mma operands: hi[j] =
// bf16(x), lo[j] = bf16(x - hi).  x - hi is exact in f32, so the pair
// carries x to about 16 significant bits; the comment at the split says
// why P needs them.
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4], int j) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi[j] = bits(h);
  lo[j] = bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                    int KH, int causal, int window, float softcap,
                    float scale) {
  using C = Tc<D>;
  constexpr int DP = C::DP, BKT = C::BK, DS = C::DS, CH = C::CH;
  constexpr int NST = C::STAGES;
  constexpr int KSTEPS = DP / 16;  // depth steps of Q K^T
  constexpr int NS = BKT / 8;      // score n-tiles a warp
  constexpr int NO = DP / 8;       // output n-tiles a warp
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, <= 256");
  static_assert(C::SMEM <= 232448, "shared tiles over 227 KB");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * DS;       // stage s at sK + s * BKT * DS
  __nv_bfloat16* sV = sK + NST * BKT * DS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column pair
  // Blocks start in the order of their linear index (x fastest).  Walk it
  // as (q tile from the last to the first, then b*H + h), so every head's
  // longest causal rows start first and the short tiles fill the tail.
  const int bh_all = gridDim.y;
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int q0 = (gridDim.x - 1 - lin / bh_all) * BQ;
  const int b = (lin % bh_all) / H, h = (lin % bh_all) % H;
  const int kh = h / (H / KH);
  const float scale_log2 = scale * LOG2E;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const float cap_log2 = softcap * LOG2E;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KH * D;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kh) * D;

  if constexpr (DP != D) {  // zero columns D..DP of every staged row
    for (int i = tid; i < (BQ + 2 * NST * BKT) * (DP - D); i += TC_THREADS)
      sQ[(i / (DP - D)) * DS + D + i % (DP - D)] = __float2bfloat16(0.f);
  }
  for (int c = tid; c < BQ * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH, s = q0 + r;
    cp_async16(smem_addr(sQ + r * DS + ch * 8),
               s < Sq ? qb + s * q_stride + ch * 8 : qb, s < Sq);
  }
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* dk = sK + stage * BKT * DS;
    __nv_bfloat16* dv = sV + stage * BKT * DS;
    for (int c = tid; c < BKT * CH; c += TC_THREADS) {
      const int r = c / CH, ch = c % CH, s = t * BKT + r;
      const size_t off = s < Sk ? s * kv_stride + ch * 8 : 0;
      cp_async16(smem_addr(dk + r * DS + ch * 8), kb + off, s < Sk);
      cp_async16(smem_addr(dv + r * DS + ch * 8), vb + off, s < Sk);
    }
  };

  // key range any query of this tile can see
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BKT, t_hi = (k_hi + BKT - 1) / BKT;
  // prologue: tiles t_lo .. t_lo + NST - 2, one commit group each (the
  // first with Q); every iteration commits one group, empty past t_hi,
  // so "all but the newest NST - 1 groups" is always tile t and older
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (t_lo + i < t_hi) load_kv(t_lo + i, i);
    cp_async_commit();
  }

  // this warp's rows: qw .. qw + 15; the thread's rows r0 and r0 + 8
  const int qw = q0 + 16 * warp;
  const int r0 = qw + g, r1 = r0 + 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's
  uint32_t qf[C::Q_IN_REGS ? KSTEPS : 1][4];

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % NST;
    // tile t + NST - 1 goes where tile t - 1 was, freed by the last sync
    if (t + NST - 1 < t_hi) load_kv(t + NST - 1, (stage + NST - 1) % NST);
    cp_async_commit();
    cp_async_wait<NST - 1>();  // tile t (and Q) landed
    __syncthreads();
    const __nv_bfloat16* sKs = sK + stage * BKT * DS;
    const __nv_bfloat16* sVs = sV + stage * BKT * DS;
    const int k0 = t * BKT;
    if constexpr (C::Q_IN_REGS) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(sQ + (16 * warp + (lane & 15)) * DS +
                                        kk * 16 + (lane >> 4) * 8));
      }
    }
    // a warp whose rows see no key of this tile (or lie past Sq) skips it
    const bool live = qw < Sq && !(causal && k0 > qw + 15) &&
                      !(window > 0 && k0 + BKT - 1 <= qw - window);
    if (live) {
      // S = Q K^T: n-tile j holds keys k0 + 8j .. k0 + 8j + 7
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        if constexpr (C::Q_IN_REGS) {
          a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2],
          a[3] = qf[kk][3];
        } else {
          ldmatrix_x4(a, smem_addr(sQ + (16 * warp + (lane & 15)) * DS +
                                   kk * 16 + (lane >> 4) * 8));
        }
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
          uint32_t kf[4];  // b0, b1 of n-tiles 2jj and 2jj + 1
          ldmatrix_x4(kf, smem_addr(sKs +
                                    (jj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                        DS +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * jj], a, kf[0], kf[1]);
          mma_bf16(s[2 * jj + 1], a, kf[2], kf[3]);
        }
      }
      // scale, softcap, mask.  Scores are kept in log2 units, x = s *
      // log2(e), so exp(s - m) = 2^(x - m).  The tests below are uniform
      // over the block, so each is taken once for the whole tile, never per
      // element; the mask only where the tile crosses the causal diagonal,
      // the window edge or the ragged Sk edge.
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * scale * inv_cap) * cap_log2;
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
      if (k0 + BKT > Sk || (causal && k0 + BKT - 1 > qw) ||
          (window > 0 && k0 <= qw + 15 - window)) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = e < 2 ? r0 : r1;
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool ok = kp < Sk && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window);
            s[j][e] = ok ? s[j][e] : NEG_INF;
          }
        }
      }
      // online softmax; a row's 8 n-tiles x 2 columns lie in 4 lanes
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = ex2(m0 - mx0);
      const float c1 = ex2(m1 - mx1);
      m0 = mx0, m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score gives p = 0 exactly, also while m is NEG_INF
          const float p = s[j][e] > MASKED ? ex2(s[j][e] - (e < 2 ? m0 : m1))
                                           : 0.f;
          s[j][e] = p;
          if (e < 2) sum0 += p; else sum1 += p;
        }
      }
      l0 = l0 * c0 + sum0;  // the unrounded p; quad-reduced at the end
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= c0, acc[n][1] *= c0;
        acc[n][2] *= c1, acc[n][3] *= c1;
      }
      // O += P V with P split into two bf16 terms, hi = bf16(p) and lo =
      // bf16(p - hi), each through the tensor cores into the same f32
      // accumulator, the smaller first.  Do not round P once to bf16.
      // tests/test_torch_flash_numerics.py emulates this arithmetic on
      // N(0,1) bf16 q/k/v at every head dim (causal, window and softcap
      // cases): P rounded once puts outputs at 6.0-17.7x chip_smoke.py's
      // per-element limit (two bf16 ulps of the output + 1e-4), the split
      // at 0.45-0.50x.  The worst elements are outputs near zero in rows
      // with few visible keys.  On the card, chip_smoke.py's train phase
      // holds every layer's output on a real batch to the same limit.
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t ph[4], pl[4];  // A operands: keys k0 + 16kk .. + 15
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph, pl, 0);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph, pl, 1);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph, pl, 2);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph, pl, 3);
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          uint32_t vf[4];  // b0, b1 of output n-tiles 2dd and 2dd + 1
          ldmatrix_x4_trans(
              vf, smem_addr(sVs +
                            (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                DS +
                            dd * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * dd], pl, vf[0], vf[1]);  // the smaller first
          mma_bf16(acc[2 * dd + 1], pl, vf[2], vf[3]);
          mma_bf16(acc[2 * dd], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * dd + 1], ph, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + ((size_t)b * Sq * H + h) * D + r0 * q_stride;
  __nv_bfloat16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= D) continue;  // D = 24: the padded columns
    const int col = 8 * n + 2 * t4;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// the shared-memory limit is a per-device attribute of a kernel: set it on
// the first launch on each device, not on every launch
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem,
                        std::atomic<bool> (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KH, int causal,
                      int window, float softcap, float scale,
                      cudaStream_t stream) {
  // cp.async copies 16 bytes: every row starts on a 16-byte boundary
  // when the tensors' data pointers do (D is a multiple of 8)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16)
    return cudaErrorMisalignedAddress;
  static std::atomic<bool> ready[MAX_DEVICES];
  cudaError_t err = opt_in_smem(flash_fwd_tc_kernel<D>, Tc<D>::SMEM, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_tc_kernel<D><<<grid, TC_THREADS, Tc<D>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, H, KH, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KH, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tc<D>(q, k, v, o, B, Sq, Sk, H, KH, causal, window,
                        softcap, scale, stream);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    static std::atomic<bool> ready[MAX_DEVICES];
    cudaError_t err = opt_in_smem(flash_fwd_kernel<T, D>, smem, ready);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, causal,
        window, softcap, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KH, int D,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                   \
  case DIM:                                                               \
    return launch<T, DIM>(q, k, v, o, B, Sq, Sk, H, KH, causal, window,  \
                          softcap, scale, stream);
  // the head dims the kernel is built for: every one a config of the
  // repository uses
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(24)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int KH,
                        int D, int causal, int window, float softcap,
                        float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, KH, D, causal,
                                  window, softcap, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D,
                                          causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
