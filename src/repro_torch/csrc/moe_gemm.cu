// Grouped expert GEMMs of a routed MoE layer.
//
// Two kernels of repro/kernels/moe_gemm/kernel.py are replaced here:
//
// * grouped_matmul (_matmul_kernel): per-expert (E, M, K) @ (E, K, N)
//   with f32 accumulation, the building block of the grouped FFN's
//   backward (eight products per layer, every operand in f32 in the
//   reference).  Entry point: grouped_matmul.
// * grouped_ffn_ecd (_ffn_kernel): per-expert gated FFN
//   y[e] = (act(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wo[e] over
//   fixed-capacity (E, C, D) buffers, f32 inside, output in x's dtype.
//   Entry point: grouped_ffn_fwd.
//
// grouped_matmul.  A and B are read through strides, in bf16 or f32,
// and converted to f32 on load (exactly), so the backward passes the
// bf16 expert weights and their transposes as they lie instead of f32,
// transposed copies (three 692 MB tensors per layer on the path).  The
// arithmetic is f32 on the CUDA cores, as the reference's f32 products
// are: TF32 tensor cores would change the numbers.  128 x 128 output
// tiles, 16-deep K chunks staged through shared memory (the next chunk's
// global loads issued before the current chunk's products), 8 x 8
// outputs per thread.  Loads are coalesced along whichever of A's (m, k)
// or B's (k, n) axes has stride 1.  Bound on the path: one product is
// 2 * 32880 * 2048 * 1408 = 190 GFLOP, 2.8 ms at the card's 67 TFLOP/s
// f32 rate; the fast route (split-bf16 or TF32x3 tensor-core products
// that keep f32 accuracy, wgmma, TMA) is later work.
//
// grouped_ffn_ecd.  The TPU kernel keeps a (Bc, D) f32 accumulator in
// VMEM across a sequential F axis; at Bc = 128, D = 2048 that is 1 MB,
// four times the 227 KB of shared memory a block may have, and a
// sequential F walk would leave most SMs idle.  So the work is split in
// two stages, launched back to back.  bf16 inputs (the path), both
// stages on the tensor cores:
//   A. ffn_gate_up_tc, per (expert, 128-row C tile, 128-column F tile):
//      h = act(x @ wg) * (x @ wu).  bf16 x bf16 products by mma.sync
//      m16n8k16 are exact in f32 and summed in f32; the gate is f32.
//      h leaves as two bf16 planes, hi = bf16(h) and lo = bf16(h - hi)
//      (h - hi is exact in f32), in the bytes of one f32 h.  The
//      reference never rounds h: h rounded once to bf16 breaks the
//      per-element check the kernel is held to, the two terms keep it
//      (tests/test_torch_moe_numerics.py emulates both).
//   B. ffn_down_tc, per (expert, 128-row C tile, 128-column D tile):
//      y = h_lo @ wo + h_hi @ wo by mma.sync into one f32 accumulator,
//      the smaller term first at each 16-deep step; each wo fragment
//      feeds both terms.  Rounded once to bf16.
// Both: 8 warps a block, each owning a 64 x 32 sub-tile (of g and of u
// in A, of y in B).  K chunks of 32 pass through a three-stage cp.async
// ring of 16-byte copies.  Operands are read in their natural row-major
// layout: A fragments by ldmatrix, B fragments by ldmatrix.trans on the
// [k][n] tiles, so no transposed copy of a weight is made.  Shared rows
// are padded by 16 bytes (no bank conflicts in ldmatrix); 81 KB (A) and
// 86 KB (B) of dynamic shared memory a block.  Rows and columns past the
// ragged C, D or F edge load as zero and are never written (the TPU
// wrapper pads instead).  An operand whose rows (D or F long) are not a
// multiple of 8 elements, or whose pointer is off 16-byte alignment, is
// loaded element by element into the same tiles.
// f32 inputs: two grouped_matmul products into f32 scratch h and u, an
// elementwise gate, then y = h @ wo through the grouped_matmul code.
// The GELU is the tanh approximation, as in the TPU kernel.
//
// Bound on the path (E=60, C=548, D=2048, F=1408, bf16): 6 * E*C*D*F =
// 569 GFLOP, 0.575 ms at 989 TFLOP/s.  The bf16 kernel issues about 886
// GFLOP of mma: C's last tile pads 548 rows to 640, and stage B does its
// product twice (lo and hi), so 4/3 of the bound's work before the
// padding.  The h planes add 185 MB written and read again (about 0.11
// ms at 3.35 TB/s).  wgmma, TMA and warp specialisation are the next
// design for both stages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// grouped matmul, f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;
constexpr int LDS = BM + 4;  // shared row stride in floats (BM == BN)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// C[e] (M, N, contiguous) = A[e] @ B[e]; A[e][m][k] at a + e*sAe + m*sAm +
// k*sAk, B[e][k][n] at b + e*sBe + k*sBk + n*sBn.  grid (N/BN, M/BM, E).
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(NT)
    gmm_kernel(const TA* __restrict__ a, int64_t sAe, int64_t sAm,
               int64_t sAk, const TB* __restrict__ b, int64_t sBe,
               int64_t sBk, int64_t sBn, TC* __restrict__ c, int M, int N,
               int K) {
  __shared__ __align__(16) float As[BK][LDS];
  __shared__ __align__(16) float Bs[BK][LDS];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += e * sAe;
  b += e * sBe;
  const int tid = threadIdx.x;
  const bool a_kc = (sAk == 1);  // A row-major: coalesce along k
  const bool b_nc = (sBn == 1);  // B row-major: coalesce along n
  float ra[8], rb[8];

  // each thread stages 8 A and 8 B values per K chunk
  auto load = [&](int k0) {
    if (a_kc) {
      const int k = k0 + (tid & 15), mm = tid >> 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + mm + 16 * i;
        ra[i] = (m < M && k < K) ? to_f(a[m * sAm + k]) : 0.f;
      }
    } else {
      const int m = m0 + (tid & 127), kk = tid >> 7;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + kk + 2 * i;
        ra[i] = (m < M && k < K) ? to_f(a[m * sAm + k * sAk]) : 0.f;
      }
    }
    if (b_nc) {
      const int n = n0 + (tid & 127), kk = tid >> 7;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + kk + 2 * i;
        rb[i] = (n < N && k < K) ? to_f(b[k * sBk + n]) : 0.f;
      }
    } else {
      const int k = k0 + (tid & 15), nn = tid >> 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + nn + 16 * i;
        rb[i] = (n < N && k < K) ? to_f(b[k * sBk + n * sBn]) : 0.f;
      }
    }
  };
  auto stage = [&]() {
    if (a_kc) {
#pragma unroll
      for (int i = 0; i < 8; ++i) As[tid & 15][(tid >> 4) + 16 * i] = ra[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) As[(tid >> 7) + 2 * i][tid & 127] = ra[i];
    }
    if (b_nc) {
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[(tid >> 7) + 2 * i][tid & 127] = rb[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[tid & 15][(tid >> 4) + 16 * i] = rb[i];
    }
  };

  // thread (ty, tx) owns rows ty*4.. and 64+ty*4.., columns tx*4.. and
  // 64+tx*4..: float4 reads of the staged tiles without bank conflicts
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the last chunk's products are done with As/Bs
    stage();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  TC* ce = c + (int64_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store(ce + (int64_t)m * N + n, acc[i][j]);
    }
  }
}

template <typename TA, typename TB, typename TC>
cudaError_t gmm(const void* a, int64_t sAe, int64_t sAm, int64_t sAk,
                const void* b, int64_t sBe, int64_t sBk, int64_t sBn,
                void* c, int E, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gmm_kernel<TA, TB, TC><<<grid, NT, 0, s>>>(
      static_cast<const TA*>(a), sAe, sAm, sAk, static_cast<const TB*>(b),
      sBe, sBk, sBn, static_cast<TC*>(c), M, N, K);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
template <typename TA, typename TB>
cudaError_t gmm_c(int dc, const void* a, int64_t sAe, int64_t sAm,
                  int64_t sAk, const void* b, int64_t sBe, int64_t sBk,
                  int64_t sBn, void* c, int E, int M, int N, int K,
                  cudaStream_t s) {
  if (dc == 0)
    return gmm<TA, TB, float>(a, sAe, sAm, sAk, b, sBe, sBk, sBn, c, E, M, N,
                              K, s);
  if (dc == 1)
    return gmm<TA, TB, __nv_bfloat16>(a, sAe, sAm, sAk, b, sBe, sBk, sBn, c,
                                      E, M, N, K, s);
  return cudaErrorInvalidValue;
}

template <typename TA>
cudaError_t gmm_b(int db, int dc, const void* a, int64_t sAe, int64_t sAm,
                  int64_t sAk, const void* b, int64_t sBe, int64_t sBk,
                  int64_t sBn, void* c, int E, int M, int N, int K,
                  cudaStream_t s) {
  if (db == 0)
    return gmm_c<TA, float>(dc, a, sAe, sAm, sAk, b, sBe, sBk, sBn, c, E, M,
                            N, K, s);
  if (db == 1)
    return gmm_c<TA, __nv_bfloat16>(dc, a, sAe, sAm, sAk, b, sBe, sBk, sBn, c,
                                    E, M, N, K, s);
  return cudaErrorInvalidValue;
}

cudaError_t gmm_any(int da, int db, int dc, const void* a, int64_t sAe,
                    int64_t sAm, int64_t sAk, const void* b, int64_t sBe,
                    int64_t sBk, int64_t sBn, void* c, int E, int M, int N,
                    int K, cudaStream_t s) {
  if (da == 0)
    return gmm_b<float>(db, dc, a, sAe, sAm, sAk, b, sBe, sBk, sBn, c, E, M,
                        N, K, s);
  if (da == 1)
    return gmm_b<__nv_bfloat16>(db, dc, a, sAe, sAm, sAk, b, sBe, sBk, sBn, c,
                                E, M, N, K, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// grouped FFN, bf16: both stages on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TM = 128;           // rows (C) per block
constexpr int TN = 128;           // columns (F in stage A, D in B) per block
constexpr int TK = 32;            // K chunk
constexpr int STAGES = 3;         // the cp.async ring
constexpr int LDA = TK + 8;       // [m][k] tile row stride: +16 bytes
constexpr int LDB = TN + 8;       // [k][n] tile row stride: +16 bytes
constexpr int A_TILE = TM * LDA;  // elements
constexpr int B_TILE = TK * LDB;
// stage A: x, wg, wu tiles; stage B: h_hi, h_lo, wo tiles (bytes)
constexpr size_t SMEM_UP = 2 * STAGES * (A_TILE + 2 * B_TILE);
constexpr size_t SMEM_DOWN = 2 * STAGES * (2 * A_TILE + B_TILE);
static_assert(SMEM_UP <= 232448 && SMEM_DOWN <= 232448,
              "shared tiles over 227 KB");
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float gated(float g, float u, int act) {
  float a;
  if (act == 1) {  // tanh-approximate GELU
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    a = 0.5f * g * (1.f + tanhf(k * (g + 0.044715f * g * g * g)));
  } else {  // SiLU
    a = g * (1.f / (1.f + expf(-g)));
  }
  return a * u;
}

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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// A ROWS x COLS bf16 tile into shared memory (row stride SLD) from the
// row-major matrix g with leading dimension ld: rows r0.. (valid below
// nr), columns c0.. (valid below nc); what lies outside is zero.  vec:
// 16-byte cp.async copies (nc and ld multiples of 8, g 16-byte aligned,
// so a chunk is wholly inside or outside); otherwise element-wise loads
// and a 16-byte store, visible after the next __syncthreads.
template <int ROWS, int COLS, int SLD>
__device__ __forceinline__ void load_tile(uint16_t* s,
                                          const uint16_t* __restrict__ g,
                                          int64_t ld, int r0, int nr, int c0,
                                          int nc, bool vec, int tid) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks a row
  static_assert(ROWS * CPR % NT == 0, "tile chunks not a multiple of NT");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const int gr = r0 + r, gc = c0 + c;
    uint16_t* dst = s + r * SLD + c;
    if (vec) {
      const bool ok = gr < nr && gc < nc;
      cp_async16(smem_addr(dst), ok ? g + gr * ld + gc : g, ok);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in0 = gr < nr && gc + 2 * j < nc;
        const bool in1 = gr < nr && gc + 2 * j + 1 < nc;
        const int64_t o = gr * ld + gc + 2 * j;
        w[j] = (in0 ? (uint32_t)g[o] : 0u) |
               ((in1 ? (uint32_t)g[o + 1] : 0u) << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// B fragments (b0, b1) of the warp's four n8 tiles at depth ks, from a
// [k][n] tile: one ldmatrix.trans per pair of n8 tiles
__device__ __forceinline__ void b_frags(uint32_t (&f)[4][2],
                                        const uint16_t* sb, int ks, int wc,
                                        int lane) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, smem_addr(sb +
                                   (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       LDB +
                                   wc + 16 * np + (lane >> 4) * 8));
    f[2 * np][0] = r[0];
    f[2 * np][1] = r[1];
    f[2 * np + 1][0] = r[2];
    f[2 * np + 1][1] = r[3];
  }
}

// A fragment of the m16 tile at row wr of an [m][k] tile, depth ks
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const uint16_t* sa,
                                       int wr, int ks, int lane) {
  ldmatrix_x4(f, smem_addr(sa + (wr + (lane & 15)) * LDA + ks +
                           (lane >> 4) * 8));
}

// stores the value pair (v0, v1) at columns col, col + 1 of a row of
// length n: one 4-byte store where n is even (col is), else one by one
__device__ __forceinline__ void store_pair(uint16_t* row, int col, int n,
                                           uint32_t v) {
  if (n % 2 == 0) {
    if (col < n) *reinterpret_cast<uint32_t*>(row + col) = v;
  } else {
    if (col < n) row[col] = (uint16_t)(v & 0xffffu);
    if (col + 1 < n) row[col + 1] = (uint16_t)(v >> 16);
  }
}

// Stage A.  grid (F/TN, C/TM, E), NT threads.  x (E, C, D), wg / wu
// (E, D, F) row-major bf16 -> h_hi, h_lo (E, C, F) bf16.  vx / vw: x /
// wg and wu take 16-byte copies.  Warp w owns rows (w / 4) * 64.. and
// columns (w % 4) * 32.. of the block's tile: 4 x 4 m16n8 tiles of each
// of g and u (128 f32 accumulators a thread).
__global__ void __launch_bounds__(NT)
    ffn_gate_up_tc(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ wg,
                   const uint16_t* __restrict__ wu,
                   uint16_t* __restrict__ h_hi, uint16_t* __restrict__ h_lo,
                   int C, int D, int F, int act, bool vx, bool vw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sX = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sG = sX + STAGES * A_TILE;
  uint16_t* sU = sG + STAGES * B_TILE;
  const int e = blockIdx.z, c0 = blockIdx.y * TM, f0 = blockIdx.x * TN;
  x += (int64_t)e * C * D;
  wg += (int64_t)e * D * F;
  wu += (int64_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;
  const int nk = (D + TK - 1) / TK;
  auto load = [&](int kt, int st) {
    const int k0 = kt * TK;
    load_tile<TM, TK, LDA>(sX + st * A_TILE, x, D, c0, C, k0, D, vx, tid);
    load_tile<TK, TN, LDB>(sG + st * B_TILE, wg, F, k0, D, f0, F, vw, tid);
    load_tile<TK, TN, LDB>(sU + st * B_TILE, wu, F, k0, D, f0, F, vw, tid);
  };

  float accg[4][4][4], accu[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) accg[i][j][t] = accu[i][j][t] = 0.f;

  // chunks 0 .. STAGES - 2 in flight, one commit group each; every
  // iteration commits one group (empty past the last chunk), so waiting
  // for all but the newest STAGES - 2 groups lands chunk kt
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kt landed for all; chunk kt - 1 consumed
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = kt % STAGES;
    const uint16_t* a = sX + st * A_TILE;
    const uint16_t* bg = sG + st * B_TILE;
    const uint16_t* bu = sU + st * B_TILE;
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      uint32_t fg[4][2], fu[4][2];
      b_frags(fg, bg, ks, wc, lane);
      b_frags(fu, bu, ks, wc, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t fa[4];
        a_frag(fa, a, wr + 16 * mi, ks, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(accg[mi][ni], fa, fg[ni][0], fg[ni][1]);
          mma_bf16(accu[mi][ni], fa, fu[ni][0], fu[ni][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // h = act(g) * u in f32, split into its two bf16 terms
  const int g8 = lane >> 2, q = lane & 3;
  uint16_t* hh = h_hi + (int64_t)e * C * F;
  uint16_t* hl = h_lo + (int64_t)e * C * F;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = c0 + wr + 16 * mi + g8 + 8 * half;
      if (r >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = f0 + wc + 8 * ni + 2 * q;
        const float h0 = gated(accg[mi][ni][2 * half],
                               accu[mi][ni][2 * half], act);
        const float h1 = gated(accg[mi][ni][2 * half + 1],
                               accu[mi][ni][2 * half + 1], act);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(h0 - hf.x, h1 - hf.y);
        store_pair(hh + (int64_t)r * F, col, F, bits(hi));
        store_pair(hl + (int64_t)r * F, col, F, bits(lo));
      }
    }
}

// Stage B.  grid (D/TN, C/TM, E), NT threads.  h_hi, h_lo (E, C, F),
// wo (E, F, D) row-major bf16 -> y (E, C, D) bf16.  vh / vo: the h
// planes / wo take 16-byte copies.  Warp w owns rows (w / 4) * 64.. and
// columns (w % 4) * 32.. of the block's tile (64 f32 accumulators a
// thread).
__global__ void __launch_bounds__(NT)
    ffn_down_tc(const uint16_t* __restrict__ h_hi,
                const uint16_t* __restrict__ h_lo,
                const uint16_t* __restrict__ wo, uint16_t* __restrict__ y,
                int C, int D, int F, bool vh, bool vo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sH = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sL = sH + STAGES * A_TILE;
  uint16_t* sO = sL + STAGES * A_TILE;
  const int e = blockIdx.z, c0 = blockIdx.y * TM, d0 = blockIdx.x * TN;
  h_hi += (int64_t)e * C * F;
  h_lo += (int64_t)e * C * F;
  wo += (int64_t)e * F * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;
  const int nk = (F + TK - 1) / TK;
  auto load = [&](int kt, int st) {
    const int k0 = kt * TK;
    load_tile<TM, TK, LDA>(sH + st * A_TILE, h_hi, F, c0, C, k0, F, vh, tid);
    load_tile<TM, TK, LDA>(sL + st * A_TILE, h_lo, F, c0, C, k0, F, vh, tid);
    load_tile<TK, TN, LDB>(sO + st * B_TILE, wo, D, k0, F, d0, D, vo, tid);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = kt % STAGES;
    const uint16_t* ah = sH + st * A_TILE;
    const uint16_t* al = sL + st * A_TILE;
    const uint16_t* bo = sO + st * B_TILE;
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      uint32_t fo[4][2];
      b_frags(fo, bo, ks, wc, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t fl[4], fh[4];
        a_frag(fl, al, wr + 16 * mi, ks, lane);
        a_frag(fh, ah, wr + 16 * mi, ks, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)  // the smaller term first
          mma_bf16(acc[mi][ni], fl, fo[ni][0], fo[ni][1]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], fh, fo[ni][0], fo[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  const int g8 = lane >> 2, q = lane & 3;
  uint16_t* ye = y + (int64_t)e * C * D;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = c0 + wr + 16 * mi + g8 + 8 * half;
      if (r >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        store_pair(ye + (int64_t)r * D, d0 + wc + 8 * ni + 2 * q, D,
                   bits(__floats2bfloat162_rn(acc[mi][ni][2 * half],
                                              acc[mi][ni][2 * half + 1])));
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t ffn_bf16(const void* x, const void* wg, const void* wu,
                     const void* wo, void* h, void* y, int act, int E, int C,
                     int D, int F, cudaStream_t s) {
  static std::atomic<bool> ready_up[MAX_DEVICES], ready_down[MAX_DEVICES];
  uint16_t* hh = static_cast<uint16_t*>(h);
  uint16_t* hl = hh + (int64_t)E * C * F;
  const bool vx = D % 8 == 0 && aligned16(x);
  const bool vw = F % 8 == 0 && aligned16(wg) && aligned16(wu);
  const bool vh = F % 8 == 0 && aligned16(hh) && aligned16(hl);
  const bool vo = D % 8 == 0 && aligned16(wo);
  cudaError_t err = opt_in_smem(ffn_gate_up_tc, SMEM_UP, ready_up);
  if (err != cudaSuccess) return err;
  ffn_gate_up_tc<<<dim3((F + TN - 1) / TN, (C + TM - 1) / TM, E), NT,
                   SMEM_UP, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wg),
      static_cast<const uint16_t*>(wu), hh, hl, C, D, F, act, vx, vw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = opt_in_smem(ffn_down_tc, SMEM_DOWN, ready_down);
  if (err != cudaSuccess) return err;
  ffn_down_tc<<<dim3((D + TN - 1) / TN, (C + TM - 1) / TM, E), NT,
                SMEM_DOWN, s>>>(hh, hl, static_cast<const uint16_t*>(wo),
                                static_cast<uint16_t*>(y), C, D, F, vh, vo);
  return cudaGetLastError();
}

// f32 stage A: h holds x @ wg, u holds x @ wu; h <- act(h) * u
__global__ void gate_kernel(float* __restrict__ h, const float* __restrict__ u,
                            int64_t n, int act) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    h[i] = gated(h[i], u[i], act);
}

}  // namespace

extern "C" {

// C[e] = A[e] @ B[e] for e < E: A (E, M, K) and B (E, K, N) through
// element strides, C (E, M, N) contiguous.  dtypes: 0 = float32,
// 1 = bfloat16, each of A, B, C on its own.  Returns cudaGetLastError().
int grouped_matmul(const void* a, int da, int64_t sAe, int64_t sAm,
                   int64_t sAk, const void* b, int db, int64_t sBe,
                   int64_t sBk, int64_t sBn, void* c, int dc, int E, int M,
                   int N, int K, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || E > 65535 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)gmm_any(da, db, dc, a, sAe, sAm, sAk, b, sBe, sBk, sBn, c, E, M,
                      N, K, static_cast<cudaStream_t>(stream));
}

// y (E, C, D) = grouped FFN of x (E, C, D), wg / wu (E, D, F), wo (E, F, D),
// all contiguous and of one dtype (0 = float32, 1 = bfloat16).  h: scratch
// of 4*E*C*F bytes, for bfloat16 the planes h_hi and h_lo (E*C*F bf16
// each, h_lo after h_hi), for float32 f32 h; u: a second f32 scratch of
// E*C*F for float32 inputs (unused for bf16).  act: 0 = SiLU, 1 =
// tanh-GELU.  Returns cudaGetLastError() after the last launch.
int grouped_ffn_fwd(const void* x, const void* wg, const void* wu,
                    const void* wo, void* h, float* u, void* y, int dtype,
                    int act, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + TM - 1) / TM > 65535 || (dtype != 0 && dtype != 1) ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)ffn_bf16(x, wg, wu, wo, h, y, act, E, C, D, F, s);
  const int64_t CD = (int64_t)C * D, DF = (int64_t)D * F, CF = (int64_t)C * F;
  float* hf = static_cast<float*>(h);
  cudaError_t err =
      gmm<float, float, float>(x, CD, D, 1, wg, DF, F, 1, hf, E, C, F, D, s);
  if (err == cudaSuccess)
    err = gmm<float, float, float>(x, CD, D, 1, wu, DF, F, 1, u, E, C, F, D,
                                   s);
  if (err == cudaSuccess) {
    gate_kernel<<<1024, 256, 0, s>>>(hf, u, (int64_t)E * CF, act);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = gmm<float, float, float>(hf, CF, F, 1, wo, DF, D, 1, y, E, C, D, F,
                                   s);
  return (int)err;
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
