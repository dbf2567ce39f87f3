// Grouped expert GEMMs of a routed MoE layer.
//
// Two kernels of repro/kernels/moe_gemm/kernel.py are replaced here:
//
// * grouped_matmul (_matmul_kernel, pallas_call at :103): per-expert
//   (E, M, K) @ (E, K, N) with f32 sums, the building block of the
//   grouped FFN's backward (eight products per layer, every operand in
//   f32 in the reference).  Entry points: grouped_matmul_wgmma,
//   grouped_matmul, split_f32.
// * grouped_ffn_ecd (_ffn_kernel): per-expert gated FFN
//   y[e] = (act(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wo[e] over
//   fixed-capacity (E, C, D) buffers, f32 inside, output in x's dtype.
//   Entry point: grouped_ffn_fwd.
//
// grouped_matmul.  Every product computes f32 sums of exact products,
// rounds once to the output dtype, and reads each operand as it lies
// (transposed views included, never a transposed copy).  One launch may
// sum two products, a @ b + a2 @ b2, into one accumulator (dx of the
// backward).  Bound on the tune path (E 60, C 548, D 2048, F 1408): one
// product is 2 * 60 * 548 * 2048 * 1408 = 190 GFLOP, 0.19 ms at the
// card's 989 TFLOP/s bf16 rate, above its 0.2-0.3 ms of bytes only by a
// little: the tensor cores bound it.  Three instances:
//
// wgmma (both operands bf16) and wgmma_split (one operand an f32 value
// carried as two bf16 terms): gmm_wgmma_kernel.
//   * Persistent: one block of 384 threads an SM walks the (expert,
//     128-row, BN-column) output tiles in order, blockIdx.x, + gridDim.x,
//     ...; no atomics, so two launches give the same bits.
//   * Thread 256 (the producer; its warpgroup drops to 40 registers)
//     feeds a ring of shared-memory stages by TMA, each stage one 64-deep
//     K chunk of every plane of A (128 x 64) and B (64 x BN), with a
//     full/empty mbarrier pair.  Two consumer warpgroups (232 registers)
//     each multiply their 64 rows by the stage's B with
//     wgmma.mma_async m64nBNk16 into f32 accumulators in registers,
//     releasing a stage as soon as the products that read it are done,
//     and store their rows straight from the registers (columns 8j + 2q
//     of two rows a thread, pairs of 8 or 4 bytes), f32 or bf16.
//   * Tensor maps are 3-D, (E, rows, cols) with a box of one expert, so a
//     ragged K (C = 548 in the weight gradients) or M zero-fills past the
//     expert's own edge: a flattened (E * rows, cols) map would add the
//     next expert's first rows into the last K chunk.  128-byte swizzle.
//   * Layouts: an operand whose K axis has stride 1 is K-major (A tile
//     128 rows of 128 bytes; a k16 step 32 bytes on in the swizzled row),
//     one whose M (N) axis has stride 1 is MN-major, read with wgmma's
//     transpose bit (64 x 64 boxes 8 KB apart: LBO; 8-row K groups 1 KB
//     apart: SBO; a k16 step 2 KB on).  x @ wg: A K-major, B MN-major;
//     dy @ wo^T and dg @ wg^T: both K-major; x^T @ dg and h^T @ dy: both
//     MN-major.
//   * An f32 operand v enters as two bf16 planes hi = bf16(v), lo =
//     bf16(v - hi) (v - hi is exact in f32; hi + lo is v to about
//     2^-17 |v|, and exactly an f32 value).  Each k16 step multiplies the
//     other operand's tile by lo, then by hi, into the same accumulator
//     (the smaller term first, as the grouped FFN's stage B does).  One
//     term alone breaks the per-element rule the products are held to
//     (tests/test_torch_gmm_numerics.py).  Design: the planes are made
//     by one elementwise pass per f32 tensor (split_kernel: dg, du and h,
//     three passes a backward, each feeding one or two products) and
//     enter the ring by TMA like any bf16 tile, as A or as B.  Splitting
//     in registers instead would force the f32 operand into A (wgmma's
//     register operand), so x^T @ dg would become dg^T @ x with a
//     transposed store, and each product would split its operand again;
//     the pass costs about 0.11 ms of traffic per tensor.
//   * Tiles: 128 x 256 with 4 stages of 48 KB (bf16 x bf16), 128 x 256
//     with 3 stages of 64 KB (A split), 128 x 128 with 4 stages of 48 KB
//     (B split).  TMA needs row strides and bases that are multiples of
//     16 bytes; the wrapper picks this instance only for such operands.
//   * The mbarrier, TMA and wgmma helpers and the host's tensor-map
//     encoder (which makes the device's context current on the calling
//     thread first) are shared with kd_loss.cu (tma_wgmma.cuh).
// general (anything TMA cannot take: a row stride or base off 16 bytes,
//   no unit-stride axis, an f32 operand beside a bf16 one unsplit) and
//   f32 (both operands f32: the f32 models, held to f32 limits):
//   gmm_kernel, f32 FMAs on the CUDA cores.  Operands in bf16 or f32
//   through element strides, a split operand as hi + lo (exact in f32),
//   converted to f32 on load; 128 x 128 output tiles, 16-deep K chunks
//   staged through shared memory (the next chunk's loads issued before
//   the current chunk's products), 8 x 8 outputs a thread, loads
//   coalesced along whichever axis has stride 1.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "tma_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// grouped matmul, general and f32 instances: f32 on the CUDA cores
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
// element i of an operand, plus its second bf16 term where it has one
// (hi + lo is exact in f32)
template <typename T>
__device__ __forceinline__ float ld(const T* p, const T* lo, int64_t i) {
  return lo ? to_f(p[i]) + to_f(lo[i]) : to_f(p[i]);
}

// One product a @ b: A[e][m][k] at a + e*sAe + m*sAm + k*sAk, B[e][k][n]
// at b + e*sBe + k*sBk + n*sBn; a_lo / b_lo: a split operand's second
// term (the same strides), or null.
struct Pair {
  const void* a;
  const void* a_lo;
  int64_t sAe, sAm, sAk;
  const void* b;
  const void* b_lo;
  int64_t sBe, sBk, sBn;
  int K;
};
struct Pairs {
  Pair p[2];
  int n;  // 1, or 2: a @ b + a2 @ b2 into one sum
};

// C[e] (M, N, contiguous) = sum over the pairs of A[e] @ B[e].
// grid (N/BN, M/BM, E).
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(NT)
    gmm_kernel(const Pairs ps, TC* __restrict__ c, int M, int N) {
  __shared__ __align__(16) float As[BK][LDS];
  __shared__ __align__(16) float Bs[BK][LDS];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  // thread (ty, tx) owns rows ty*4.. and 64+ty*4.., columns tx*4.. and
  // 64+tx*4..: float4 reads of the staged tiles without bank conflicts
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int pi = 0; pi < ps.n; ++pi) {
    const Pair P = ps.p[pi];
    const TA* a = static_cast<const TA*>(P.a) + e * P.sAe;
    const TA* alo =
        P.a_lo ? static_cast<const TA*>(P.a_lo) + e * P.sAe : nullptr;
    const TB* b = static_cast<const TB*>(P.b) + e * P.sBe;
    const TB* blo =
        P.b_lo ? static_cast<const TB*>(P.b_lo) + e * P.sBe : nullptr;
    const int64_t sAm = P.sAm, sAk = P.sAk, sBk = P.sBk, sBn = P.sBn;
    const int K = P.K;
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
          ra[i] = (m < M && k < K) ? ld(a, alo, m * sAm + k) : 0.f;
        }
      } else {
        const int m = m0 + (tid & 127), kk = tid >> 7;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + kk + 2 * i;
          ra[i] = (m < M && k < K) ? ld(a, alo, m * sAm + k * sAk) : 0.f;
        }
      }
      if (b_nc) {
        const int n = n0 + (tid & 127), kk = tid >> 7;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + kk + 2 * i;
          rb[i] = (n < N && k < K) ? ld(b, blo, k * sBk + n) : 0.f;
        }
      } else {
        const int k = k0 + (tid & 15), nn = tid >> 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = n0 + nn + 16 * i;
          rb[i] = (n < N && k < K) ? ld(b, blo, k * sBk + n * sBn) : 0.f;
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
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
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
cudaError_t gmm(const Pairs& ps, void* c, int E, int M, int N,
                cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gmm_kernel<TA, TB, TC><<<grid, NT, 0, s>>>(ps, static_cast<TC*>(c), M, N);
  return cudaGetLastError();
}

// one product of unsplit operands (the f32 grouped FFN's)
template <typename TA, typename TB, typename TC>
cudaError_t gmm(const void* a, int64_t sAe, int64_t sAm, int64_t sAk,
                const void* b, int64_t sBe, int64_t sBk, int64_t sBn,
                void* c, int E, int M, int N, int K, cudaStream_t s) {
  Pairs ps = {};
  ps.p[0] = Pair{a, nullptr, sAe, sAm, sAk, b, nullptr, sBe, sBk, sBn, K};
  ps.n = 1;
  return gmm<TA, TB, TC>(ps, c, E, M, N, s);
}

// dtype codes: 0 = float32, 1 = bfloat16
template <typename TA, typename TB>
cudaError_t gmm_c(int dc, const Pairs& ps, void* c, int E, int M, int N,
                  cudaStream_t s) {
  if (dc == 0) return gmm<TA, TB, float>(ps, c, E, M, N, s);
  if (dc == 1) return gmm<TA, TB, __nv_bfloat16>(ps, c, E, M, N, s);
  return cudaErrorInvalidValue;
}

template <typename TA>
cudaError_t gmm_b(int db, int dc, const Pairs& ps, void* c, int E, int M,
                  int N, cudaStream_t s) {
  if (db == 0) return gmm_c<TA, float>(dc, ps, c, E, M, N, s);
  if (db == 1) return gmm_c<TA, __nv_bfloat16>(dc, ps, c, E, M, N, s);
  return cudaErrorInvalidValue;
}

cudaError_t gmm_any(int da, int db, int dc, const Pairs& ps, void* c, int E,
                    int M, int N, cudaStream_t s) {
  if (da == 0) return gmm_b<float>(db, dc, ps, c, E, M, N, s);
  if (da == 1) return gmm_b<__nv_bfloat16>(db, dc, ps, c, E, M, N, s);
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


// ---------------------------------------------------------------------------
// grouped matmul: an f32 tensor as two bf16 planes
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split1(float v, __nv_bfloat16& hi,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));  // v - hi is exact
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 x, __nv_bfloat16 y) {
  return (uint32_t)__bfloat16_as_ushort(x) |
         ((uint32_t)__bfloat16_as_ushort(y) << 16);
}

// hi[i] = bf16(t[i]), lo[i] = bf16(t[i] - hi[i]) for i < n.  vec: t
// 16-byte aligned, hi and lo 8-byte aligned (4 elements a step).
__global__ void split_kernel(const float* __restrict__ t,
                             __nv_bfloat16* __restrict__ hi,
                             __nv_bfloat16* __restrict__ lo, int64_t n,
                             bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t j = i; j < n4; j += stride) {
      const float4 v = reinterpret_cast<const float4*>(t)[j];
      __nv_bfloat16 h[4], l[4];
      split1(v.x, h[0], l[0]);
      split1(v.y, h[1], l[1]);
      split1(v.z, h[2], l[2]);
      split1(v.w, h[3], l[3]);
      *reinterpret_cast<uint2*>(hi + 4 * j) =
          make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
      *reinterpret_cast<uint2*>(lo + 4 * j) =
          make_uint2(pack(l[0], l[1]), pack(l[2], l[3]));
    }
    done = 4 * n4;
  }
  for (int64_t j = done + i; j < n; j += stride) split1(t[j], hi[j], lo[j]);
}

// ---------------------------------------------------------------------------
// grouped matmul, wgmma and wgmma_split instances: TMA + wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;     // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;      // K a stage: one 128-byte swizzled row
constexpr int HALF = 8192;  // 64 rows of 128 bytes: a warpgroup's A rows
                            // (K-major), one 64 x 64 box (MN-major)
constexpr int A_PLANE = 2 * HALF;  // one plane of A: 128 x 64 bf16
constexpr int NTHREADS = 384;      // consumers 0-255, producer 256+
constexpr int RING_BYTES = 196608;  // 192 KB of stages

// a ring for BN columns, NA planes of A and NB of B
template <int BN, int NA, int NB>
struct Shape {
  static constexpr int B_PLANE = BN * BK * 2;
  static constexpr int STAGE = NA * A_PLANE + NB * B_PLANE;
  static constexpr int NSTAGE = RING_BYTES / STAGE;
  // stages, 1 KB of slack to align them to the swizzle's 1 KB period,
  // the full/empty barriers
  static constexpr size_t SMEM = (size_t)NSTAGE * STAGE + 1024 + 16 * NSTAGE;
  static_assert(NSTAGE >= 3 && SMEM <= 232448, "ring over 227 KB");
};

// [pair][term]: term 0 is the operand (a split operand's hi), 1 its lo
struct Maps {
  CUtensorMap a[2][2];
  CUtensorMap b[2][2];
};

// an operand tile's descriptor at k16 step kk: K-major (MN = 0), a step
// 32 bytes on in the swizzled row; MN-major (MN = 1), 64 x 64 boxes 8 KB
// apart, 8-row K groups 1 KB apart, a step 16 rows (2 KB) on
template <int MN>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int kk) {
  return MN ? desc_sw128(tile + kk * 2048, HALF, 1024)
            : desc_sw128(tile + kk * 32, 16, 1024);
}

// stores the pair (v0, v1) at columns col, col + 1 of a row of length n:
// one 8- (f32) or 4-byte (bf16) store where n is even (col is), else one
// by one
__device__ __forceinline__ void put(float* row, int col, int n, float v0,
                                    float v1) {
  if (n % 2 == 0) {
    if (col < n) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < n) row[col] = v0;
    if (col + 1 < n) row[col + 1] = v1;
  }
}
__device__ __forceinline__ void put(__nv_bfloat16* row, int col, int n,
                                    float v0, float v1) {
  if (n % 2 == 0) {
    if (col < n)
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) row[col] = __float2bfloat16_rn(v0);
    if (col + 1 < n) row[col + 1] = __float2bfloat16_rn(v1);
  }
}

// a consumer thread's rows of the tile into C (E, M, N) contiguous:
// d[4j + 2h + x] is row 16 * warp + lane / 4 + 8h of its warpgroup's 64,
// column 8j + 2 (lane % 4) + x
template <int BN, typename T>
__device__ __forceinline__ void store_tile(const float (&d)[BN / 2], T* c,
                                           int e, int M, int N, int r0,
                                           int n0, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r >= M) continue;
    T* row = c + ((int64_t)e * M + r) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      put(row, n0 + 8 * j + 2 * q, N, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// C = A @ B (+ A2 @ B2), persistent over the (expert, 128-row, BN-column)
// tiles.  NA / NB: planes of A / B (2: a split operand, lo then hi at
// each k16 step); TA / TB: A / B MN-major.  Threads 0-255: two consumer
// warpgroups of 64 rows; thread 256: the producer.
template <int BN, int NA, int NB, int TA, int TB>
__global__ void __launch_bounds__(NTHREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ Maps maps, void* __restrict__ c,
                     int bf16_out, int E, int M, int N, int K0, int K1,
                     int npairs) {
  using S = Shape<BN, NA, NB>;
  static_assert(NA == 1 || NB == 1, "one split operand at most");
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = base + S::NSTAGE * S::STAGE;
  const uint32_t empty = full + 8 * S::NSTAGE;
  const int tid = threadIdx.x;
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int tiles = E * tm * tn;

  if (tid == 0) {
    for (int i = 0; i < S::NSTAGE; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 256) {
      Ring<S::NSTAGE> ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int e = t / (tm * tn), r = t % (tm * tn);
        const int m0 = r / tn * BM, n0 = r % tn * BN;
        for (int p = 0; p < npairs; ++p) {
          const int nk = ((p ? K1 : K0) + BK - 1) / BK;
          for (int kb = 0; kb < nk; ++kb) {
            mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
            const uint32_t f = full + 8 * ring.stage;
            const uint32_t s = base + ring.stage * S::STAGE;
            const int k0 = kb * BK;
            mbar_expect_tx(f, S::STAGE);
#pragma unroll
            for (int i = 0; i < NA; ++i) {
              const CUtensorMap* m = &maps.a[p][i];
              const uint32_t d = s + i * A_PLANE;
              if (TA) {  // (m, k) boxes of 64 x 64, m innermost
                tma_load3(d, m, f, m0, k0, e);
                tma_load3(d + HALF, m, f, m0 + 64, k0, e);
              } else {   // one (k, m) box of 64 x 128
                tma_load3(d, m, f, k0, m0, e);
              }
            }
#pragma unroll
            for (int i = 0; i < NB; ++i) {
              const CUtensorMap* m = &maps.b[p][i];
              const uint32_t d = s + NA * A_PLANE + i * S::B_PLANE;
              if (TB) {  // (n, k) boxes of 64 x 64, n innermost
#pragma unroll
                for (int j = 0; j < BN / 64; ++j)
                  tma_load3(d + j * HALF, m, f, n0 + 64 * j, k0, e);
              } else {   // one (k, n) box of 64 x BN
                tma_load3(d, m, f, k0, n0, e);
              }
            }
            ring.next();
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const bool leader = (tid & 127) == 0;
    Ring<S::NSTAGE> ring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = t / (tm * tn), r = t % (tm * tn);
      const int m0 = r / tn * BM, n0 = r % tn * BN;
      float d[BN / 2];
      int prev = 0;
      bool held = false;  // d holds this tile's earlier stages
      for (int p = 0; p < npairs; ++p) {
        const int nk = ((p ? K1 : K0) + BK - 1) / BK;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(full + 8 * ring.stage, ring.phase);
          const uint32_t s = base + ring.stage * S::STAGE;
          const uint32_t a = s + wg * HALF, b = s + NA * A_PLANE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const int acc = held || kk > 0;
            if (NA == 2) {  // lo, then hi, of A
              wgmma_n<BN, TA, TB>(d, desc<TA>(a + A_PLANE, kk),
                                  desc<TB>(b, kk), acc);
              wgmma_n<BN, TA, TB>(d, desc<TA>(a, kk), desc<TB>(b, kk), 1);
            } else if (NB == 2) {  // lo, then hi, of B
              wgmma_n<BN, TA, TB>(d, desc<TA>(a, kk),
                                  desc<TB>(b + S::B_PLANE, kk), acc);
              wgmma_n<BN, TA, TB>(d, desc<TA>(a, kk), desc<TB>(b, kk), 1);
            } else {
              wgmma_n<BN, TA, TB>(d, desc<TA>(a, kk), desc<TB>(b, kk), acc);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done
          if (held && leader) mbar_arrive(empty + 8 * prev);
          prev = ring.stage;
          held = true;
          ring.next();
        }
      }
      wgmma_wait<0>();
      if (leader) mbar_arrive(empty + 8 * prev);
      fence_regs(d);
      const int r0 = m0 + wg * 64 + warp * 16;
      if (bf16_out)
        store_tile<BN>(d, static_cast<__nv_bfloat16*>(c), e, M, N, r0, n0,
                       lane);
      else
        store_tile<BN>(d, static_cast<float*>(c), e, M, N, r0, n0, lane);
    }
  }
}

}  // namespace tc

// a bf16 (E, outer, inner) tensor, inner contiguous, strides in elements,
// in boxes of 64 x box_rows x one expert: zeros past every edge of the
// expert's own matrix
bool make_map3(EncodeTiled enc, CUtensorMap* map, int64_t p, int64_t inner,
               int64_t outer, int E, int64_t s_outer, int64_t s_e,
               int box_rows) {
  const int64_t dims[3] = {inner, outer, E}, strides[2] = {s_outer, s_e};
  return make_map(enc, map, reinterpret_cast<const void*>(p), 3, dims,
                  strides, box_rows);
}

template <int BN, int NA, int NB, int TA, int TB>
cudaError_t launch_wgmma(const tc::Maps& maps, void* c, int bf16_out, int E,
                         int M, int N, int K0, int K1, int npairs,
                         cudaStream_t s) {
  using S = tc::Shape<BN, NA, NB>;
  static std::atomic<bool> ready[MAX_DEVICES];
  auto kernel = tc::gmm_wgmma_kernel<BN, NA, NB, TA, TB>;
  cudaError_t err = opt_in_smem(kernel, S::SMEM, ready);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)E * ((M + tc::BM - 1) / tc::BM) *
                        ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, tc::NTHREADS, S::SMEM, s>>>(maps, c, bf16_out, E, M, N, K0,
                                            K1, npairs);
  return cudaGetLastError();
}

template <int NA, int NB>
cudaError_t by_layout(int ta, int tb, const tc::Maps& maps, void* c,
                      int bf16_out, int E, int M, int N, int K0, int K1,
                      int npairs, cudaStream_t s) {
  constexpr int BN = NB == 2 ? 128 : 256;
  if (ta)
    return tb ? launch_wgmma<BN, NA, NB, 1, 1>(maps, c, bf16_out, E, M, N, K0,
                                               K1, npairs, s)
              : launch_wgmma<BN, NA, NB, 1, 0>(maps, c, bf16_out, E, M, N, K0,
                                               K1, npairs, s);
  return tb ? launch_wgmma<BN, NA, NB, 0, 1>(maps, c, bf16_out, E, M, N, K0,
                                             K1, npairs, s)
            : launch_wgmma<BN, NA, NB, 0, 0>(maps, c, bf16_out, E, M, N, K0,
                                             K1, npairs, s);
}

// ops: for each pair, A then B, each {pointer, second bf16 term's
// pointer or 0, element strides along e, then along the matrix's two
// axes ((m, k) for A, (k, n) for B)}
constexpr int OP = 5;

bool valid_shape(int npairs, int E, int M, int N, int K0, int K1) {
  return E > 0 && M > 0 && N > 0 && K0 > 0 &&
         (npairs == 1 || (npairs == 2 && K1 > 0));
}

}  // namespace

extern "C" {

// C[e] = A[e] @ B[e] (+ A2[e] @ B2[e]) for e < E on the CUDA cores (the
// general and f32 instances): A (E, M, K0), B (E, K0, N), A2 (E, M, K1),
// B2 (E, K1, N) as ``ops`` describes them (npairs of A, B), C (E, M, N)
// contiguous.  dtypes: 0 = float32, 1 = bfloat16, each of A (and A2), B
// (and B2), C on its own; an operand with a second term is bf16.
// Returns cudaGetLastError().
int grouped_matmul(const int64_t* ops, int npairs, int da, int db, void* c,
                   int dc, int E, int M, int N, int K0, int K1,
                   void* stream) {
  if (!valid_shape(npairs, E, M, N, K0, K1) || E > 65535 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  Pairs ps = {};
  ps.n = npairs;
  for (int p = 0; p < npairs; ++p) {
    const int64_t* a = ops + 2 * OP * p;
    const int64_t* b = a + OP;
    ps.p[p] = Pair{reinterpret_cast<const void*>(a[0]),
                   reinterpret_cast<const void*>(a[1]), a[2], a[3], a[4],
                   reinterpret_cast<const void*>(b[0]),
                   reinterpret_cast<const void*>(b[1]), b[2], b[3], b[4],
                   p ? K1 : K0};
  }
  return (int)gmm_any(da, db, dc, ps, c, E, M, N,
                      static_cast<cudaStream_t>(stream));
}

// The same product on the tensor cores (the wgmma and wgmma_split
// instances): every operand bf16 (a split operand as its two planes),
// at most one operand of a pair split, and every pair alike in which
// operand is split and in layout.  ta / tb: A / B MN-major (its M / N
// axis has stride 1), else K-major (K has stride 1).  Bases 16-byte
// aligned, strides other than the unit one multiples of 8 elements (TMA).
// dc: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError(), or
// ERR_NO_ENCODE / ERR_ENCODE when no tensor map could be made.
int grouped_matmul_wgmma(const int64_t* ops, int npairs, int ta, int tb,
                         void* c, int dc, int E, int M, int N, int K0, int K1,
                         void* stream) {
  if (!valid_shape(npairs, E, M, N, K0, K1) || (dc != 0 && dc != 1))
    return (int)cudaErrorInvalidValue;
  const int na = ops[1] ? 2 : 1, nb = ops[OP + 1] ? 2 : 1;
  if (na == 2 && nb == 2) return (int)cudaErrorInvalidValue;
  EncodeTiled enc;
  const int status = tma_encoder(&enc);
  if (status != 0) return status;
  const int bn = nb == 2 ? 128 : 256;
  tc::Maps maps = {};
  for (int p = 0; p < npairs; ++p) {
    const int64_t* a = ops + 2 * OP * p;
    const int64_t* b = a + OP;
    if ((a[1] != 0) != (na == 2) || (b[1] != 0) != (nb == 2))
      return (int)cudaErrorInvalidValue;
    const int K = p ? K1 : K0;
    for (int i = 0; i < na; ++i) {
      const bool ok =
          ta ? make_map3(enc, &maps.a[p][i], a[i], M, K, E, a[4], a[2], 64)
             : make_map3(enc, &maps.a[p][i], a[i], K, M, E, a[3], a[2],
                         tc::BM);
      if (!ok) return ERR_ENCODE;
    }
    for (int i = 0; i < nb; ++i) {
      const bool ok =
          tb ? make_map3(enc, &maps.b[p][i], b[i], N, K, E, b[3], b[2], 64)
             : make_map3(enc, &maps.b[p][i], b[i], K, N, E, b[4], b[2], bn);
      if (!ok) return ERR_ENCODE;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (na == 2)
    err = by_layout<2, 1>(ta, tb, maps, c, dc, E, M, N, K0, K1, npairs, s);
  else if (nb == 2)
    err = by_layout<1, 2>(ta, tb, maps, c, dc, E, M, N, K0, K1, npairs, s);
  else
    err = by_layout<1, 1>(ta, tb, maps, c, dc, E, M, N, K0, K1, npairs, s);
  return (int)err;
}

// hi[i] = bf16(t[i]), lo[i] = bf16(t[i] - hi[i]) for i < n: an f32 tensor
// as the two bf16 terms the wgmma_split instance reads.  Returns
// cudaGetLastError().
int split_f32(const float* t, void* hi, void* lo, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(hi) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(lo) % 8 == 0;
  const int64_t want = (n / 4 + 255) / 256 + 1;
  const int blocks = (int)(want < 4096 ? want : 4096);
  split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(lo), n,
      vec);
  return cudaGetLastError();
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

const char* moe_gemm_error_string(int err) { return tma_error_string(err); }

}  // extern "C"
