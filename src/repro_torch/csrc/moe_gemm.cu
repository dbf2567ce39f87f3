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
// two stages, launched back to back:
//   A. per (expert, 64-row tile, 128-column F tile):
//      h = act(x @ wg) * (x @ wu), written in f32 to a scratch tensor
//      (E, C, F) the wrapper allocates, because the reference never
//      rounds h.  bf16 inputs take mma.sync m16n8k16 with f32
//      accumulation (bf16 x bf16 products are exact in f32); f32 inputs
//      take two grouped_matmul products and an elementwise gate.
//   B. y = h @ wo through the grouped_matmul code, f32 accumulation,
//      rounded once to x's dtype.
// The GELU is the tanh approximation, as in the TPU kernel.  Ragged C
// and F are masked (rows and columns past the edge load as zero and are
// not written); the TPU wrapper pads instead.  Bound on the path (E=60,
// C=548, D=2048, F=1408, bf16): 6 * E*C*D*F = 569 GFLOP, 0.575 ms at
// 989 TFLOP/s; stage B on the CUDA cores in f32 is the slow part.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// grouped FFN, stage A: h = act(x @ wg) * (x @ wu)
// ---------------------------------------------------------------------------

constexpr int AT = 64;       // rows per block
constexpr int AF = 128;      // F columns per block
constexpr int KC = 32;       // bf16 K chunk
constexpr int KP = KC + 8;   // bf16 staging row stride (elements)

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (F/AF, C/AT, E), 256 threads.  x (E, C, D), wg / wu (E, D, F)
// row-major bf16; h (E, C, F) f32.  Warp w owns rows (w/4)*32.. and
// columns (w%4)*32.. of the block's tile, as 2 x 4 m16n8 tiles for each
// of the two products.
__global__ void __launch_bounds__(NT)
    ffn_gate_up_bf16(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wg,
                     const __nv_bfloat16* __restrict__ wu,
                     float* __restrict__ h, int C, int D, int F, int act,
                     bool vec_a) {
  __shared__ __align__(16) uint16_t sA[AT * KP];
  __shared__ __align__(16) uint16_t sG[AF * KP];  // k inner
  __shared__ __align__(16) uint16_t sU[AF * KP];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * AT, f0 = blockIdx.x * AF;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + (int64_t)e * C * D;
  const uint16_t* gr = reinterpret_cast<const uint16_t*>(wg) + (int64_t)e * D * F;
  const uint16_t* ur = reinterpret_cast<const uint16_t*>(wu) + (int64_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wrow = (warp >> 2) * 32, wcol = (warp & 3) * 32;

  // loader roles: A row ar, 8 K entries from ac; B column bn, K pairs
  // bk*8 .. bk*8+7
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const int bn = tid & (AF - 1), bk = tid >> 7;
  const int arow = c0 + ar, bcol = f0 + bn;
  uint32_t ra[4], rg[8], ru[8];

  auto load = [&](int k0) {
    const int k = k0 + ac;
    if (vec_a && arow < C && k < D) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(xr + (int64_t)arow * D + k);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k2 = k + 2 * i;
        const uint32_t lo =
            (arow < C && k2 < D) ? xr[(int64_t)arow * D + k2] : 0u;
        const uint32_t hi =
            (arow < C && k2 + 1 < D) ? xr[(int64_t)arow * D + k2 + 1] : 0u;
        ra[i] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k2 = k0 + 2 * (bk * 8 + j);
      const bool in0 = bcol < F && k2 < D, in1 = bcol < F && k2 + 1 < D;
      const int64_t o0 = (int64_t)k2 * F + bcol, o1 = o0 + F;
      rg[j] = (in0 ? gr[o0] : 0u) | ((in1 ? (uint32_t)gr[o1] : 0u) << 16);
      ru[j] = (in0 ? ur[o0] : 0u) | ((in1 ? (uint32_t)ur[o1] : 0u) << 16);
    }
  };

  float accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) accg[i][j][t] = accu[i][j][t] = 0.f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the last chunk's products are done with sA/sG/sU
    *reinterpret_cast<uint4*>(sA + ar * KP + ac) =
        make_uint4(ra[0], ra[1], ra[2], ra[3]);
    uint32_t* sGw = reinterpret_cast<uint32_t*>(sG);
    uint32_t* sUw = reinterpret_cast<uint32_t*>(sU);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sGw[bn * (KP / 2) + bk * 8 + j] = rg[j];
      sUw[bn * (KP / 2) + bk * 8 + j] = ru[j];
    }
    __syncthreads();
    if (k0 + KC < D) load(k0 + KC);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint16_t* p0 = sA + (wrow + mi * 16 + g) * KP + ks + 2 * q;
        const uint16_t* p1 = p0 + 8 * KP;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int off = (wcol + ni * 8 + g) * KP + ks + 2 * q;
        const uint32_t g0 = *reinterpret_cast<const uint32_t*>(sG + off);
        const uint32_t g1 = *reinterpret_cast<const uint32_t*>(sG + off + 8);
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(sU + off);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(sU + off + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(accg[mi][ni], af[mi], g0, g1);
          mma_bf16(accu[mi][ni], af[mi], u0, u1);
        }
      }
    }
  }
  float* he = h + (int64_t)e * C * F;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = c0 + wrow + mi * 16 + g + (t >= 2 ? 8 : 0);
        const int col = f0 + wcol + ni * 8 + 2 * q + (t & 1);
        if (r < C && col < F)
          he[(int64_t)r * F + col] = gated(accg[mi][ni][t], accu[mi][ni][t], act);
      }
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
// all contiguous and of one dtype (0 = float32, 1 = bfloat16).  h: f32
// scratch of E*C*F; u: a second f32 scratch of E*C*F for float32 inputs
// (unused for bf16).  act: 0 = SiLU, 1 = tanh-GELU.  Returns
// cudaGetLastError() after the last launch.
int grouped_ffn_fwd(const void* x, const void* wg, const void* wu,
                    const void* wo, float* h, float* u, void* y, int dtype,
                    int act, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + AT - 1) / AT > 65535 || (dtype != 0 && dtype != 1) ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t CD = (int64_t)C * D, DF = (int64_t)D * F, CF = (int64_t)C * F;
  cudaError_t err;
  if (dtype == 1) {
    const bool vec_a = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const dim3 grid((F + AF - 1) / AF, (C + AT - 1) / AT, E);
    ffn_gate_up_bf16<<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wg),
        static_cast<const __nv_bfloat16*>(wu), h, C, D, F, act, vec_a);
    err = cudaGetLastError();
  } else {
    err = gmm<float, float, float>(x, CD, D, 1, wg, DF, F, 1, h, E, C, F, D, s);
    if (err == cudaSuccess)
      err = gmm<float, float, float>(x, CD, D, 1, wu, DF, F, 1, u, E, C, F, D,
                                     s);
    if (err == cudaSuccess) {
      gate_kernel<<<1024, 256, 0, s>>>(h, u, (int64_t)E * CF, act);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    err = gmm<float, __nv_bfloat16, __nv_bfloat16>(h, CF, F, 1, wo, DF, D, 1,
                                                   y, E, C, D, F, s);
  else
    err = gmm<float, float, float>(h, CF, F, 1, wo, DF, D, 1, y, E, C, D, F, s);
  return (int)err;
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
