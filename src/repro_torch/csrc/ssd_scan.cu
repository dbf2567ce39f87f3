// Mamba-2 SSD chunked scan (prefill of the ssm family).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:91
// (ssd_scan_bh / _ssd_kernel).  Layout is the model's: x (B, S, H, P),
// dt (B, S, H) f32, A (H,) f32, B/C (B, S, G, N) with head h reading
// group h / (H / G), h0 (B, H, P, N) f32 or none -> y (B, S, H, P) in
// x's dtype, final state (B, H, P, N) f32.  x, dt, B and C are read
// through their strides (the model passes views of its conv output and
// each group's B/C once); unit stride along P and N.  Per chunk of Q
// rows, with cum the in-chunk prefix sum of dt * A:
//
//   y  = (C Bᵀ ∘ L)(x ∘ dt) + (C ∘ exp(cum)) hᵀ,
//        L[q, s] = exp(cum[q] - cum[s]) for s <= q, else 0
//   h <- exp(cum[Q-1]) h + xᵀ (B ∘ exp(cum[Q-1] - cum) dt)
//
// Rows past S (a ragged last chunk) count as dt = 0 and contribute
// nothing, so the final state is the state at row S - 1, as the
// reference's padding gives.  All arithmetic is f32, as the reference
// kernel's; y is rounded once to x's dtype.
//
// Design.  The TPU kernel carries the (P, N) state in VMEM across a
// sequential grid axis of chunks.  Blocks of a CUDA grid run in no
// order, so the scan is split into three launches on one stream
// (state passing):
//   1. ssd_chunk_state, one block per (chunk, b*h, 64x64 tile of the
//      state): the chunk's own contribution to the state, from zero,
//      and the chunk's total decay cum[Q-1];
//   2. ssd_state_pass, one thread per state element: the short
//      sequential pass over chunks, h_in[c] = state entering chunk c
//      (written over the chunk's contribution), and the final state;
//   3. ssd_chunk_out, one block per (64-row tile of a chunk, 64 columns
//      of P, chunk, b*h): the intra-chunk quadratic form over key tiles
//      up to the diagonal only, plus the carried-state term from h_in.
// So every chunk of every head runs in parallel (1024 blocks of the
// third launch at the path's shape: B 1, S 1024, H 64, P 64, N 128,
// Q 256), and nothing is recomputed but the cumsum.  The mask is taken
// before the exponent: above the diagonal cum[q] - cum[s] > 0 and exp
// could overflow, and inf * 0 is NaN.  The cumsum runs as per-lane
// sequential runs joined by a warp scan, in another order than
// jnp.cumsum (f32 rounding differences only).
//
// Bound.  At the path's shape a launch does, counting the causal
// triangle only, 2.2 GFLOP of C Bᵀ on the model's bf16 operands (0.002
// ms at 989 TFLOP/s) and 3.2 GFLOP with an f32 operand ((C Bᵀ ∘ L)(x dt),
// the carried-state term, the state update: 0.048 ms at 67 TFLOP/s),
// and moves about 20 MB (0.006 ms at 3.35 TB/s): bound by operations,
// about 0.05 ms.  This first kernel does all of it as f32 FMAs on the
// CUDA cores from shared-memory tiles (4 x 4 outputs per thread); bf16
// tensor cores for C Bᵀ (exact products) and wgmma are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const float* h0;  // null: zero initial state
  void* y;
  float* hout;
  float* hbuf;   // (B*H, nC, P, N): chunk states, then the entering states
  float* clast;  // (B*H, nC): cum[Q-1] of each chunk
  int batch, S, H, G, P, N, Q, nC, dtype;
  long long xs_b, xs_s, xs_h;  // strides in elements
  long long ds_b, ds_s, ds_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
};

namespace {

constexpr int NT = 256;   // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int T64 = 64;   // tile edge (rows of q, s, p or n)
constexpr int TK = 32;    // reduction slice
constexpr int LD = 68;    // padded row of a 64-wide tile (16-byte aligned)

// per-row arrays of a chunk in shared memory, each rounded up to 4 floats
// so the tiles after them stay 16-byte aligned
__host__ __device__ __forceinline__ int rows4(int q) { return (q + 3) & ~3; }

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// cum[i] = sum_{j <= i} dt[j] * A over the chunk's Q rows, dts[i] = dt[i]
// (0 past S).  Every thread of the block must call it.
__device__ void chunk_cumsum(const SsdArgs& a, int b, int h, int c,
                             float* cum, float* dts) {
  const int t = threadIdx.x;
  const int s0 = c * a.Q;
  for (int i = t; i < a.Q; i += NT) {
    const int s = s0 + i;
    dts[i] = s < a.S ? a.dt[b * a.ds_b + (long long)s * a.ds_s + h * a.ds_h]
                     : 0.f;
  }
  __syncthreads();
  if (t < 32) {
    const float A = a.A[h];
    const int per = (a.Q + 31) / 32;
    const int i0 = t * per;
    float run = 0.f;
    for (int k = 0; k < per && i0 + k < a.Q; ++k) {
      run = __fadd_rn(run, __fmul_rn(dts[i0 + k], A));
      cum[i0 + k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (t >= off) incl = __fadd_rn(incl, v);
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (t == 0) before = 0.f;
    for (int k = 0; k < per && i0 + k < a.Q; ++k)
      cum[i0 + k] = __fadd_rn(before, cum[i0 + k]);
  }
  __syncthreads();
}

// 1. grid (nC, B*H, p tiles * n tiles): upd[p, n] = sum_s x[s, p] *
// (B[s, n] * (exp(cum[Q-1] - cum[s]) * dt[s])) into hbuf[bh, c].
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_state(SsdArgs a) {
  extern __shared__ float sm[];
  float* cum = sm;
  float* dts = cum + rows4(a.Q);
  float* wts = dts + rows4(a.Q);
  float* xs = wts + rows4(a.Q); // [TK][LD]  (s, p)
  float* bs = xs + TK * LD;     // [TK][LD]  (s, n)
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int n_pt = (a.P + T64 - 1) / T64;
  const int p0 = (blockIdx.z % n_pt) * T64, n0 = (blockIdx.z / n_pt) * T64;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  chunk_cumsum(a, b, h, c, cum, dts);
  const float cl = cum[a.Q - 1];
  for (int i = t; i < a.Q; i += NT)
    wts[i] = __fmul_rn(expf(cl - cum[i]), dts[i]);
  if (blockIdx.z == 0 && t == 0) a.clast[(long long)bh * a.nC + c] = cl;
  const T* xg = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* bg = static_cast<const T*>(a.b) + b * a.bs_b + g * a.bs_g;
  const int s_base = c * a.Q;
  float acc[4][4] = {};
  __syncthreads();
  for (int k0 = 0; k0 < a.Q; k0 += TK) {
    for (int e = t; e < TK * T64; e += NT) {
      const int i = e / T64, j = e % T64;
      const int sc = k0 + i, s = s_base + sc;
      const bool row = sc < a.Q && s < a.S;
      xs[i * LD + j] = (row && p0 + j < a.P)
                           ? ld(xg, (long long)s * a.xs_s + p0 + j) : 0.f;
      bs[i * LD + j] = (row && n0 + j < a.N)
                           ? __fmul_rn(ld(bg, (long long)s * a.bs_s + n0 + j),
                                       wts[sc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < TK; ++i) {
      const float4 xv = ld4(xs + i * LD + ty * 4);
      const float4 bv = ld4(bs + i * LD + tx * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xa[u], ba[v], acc[u][v]);
    }
    __syncthreads();
  }
  float* out = a.hbuf + ((long long)bh * a.nC + c) * a.P * a.N;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = p0 + ty * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tx * 4 + v;
      if (p < a.P && n < a.N) out[(long long)p * a.N + n] = acc[u][v];
    }
  }
}

// 2. grid (ceil(P*N / NT), B*H): the sequential pass over chunks.
__global__ void __launch_bounds__(NT) ssd_state_pass(SsdArgs a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * NT + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float h = a.h0 ? a.h0[(long long)bh * PN + e] : 0.f;
  for (int c = 0; c < a.nC; ++c) {
    float* slot = a.hbuf + ((long long)bh * a.nC + c) * PN + e;
    const float upd = *slot;
    *slot = h;
    h = __fadd_rn(__fmul_rn(h, expf(a.clast[(long long)bh * a.nC + c])), upd);
  }
  a.hout[(long long)bh * PN + e] = h;
}

// 3. grid (q tiles * p tiles, nC, B*H): y for 64 rows x 64 columns.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_out(SsdArgs a) {
  extern __shared__ float sm[];
  float* cum = sm;
  float* dts = cum + rows4(a.Q);
  float* cs = dts + rows4(a.Q); // [TK][LD]   (n, q)
  float* bs = cs + TK * LD;     // [TK][LD]   (n, s); (n, p) of h_in later
  float* ws = bs + TK * LD;     // [T64][LD]  (q, s)
  float* xs = ws + T64 * LD;    // [T64][LD]  (s, p)
  const int n_qt = (a.Q + T64 - 1) / T64;
  const int q0 = (blockIdx.x % n_qt) * T64, p0 = (blockIdx.x / n_qt) * T64;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int s_base = c * a.Q;
  const int qv = min(a.Q, a.S - s_base);  // valid rows of this chunk
  if (q0 >= qv) return;  // a tile past the end of a ragged last chunk
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  chunk_cumsum(a, b, h, c, cum, dts);
  const T* xg = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const T* bg = static_cast<const T*>(a.b) + b * a.bs_b + g * a.bs_g;
  const T* cg = static_cast<const T*>(a.c) + b * a.cs_b + g * a.cs_g;

  float acc[4][4] = {};
  const int s_end = min(q0 + T64, qv);  // keys up to the diagonal
  for (int s0 = 0; s0 < s_end; s0 += T64) {
    // G = C[q tile] B[s tile]ᵀ over N, in slices of TK
    float gm[4][4] = {};
    for (int k0 = 0; k0 < a.N; k0 += TK) {
      for (int e = t; e < TK * T64; e += NT) {
        const int kk = e % TK, r = e / TK, n = k0 + kk;
        const int q = q0 + r, s = s0 + r;
        cs[kk * LD + r] = (q < qv && n < a.N)
            ? ld(cg, (long long)(s_base + q) * a.cs_s + n) : 0.f;
        bs[kk * LD + r] = (s < qv && n < a.N)
            ? ld(bg, (long long)(s_base + s) * a.bs_s + n) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float4 cv = ld4(cs + kk * LD + ty * 4);
        const float4 bv = ld4(bs + kk * LD + tx * 4);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) gm[u][v] = fmaf(ca[u], ba[v], gm[u][v]);
      }
      __syncthreads();
    }
    // W = G ∘ L, masked before the exponent
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + ty * 4 + u;
      float w[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int s = s0 + tx * 4 + v;
        w[v] = (s <= q && q < qv) ? __fmul_rn(gm[u][v], expf(cum[q] - cum[s]))
                                  : 0.f;
      }
      *reinterpret_cast<float4*>(ws + (ty * 4 + u) * LD + tx * 4) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    // x ∘ dt for the key tile
    for (int e = t; e < T64 * T64; e += NT) {
      const int r = e / T64, j = e % T64, s = s0 + r;
      xs[r * LD + j] = (s < qv && p0 + j < a.P)
          ? __fmul_rn(ld(xg, (long long)(s_base + s) * a.xs_s + p0 + j),
                      dts[s]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < T64; ++r) {
      const float4 xv = ld4(xs + r * LD + tx * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float wv = ws[(ty * 4 + u) * LD + r];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(wv, xa[v], acc[u][v]);
      }
    }
    __syncthreads();
  }

  // carried-state term: (C ∘ exp(cum)) h_inᵀ over N
  const float* hin = a.hbuf + ((long long)bh * a.nC + c) * a.P * a.N;
  float acc2[4][4] = {};
  for (int k0 = 0; k0 < a.N; k0 += TK) {
    for (int e = t; e < TK * T64; e += NT) {
      const int kk = e % TK, r = e / TK, n = k0 + kk;
      const int q = q0 + r, p = p0 + r;
      cs[kk * LD + r] = (q < qv && n < a.N)
          ? __fmul_rn(ld(cg, (long long)(s_base + q) * a.cs_s + n),
                      expf(cum[q])) : 0.f;
      bs[kk * LD + r] = (p < a.P && n < a.N)
          ? hin[(long long)p * a.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 cv = ld4(cs + kk * LD + ty * 4);
      const float4 hv = ld4(bs + kk * LD + tx * 4);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc2[u][v] = fmaf(ca[u], ha[v], acc2[u][v]);
    }
    __syncthreads();
  }

  T* yg = static_cast<T*>(a.y);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = q0 + ty * 4 + u;
    if (q >= qv) continue;
    const long long row = (((long long)b * a.S + s_base + q) * a.H + h) * a.P;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int p = p0 + tx * 4 + v;
      if (p < a.P) st(yg, row + p, __fadd_rn(acc[u][v], acc2[u][v]));
    }
  }
}

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t st) {
  const int BH = a.batch * a.H;
  const int n_pt = (a.P + T64 - 1) / T64, n_nt = (a.N + T64 - 1) / T64;
  const int n_qt = (a.Q + T64 - 1) / T64;
  const size_t sm1 = sizeof(float) * (3 * rows4(a.Q) + 2 * TK * LD);
  ssd_chunk_state<T><<<dim3(a.nC, BH, n_pt * n_nt), NT, sm1, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass<<<dim3((a.P * a.N + NT - 1) / NT, BH), NT, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t sm3 =
      sizeof(float) * (2 * rows4(a.Q) + 2 * TK * LD + 2 * T64 * LD);
  err = cudaFuncSetAttribute(ssd_chunk_out<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return err;
  ssd_chunk_out<T><<<dim3(n_qt * n_pt, a.nC, BH), NT, sm3, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C and y).  Returns
// cudaGetLastError() of the first launch that failed, else 0.
int ssd_scan_fwd(const SsdArgs* a, void* stream) {
  if (a->batch <= 0 || a->S <= 0 || a->H <= 0 || a->G <= 0 ||
      a->H % a->G || a->P <= 0 || a->N <= 0 || a->Q <= 0 || a->Q > 1024 ||
      a->nC != (a->S + a->Q - 1) / a->Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return (int)launch<float>(*a, s);
  if (a->dtype == 1) return (int)launch<__nv_bfloat16>(*a, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
