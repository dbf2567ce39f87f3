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
// reference's padding gives.  Every sum is f32, as the reference
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
//      sequential pass over chunks, h_in[c] = state entering chunk c,
//      and the final state;
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
// Bound.  At the path's shape the scan does 5.1 GFLOP counting the
// causal triangle only (2.2 of C Bᵀ, 2.9 of (C Bᵀ ∘ L)(x dt), the
// carried-state term and the state update): 0.005 ms at the bf16
// tensor-core rate, counted once.  It moves about 20 MB (x and y 8.4 MB
// each, the final state 2.1): 0.006 ms at 3.35 TB/s.  So it is bound by
// bytes, about 0.006 ms.
//
// Instances (ops.instance picks one before the launch):
//  - tc: bf16 with P and N multiples of 16, N <= 256, strides of x, B, C
//    multiples of 8 elements, 16-byte-aligned bases (the model's views of
//    its conv output).  Every product on the tensor cores, mma.sync
//    m16n8k16 with tiles copied by cp.async and read by ldmatrix:
//      - C Bᵀ of the model's bf16 operands: products exact in f32, sums
//        in f32;
//      - W = (C Bᵀ) ∘ L ∘ dt[s] formed in f32 from the accumulator
//        fragments, masked before the exponent, split into hi = bf16(W)
//        and lo = bf16(W - hi), and reused as A operands against the
//        exact bf16 x (dt is in W, not in x): y += W_lo x + W_hi x;
//      - the carried term C h_inᵀ with h_in as two bf16 planes that the
//        state pass writes, added first into the same f32 accumulator and
//        scaled by exp(cum[q]);
//      - the state update xᵀ (B ∘ w), x read MN-major (ldmatrix.trans),
//        B ∘ w formed in f32 and split into two planes, two products
//        into one f32 accumulator.
//    W, h_in or B ∘ w rounded once to bf16 would put y at 28-58x the
//    per-element limit (two bf16 ulps of each element + 1e-4) and the
//    state at 74-90x its 2e-5 limit; the two terms keep y near 0.5 of it
//    (tests/test_torch_ssd_numerics.py).  The outputs launch streams the
//    two h_in planes and then the key tiles through one two-stage
//    cp.async ring; the chunk-state launch double-buffers x and loads the
//    next tile's B rows into registers during the products, and leaves
//    each chunk's cumsum and dt for the outputs launch to copy.  The
//    state pass, the cumsum and every decay stay f32; L inside W takes
//    the SFU's 2^x (see ex2).
//  - general (other bf16) and f32: the first kernel, f32 FMAs on the CUDA
//    cores from shared-memory tiles (4 x 4 outputs per thread); the state
//    pass writes h_in over the chunk states.
// PERF.md holds the times and the compiler's registers (chip_smoke.py,
// scripts/ssd_bench.py).
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
  float* hbuf;   // (B*H, nC, P, N): chunk states, then (general, f32) the
                 // entering states
  float* clast;  // (B*H, nC): cum[Q-1] of each chunk
  void* hin_hi;  // tc: (B*H, nC, P, N) bf16, the entering states' hi term
  void* hin_lo;  // tc: the lo term, bf16(h - hi)
  float* cumdt;  // tc: (B*H, nC, 2, rows4(Q)): each chunk's cum, then dt
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
// (0 past S).  Every thread of the block (NTH of them) must call it.  The
// sums are taken by warp 0 alone, so every instance gets the same bits.
template <int NTH>
__device__ void chunk_cumsum(const SsdArgs& a, int b, int h, int c,
                             float* cum, float* dts) {
  const int t = threadIdx.x;
  const int s0 = c * a.Q;
  for (int i = t; i < a.Q; i += NTH) {
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
  chunk_cumsum<NT>(a, b, h, c, cum, dts);
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
  chunk_cumsum<NT>(a, b, h, c, cum, dts);
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores (the tc instance): mma.sync m16n8k16, cp.async
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int TT = 64;           // tile edge: rows q or s, columns p or n
constexpr int LDX = TT + 8;      // bf16 row of a 64-wide tile, +16 bytes
constexpr int TC_MAX_N = 256;    // N of the shared tiles (ops.TC_MAX_N)

// a bf16 row of N columns, +16 bytes: an odd number of 16-byte units for
// N a multiple of 16, so ldmatrix's eight rows hit eight bank groups
__host__ __device__ __forceinline__ int ldn(int N) { return N + 8; }

__host__ __device__ inline size_t tc_state_smem(int Q) {
  // cum, dts, w; two stages of the x tile; the hi and lo planes of B ∘ w
  return sizeof(float) * 3 * rows4(Q) + sizeof(__nv_bfloat16) * 4 * TT * LDX;
}
__host__ __device__ inline size_t tc_out_smem(int Q, int N) {
  // cum, dts; the C tile; two stages of (B tile, x tile) or an h_in plane
  return sizeof(float) * 2 * rows4(Q) +
         sizeof(__nv_bfloat16) * (TT * ldn(N) + 2 * TT * (ldn(N) + LDX));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x by the SFU (about 2 ulp; results below 2^-126 flush to 0).  Used
// for L inside W only: W is carried to about 16 bits (hi + lo) anyway,
// and exp(d) = 2^(d log2 e) adds |d| 2^-24 relative error, under 2^-19
// for every |d| < 30 (beyond that L < 1e-13 adds nothing to y).  The
// f32 state, w and the carried term's exp(cum) keep expf.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (x0, x1) -> their two bf16 terms packed: hi = bf16(x), lo = bf16(x - hi).
// x - hi is exact in f32, so hi + lo carries x to about 16 significant bits.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// A fragment (rows m0..m0+15, depth k0..k0+15) of a tile stored (m, k)
__device__ __forceinline__ void frag_a(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld, int m0,
                                       int k0, int lane) {
  ldmatrix_x4(r, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// A fragment of a tile stored (k, m): the transpose, by ldmatrix.trans
__device__ __forceinline__ void frag_a_t(uint32_t (&r)[4],
                                         const __nv_bfloat16* s, int ld,
                                         int m0, int k0, int lane) {
  ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                           ((lane >> 3) & 1) * 8);
}
// B fragments of n-tiles n0..n0+7 (r[0], r[1]) and n0+8.. (r[2], r[3]),
// depth k0..k0+15, of a tile stored (n, k)
__device__ __forceinline__ void frag_b(uint32_t (&r)[4],
                                       const __nv_bfloat16* s, int ld, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}
// the same of a tile stored (k, n), by ldmatrix.trans
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4],
                                         const __nv_bfloat16* s, int ld,
                                         int n0, int k0, int lane) {
  ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// 1 (tc). grid (nC, B*H, p tiles * n tiles), 4 warps: upd = xᵀ (B ∘ w)
// for 64 p x 64 n, warp w owning p rows 16w..16w+15, over the chunk's
// rows in tiles of 64.  x is the exact bf16 A operand (MN-major, by
// ldmatrix.trans), through a two-stage cp.async ring; B ∘ w is formed in
// f32 from B rows loaded a tile ahead into registers, and split into hi
// and lo planes, two products into one f32 accumulator.
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_state_tc(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + rows4(a.Q);
  float* wts = dts + rows4(a.Q);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(wts + rows4(a.Q));
  __nv_bfloat16* sH = sX + 2 * TT * LDX;  // (s, n): hi of B ∘ w
  __nv_bfloat16* sL = sH + TT * LDX;      // (s, n): lo
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int n_pt = (a.P + TT - 1) / TT;
  const int p0 = (blockIdx.z % n_pt) * TT, n0 = (blockIdx.z / n_pt) * TT;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) +
                            b * a.xs_b + h * a.xs_h;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.b) +
                            b * a.bs_b + g * a.bs_g;
  const int s_base = c * a.Q;
  const int qv = min(a.Q, a.S - s_base);  // valid rows of this chunk
  constexpr int PER = TT * 8 / TC_THREADS;  // 16-byte chunks a thread
  auto load_x = [&](int k0, int stage) {
    __nv_bfloat16* dst = sX + stage * TT * LDX;
    for (int e = t; e < TT * 8; e += TC_THREADS) {
      const int r = e / 8, ch = e % 8, s = k0 + r, p = p0 + ch * 8;
      const bool ok = s < qv && p < a.P;
      cp_async16(dst + r * LDX + ch * 8,
                 ok ? xg + (long long)(s_base + s) * a.xs_s + p : xg, ok);
    }
  };
  uint4 raw[PER];  // B rows of the next tile
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + i * TC_THREADS;
      const int r = e / 8, ch = e % 8, s = k0 + r, n = n0 + ch * 8;
      raw[i] = s < qv && n < a.N
                   ? *reinterpret_cast<const uint4*>(
                         bg + (long long)(s_base + s) * a.bs_s + n)
                   : make_uint4(0, 0, 0, 0);
    }
  };
  load_x(0, 0);
  cp_async_commit();
  load_b(0);
  chunk_cumsum<TC_THREADS>(a, b, h, c, cum, dts);
  const float cl = cum[a.Q - 1];
  for (int i = t; i < a.Q; i += TC_THREADS)
    wts[i] = __fmul_rn(expf(cl - cum[i]), dts[i]);
  if (blockIdx.z == 0) {  // for the outputs launch, which reads them whole
    float* cd = a.cumdt + ((long long)bh * a.nC + c) * 2 * rows4(a.Q);
    for (int i = t; i < a.Q; i += TC_THREADS) {
      cd[i] = cum[i];
      cd[rows4(a.Q) + i] = dts[i];
    }
    if (t == 0) a.clast[(long long)bh * a.nC + c] = cl;
  }
  __syncthreads();
  float acc[8][4] = {};
  for (int k0 = 0, it = 0; k0 < qv; k0 += TT, ++it) {
    // B ∘ w of this tile, split, from the registers (w is 0 past S)
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + i * TC_THREADS;
      const int r = e / 8, ch = e % 8;
      const float w = wts[min(k0 + r, a.Q - 1)];
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      uint4 hv, lv;
      uint32_t* ho = reinterpret_cast<uint32_t*>(&hv);
      uint32_t* lo = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(v2[u]);
        split2(__fmul_rn(f.x, w), __fmul_rn(f.y, w), ho[u], lo[u]);
      }
      *reinterpret_cast<uint4*>(sH + r * LDX + ch * 8) = hv;
      *reinterpret_cast<uint4*>(sL + r * LDX + ch * 8) = lv;
    }
    if (k0 + TT < qv) {  // the next tile's loads overlap these products
      load_x(k0 + TT, (it + 1) & 1);
      load_b(k0 + TT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's x landed
    __syncthreads();
    const __nv_bfloat16* xs = sX + (it & 1) * TT * LDX;
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk) {
      uint32_t af[4];
      frag_a_t(af, xs, LDX, 16 * warp, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bl[4], bu[4];
        frag_b_t(bl, sL, LDX, jj * 16, kk * 16, lane);
        frag_b_t(bu, sH, LDX, jj * 16, kk * 16, lane);
        mma_bf16(acc[2 * jj], af, bl[0], bl[1]);  // the smaller first
        mma_bf16(acc[2 * jj + 1], af, bl[2], bl[3]);
        mma_bf16(acc[2 * jj], af, bu[0], bu[1]);
        mma_bf16(acc[2 * jj + 1], af, bu[2], bu[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  float* out = a.hbuf + ((long long)bh * a.nC + c) * a.P * a.N;
  const int gr = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;  // N is even: n < N gives n + 1 < N
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + 16 * warp + gr + 8 * hf;
      if (p < a.P && n < a.N)
        *reinterpret_cast<float2*>(out + (long long)p * a.N + n) =
            make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

// 2 (tc). grid (ceil(P*N / NT), B*H): the sequential pass over chunks.
// The chunk states stay in hbuf; the state entering chunk c is written
// as two bf16 planes, hi and lo, the operands of the outputs launch
// (none for chunk 0 without h0: the outputs launch skips that term).
__global__ void __launch_bounds__(NT) ssd_state_pass_tc(SsdArgs a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * NT + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(a.hin_hi);
  __nv_bfloat16* lo = static_cast<__nv_bfloat16*>(a.hin_lo);
  float h = a.h0 ? a.h0[(long long)bh * PN + e] : 0.f;
  for (int c = 0; c < a.nC; ++c) {
    const long long off = ((long long)bh * a.nC + c) * PN + e;
    if (c > 0 || a.h0) {
      const __nv_bfloat16 hb = __float2bfloat16_rn(h);
      hi[off] = hb;
      lo[off] = __float2bfloat16_rn(h - __bfloat162float(hb));
    }
    h = __fadd_rn(__fmul_rn(h, expf(a.clast[(long long)bh * a.nC + c])),
                  a.hbuf[off]);
  }
  a.hout[(long long)bh * PN + e] = h;
}

// 3 (tc). one block per (64-row tile of a chunk, 64 columns of P, chunk,
// b*h), 4 warps, warp w owning rows q0+16w..q0+16w+15.  Flash attention's
// forward with C the queries, B the keys, x the values and the decay mask
// in place of the softmax:
//   acc  = exp(cum[q]) (C h_loᵀ + C h_hiᵀ)            (carried state)
//   acc += W_lo x + W_hi x,  W = (C Bᵀ) ∘ L ∘ dt[s]     (per key tile)
// with y rounded once from acc.  The two h_in planes and then the key
// tiles stream through one two-stage cp.async ring, so every load but
// the first overlaps a product.
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_out_tc(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDN = ldn(a.N);
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + rows4(a.Q);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(dts + rows4(a.Q));
  // a stage: a key tile's (s, n) B then (s, p) x, or one (p, n) h_in plane
  __nv_bfloat16* ring = sC + TT * LDN;
  const int stage_elems = TT * (LDN + LDX);

  // blocks start in the order of their linear index: the q tiles from the
  // last (most key tiles) to the first, so the short ones fill the tail
  const int n_qt = (a.Q + TT - 1) / TT, n_pt = (a.P + TT - 1) / TT;
  const int rest = n_pt * a.nC * a.batch * a.H;
  const int lin = blockIdx.x;
  const int q0 = (n_qt - 1 - lin / rest) * TT;
  const int p0 = (lin % rest % n_pt) * TT;
  const int c = lin % rest / n_pt % a.nC;
  const int bh = lin % rest / (n_pt * a.nC);
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int s_base = c * a.Q;
  const int qv = min(a.Q, a.S - s_base);  // valid rows of this chunk
  if (q0 >= qv) return;  // a tile past the end of a ragged last chunk
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) +
                            b * a.xs_b + h * a.xs_h;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.b) +
                            b * a.bs_b + g * a.bs_g;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(a.c) +
                            b * a.cs_b + g * a.cs_g;
  const int nch = a.N / 8;  // 16-byte chunks of a row of N
  // items through the ring: the lo and hi planes of h_in (none for chunk
  // 0 without h0), then key tiles 0 .. the diagonal's
  const int n_h = c > 0 || a.h0 != nullptr ? 2 : 0;
  const int n_items = n_h + (min(q0 + TT, qv) + TT - 1) / TT;
  const long long h_off = ((long long)bh * a.nC + c) * a.P * a.N;

  for (int e = t; e < TT * nch; e += TC_THREADS) {
    const int r = e / nch, ch = e % nch, q = q0 + r;
    const bool ok = q < qv;
    cp_async16(sC + r * LDN + ch * 8,
               ok ? cg + (long long)(s_base + q) * a.cs_s + ch * 8 : cg, ok);
  }
  auto load = [&](int item, int stage) {
    __nv_bfloat16* sB = ring + stage * stage_elems;
    if (item < n_h) {  // an h_in plane, (p, n)
      const __nv_bfloat16* hp = static_cast<const __nv_bfloat16*>(
          item == 0 ? a.hin_lo : a.hin_hi) + h_off;
      for (int e = t; e < TT * nch; e += TC_THREADS) {
        const int r = e / nch, ch = e % nch, p = p0 + r;
        const bool ok = p < a.P;
        cp_async16(sB + r * LDN + ch * 8,
                   ok ? hp + (long long)p * a.N + ch * 8 : hp, ok);
      }
      return;
    }
    __nv_bfloat16* sX = sB + TT * LDN;
    const int s0 = (item - n_h) * TT;
    for (int e = t; e < TT * nch; e += TC_THREADS) {
      const int r = e / nch, ch = e % nch, s = s0 + r;
      const bool ok = s < qv;
      cp_async16(sB + r * LDN + ch * 8,
                 ok ? bg + (long long)(s_base + s) * a.bs_s + ch * 8 : bg, ok);
    }
    for (int e = t; e < TT * 8; e += TC_THREADS) {
      const int r = e / 8, ch = e % 8, s = s0 + r, p = p0 + ch * 8;
      const bool ok = s < qv && p < a.P;
      cp_async16(sX + r * LDX + ch * 8,
                 ok ? xg + (long long)(s_base + s) * a.xs_s + p : xg, ok);
    }
  };
  // cum and dt of the chunk, as the chunk-state launch computed them
  const float* cd = a.cumdt + ((long long)bh * a.nC + c) * 2 * rows4(a.Q);
  for (int e = t; e < rows4(a.Q) / 2; e += TC_THREADS)
    cp_async16(cum + 4 * e, cd + 4 * e, true);
  load(0, 0);
  cp_async_commit();  // with the C tile and cum, dt

  const int qw = q0 + 16 * warp;  // this warp's first row
  const int r0 = qw + gr, r1 = r0 + 8;
  const bool live = qw < qv;
  float acc[8][4] = {};
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // item it (and the C tile) landed
    __syncthreads();
    const __nv_bfloat16* sB = ring + (it & 1) * stage_elems;
    const __nv_bfloat16* sX = sB + TT * LDN;
    const int s0 = (it - n_h) * TT;
    if (live && it < n_h) {
      // C h_inᵀ over N, one plane (lo, then hi) into the f32 sum; after
      // the hi plane each row is scaled by exp(cum[q])
      for (int kk = 0; kk < a.N / 16; ++kk) {
        uint32_t af[4];
        frag_a(af, sC, LDN, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t hf[4];
          frag_b(hf, sB, LDN, jj * 16, kk * 16, lane);
          mma_bf16(acc[2 * jj], af, hf[0], hf[1]);
          mma_bf16(acc[2 * jj + 1], af, hf[2], hf[3]);
        }
      }
      if (it == 1) {
        const float e0 = r0 < qv ? expf(cum[r0]) : 0.f;
        const float e1 = r1 < qv ? expf(cum[r1]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= e0, acc[j][1] *= e0;
          acc[j][2] *= e1, acc[j][3] *= e1;
        }
      }
    } else if (live && s0 <= qw + 15) {
      // n-tiles of keys this warp's rows can see: all 8 below the
      // diagonal tile, 2w + 2 on it
      const int nj = min(8, (qw + 15 - s0) / 8 + 1);
      // G = C Bᵀ: bf16 products, exact in f32, summed in f32
      float gm[8][4] = {};
      for (int kk = 0; kk < a.N / 16; ++kk) {
        uint32_t af[4];
        frag_a(af, sC, LDN, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (2 * jj < nj) {
            uint32_t kf[4];
            frag_b(kf, sB, LDN, jj * 16, kk * 16, lane);
            mma_bf16(gm[2 * jj], af, kf[0], kf[1]);
            mma_bf16(gm[2 * jj + 1], af, kf[2], kf[3]);
          }
        }
      }
      // W = G ∘ L ∘ dt[s] in f32, masked before the exponent (above the
      // diagonal cum[q] - cum[s] > 0), then y += W_lo x + W_hi x.  dt goes
      // into W, not into x, so x stays an exact bf16 operand.  Do not
      // round W once: tests/test_torch_ssd_numerics.py plants that fault.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk < nj) {
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 2 * kk + u;
            float w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = e < 2 ? r0 : r1;
              const int s = s0 + 8 * j + 2 * t4 + (e & 1);
              w[e] = (s <= q && q < qv)
                         ? __fmul_rn(__fmul_rn(gm[j][e],
                                               ex2(__fmul_rn(cum[q] - cum[s],
                                                             LOG2E))),
                                     dts[s])
                         : 0.f;
            }
            split2(w[0], w[1], wh[2 * u], wl[2 * u]);
            split2(w[2], w[3], wh[2 * u + 1], wl[2 * u + 1]);
          }
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) {
            uint32_t vf[4];
            frag_b_t(vf, sX, LDX, dd * 16, kk * 16, lane);
            mma_bf16(acc[2 * dd], wl, vf[0], vf[1]);  // the smaller first
            mma_bf16(acc[2 * dd + 1], wl, vf[2], vf[3]);
            mma_bf16(acc[2 * dd], wh, vf[0], vf[1]);
            mma_bf16(acc[2 * dd + 1], wh, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(a.y);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + 8 * j + 2 * t4;  // P is even: p < P gives p + 1 < P
    if (p >= a.P) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = hf ? r1 : r0;
      if (q < qv)
        *reinterpret_cast<__nv_bfloat162*>(
            yg + (((long long)b * a.S + s_base + q) * a.H + h) * a.P + p) =
            __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

cudaError_t launch_tc(const SsdArgs& a, cudaStream_t st) {
  const int BH = a.batch * a.H;
  const int n_pt = (a.P + TT - 1) / TT, n_nt = (a.N + TT - 1) / TT;
  const int n_qt = (a.Q + TT - 1) / TT;
  const size_t sm1 = tc_state_smem(a.Q), sm3 = tc_out_smem(a.Q, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm1);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_tc<<<dim3(a.nC, BH, n_pt * n_nt), TC_THREADS, sm1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass_tc<<<dim3((a.P * a.N + NT - 1) / NT, BH), NT, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return err;
  ssd_chunk_out_tc<<<n_qt * n_pt * a.nC * BH, TC_THREADS, sm3, st>>>(a);
  return cudaGetLastError();
}

bool args_ok(const SsdArgs* a) {
  return a->batch > 0 && a->S > 0 && a->H > 0 && a->G > 0 && !(a->H % a->G) &&
         a->P > 0 && a->N > 0 && a->Q > 0 && a->Q <= 1024 &&
         a->nC == (a->S + a->Q - 1) / a->Q;
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C and y): the CUDA-core
// instances (f32, general).  Returns cudaGetLastError() of the first
// launch that failed, else 0.
int ssd_scan_fwd(const SsdArgs* a, void* stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return (int)launch<float>(*a, s);
  if (a->dtype == 1) return (int)launch<__nv_bfloat16>(*a, s);
  return (int)cudaErrorInvalidValue;
}

// The tc instance: bf16, P and N multiples of 16, N <= TC_MAX_N, every
// stride of x, B and C a multiple of 8 elements and their bases 16-byte
// aligned (cp.async copies 16 bytes), hin_hi/hin_lo given.
int ssd_scan_fwd_tc(const SsdArgs* a, void* stream) {
  if (!args_ok(a) || a->dtype != 1 || a->P % 16 || a->N % 16 ||
      a->N > TC_MAX_N || !a->hin_hi || !a->hin_lo || !a->cumdt)
    return (int)cudaErrorInvalidValue;
  const long long strides = a->xs_b | a->xs_s | a->xs_h | a->bs_b | a->bs_s |
                            a->bs_g | a->cs_b | a->cs_s | a->cs_g;
  if (strides % 8 ||
      (reinterpret_cast<uintptr_t>(a->x) | reinterpret_cast<uintptr_t>(a->b) |
       reinterpret_cast<uintptr_t>(a->c) | reinterpret_cast<uintptr_t>(a->y) |
       reinterpret_cast<uintptr_t>(a->hin_hi) |
       reinterpret_cast<uintptr_t>(a->hin_lo) |
       reinterpret_cast<uintptr_t>(a->cumdt)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_tc(*a, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory bytes of the tc instance's chunk-state (which 0)
// and outputs (which 1) launches at these Q and N
int ssd_scan_tc_smem(int Q, int N, int which) {
  return (int)(which ? tc_out_smem(Q, N) : tc_state_smem(Q));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
