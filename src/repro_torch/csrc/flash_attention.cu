// Blocked online-softmax attention, forward only (prefill).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd / _attn_kernel).  Layout is the public one,
// q (B, Sq, H, D) and k/v (B, Sk, KH, D), read in place: query head h
// reads kv head h / (H / KH), so GQA needs no repeated K/V copy.
//
// One thread block per (tile of 64 query rows, b*H + h).  The TPU's
// sequential k grid axis becomes a loop inside the block over 64-key
// tiles staged in shared memory (f32); the running max, denominator and
// the 64 x D output accumulator stay in f32 (max/denominator in shared
// memory, the accumulator in registers, D/4 values a thread).  Key tiles
// entirely above the causal diagonal or left of every query's window are
// never visited, and the ragged Sq/Sk edges are masked here (the TPU
// wrapper pads them instead).
//
// Causal attention at prefill shapes does about 4*D flops per visible
// (query, key) pair on 4 bytes of q/k/v/o per row, so on the H100 it is
// bound by arithmetic, not memory.  This first version does that
// arithmetic on the CUDA cores in f32 (a 4x4 register tile per thread
// for Q K^T and for P V) rather than with wgmma on the tensor cores, so
// it sits far below the bf16 tensor-core bound; tensor cores, TMA and
// warp specialisation are the next step.
//
// Any head dim that is a multiple of 8 up to 256 builds (the instances
// are listed in dispatch_d).  A thread owns output columns tx + 16 j; where
// D is not a multiple of 16 (D = 24) the V tile is padded with zero
// columns up to the next multiple of 16, and the padded outputs are never
// written.  At D = 256 in f32 the shared tiles take 214.5 KB, under the
// 227 KB a block may opt in to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1.0e30f;
constexpr float MASKED = -0.5e30f;  // scores below this are masked
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KH, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it on the first launch on each device, not on every launch
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, causal,
      window, softcap, scale);
  return cudaGetLastError();
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
