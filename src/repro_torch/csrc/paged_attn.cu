// Paged attention over a block-paged KV pool (decode, and C-query chunks).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attn/kernel.py
// (paged_attention_bhgd / _paged_kernel), unquantized branch.  Layout is
// the public one: q (B, C, H, D); pools (n_blocks, block_len, KH, D);
// block_table (B, nbt) int32; pos (B,) int32, the FIRST query's position
// (query c sits at pos + c) -> out (B, C, H, D).  Logical position p of
// slot b lives in pool row block_table[b, p / block_len] at offset
// p % block_len.
//
// One thread block per (kv head, slot, chunk of RC = 8 query rows); a query
// row is one (c, g) pair of the C chunk positions and the G = H / KH
// query heads that share the kv head, so each K/V row is read once for
// all of them.  The block walks the slot's logical positions in tiles of
// 64 up to the last query's position only (and from the left edge of the
// window), gathering each key through the block table into shared
// memory, so a slot pays for the blocks it has filled and no more.
// Scores, the running max and denominator and the output accumulator
// are f32.  Masked (query, key) pairs get probability 0, not exp(0): a
// query row may have no visible key in a tile yet.
//
// A decode step reads every visible K/V row once and does ~4*D*G flops
// per row, far below the H100's flop/byte balance, so the kernel is
// bound by memory.  With one block per (slot, kv head) a small batch
// puts few blocks on the card, so each block must keep many loads in
// flight itself: a tile's K/V rows are fetched with 16-byte loads that
// are all issued before the first is used.  Most SMs still idle at
// small batch; splitting the context across blocks (split-K) is the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block
// query rows per block: a decode step's G = 8 query heads of one kv head
// fill it; wider chunks (C * G > 8) take more blocks along grid.z
constexpr int RC = 8;
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -1.0e30f;
constexpr float MASKED = -0.5e30f;

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

// 16 bytes of row data -> f32 (bf16 -> f32 is exact: the high half)
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* dst,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dst[2 * j] = __uint_as_float(w[j] << 16);
    dst[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK (padded rows), sV, sS (padded rows), m, l, corr
  return sizeof(float) * (RC * D + TK * (D + 1) + TK * D + RC * (TK + 1) +
                          3 * RC) +
         sizeof(long long) * TK;  // pool row offset of each key
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ bt,
                 const int* __restrict__ pos, T* __restrict__ o, int C,
                 int H, int KH, int block_len, int nbt, int window,
                 float softcap, float scale) {
  static_assert(NT % D == 0 && D <= NT, "head dim must divide 128");
  static_assert(RC % (NT / D) == 0 && 4 * RC <= NT && (4 * RC) % 32 == 0,
                "row split");
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER = TK * D / VEC / NT;  // 16-byte loads per thread
  static_assert(D % VEC == 0 && PER * VEC * NT == TK * D, "tile split");
  constexpr int DP = D + 1;
  constexpr int SP = TK + 1;
  constexpr int NRG = NT / D;      // row groups in the P V phase
  constexpr int RPT = RC / NRG;    // rows a thread accumulates
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + RC * D;
  float* sV = sK + TK * DP;
  float* sS = sV + TK * D;
  float* sM = sS + RC * SP;
  float* sL = sM + RC;
  float* sC = sL + RC;
  long long* sOff = reinterpret_cast<long long*>(sC + RC);

  const int tid = threadIdx.x;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int r0 = blockIdx.z * RC;
  const int nrows = min(RC, C * G - r0);
  const int p0 = pos[b];

  for (int i = tid; i < RC * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < nrows) {
      const int row = r0 + r, c = row / G, g = row % G;
      x = to_f32(q[(((size_t)b * C + c) * H + kh * G + g) * D + d]);
    }
    sQ[i] = x;
  }
  if (tid < RC) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  const int k_hi = min(p0 + C, nbt * block_len);  // past the last query
  const int k_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_lo = k_lo / TK, t_hi = (k_hi + TK - 1) / TK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // last tile's P V is done with sK/sV/sS/sOff
    if (tid < TK) {
      const int p = k0 + tid;
      long long off = -1;
      if (p < k_hi) {
        const int blk = bt[(size_t)b * nbt + p / block_len];
        off = (((long long)blk * block_len + p % block_len) * KH + kh) * D;
      }
      sOff[tid] = off;
    }
    __syncthreads();
    {
      // 16-byte loads, all issued before any is used: with few blocks
      // per SM, one round trip per tile instead of one per element
      uint4 kr[PER], vr[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = (tid + u * NT) * VEC, r = e / D, d = e % D;
        const long long off = sOff[r];
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (off >= 0) {
          kr[u] = *reinterpret_cast<const uint4*>(kp + off + d);
          vr[u] = *reinterpret_cast<const uint4*>(vp + off + d);
        }
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = (tid + u * NT) * VEC, r = e / D, d = e % D;
        unpack(kr[u], sK + r * DP + d, T());
        unpack(vr[u], sV + r * D + d, T());
      }
    }
    __syncthreads();

    // scores: thread owns key tid % 64 for rows rg, rg + 2, ...
    {
      const int key = tid % TK, rg = tid / TK;
      float sc[RC / 2];
#pragma unroll
      for (int i = 0; i < RC / 2; ++i) sc[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = sK[key * DP + d];
#pragma unroll
        for (int i = 0; i < RC / 2; ++i)
          if (rg + 2 * i < nrows)
            sc[i] = fmaf(sQ[(rg + 2 * i) * D + d], kv, sc[i]);
      }
      const int kpos = k0 + key;
#pragma unroll
      for (int i = 0; i < RC / 2; ++i) {
        const int r = rg + 2 * i;
        const int qpos = p0 + (r0 + r) / G;
        float s = sc[i] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = r < nrows && sOff[key] >= 0 && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sS[r * SP + key] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring lanes share one row, 16 keys each
    // (whole warps: 4 * RC is a multiple of 32)
    if (tid < 4 * RC) {
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

    // acc = acc * corr + P V: thread owns column tid % D of rows
    // rg, rg + NRG, ...
    {
      const int d = tid % D, rg = tid / D;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] *= sC[rg + NRG * i];
#pragma unroll 4
      for (int c = 0; c < TK; ++c) {
        const float vv = sV[c * D + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if (rg + NRG * i < nrows)
            acc[i] = fmaf(sS[(rg + NRG * i) * SP + c], vv, acc[i]);
      }
    }
  }
  __syncthreads();

  const int d = tid % D, rg = tid / D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + NRG * i;
    if (r >= nrows) continue;
    const int row = r0 + r, c = row / G, g = row % G;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    o[(((size_t)b * C + c) * H + kh * G + g) * D + d] =
        from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* pos, void* o, int B, int C,
                   int H, int KH, int block_len, int nbt, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it on the first launch on each device, not on every launch
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(paged_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  const int rows = C * (H / KH);
  dim3 grid(KH, B, (rows + RC - 1) / RC);
  paged_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), C, H, KH,
      block_len, nbt, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* bt, const int* pos, void* o, int B, int C,
                       int H, int KH, int D, int block_len, int nbt,
                       int window, float softcap, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, bt, pos, o, B, C, H, KH, block_len,
                           nbt, window, softcap, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, bt, pos, o, B, C, H, KH, block_len,
                           nbt, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, bt, pos, o, B, C, H, KH, block_len,
                            nbt, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
int paged_attention_fwd(const void* q, const void* k_pool,
                        const void* v_pool, const void* block_table,
                        const void* pos, void* o, int dtype, int B, int C,
                        int H, int KH, int D, int block_len, int nbt,
                        int window, float softcap, float scale,
                        void* stream) {
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || block_len <= 0 ||
      nbt <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k_pool, v_pool, bt, ps, o, B, C, H, KH,
                                  D, block_len, nbt, window, softcap, scale,
                                  s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, bt, ps, o, B, C,
                                          H, KH, D, block_len, nbt, window,
                                          softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
