// Paged attention over a block-paged KV pool (decode, and C-query chunks).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attn/kernel.py
// (paged_attention_bhgd / _paged_kernel), both branches: f32 or bf16
// pools, and quantized pools (quantized=True) whose rows are int8 or fp8
// e4m3 with one f32 scale per (position, kv head).  Layout is the public
// one: q (B, C, H, D); pools (n_blocks, block_len, KH, D); scales
// (n_blocks, block_len, KH); block_table (B, nbt) int32; pos (B,) int32,
// the FIRST query's position (query c sits at pos + c) -> out
// (B, C, H, D).  Logical position p of slot b lives in pool
// row block_table[b, p / block_len] at offset p % block_len; its scales
// ride the same indirection.
//
// One thread block per (kv head, slot, chunk of RC = 8 query rows); a query
// row is one (c, g) pair of the C chunk positions and the G = H / KH
// query heads that share the kv head, so each K/V row is read once for
// all of them.  The block walks the slot's logical positions in tiles of
// 64 up to the last query's position only (and from the left edge of the
// window), gathering each key through the block table into shared
// memory, so a slot pays for the blocks it has filled and no more.  A
// quantized row is converted to f32 and multiplied by its row's scale in
// registers on the way into shared memory, as the TPU kernel dequantizes
// the DMA'd rows: scores and P V see f32 values either way.  q and out
// are f32 or bf16 each, chosen at run time (read once and written once
// per block); the pool's storage type and D are template parameters.
// Scores, the running max and denominator and the output accumulator
// are f32.
// Masked (query, key) pairs get probability 0, not exp(0): a query row
// may have no visible key in a tile yet.
//
// Any head dim that is a multiple of 8 up to 256 builds (the instances
// are listed in dispatch_d).  Rows are fetched with 16-byte loads where
// a row is a multiple of 16 bytes, else 8-byte loads (an int8/fp8 row of
// D = 24 is 24 bytes); the P V phase spreads the RC x D outputs over the
// threads whatever D is.
//
// A decode step reads every visible K/V row once and does ~4*D*G flops
// per row, far below the H100's flop/byte balance, so the kernel is
// bound by memory: an int8/fp8 pool halves the bytes of a bf16 one, plus
// 4 bytes of scale per row and kv head.  With one block per (slot, kv
// head) a small batch puts few blocks on the card, so each block must
// keep many loads in flight itself: a tile's K/V rows are all requested
// before the first is used (in passes of 16 loads a thread where a tile
// needs more).  Most SMs still idle at small batch; splitting the
// context across blocks (split-K) is the next step.
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
constexpr int MAX_PER = 16;  // row loads in flight per thread and pool
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -1.0e30f;
constexpr float MASKED = -0.5e30f;

// fp8 e4m3 (no infinities) storage: one byte
struct fp8_e4m3 {
  uint8_t bits;
};

// element i of an f32 (bf16 = 0) or bf16 (bf16 = 1) array
__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_f32(void* p, size_t i, int bf16,
                                          float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// Element j of a little-endian 32-bit word of pool data, as f32 (exact
// for every storage type).
template <typename S> struct Storage;
template <> struct Storage<float> {
  static constexpr int PER_WORD = 1;
  static constexpr bool QUANT = false;
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
};
template <> struct Storage<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  static constexpr bool QUANT = false;
  __device__ static float get(uint32_t w, int j) {
    return __uint_as_float(j ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Storage<int8_t> {
  static constexpr int PER_WORD = 4;
  static constexpr bool QUANT = true;
  __device__ static float get(uint32_t w, int j) {
    return (float)((int)(w << (24 - 8 * j)) >> 24);  // sign-extended byte
  }
};
template <> struct Storage<fp8_e4m3> {
  static constexpr int PER_WORD = 4;
  static constexpr bool QUANT = true;
  // e4m3 magnitude bits placed at an f32's exponent/mantissa, rescaled by
  // 2^(127 - 7): exact for normals and subnormals.  The NaN code 0x7f
  // would read 480; quantize clips to +-448 and never writes it.
  __device__ static float get(uint32_t w, int j) {
    const uint32_t b = (w >> (8 * j)) & 0xffu;
    const float mag = __uint_as_float((b & 0x7fu) << 20) * 0x1p120f;
    return (b & 0x80u) ? -mag : mag;
  }
};

template <int VB> struct RowVec;  // one load of VB bytes
template <> struct RowVec<16> {
  uint32_t w[4];
  __device__ void load(const char* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
};
template <> struct RowVec<8> {
  uint32_t w[2];
  __device__ void load(const char* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
};

// bytes of one row load: 16 where a row is a multiple of 16 bytes, else 8
template <typename S, int D>
__host__ __device__ constexpr int row_load_bytes() {
  return (D * (int)sizeof(S)) % 16 == 0 ? 16 : 8;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // sQ, sK (padded rows), sV, sS (padded rows), m, l, corr, the k/v row
  // scales, then the pool row offset of each key
  return sizeof(float) * (RC * D + TK * (D + 1) + TK * D + RC * (TK + 1) +
                          3 * RC + 2 * TK) +
         sizeof(long long) * TK;
}

template <typename S, int D>
__global__ void __launch_bounds__(NT)
paged_fwd_kernel(const void* __restrict__ q, const char* __restrict__ kp,
                 const char* __restrict__ vp, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ bt,
                 const int* __restrict__ pos, void* __restrict__ o,
                 int q_bf16, int o_bf16, int C, int H, int KH, int block_len,
                 int nbt, int window, float softcap, float scale) {
  using St = Storage<S>;
  constexpr int ES = sizeof(S);
  constexpr int VB = row_load_bytes<S, D>();
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, <= 256");
  static_assert((D * ES) % VB == 0, "row split");
  static_assert(4 * RC <= NT && (4 * RC) % 32 == 0 && NT == 2 * TK,
                "thread split");
  constexpr int EPV = VB / ES;                 // elements per load
  constexpr int NW = VB / 4;                   // 32-bit words per load
  constexpr int RV = D / EPV;                  // loads per row
  constexpr int NV = TK * RV;                  // loads per tile and pool
  constexpr int PASS = NV < MAX_PER * NT ? NV : MAX_PER * NT;
  static_assert(NV % PASS == 0, "load passes");
  constexpr int PER = (PASS + NT - 1) / NT;    // loads per thread a pass
  constexpr int NO = (RC * D + NT - 1) / NT;   // outputs per thread
  constexpr int DP = D + 1;
  constexpr int SP = TK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + RC * D;
  float* sV = sK + TK * DP;
  float* sS = sV + TK * D;
  float* sM = sS + RC * SP;
  float* sL = sM + RC;
  float* sC = sL + RC;
  float* sKs = sC + RC;
  float* sVs = sKs + TK;
  long long* sOff = reinterpret_cast<long long*>(sVs + TK);

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
      x = load_f32(q, (((size_t)b * C + c) * H + kh * G + g) * D + d,
                   q_bf16);
    }
    sQ[i] = x;
  }
  if (tid < RC) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  // this thread's outputs of the P V phase: (row, column) pairs
  // tid, tid + NT, ... of the row-major RC x D block
  float acc[NO];
  int orow[NO], ocol[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int idx = tid + i * NT;
    acc[i] = 0.f;
    orow[i] = idx < RC * D ? idx / D : RC;  // RC: no output
    ocol[i] = idx % D;
  }

  const int k_hi = min(p0 + C, nbt * block_len);  // past the last query
  const int k_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_lo = k_lo / TK, t_hi = (k_hi + TK - 1) / TK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // last tile's P V is done with sK/sV/sS/sOff
    if (tid < TK) {
      const int p = k0 + tid;
      long long off = -1;
      float kscale = 0.f, vscale = 0.f;
      if (p < k_hi) {
        const int blk = bt[(size_t)b * nbt + p / block_len];
        const long long row =
            ((long long)blk * block_len + p % block_len) * KH + kh;
        off = row * D;
        if (St::QUANT) {
          kscale = ks[row];
          vscale = vs[row];
        }
      }
      sOff[tid] = off;
      sKs[tid] = kscale;
      sVs[tid] = vscale;
    }
    __syncthreads();
    for (int base = 0; base < NV; base += PASS) {
      // all of a pass's loads issued before any is used: with few blocks
      // per SM, one round trip per pass instead of one per element
      RowVec<VB> kr[PER], vr[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = base + tid + u * NT, r = e / RV, c = e % RV;
#pragma unroll
        for (int m = 0; m < NW; ++m) kr[u].w[m] = vr[u].w[m] = 0u;
        if (tid + u * NT < PASS) {
          const long long off = sOff[r];
          if (off >= 0) {
            kr[u].load(kp + off * ES + c * VB);
            vr[u].load(vp + off * ES + c * VB);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        if (tid + u * NT >= PASS) continue;
        const int e = base + tid + u * NT, r = e / RV;
        const int d = (e % RV) * EPV;
        float* kd = sK + r * DP + d;
        float* vd = sV + r * D + d;
        const float kf = sKs[r], vf = sVs[r];
#pragma unroll
        for (int m = 0; m < NW; ++m) {
#pragma unroll
          for (int j = 0; j < St::PER_WORD; ++j) {
            float kx = St::get(kr[u].w[m], j), vx = St::get(vr[u].w[m], j);
            if (St::QUANT) {
              kx *= kf;
              vx *= vf;
            }
            kd[m * St::PER_WORD + j] = kx;
            vd[m * St::PER_WORD + j] = vx;
          }
        }
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

    // acc = acc * corr + P V over this thread's (row, column) pairs
#pragma unroll
    for (int i = 0; i < NO; ++i)
      if (orow[i] < nrows) acc[i] *= sC[orow[i]];
#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
#pragma unroll
      for (int i = 0; i < NO; ++i)
        if (orow[i] < nrows)
          acc[i] = fmaf(sS[orow[i] * SP + c], sV[c * D + ocol[i]], acc[i]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int r = orow[i];
    if (r >= nrows) continue;
    const int row = r0 + r, c = row / G, g = row % G;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    store_f32(o, (((size_t)b * C + c) * H + kh * G + g) * D + ocol[i],
              o_bf16, acc[i] * inv);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *bt, *pos;
  void* o;
  int q_bf16, o_bf16, B, C, H, KH, block_len, nbt, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename S, int D>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it on the first launch on each device, not on every launch
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(paged_fwd_kernel<S, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  const int rows = a.C * (a.H / a.KH);
  dim3 grid(a.KH, a.B, (rows + RC - 1) / RC);
  paged_fwd_kernel<S, D><<<grid, NT, smem, a.stream>>>(
      a.q, static_cast<const char*>(a.kp), static_cast<const char*>(a.vp),
      a.ks, a.vs, a.bt, a.pos, a.o, a.q_bf16, a.o_bf16, a.C, a.H, a.KH,
      a.block_len, a.nbt, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

// the head dims the kernel is built for: every one a config of the
// repository uses
template <typename S>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 16: return launch<S, 16>(a);
    case 24: return launch<S, 24>(a);
    case 32: return launch<S, 32>(a);
    case 64: return launch<S, 64>(a);
    case 96: return launch<S, 96>(a);
    case 112: return launch<S, 112>(a);
    case 128: return launch<S, 128>(a);
    case 256: return launch<S, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype, out_dtype: 0 = float32, 1 = bfloat16.  kv_dtype (pools):
// 0 = float32, 1 = bfloat16, or 2 = int8, 3 = fp8 e4m3 with f32
// k_scale/v_scale (null otherwise).  Returns cudaGetLastError().
int paged_attention_fwd(const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* block_table,
                        const void* pos, void* o, int q_dtype, int kv_dtype,
                        int out_dtype, int B, int C, int H, int KH, int D,
                        int block_len, int nbt, int window, float softcap,
                        float scale, void* stream) {
  const bool quant = kv_dtype == 2 || kv_dtype == 3;
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || block_len <= 0 ||
      nbt <= 0 || q_dtype < 0 || q_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || quant != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(block_table), static_cast<const int*>(pos),
         o, q_dtype, out_dtype, B, C, H, KH, block_len, nbt, window,
         softcap, scale, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case 0: return (int)dispatch_d<float>(a, D);
    case 1: return (int)dispatch_d<__nv_bfloat16>(a, D);
    case 2: return (int)dispatch_d<int8_t>(a, D);
    case 3: return (int)dispatch_d<fp8_e4m3>(a, D);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
