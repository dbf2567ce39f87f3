// Fused CE (+ temperature-tau KL) loss straight from hidden states.
//
// Replaces the Pallas TPU kernel repro/kernels/kd_loss/kernel.py
// (kd_loss_fwd / _kd_kernel).  Inputs hs (T, Ds), ws (Ds, V) row-major,
// labels (T,) int32 and, in KD mode, ht (T, Dt), wt (Dt, V); outputs
// three f32 vectors of length T: ce, kl (0 without a teacher), correct.
// The (T, V) logits never reach device memory: vocab tiles of 128
// columns are computed into shared memory and folded into per-row
// online statistics, as the TPU kernel does:
//   raw student logits z_s: m, l (logsumexp), gold logit, first argmax
//   KD mode, z_s/tau:       m, l
//           z_t/tau:        m, l, U = sum e^{z_t/tau-m} z_t/tau,
//                           W = sum e^{z_t/tau-m} z_s/tau
//   ce = lse_s - z_gold,  kl = tau^2 [(U/l_t - lse_t) - (W/l_t - lse_s)].
//
// Parallelism.  The TPU walks the whole vocab of a row tile in series
// (its grid's vocab axis is sequential).  On the path T = 4 x 512 = 2048
// rows, so 64-row tiles give only 32 blocks for 132 SMs.  Here the grid
// is (row tiles, vocab splits): each block walks a contiguous run of
// vocab tiles and writes its partial statistics per (split, row); a
// second small kernel merges the splits per row with the same
// rescale-and-add the online softmax does (l, U, W scaled by
// e^{m_split - m}), and keeps "lowest vocab index wins" for the argmax by
// taking splits in vocab order with a strict >, as the TPU kernel takes
// its tiles.  Inside a tile a thread keeps its first maximum and lanes
// combine by (value, lower index).
//
// Bound.  2*T*D*V flops on T*D + D*V input bytes: at the path's shape
// (T=2048, D=2048, V=32000) 268 GFLOP against 139 MB, far above the
// H100's ~295 flops per byte, so the tensor cores bound it.  bf16 inputs
// take mma.sync m16n8k16 (bf16 x bf16 products are exact in f32 and are
// accumulated in f32, so only the summation order differs from the
// plain version); f32 inputs take f32 FMAs on the CUDA cores.  Global
// loads of the next K chunk start before the current chunk's
// products; wgmma, TMA and a deeper pipeline are the next step.
// Ragged T, V and D are masked here (the TPU wrapper pads instead).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BT = 64;        // rows per block
constexpr int BV = 128;       // vocab columns per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int ZS = BV + 4;    // logits tile row stride (floats)
constexpr int KC = 32;        // bf16 K chunk
constexpr int KP = KC + 8;    // bf16 staging row stride (elements)
constexpr int KF = 16;        // f32 K chunk
constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_DEVICES = 64;

// partial statistics per (split, row)
enum Stat { M_S, L_S, GOLD, BMAX, M_ST, L_ST, M_TT, L_TT, U_T, W_T, NSTAT };

// dynamic shared memory: the K-chunk staging buffers (bf16 or f32
// layout, whichever is larger), then one logits tile per side
constexpr size_t STAGE_BF16 = sizeof(uint16_t) * (BT * KP + BV * KP);
constexpr size_t STAGE_F32 = sizeof(float) * KF * (BT + BV);
constexpr size_t STAGE_BYTES = STAGE_BF16 > STAGE_F32 ? STAGE_BF16 : STAGE_F32;
constexpr size_t TILE_BYTES = sizeof(float) * BT * ZS;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Z[BT][BV] (stride ZS) = h[t0:t0+BT, :] @ w[:, v0:v0+BV], bf16 inputs,
// f32 accumulation on the tensor cores.  Out-of-range rows, columns and
// K entries load as 0.  Warp w owns rows (w/4)*32.. and columns
// (w%4)*32.., as 2 x 4 m16n8 tiles.
__device__ void tile_logits(const __nv_bfloat16* __restrict__ h,
                            const __nv_bfloat16* __restrict__ w, int T,
                            int D, int V, int t0, int v0, bool vec_a,
                            char* stage, float* sZ) {
  uint16_t* sA = reinterpret_cast<uint16_t*>(stage);  // [BT][KP]
  uint16_t* sB = sA + BT * KP;                        // [BV][KP], k inner
  const uint16_t* hr = reinterpret_cast<const uint16_t*>(h);
  const uint16_t* wr = reinterpret_cast<const uint16_t*>(w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wrow = (warp >> 2) * 32, wcol = (warp & 3) * 32;

  // loader roles: A row ar, 8 K entries from ac; B column bn, K pairs
  // bk*8 .. bk*8+7
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const int bn = tid & (BV - 1), bk = tid >> 7;
  const int arow = t0 + ar, bcol = v0 + bn;
  uint32_t ra[4], rb[8];

  auto load = [&](int k0) {
    const int k = k0 + ac;
    if (vec_a && arow < T && k < D) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(hr + (size_t)arow * D + k);
      ra[0] = x.x; ra[1] = x.y; ra[2] = x.z; ra[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k2 = k + 2 * i;
        const uint32_t lo =
            (arow < T && k2 < D) ? hr[(size_t)arow * D + k2] : 0u;
        const uint32_t hi =
            (arow < T && k2 + 1 < D) ? hr[(size_t)arow * D + k2 + 1] : 0u;
        ra[i] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k2 = k0 + 2 * (bk * 8 + j);
      const uint32_t lo =
          (bcol < V && k2 < D) ? wr[(size_t)k2 * V + bcol] : 0u;
      const uint32_t hi =
          (bcol < V && k2 + 1 < D) ? wr[(size_t)(k2 + 1) * V + bcol] : 0u;
      rb[j] = lo | (hi << 16);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the last chunk's products are done with sA/sB
    *reinterpret_cast<uint4*>(sA + ar * KP + ac) =
        make_uint4(ra[0], ra[1], ra[2], ra[3]);
    uint32_t* sBw = reinterpret_cast<uint32_t*>(sB);
#pragma unroll
    for (int j = 0; j < 8; ++j) sBw[bn * (KP / 2) + bk * 8 + j] = rb[j];
    __syncthreads();
    if (k0 + KC < D) load(k0 + KC);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint16_t* p0 = sA + (wrow + mi * 16 + g) * KP + ks + 2 * q;
        const uint16_t* p1 = p0 + 8 * KP;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* pb = sB + (wcol + ni * 8 + g) * KP + ks + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wrow + mi * 16 + g, c = wcol + ni * 8 + 2 * q;
      sZ[r * ZS + c] = acc[mi][ni][0];
      sZ[r * ZS + c + 1] = acc[mi][ni][1];
      sZ[(r + 8) * ZS + c] = acc[mi][ni][2];
      sZ[(r + 8) * ZS + c + 1] = acc[mi][ni][3];
    }
}

// The same tile from f32 inputs, with f32 FMAs on the CUDA cores.
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i, columns tx + 16j.
__device__ void tile_logits(const float* __restrict__ h,
                            const float* __restrict__ w, int T, int D, int V,
                            int t0, int v0, bool /*vec_a*/, char* stage,
                            float* sZ) {
  float* sA = reinterpret_cast<float*>(stage);  // [KF][BT]
  float* sB = sA + KF * BT;                     // [KF][BV]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bn = tid & (BV - 1), bk = (tid >> 7) * 8;
  for (int k0 = 0; k0 < D; k0 += KF) {
    __syncthreads();
    const int arow = t0 + ar;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      sA[(ak + i) * BT + ar] =
          (arow < T && k < D) ? h[(size_t)arow * D + k] : 0.f;
    }
    const int bcol = v0 + bn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + bk + j;
      sB[(bk + j) * BV + bn] =
          (bcol < V && k < D) ? w[(size_t)k * V + bcol] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KF; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k * BT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[k * BV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sZ[(ty + 16 * i) * ZS + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ float softcap(float z, float cap) {
  return cap > 0.f ? tanhf(z / cap) * cap : z;
}

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Per (row tile, vocab split): walk the split's vocab tiles, keep the
// online statistics of each row in registers (the 4 lanes that share a
// row hold equal copies), write them to part[stat][split][row].
template <typename Tin, bool KD>
__global__ void __launch_bounds__(NT)
kd_partial_kernel(const Tin* __restrict__ hs, const Tin* __restrict__ ws,
                  const Tin* __restrict__ ht, const Tin* __restrict__ wt,
                  const int* __restrict__ labels, float* __restrict__ part,
                  int* __restrict__ part_arg, int T, int Ds, int Dt, int V,
                  int tiles_per_split, float tau, float cap_s, float cap_t,
                  bool vec_s, bool vec_t) {
  extern __shared__ __align__(16) char smem[];
  char* stage = smem;
  float* sZ = reinterpret_cast<float*>(smem + STAGE_BYTES);
  float* sZt = sZ + BT * ZS;  // KD only

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT, split = blockIdx.y, n_splits = gridDim.y;
  const int n_tiles = (V + BV - 1) / BV;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);

  // epilogue role: 4 lanes per row, lane `part4` takes columns 4c + part4
  const int r = tid >> 2, part4 = tid & 3;
  const int row = t0 + r;
  const int label = row < T ? labels[row] : -1;
  const float inv_tau = 1.f / tau;

  float m_s = NEG_INF, l_s = 0.f, gold = 0.f, bmax = NEG_INF;
  int barg = 0;
  float m_st = NEG_INF, l_st = 0.f, m_tt = NEG_INF, l_tt = 0.f, U = 0.f,
        W = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int v0 = tile * BV;
    tile_logits(hs, ws, T, Ds, V, t0, v0, vec_s, stage, sZ);
    if constexpr (KD) {
      __syncthreads();  // the staging buffers are reused
      tile_logits(ht, wt, T, Dt, V, t0, v0, vec_t, stage, sZt);
    }
    __syncthreads();

    // pass 1: softcap in place, masks, tile maxima, argmax, gold
    float* zr = sZ + r * ZS;
    float* ztr = sZt + r * ZS;
    float tmax = NEG_INF, tmax_t = NEG_INF;
    int targ = 0x7fffffff;
#pragma unroll 4
    for (int c4 = 0; c4 < BV / 4; ++c4) {
      const int c = 4 * c4 + part4, v = v0 + c;
      if (v < V) {
        const float z = softcap(zr[c], cap_s);
        zr[c] = z;
        if (z > tmax) { tmax = z; targ = v; }
        if (v == label) gold += z;
        if constexpr (KD) {
          const float zt = softcap(ztr[c], cap_t);
          ztr[c] = zt;
          tmax_t = fmaxf(tmax_t, zt);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, tmax, o);
      const int oa = __shfl_xor_sync(0xffffffffu, targ, o);
      if (om > tmax || (om == tmax && oa < targ)) { tmax = om; targ = oa; }
    }
    if (tmax > bmax) { bmax = tmax; barg = targ; }  // earliest tile wins
    const float m_new = fmaxf(m_s, tmax);
    float s_raw = 0.f, s_st = 0.f, s_tt = 0.f, s_u = 0.f, s_w = 0.f;
    float mst_new = 0.f, mtt_new = 0.f;
    if constexpr (KD) {
      mst_new = fmaxf(m_st, tmax * inv_tau);
      mtt_new = fmaxf(m_tt, max4(tmax_t) * inv_tau);
    }

    // pass 2: the sums of the online statistics
#pragma unroll 4
    for (int c4 = 0; c4 < BV / 4; ++c4) {
      const int c = 4 * c4 + part4, v = v0 + c;
      if (v < V) {
        const float z = zr[c];
        s_raw += expf(z - m_new);
        if constexpr (KD) {
          const float zs_t = z * inv_tau, zt_t = ztr[c] * inv_tau;
          s_st += expf(zs_t - mst_new);
          const float p = expf(zt_t - mtt_new);
          s_tt += p;
          s_u += p * zt_t;
          s_w += p * zs_t;
        }
      }
    }
    l_s = l_s * expf(m_s - m_new) + sum4(s_raw);
    m_s = m_new;
    if constexpr (KD) {
      l_st = l_st * expf(m_st - mst_new) + sum4(s_st);
      m_st = mst_new;
      const float corr = expf(m_tt - mtt_new);
      l_tt = l_tt * corr + sum4(s_tt);
      U = U * corr + sum4(s_u);
      W = W * corr + sum4(s_w);
      m_tt = mtt_new;
    }
    __syncthreads();  // sZ/sZt are rewritten by the next tile
  }
  gold = sum4(gold);

  if (part4 == 0 && row < T) {
    auto put = [&](Stat s, float x) {
      part[((size_t)s * n_splits + split) * T + row] = x;
    };
    put(M_S, m_s); put(L_S, l_s); put(GOLD, gold); put(BMAX, bmax);
    part_arg[(size_t)split * T + row] = barg;
    if constexpr (KD) {
      put(M_ST, m_st); put(L_ST, l_st); put(M_TT, m_tt); put(L_TT, l_tt);
      put(U_T, U); put(W_T, W);
    }
  }
}

// One thread per row: merge the splits' statistics and finalise.
template <bool KD>
__global__ void kd_merge_kernel(const float* __restrict__ part,
                                const int* __restrict__ part_arg,
                                const int* __restrict__ labels,
                                float* __restrict__ ce, float* __restrict__ kl,
                                float* __restrict__ correct, int T,
                                int n_splits, float tau) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  auto at = [&](Stat s, int i) {
    return part[((size_t)s * n_splits + i) * T + row];
  };
  // logsumexp of one side from its per-split (m, l)
  auto lse = [&](Stat sm, Stat sl, float* m_out, float* l_out) {
    float m = NEG_INF;
    for (int i = 0; i < n_splits; ++i) m = fmaxf(m, at(sm, i));
    float l = 0.f;
    for (int i = 0; i < n_splits; ++i) l += at(sl, i) * expf(at(sm, i) - m);
    if (m_out) *m_out = m;
    if (l_out) *l_out = l;
    return m + logf(fmaxf(l, 1e-30f));
  };
  float gold = 0.f, bmax = NEG_INF;
  int barg = 0;
  for (int i = 0; i < n_splits; ++i) {
    gold += at(GOLD, i);
    const float b = at(BMAX, i);
    if (b > bmax) { bmax = b; barg = part_arg[(size_t)i * T + row]; }
  }
  ce[row] = lse(M_S, L_S, nullptr, nullptr) - gold;
  correct[row] = barg == labels[row] ? 1.f : 0.f;
  if constexpr (KD) {
    const float lse_st = lse(M_ST, L_ST, nullptr, nullptr);
    float m_t, l_t;
    const float lse_tt = lse(M_TT, L_TT, &m_t, &l_t);
    float U = 0.f, W = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float s = expf(at(M_TT, i) - m_t);
      U += at(U_T, i) * s;
      W += at(W_T, i) * s;
    }
    const float lt = fmaxf(l_t, 1e-30f);
    kl[row] = tau * tau * ((U / lt - lse_tt) - (W / lt - lse_st));
  } else {
    kl[row] = 0.f;
  }
}

template <typename Tin, bool KD>
cudaError_t launch(const void* hs, const void* ws, const void* ht,
                   const void* wt, const int* labels, float* ce, float* kl,
                   float* correct, float* part, int* part_arg, int T, int Ds,
                   int Dt, int V, int n_splits, int tiles_per_split,
                   float tau, float cap_s, float cap_t, cudaStream_t stream) {
  constexpr size_t smem = STAGE_BYTES + TILE_BYTES * (KD ? 2 : 1);
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it on the first launch on each device, not on every launch
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kd_partial_kernel<Tin, KD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  const bool vec_s = Ds % 8 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  const bool vec_t =
      KD && Dt % 8 == 0 && reinterpret_cast<uintptr_t>(ht) % 16 == 0;
  dim3 grid((T + BT - 1) / BT, n_splits);
  kd_partial_kernel<Tin, KD><<<grid, NT, smem, stream>>>(
      static_cast<const Tin*>(hs), static_cast<const Tin*>(ws),
      static_cast<const Tin*>(ht), static_cast<const Tin*>(wt), labels, part,
      part_arg, T, Ds, Dt, V, tiles_per_split, tau, cap_s, cap_t, vec_s,
      vec_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kd_merge_kernel<KD><<<(T + 255) / 256, 256, 0, stream>>>(
      part, part_arg, labels, ce, kl, correct, T, n_splits, tau);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t dispatch(int with_teacher, const void* hs, const void* ws,
                     const void* ht, const void* wt, const int* labels,
                     float* ce, float* kl, float* correct, float* part,
                     int* part_arg, int T, int Ds, int Dt, int V,
                     int n_splits, int tiles_per_split, float tau,
                     float cap_s, float cap_t, cudaStream_t s) {
  if (with_teacher)
    return launch<Tin, true>(hs, ws, ht, wt, labels, ce, kl, correct, part,
                             part_arg, T, Ds, Dt, V, n_splits,
                             tiles_per_split, tau, cap_s, cap_t, s);
  return launch<Tin, false>(hs, ws, ht, wt, labels, ce, kl, correct, part,
                            part_arg, T, Ds, Dt, V, n_splits,
                            tiles_per_split, tau, cap_s, cap_t, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (hs, ws, ht, wt share it).  part holds
// NSTAT * n_splits * T floats, part_arg n_splits * T ints; splits cover
// tiles_per_split vocab tiles of 128 each.  Returns cudaGetLastError().
int kd_loss_fwd(const void* hs, const void* ws, const void* ht,
                const void* wt, const int* labels, float* ce, float* kl,
                float* correct, float* part, int* part_arg, int dtype, int T,
                int Ds, int Dt, int V, int n_splits, int tiles_per_split,
                int with_teacher, float tau, float softcap_s,
                float softcap_t, void* stream) {
  const int n_tiles = (V + BV - 1) / BV;
  if (T <= 0 || Ds <= 0 || V <= 0 || n_splits <= 0 || tiles_per_split <= 0 ||
      (n_splits - 1) * tiles_per_split >= n_tiles ||
      n_splits * tiles_per_split < n_tiles || !(tau > 0.f) ||
      (with_teacher && Dt <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(with_teacher, hs, ws, ht, wt, labels, ce, kl,
                                correct, part, part_arg, T, Ds, Dt, V,
                                n_splits, tiles_per_split, tau, softcap_s,
                                softcap_t, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(with_teacher, hs, ws, ht, wt, labels,
                                        ce, kl, correct, part, part_arg, T, Ds,
                                        Dt, V, n_splits, tiles_per_split, tau,
                                        softcap_s, softcap_t, s);
  return (int)cudaErrorInvalidValue;
}

int kd_loss_nstat() { return NSTAT; }

const char* kd_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
