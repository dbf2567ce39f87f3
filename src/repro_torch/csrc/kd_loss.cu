// Fused CE (+ temperature-tau KL) loss straight from hidden states.
//
// Replaces the Pallas TPU kernel repro/kernels/kd_loss/kernel.py:163
// (kd_loss_fwd / _kd_kernel).  Inputs hs (T, Ds), ws (Ds, V) row-major,
// labels (T,) int32 and, in KD mode, ht (T, Dt), wt (Dt, V); outputs
// three f32 vectors of length T: ce, kl (0 without a teacher), correct.
// The (T, V) logits never reach device memory: each vocab tile's logits
// are folded into per-row online statistics, as the TPU kernel does:
//   raw student logits z_s: m, l (logsumexp), gold logit, first argmax
//   KD mode, z_s/tau:       m, l
//           z_t/tau:        m, l, U = sum e^{z_t/tau-m} z_t/tau,
//                           W = sum e^{z_t/tau-m} z_s/tau
//   ce = lse_s - z_gold,  kl = tau^2 [(U/l_t - lse_t) - (W/l_t - lse_s)].
//
// Bound.  2*T*D*V flops (D = Ds + Dt in KD mode) on T*D + D*V input
// bytes: at the train path's shape (T 2048, D 2048, V 32000) 268 GFLOP
// against 139 MB, at the tune path's (V 151936) 1.27 TFLOP against 631
// MB, far above the H100's ~295 bf16 flops per byte: the tensor cores
// bound it (0.271 and 1.29 ms at 989 TFLOP/s).
//
// Parallelism.  The TPU walks the whole vocab of a row tile in series
// (its grid's vocab axis is sequential).  Here the grid is (row tiles,
// vocab splits), blockIdx.x fastest, so the blocks of one split run
// together and share its ws tiles in L2.  Each block walks a
// contiguous run of vocab tiles and writes its partial statistics per
// (split, row); a second small kernel merges the splits per row with
// the rescale-and-add of the online softmax (l, U, W scaled by
// e^{m_split - m}) and keeps "lowest vocab index wins" for the argmax
// by taking splits in vocab order with a strict >, as the TPU kernel
// takes its tiles.  No atomics: two launches on the same inputs give
// the same bits.
//
// Three instances, chosen by the wrapper from shapes and pointers:
//
// wgmma (bf16; Ds, Dt, V multiples of 8 and 16-byte-aligned bases, as
// TMA needs): kd_wgmma_kernel.  A block of 384 threads owns 128 rows.
//   * Operands come by TMA (tensor maps built on the host, 128-byte
//     swizzle, zero fill past the T, K and V edges) into a ring of 4
//     shared-memory stages of A 128 x 64 and B 64 x 256 (48 KB), each
//     with a full/empty mbarrier pair.  One producer thread issues the
//     copies; its warpgroup gives its registers up (setmaxnreg 40).
//   * Two consumer warpgroups (setmaxnreg 232) each multiply their 64
//     rows by the shared B tile with wgmma.mma_async m64nNk16, f32
//     accumulators in registers.  ws is read as it lies, (D, V) row
//     major: an MN-major B operand (wgmma's transpose bit), never
//     transposed in memory.  CE mode: N = 256, 128 accumulators a
//     thread.  KD mode: a student and a teacher tile of N = 128 each,
//     one K loop over Ds then one over Dt through the same ring, so
//     both logits of an element are in registers at once.
//   * The statistics come straight from the accumulators: each thread
//     holds two rows' columns 8j + 2q + {0,1} and keeps its own m, l,
//     gold and first argmax per row (and the KD sums); the 4 lanes of a
//     quad combine by shuffles once, at the end of the split (ties to
//     the lower index).  No logits tile in shared memory and no
//     __syncthreads per tile; only a split's last, ragged tile masks
//     columns v >= V.
// general (any other bf16 input): kd_partial_kernel.  64-row blocks,
//   128-column tiles by mma.sync m16n8k16 through a logits tile in
//   shared memory; operands staged through registers.
// f32: kd_partial_kernel on CUDA-core FMAs (f32 models only).
// bf16 x bf16 products are exact in f32 and are summed in f32, so the
// bf16 instances differ from the plain version only in summation order.
// The mbarrier, TMA and wgmma helpers and the host's tensor-map encoder
// are shared with moe_gemm.cu (tma_wgmma.cuh).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_wgmma.cuh"

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

// The shared-memory limit is a per-device attribute of a kernel: set it
// on the first launch on each device, not on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<bool> (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    ready[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// wgmma instance: TMA ring, warp-specialised, statistics from registers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;                 // rows per block (2 x 64)
constexpr int BK = 64;                  // K per stage: one 128-byte row
constexpr int BOX_N = 64;               // vocab columns per B box (128 B)
constexpr int NSTAGE = 4;
constexpr int A_BYTES = BM * BK * 2;    // 16 KB
constexpr int BOX_BYTES = BK * BOX_N * 2;               // 8 KB
constexpr int STAGE_BYTES = A_BYTES + 4 * BOX_BYTES;    // 48 KB
constexpr int NTHREADS = 384;           // consumers 0-255, producer 256+
// stages, 1 KB of slack to align them to the swizzle's 1 KB period, and
// the full/empty barriers
constexpr size_t SMEM = NSTAGE * STAGE_BYTES + 1024 + 2 * NSTAGE * 8;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One side's K loop for a consumer warpgroup: acc = A[its 64 rows] . B
// over nk stages.  A stage is released (one arrival per warpgroup) as
// soon as the products that read it are done, while the next stage's
// run.  A is K-major (advance 32 bytes a k16 step inside the swizzled
// row); B is MN-major: 8-row K groups 1 KB apart (SBO), 64-column boxes
// 8 KB apart (LBO), a k16 step 16 rows (2 KB) on.
template <int N>
__device__ __forceinline__ void mma_side(float (&acc)[N / 2], int nk,
                                         uint32_t base, uint32_t full,
                                         uint32_t empty, Ring<NSTAGE>& ring,
                                         int wg, bool leader) {
  int prev = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(full + 8 * ring.stage, ring.phase);
    const uint32_t s = base + ring.stage * STAGE_BYTES;
    const uint32_t a = s + wg * (A_BYTES / 2), b = s + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n<N, 0, 1>(acc, desc_sw128(a + kk * 32, 16, 1024),
                 desc_sw128(b + kk * 16 * 128, BOX_BYTES, 1024),
                 kb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (kb > 0 && leader) mbar_arrive(empty + 8 * prev);
    prev = ring.stage;
    ring.next();
  }
  wgmma_wait<0>();
  if (leader) mbar_arrive(empty + 8 * prev);
  fence_regs(acc);
}

// A thread's statistics of one row over the columns it holds.
struct Row {
  float m = NEG_INF, l = 0.f, gold = 0.f;  // raw student logits
  int arg = 0;                              // first index of m
  float l_st = 0.f;                         // student at tau: max m / tau
  float mt = NEG_INF, l_tt = 0.f;           // teacher: raw max, l at tau
  float u = 0.f, w = 0.f;  // sum p z_t, sum p z_s (p at tau), raw units
};

// Fold a CE tile (N = 256) into the rows' statistics.  d[4j + 2h + e] is
// row h's column 8j + 2q + e of the tile, i.e. vocab index vq + 8j + e;
// lim = V - vq, lc[h] = label - vq.  Each row: pass 1 masks, keeps the
// first maximum and the gold logit; pass 2 sums e^{z - m}.
template <bool RAGGED>
__device__ __forceinline__ void fold_ce(float (&d)[128], Row (&st)[2],
                                        const int (&lc)[2], int vq, int lim,
                                        float cap) {
  if (cap > 0.f) {
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = tanhf(d[i] / cap) * cap;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmx = NEG_INF;
    int tk = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * j + e, i = 4 * j + 2 * h + e;
        if (RAGGED && k >= lim) d[i] = NEG_INF;
        if (d[i] > tmx) {
          tmx = d[i];
          tk = k;
        }
        if (k == lc[h]) st[h].gold += d[i];
      }
    if (tmx > st[h].m) st[h].arg = vq + tk;  // an earlier tile keeps ties
    const float m_new = fmaxf(st[h].m, tmx);
    if (m_new > NEG_INF) {  // else this thread has seen no column yet
      const float mL = m_new * LOG2E;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s0 += ex2(fmaf(d[4 * j + 2 * h], LOG2E, -mL));
        s1 += ex2(fmaf(d[4 * j + 2 * h + 1], LOG2E, -mL));
      }
      st[h].l = st[h].l * ex2((st[h].m - m_new) * LOG2E) + (s0 + s1);
    }
    st[h].m = m_new;
  }
}

// Fold a KD tile pair (student ds, teacher dt, N = 128 each; layout as
// fold_ce's) into the rows' statistics.
template <bool RAGGED>
__device__ __forceinline__ void fold_kd(float (&ds)[64], float (&dt)[64],
                                        Row (&st)[2], const int (&lc)[2],
                                        int vq, int lim, float cap_s,
                                        float cap_t, float inv_tau) {
  if (cap_s > 0.f) {
#pragma unroll
    for (int i = 0; i < 64; ++i) ds[i] = tanhf(ds[i] / cap_s) * cap_s;
  }
  if (cap_t > 0.f) {
#pragma unroll
    for (int i = 0; i < 64; ++i) dt[i] = tanhf(dt[i] / cap_t) * cap_t;
  }
  const float Lt = inv_tau * LOG2E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    Row& r = st[h];
    float tmx = NEG_INF, tmt = NEG_INF;
    int tk = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * j + e, i = 4 * j + 2 * h + e;
        if (RAGGED && k >= lim) ds[i] = dt[i] = NEG_INF;
        if (ds[i] > tmx) {
          tmx = ds[i];
          tk = k;
        }
        if (k == lc[h]) r.gold += ds[i];
        tmt = fmaxf(tmt, dt[i]);
      }
    if (tmx > r.m) r.arg = vq + tk;
    const float m_new = fmaxf(r.m, tmx), mt_new = fmaxf(r.mt, tmt);
    if (m_new > NEG_INF) {
      const float mL = m_new * LOG2E, mLt = m_new * Lt, mtLt = mt_new * Lt;
      float s = 0.f, s_st = 0.f, s_tt = 0.f, s_u = 0.f, s_w = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float z = ds[i], zt = dt[i];
          s += ex2(fmaf(z, LOG2E, -mL));
          s_st += ex2(fmaf(z, Lt, -mLt));
          const float p = ex2(fmaf(zt, Lt, -mtLt));
          s_tt += p;
          s_u = fmaf(p, zt, s_u);
          s_w = fmaf(p, z, s_w);
        }
      r.l = r.l * ex2((r.m - m_new) * LOG2E) + s;
      r.l_st = r.l_st * ex2((r.m - m_new) * Lt) + s_st;
      const float c = ex2((r.mt - mt_new) * Lt);
      r.l_tt = r.l_tt * c + s_tt;
      r.u = r.u * c + s_u;
      r.w = r.w * c + s_w;
    }
    r.m = m_new;
    r.mt = mt_new;
  }
}

// Combine the 4 lanes of each quad (they share rows) and write the
// split's statistics in the layout the merge kernel reads.
template <bool KD>
__device__ __forceinline__ void write_rows(Row (&st)[2], const int (&row)[2],
                                           int q, int T, int split,
                                           int n_splits, float inv_tau,
                                           float* __restrict__ part,
                                           int* __restrict__ part_arg) {
  const float Lt = inv_tau * LOG2E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Row& r = st[h];
    const float mq = max4(r.m);
    const float l = sum4(r.l * ex2((r.m - mq) * LOG2E));
    const float gold = sum4(r.gold);
    float bm = r.m;
    int ba = r.arg;
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, bm, o);
      const int oa = __shfl_xor_sync(0xffffffffu, ba, o);
      if (om > bm || (om == bm && oa < ba)) {
        bm = om;
        ba = oa;
      }
    }
    float l_st = 0.f, mtq = 0.f, l_tt = 0.f, u = 0.f, w = 0.f;
    if constexpr (KD) {
      l_st = sum4(r.l_st * ex2((r.m - mq) * Lt));
      mtq = max4(r.mt);
      const float c = ex2((r.mt - mtq) * Lt);
      l_tt = sum4(r.l_tt * c);
      u = sum4(r.u * c);
      w = sum4(r.w * c);
    }
    if (q == 0 && row[h] < T) {
      auto put = [&](Stat s, float x) {
        part[((size_t)s * n_splits + split) * T + row[h]] = x;
      };
      put(M_S, mq); put(L_S, l); put(GOLD, gold); put(BMAX, mq);
      part_arg[(size_t)split * T + row[h]] = ba;
      if constexpr (KD) {
        put(M_ST, mq * inv_tau); put(L_ST, l_st); put(M_TT, mtq * inv_tau);
        put(L_TT, l_tt); put(U_T, u * inv_tau); put(W_T, w * inv_tau);
      }
    }
  }
}

// Per (128-row tile, vocab split).  Threads 0-255: two consumer
// warpgroups of 64 rows; thread 256: the producer.
template <bool KD>
__global__ void __launch_bounds__(NTHREADS, 1)
kd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_hs,
                const __grid_constant__ CUtensorMap tm_ws,
                const __grid_constant__ CUtensorMap tm_ht,
                const __grid_constant__ CUtensorMap tm_wt,
                const int* __restrict__ labels, float* __restrict__ part,
                int* __restrict__ part_arg, int T, int Ds, int Dt, int V,
                int tiles_per_split, float tau, float cap_s, float cap_t) {
  constexpr int BN = KD ? 128 : 256;  // vocab columns a tile (each side)
  constexpr int NBOX = BN / BOX_N;
  constexpr uint32_t TX = A_BYTES + NBOX * BOX_BYTES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = base + NSTAGE * STAGE_BYTES, empty = full + 8 * NSTAGE;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BM, split = blockIdx.y;
  const int n_tiles = (V + BN - 1) / BN;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  const int nks = (Ds + BK - 1) / BK, nkt = KD ? (Dt + BK - 1) / BK : 0;

  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 256) {
      Ring<NSTAGE> ring;
      for (int tile = tile_lo; tile < tile_hi; ++tile) {
        const int v0 = tile * BN;
#pragma unroll 1
        for (int side = 0; side < (KD ? 2 : 1); ++side) {
          const CUtensorMap* ma = side ? &tm_ht : &tm_hs;
          const CUtensorMap* mb = side ? &tm_wt : &tm_ws;
          const int nk = side ? nkt : nks;
          for (int kb = 0; kb < nk; ++kb) {
            mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
            const uint32_t f = full + 8 * ring.stage;
            const uint32_t s = base + ring.stage * STAGE_BYTES;
            mbar_expect_tx(f, TX);
            tma_load(s, ma, f, kb * BK, t0);
#pragma unroll
            for (int j = 0; j < NBOX; ++j)
              tma_load(s + A_BYTES + j * BOX_BYTES, mb, f, v0 + j * BOX_N,
                       kb * BK);
            ring.next();
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int q = lane & 3;
    const bool leader = (tid & 127) == 0;
    int row[2], lab[2];
    row[0] = t0 + wg * 64 + warp * 16 + (lane >> 2);
    row[1] = row[0] + 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) lab[h] = row[h] < T ? labels[row[h]] : -1;
    const float inv_tau = 1.f / tau;
    Row st[2];
    Ring<NSTAGE> ring;
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int v0 = tile * BN, vq = v0 + 2 * q, lim = V - vq;
      const int lc[2] = {lab[0] - vq, lab[1] - vq};
      const bool ragged = v0 + BN > V;
      if constexpr (KD) {
        float ds[64], dt[64];
        mma_side<128>(ds, nks, base, full, empty, ring, wg, leader);
        mma_side<128>(dt, nkt, base, full, empty, ring, wg, leader);
        if (ragged)
          fold_kd<true>(ds, dt, st, lc, vq, lim, cap_s, cap_t, inv_tau);
        else
          fold_kd<false>(ds, dt, st, lc, vq, lim, cap_s, cap_t, inv_tau);
      } else {
        float d[128];
        mma_side<256>(d, nks, base, full, empty, ring, wg, leader);
        if (ragged)
          fold_ce<true>(d, st, lc, vq, lim, cap_s);
        else
          fold_ce<false>(d, st, lc, vq, lim, cap_s);
      }
    }
    write_rows<KD>(st, row, q, T, split, gridDim.y, inv_tau, part, part_arg);
  }
}

}  // namespace tc

// a row-major (rows, cols) bf16 matrix in boxes of box_rows x 64 columns
bool make_map2(EncodeTiled enc, CUtensorMap* map, const void* p, int rows,
               int cols, int box_rows) {
  const int64_t dims[2] = {cols, rows}, strides[1] = {cols};
  return make_map(enc, map, p, 2, dims, strides, box_rows);
}

template <bool KD>
int launch_wgmma(const void* hs, const void* ws, const void* ht,
                 const void* wt, const int* labels, float* ce, float* kl,
                 float* correct, float* part, int* part_arg, int T, int Ds,
                 int Dt, int V, int n_splits, int tiles_per_split, float tau,
                 float cap_s, float cap_t, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  cudaError_t err = allow_smem(tc::kd_wgmma_kernel<KD>, tc::SMEM, ready);
  if (err != cudaSuccess) return err;
  EncodeTiled enc;
  const int status = tma_encoder(&enc);
  if (status != 0) return status;
  CUtensorMap m_hs, m_ws, m_ht = {}, m_wt = {};
  if (!make_map2(enc, &m_hs, hs, T, Ds, tc::BM) ||
      !make_map2(enc, &m_ws, ws, Ds, V, tc::BK))
    return ERR_ENCODE;
  if (KD && (!make_map2(enc, &m_ht, ht, T, Dt, tc::BM) ||
             !make_map2(enc, &m_wt, wt, Dt, V, tc::BK)))
    return ERR_ENCODE;
  dim3 grid((T + tc::BM - 1) / tc::BM, n_splits);
  tc::kd_wgmma_kernel<KD><<<grid, tc::NTHREADS, tc::SMEM, stream>>>(
      m_hs, m_ws, m_ht, m_wt, labels, part, part_arg, T, Ds, Dt, V,
      tiles_per_split, tau, cap_s, cap_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kd_merge_kernel<KD><<<(T + 255) / 256, 256, 0, stream>>>(
      part, part_arg, labels, ce, kl, correct, T, n_splits, tau);
  return cudaGetLastError();
}

template <typename Tin, bool KD>
cudaError_t launch(const void* hs, const void* ws, const void* ht,
                   const void* wt, const int* labels, float* ce, float* kl,
                   float* correct, float* part, int* part_arg, int T, int Ds,
                   int Dt, int V, int n_splits, int tiles_per_split,
                   float tau, float cap_s, float cap_t, cudaStream_t stream) {
  constexpr size_t smem = STAGE_BYTES + TILE_BYTES * (KD ? 2 : 1);
  static std::atomic<bool> ready[MAX_DEVICES];
  cudaError_t err = allow_smem(kd_partial_kernel<Tin, KD>, smem, ready);
  if (err != cudaSuccess) return err;
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

// The general and f32 instances.
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

// The wgmma instance: bf16 only; Ds, Dt and V multiples of 8 and every
// base 16-byte aligned (TMA's strides and addresses); splits cover
// tiles_per_split vocab tiles of 256 columns (128 with a teacher).  Other
// arguments as kd_loss_fwd's.  Returns cudaGetLastError(), or
// ERR_NO_ENCODE / ERR_ENCODE when no tensor map could be made.
int kd_loss_fwd_wgmma(const void* hs, const void* ws, const void* ht,
                      const void* wt, const int* labels, float* ce,
                      float* kl, float* correct, float* part, int* part_arg,
                      int T, int Ds, int Dt, int V, int n_splits,
                      int tiles_per_split, int with_teacher, float tau,
                      float softcap_s, float softcap_t, void* stream) {
  const int bn = with_teacher ? 128 : 256;
  const int n_tiles = (V + bn - 1) / bn;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (T <= 0 || Ds <= 0 || V <= 0 || Ds % 8 || V % 8 || n_splits <= 0 ||
      tiles_per_split <= 0 || (n_splits - 1) * tiles_per_split >= n_tiles ||
      n_splits * tiles_per_split < n_tiles || !(tau > 0.f) ||
      !aligned(hs) || !aligned(ws) ||
      (with_teacher && (Dt <= 0 || Dt % 8 || !aligned(ht) || !aligned(wt))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_teacher)
    return launch_wgmma<true>(hs, ws, ht, wt, labels, ce, kl, correct, part,
                              part_arg, T, Ds, Dt, V, n_splits,
                              tiles_per_split, tau, softcap_s, softcap_t, s);
  return launch_wgmma<false>(hs, ws, ht, wt, labels, ce, kl, correct, part,
                             part_arg, T, Ds, Dt, V, n_splits,
                             tiles_per_split, tau, softcap_s, softcap_t, s);
}

const char* kd_loss_error_string(int err) { return tma_error_string(err); }

}  // extern "C"
