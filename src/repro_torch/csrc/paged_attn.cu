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
// What bounds it.  A decode step reads every visible K/V row once and
// does about 4*D*G flops per row (G = H / KH query heads share a kv
// head), far below the H100's flop/byte balance: the bytes bound it,
// and at the serve path's shape (8 slots, contexts up to ~1k, TinyLlama's
// 4 kv heads) those bytes take about a microsecond at full bandwidth, so
// in practice the chain of dependent memory round trips and the launch
// bound it.  The TPU kernel walks a slot's table entries in order on one
// core, carrying the online softmax in VMEM; one block per (kv head,
// slot) on the H100 puts 32 blocks on 132 SMs and makes each walk its
// context serially, so time grows with tiles times latency.
//
// The design (flash-decoding, merged inside the same launch):
//
// * Split the context.  The grid is (KH, B, row chunks x n_split).  A
//   block takes RC = 8 query rows (the (c, g) pairs of the C chunk
//   positions and G query heads of one kv head, so each K/V row is read
//   once for all of them) and one slice of tiles_per_split tiles of TK
//   logical positions.  The wrapper picks the split from shapes only
//   (never from pos, so a decode step needs no host sync): enough blocks
//   for about two an SM.  A block walks only the part of its slice that
//   lies between the window's left edge and the last query; a slice
//   wholly outside it (the tail of a table as wide as max_len, whose
//   entries point at trash block 0, or keys left of the window) reads
//   no pool row and leaves an empty partial (l = 0).  The table entries
//   of a slice's first two tiles are read together with pos, to save a
//   round trip; an entry outside the walked keys is never used.
// * Merge in a fixed order, in the same launch.  A block writes its
//   unnormalised f32 partial (m, l, acc[RC x D]) to scratch, fences,
//   and counts itself in a per-(kv head, slot, row chunk) counter; the
//   block that brings the count to n_split merges the partials in split
//   order 0 .. n_split-1, each rescaled by exp(m_i - m), writes the
//   output rounded once, and resets the counter to 0.  The order is
//   fixed, so two launches on the same inputs give bit-identical
//   outputs, whichever block finishes last.  With n_split = 1 a block
//   writes its output directly (no scratch, no counter).
// * Overlap loads with work.  Raw pool rows (f32, bf16, int8 or fp8
//   bytes: not widened) come into a two-stage shared-memory ring with
//   16-byte cp.async (8-byte where a row is not a multiple of 16 bytes:
//   int8/fp8 at D = 24), together with each key's two scales (4-byte
//   cp.async); keys outside the walked range are zero-filled.  Tile
//   t+1's rows are in flight while tile t is scored, and tile t+2's
//   table entries are read while tile t is scored.  Rows are widened,
//   and scaled (quantized pools) in registers at use, as the reference
//   dequantizes each row before the scores.
// * Warps, not the block, own the work.  Eight warps: four pairs of
//   query rows times two key groups.  A warp scores its two rows against
//   its half of each tile's keys (a lane per key, or several lanes per
//   key splitting D where a half tile has fewer than 32 keys), takes the
//   row max and sum with shuffles, and accumulates P V for its two rows
//   with lanes over columns, in an online softmax of its own; the two
//   key groups' states merge once, at the slice's end, in group order.
//   Two block barriers a tile, none inside the softmax.  Scores, the
//   running max and denominator and the accumulator are f32; masked
//   pairs get probability exactly 0 (a row may have no visible key in a
//   tile or a whole slice yet).  No tensor cores: at G = 8 rows a kv
//   head there is too little work per byte for them to matter.
//
// On the H100 at the serve shape the launch and this chain of round
// trips still set the time (about four times the launch floor); at long
// contexts the CUDA-core work of a tile, not the bytes, does
// (scripts/paged_bench.py).
//
// Tiles are 64 keys, 32 or 16 for rows over 256 or 512 bytes, so the
// ring stays near 40 KB (about 66 KB at D = 256 in f32) and several
// blocks fit on an SM.  Shared-memory rows are padded to an odd number
// of copies, so lanes reading one copy of consecutive rows hit distinct
// banks.  Head dims built: those listed in by_dim.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int RC = 8;              // query rows per block
constexpr int RW = 2;              // query rows per warp
constexpr int KG = NWARP * RW / RC;  // key groups: warps sharing rows
constexpr int MAX_SPLITS = 64;     // slices of one (kv head, slot, chunk)
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RW == 2, "P is read as a float2 per key: two rows a warp");
static_assert(NWARP == RC, "the merge takes one row a warp");

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

// N consecutive elements of pool data in shared memory, widened to f32.
// p is aligned to the bytes read (N * sizeof(S) a power of two).
template <typename S, int N>
__device__ __forceinline__ void widen(const char* p, float* out) {
  using St = Storage<S>;
  constexpr int BYTES = N * (int)sizeof(S);
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int u = 0; u < BYTES / 16; ++u) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[u];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < St::PER_WORD; ++j)
          out[(u * 4 + m) * St::PER_WORD + j] = St::get(w[m], j);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < St::PER_WORD; ++j)
        out[m * St::PER_WORD + j] = St::get(w[m], j);
  } else {
    // 4, 2 or 1 bytes: one partial word (little-endian, low bytes first)
    uint32_t w;
    if constexpr (BYTES == 4) w = *reinterpret_cast<const uint32_t*>(p);
    if constexpr (BYTES == 2) w = *reinterpret_cast<const uint16_t*>(p);
    if constexpr (BYTES == 1) w = *reinterpret_cast<const uint8_t*>(p);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = St::get(w, j);
  }
}

// cp.async of N bytes (16: bypassing L1; 8 or 4: through it); with
// valid == false nothing is read and the N bytes are zero-filled
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keys per tile: 64, fewer for wide rows so the ring stays near 40 KB
__host__ __device__ constexpr int tile_keys(int row_bytes) {
  return row_bytes <= 256 ? 64 : row_bytes <= 512 ? 32 : 16;
}
// consecutive output columns a lane owns in P V (a power of two <= D/32)
__host__ __device__ constexpr int pv_width(int D) {
  return D >= 256 ? 8 : D >= 128 ? 4 : D >= 64 ? 2 : 1;
}

template <typename S, int D> struct Cfg {
  static constexpr int ES = sizeof(S);
  static constexpr int RB = D * ES;                 // bytes of a pool row
  static constexpr int VB = RB % 16 == 0 ? 16 : 8;  // bytes of one copy
  static constexpr int RPR = RB / VB;               // copies per row
  static constexpr int STRIDE = (RPR | 1) * VB;     // shared row pitch
  static constexpr int EPV = VB / ES;               // elements per copy
  static constexpr int TK = tile_keys(RB);
  static constexpr int WK = TK / KG;  // keys a warp scores, one a lane
  static constexpr int DPARTS = 32 / WK;  // lanes splitting a key's D
  static constexpr int W = pv_width(D);
  static constexpr int NG = (D / W + 31) / 32;  // column groups per lane
  static constexpr int NCP = TK * RPR;          // copies per tile and pool
  static constexpr int NCH = (NCP + NT - 1) / NT;  // ... per thread
  static constexpr int NE = (RC * D + NT - 1) / NT;  // of RC x D a thread
  // shared memory: the ring [stage][k, v][TK][STRIDE] bytes, the scales
  // [stage][k, v][TK], q [RC][D], P [warp][WK][RW], merge weights
  // [RC][MAX_SPLITS], merged l [RC], the last-block flag.  After the
  // walk the ring holds the key groups' states, then the slices' (m, l).
  static constexpr int RING = 2 * 2 * TK * STRIDE;
  static constexpr int SMEM =
      RING + 4 * (2 * 2 * TK + RC * D + NWARP * WK * RW + RC * MAX_SPLITS +
                  RC + 4);
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, <= 256");
  static_assert(RB % VB == 0 && EPV % 4 == 0, "row split");
  static_assert(D % W == 0 && WK <= 32 && 32 % WK == 0, "lane split");
  static_assert(RING >= 4 * (KG - 1) * RC * (D + 2) &&
                    RING >= MAX_SPLITS * RC * (int)sizeof(float2),
                "the ring holds the key groups' states and the (m, l)s");
  static_assert(SMEM <= 232448, "shared memory over the 227 KB opt-in");
};

// a thread's share of one tile's copies: the pool position
// (block * block_len + offset) of each, -1 where nothing is read, and
// that of key tid for the scales
template <int NCH> struct Fetch {
  int pos[NCH];
  int meta;
};

template <typename S, int D>
__global__ void __launch_bounds__(NT)
paged_fwd_kernel(const void* __restrict__ q, const char* __restrict__ kp,
                 const char* __restrict__ vp, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ bt,
                 const int* __restrict__ pos, void* __restrict__ o,
                 float* __restrict__ part, int* __restrict__ counters,
                 int q_bf16, int o_bf16, int B, int C, int H, int KH,
                 int block_len, int nbt, int window, float softcap,
                 float scale, int tiles_per_split, int n_split) {
  using K = Cfg<S, D>;
  using St = Storage<S>;
  constexpr int TK = K::TK, WK = K::WK;
  extern __shared__ __align__(16) char smem[];
  char* ring = smem;
  float* sScale = reinterpret_cast<float*>(smem + K::RING);
  float* sQ = sScale + 2 * 2 * TK;
  float* sP = sQ + RC * D;
  float* sW = sP + NWARP * WK * RW;
  float* sL = sW + RC * MAX_SPLITS;
  int* sLast = reinterpret_cast<int*>(sL + RC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rp = warp % (NWARP / KG), kg = warp / (NWARP / KG);
  const int row0 = rp * RW;  // this warp's first query row in the block
  const int kh = blockIdx.x, b = blockIdx.y;
  const int rc = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int G = H / KH, nrc = (C * G + RC - 1) / RC;
  const int r0 = rc * RC, nrows = min(RC, C * G - r0);
  const int group = (kh * B + b) * nrc + rc;
  const int L = nbt * block_len;  // logical positions the table holds

  // Loads that need no pos go out with it: q, and the table entries of
  // the slice's first two tiles (read, not yet taken as live).
  const int p0 = pos[b];
  const int s_t0 = split * tiles_per_split;  // the slice's first tile
  auto table_pos = [&](int p) -> int {       // pool position of key p
    return p < L ? bt[(size_t)b * nbt + p / block_len] * block_len +
                       p % block_len
                 : -1;
  };
  auto fetch = [&](Fetch<K::NCH>& f, int t) {
    const int k0 = t * TK;
#pragma unroll
    for (int i = 0; i < K::NCH; ++i) {
      const int e = tid + i * NT;
      f.pos[i] = e < K::NCP ? table_pos(k0 + e / K::RPR) : -1;
    }
    f.meta = St::QUANT && tid < TK ? table_pos(k0 + tid) : -1;
  };
  Fetch<K::NCH> f0, f1;
  fetch(f0, s_t0);
  fetch(f1, s_t0 + 1);
  float qx[K::NE];
#pragma unroll
  for (int k = 0; k < K::NE; ++k) {
    const int i = tid + k * NT, r = i / D, d = i % D;
    qx[k] = 0.f;
    if (i < RC * D && r < nrows) {
      const int row = r0 + r, c = row / G, g = row % G;
      qx[k] = load_f32(q, (((size_t)b * C + c) * H + kh * G + g) * D + d,
                       q_bf16);
    }
  }

  // keys [lo, hi): this block's slice, right of the window's left edge
  // and up to the last query
  const int k_hi = min(p0 + C, L);
  const int k_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  const int s_lo = s_t0 * TK;
  const int lo = max(s_lo, k_lo);
  const int hi = min(min(s_lo + tiles_per_split * TK, L), k_hi);
  const int t0 = lo / TK;
  const int t1 = lo < hi ? (hi + TK - 1) / TK : t0;

  // keep what tile t reads of [lo, hi) only
  auto clip = [&](Fetch<K::NCH>& f, int t) {
    const int k0 = t * TK;
#pragma unroll
    for (int i = 0; i < K::NCH; ++i) {
      const int p = k0 + (tid + i * NT) / K::RPR;
      if (p < lo || p >= hi) f.pos[i] = -1;
    }
    if (k0 + tid < lo || k0 + tid >= hi) f.meta = -1;
  };
  auto issue = [&](const Fetch<K::NCH>& f, int stage) {
    char* kd = ring + (size_t)stage * 2 * TK * K::STRIDE;
    char* vd = kd + TK * K::STRIDE;
#pragma unroll
    for (int i = 0; i < K::NCH; ++i) {
      const int e = tid + i * NT;
      if (e >= K::NCP) break;
      const int key = e / K::RPR, c = e % K::RPR;
      const bool ok = f.pos[i] >= 0;
      const size_t off =
          ok ? ((size_t)f.pos[i] * KH + kh) * K::RB + c * K::VB : 0;
      cp_async<K::VB>(kd + key * K::STRIDE + c * K::VB, kp + off, ok);
      cp_async<K::VB>(vd + key * K::STRIDE + c * K::VB, vp + off, ok);
    }
    if (St::QUANT && tid < TK) {
      const bool ok = f.meta >= 0;
      const size_t row = ok ? (size_t)f.meta * KH + kh : 0;
      float* sd = sScale + stage * 2 * TK;
      cp_async<4>(sd + tid, ks + row, ok);
      cp_async<4>(sd + TK + tid, vs + row, ok);
    }
  };

  // this warp's rows over its key group: running max, denominator, and
  // acc[r][g * W + j] for columns (lane + 32 g) * W + j
  float m[RW], l[RW], acc[RW][K::NG * K::W];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < K::NG * K::W; ++j) acc[r][j] = 0.f;
  }
  const bool active = row0 < nrows;
  // the key of the warp's half tile this lane scores, and its share of D
  const int key = lane % WK, dpart = lane / WK;

  if (t0 < t1) {
    if (t0 != s_t0) {  // a window cut the slice's start: read again
      fetch(f0, t0);
      fetch(f1, t0 + 1);
    }
    clip(f0, t0);
    issue(f0, 0);
    cp_async_commit();
    if (t0 + 1 < t1) {
      clip(f1, t0 + 1);
      issue(f1, 1);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < K::NE; ++k)
    if (tid + k * NT < RC * D) sQ[tid + k * NT] = qx[k];

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    const bool ahead = t + 2 < t1;
    Fetch<K::NCH> fn;
    if (ahead) fetch(fn, t + 2);  // in flight while tile t is scored
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int k0 = t * TK + kg * WK;  // this warp's keys of the tile
      const char* kt =
          ring + (size_t)stage * 2 * TK * K::STRIDE + kg * WK * K::STRIDE;
      const char* vt = kt + TK * K::STRIDE;
      const float* sks = sScale + stage * 2 * TK + kg * WK;
      const float* svs = sks + TK;
      float* wp = sP + warp * WK * RW;

      // scores of this warp's rows against the lane's key
      float sc[RW] = {};
      const char* krow = kt + key * K::STRIDE;
      const float kf = St::QUANT ? sks[key] : 1.f;
#pragma unroll
      for (int cc = 0; cc < (K::RPR + K::DPARTS - 1) / K::DPARTS; ++cc) {
        const int c = dpart + cc * K::DPARTS;
        if (K::RPR % K::DPARTS && c >= K::RPR) break;
        float x[K::EPV];
        widen<S, K::EPV>(krow + c * K::VB, x);
        if (St::QUANT) {
#pragma unroll
          for (int j = 0; j < K::EPV; ++j) x[j] *= kf;
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(
              sQ + (row0 + r) * D + c * K::EPV);
#pragma unroll
          for (int j = 0; j < K::EPV / 4; ++j) {
            const float4 qq = qv[j];
            sc[r] = fmaf(qq.x, x[4 * j], sc[r]);
            sc[r] = fmaf(qq.y, x[4 * j + 1], sc[r]);
            sc[r] = fmaf(qq.z, x[4 * j + 2], sc[r]);
            sc[r] = fmaf(qq.w, x[4 * j + 3], sc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int off = WK; off < 32; off <<= 1)
          sc[r] += __shfl_xor_sync(FULL, sc[r], off);

      // online softmax of each row over the warp's keys of the tile
      float corr[RW];
      const int kpos = k0 + key;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int qpos = p0 + (r0 + row0 + r) / G;
        float x = sc[r] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = kpos >= lo && kpos < hi && kpos <= qpos &&
                        (window <= 0 || kpos > qpos - window);
        float mx = ok ? x : NEG_INF;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float p = ok ? expf(x - m_new) : 0.f;
        float sum = 0.f;
        if (dpart == 0) {
          wp[key * RW + r] = p;
          sum = p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(FULL, sum, off);
        corr[r] = expf(m[r] - m_new);
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
      __syncwarp();

      // acc = acc * corr + P V over the warp's keys that were read
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int j = 0; j < K::NG * K::W; ++j) acc[r][j] *= corr[r];
      const int kb = max(lo - k0, 0), ke = min(hi - k0, WK);
#pragma unroll 4
      for (int k = kb; k < ke; ++k) {
        const float2 p2 = reinterpret_cast<const float2*>(wp)[k];
        const float pp[RW] = {p2.x, p2.y};
        const char* vrow = vt + k * K::STRIDE;
        const float vf = St::QUANT ? svs[k] : 1.f;
#pragma unroll
        for (int g = 0; g < K::NG; ++g) {
          const int col = (lane + 32 * g) * K::W;
          if (K::NG * 32 * K::W > D && col >= D) continue;
          float v[K::W];
          widen<S, K::W>(vrow + col * K::ES, v);
#pragma unroll
          for (int j = 0; j < K::W; ++j) {
            const float x = St::QUANT ? v[j] * vf : v[j];
#pragma unroll
            for (int r = 0; r < RW; ++r)
              acc[r][g * K::W + j] = fmaf(pp[r], x, acc[r][g * K::W + j]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (ahead) {
      clip(fn, t + 2);
      issue(fn, stage);
    }
    cp_async_commit();
  }

  // The key groups' states of a row merge into key group 0's warp in
  // group order, each weighted by exp(m_g - m) (the ring is free: every
  // copy has landed and been read).
  float* xacc = reinterpret_cast<float*>(ring);  // [KG - 1][RC][D]
  float2* xml = reinterpret_cast<float2*>(xacc + (KG - 1) * RC * D);
  if (active && kg > 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int xi = (kg - 1) * RC + row0 + r;
      if (lane == 0) xml[xi] = make_float2(m[r], l[r]);
#pragma unroll
      for (int g = 0; g < K::NG; ++g)
#pragma unroll
        for (int j = 0; j < K::W; ++j) {
          const int col = (lane + 32 * g) * K::W + j;
          if (col < D) xacc[xi * D + col] = acc[r][g * K::W + j];
        }
    }
  }
  __syncthreads();
  const bool writer = active && kg == 0;
  if (writer) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float2 st[KG];
      st[0] = make_float2(m[r], l[r]);
      float mx = l[r] > 0.f ? m[r] : NEG_INF;
#pragma unroll
      for (int k = 1; k < KG; ++k) {
        st[k] = xml[(k - 1) * RC + row0 + r];
        if (st[k].y > 0.f) mx = fmaxf(mx, st[k].x);
      }
      float w[KG], den = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        w[k] = st[k].y > 0.f ? expf(st[k].x - mx) : 0.f;
        den = fmaf(w[k], st[k].y, den);
      }
      m[r] = mx;
      l[r] = den;
#pragma unroll
      for (int g = 0; g < K::NG; ++g)
#pragma unroll
        for (int j = 0; j < K::W; ++j) {
          const int col = (lane + 32 * g) * K::W + j;
          if (col >= D) continue;
          float a = w[0] * acc[r][g * K::W + j];
#pragma unroll
          for (int k = 1; k < KG; ++k)
            a = fmaf(w[k], xacc[((k - 1) * RC + row0 + r) * D + col], a);
          acc[r][g * K::W + j] = a;
        }
    }
  }

  // this warp's rows: the output (one slice), or the partial
  auto out_index = [&](int r, int col) {
    const int row = r0 + r, c = row / G, g = row % G;
    return (((size_t)b * C + c) * H + kh * G + g) * D + col;
  };
  if (n_split == 1) {
    if (!writer) return;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (row0 + r >= nrows) continue;
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int g = 0; g < K::NG; ++g)
#pragma unroll
        for (int j = 0; j < K::W; ++j) {
          const int col = (lane + 32 * g) * K::W + j;
          if (col < D)
            store_f32(o, out_index(row0 + r, col), o_bf16,
                      acc[r][g * K::W + j] / den);
        }
    }
    return;
  }
  const size_t n_part = (size_t)KH * B * nrc * n_split;  // partials
  float* pacc = part + ((size_t)group * n_split + split) * RC * D;
  float2* pml = reinterpret_cast<float2*>(part + n_part * RC * D);
  if (writer) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int rr = row0 + r;
      if (rr >= nrows) continue;
      if (lane == 0)
        pml[((size_t)group * n_split + split) * RC + rr] =
            make_float2(m[r], l[r]);
      if (l[r] > 0.f) {  // a row with no visible key in the slice: skipped
#pragma unroll
        for (int g = 0; g < K::NG; ++g)
#pragma unroll
          for (int j = 0; j < K::W; ++j) {
            const int col = (lane + 32 * g) * K::W + j;
            if (col < D) pacc[rr * D + col] = acc[r][g * K::W + j];
          }
      }
    }
  }
  __threadfence();  // the partial is visible before the count
  __syncthreads();
  if (tid == 0) *sLast = atomicAdd(counters + group, 1) == n_split - 1;
  __syncthreads();
  if (!*sLast) return;
  __threadfence();

  // The last block merges the partials in split order.  The (m, l) of
  // every slice and the partial values of the first 8 slices are loaded
  // in one round (a slice's unwritten rows are loaded but weigh 0).
  const float2* gml = pml + (size_t)group * n_split * RC;
  const float* gacc = part + (size_t)group * n_split * RC * D;
  float2* sML = reinterpret_cast<float2*>(ring);  // [split][RC]
  constexpr int NM = MAX_SPLITS * RC / NT;
  float2 v[NM];
#pragma unroll
  for (int k = 0; k < NM; ++k)
    if (tid + k * NT < n_split * RC) v[k] = __ldcg(gml + tid + k * NT);
  float x[K::NE][8];
#pragma unroll
  for (int u = 0; u < K::NE; ++u) {
    const int e = tid + u * NT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[u][j] = e < nrows * D && j < n_split
                    ? __ldcg(gacc + (size_t)j * RC * D + e)
                    : 0.f;
  }
#pragma unroll
  for (int k = 0; k < NM; ++k)
    if (tid + k * NT < n_split * RC) sML[tid + k * NT] = v[k];
  __syncthreads();
  // weights: warp r takes row r, its lanes the slices
  if (warp < nrows) {
    float mv[MAX_SPLITS / 32], lv[MAX_SPLITS / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS / 32; ++k) {
      const int i = lane + 32 * k;
      const float2 e = i < n_split ? sML[i * RC + warp] : make_float2(0.f, 0.f);
      mv[k] = e.x;
      lv[k] = e.y;
      if (lv[k] > 0.f) mx = fmaxf(mx, mv[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS / 32; ++k) {
      const float w = lv[k] > 0.f ? expf(mv[k] - mx) : 0.f;
      if (lane + 32 * k < n_split) sW[warp * MAX_SPLITS + lane + 32 * k] = w;
      den = fmaf(w, lv[k], den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      den += __shfl_xor_sync(FULL, den, off);
    if (lane == 0) sL[warp] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < K::NE; ++u) {
    const int e = tid + u * NT;
    if (e >= nrows * D) break;
    const int r = e / D;
    const float* w = sW + r * MAX_SPLITS;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n_split && w[j] != 0.f) a = fmaf(w[j], x[u][j], a);
    for (int i0 = 8; i0 < n_split; i0 += 8) {  // 8 slices at a time
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = i0 + j < n_split ? __ldcg(gacc + (size_t)(i0 + j) * RC * D + e)
                                : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i0 + j < n_split && w[i0 + j] != 0.f)
          a = fmaf(w[i0 + j], y[j], a);
    }
    store_f32(o, out_index(r, e % D), o_bf16, a / sL[r]);
  }
  if (tid == 0) counters[group] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *bt, *pos;
  void* o;
  float* part;
  int* counters;
  int q_bf16, o_bf16, B, C, H, KH, block_len, nbt, window;
  float softcap, scale;
  int tiles_per_split, n_split;
  cudaStream_t stream;
};

template <typename S, int D>
cudaError_t launch(const Args& a) {
  using K = Cfg<S, D>;
  constexpr size_t smem = K::SMEM;
  const long long keys = (long long)a.nbt * a.block_len;
  const int tiles = (int)((keys + K::TK - 1) / K::TK);
  int tps = a.tiles_per_split;
  if (a.n_split == 1) {
    tps = tiles;
  } else if (a.n_split < 1 || a.n_split > MAX_SPLITS || tps < 1 ||
             (long long)tps * K::TK * a.n_split < keys || !a.part ||
             !a.counters) {
    return cudaErrorInvalidValue;
  }
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
  const int nrc = (a.C * (a.H / a.KH) + RC - 1) / RC;
  dim3 grid(a.KH, a.B, nrc * a.n_split);
  paged_fwd_kernel<S, D><<<grid, NT, smem, a.stream>>>(
      a.q, static_cast<const char*>(a.kp), static_cast<const char*>(a.vp),
      a.ks, a.vs, a.bt, a.pos, a.o, a.part, a.counters, a.q_bf16, a.o_bf16,
      a.B, a.C, a.H, a.KH, a.block_len, a.nbt, a.window, a.softcap, a.scale,
      tps, a.n_split);
  return cudaGetLastError();
}

// f(S{}, integral_constant<int, D>{}) for the instance of a pool dtype
// code and head dim: every head dim a config of the repository uses
template <typename S, typename F> cudaError_t by_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(S{}, std::integral_constant<int, 16>{});
    case 24: return f(S{}, std::integral_constant<int, 24>{});
    case 32: return f(S{}, std::integral_constant<int, 32>{});
    case 64: return f(S{}, std::integral_constant<int, 64>{});
    case 96: return f(S{}, std::integral_constant<int, 96>{});
    case 112: return f(S{}, std::integral_constant<int, 112>{});
    case 128: return f(S{}, std::integral_constant<int, 128>{});
    case 256: return f(S{}, std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}
template <typename F> cudaError_t by_instance(int kv_dtype, int D, F&& f) {
  switch (kv_dtype) {
    case 0: return by_dim<float>(D, f);
    case 1: return by_dim<__nv_bfloat16>(D, f);
    case 2: return by_dim<int8_t>(D, f);
    case 3: return by_dim<fp8_e4m3>(D, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype, out_dtype: 0 = float32, 1 = bfloat16.  kv_dtype (pools):
// 0 = float32, 1 = bfloat16, or 2 = int8, 3 = fp8 e4m3 with f32
// k_scale/v_scale (null otherwise).  Splits the context n_split ways:
// slice i holds tiles [i, i + 1) * tiles_per_split of the table's
// logical positions, and must together cover nbt * block_len.  With
// n = KH * B * ceil(C * H / KH / 8) groups of query rows, partials is f32
// scratch of n * n_split * 8 * (D + 2) floats and counters n int32
// zeros, which the launch leaves zero.  n_split = 1 needs neither.
// Returns cudaGetLastError().
int paged_attention_fwd_split(const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* block_table,
                              const void* pos, void* o, int q_dtype,
                              int kv_dtype, int out_dtype, int B, int C,
                              int H, int KH, int D, int block_len, int nbt,
                              int window, float softcap, float scale,
                              void* stream, void* partials, void* counters,
                              int tiles_per_split, int n_split) {
  const bool quant = kv_dtype == 2 || kv_dtype == 3;
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || block_len <= 0 ||
      nbt <= 0 || q_dtype < 0 || q_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || quant != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(block_table), static_cast<const int*>(pos),
         o, static_cast<float*>(partials), static_cast<int*>(counters),
         q_dtype, out_dtype, B, C, H, KH, block_len, nbt, window, softcap,
         scale, tiles_per_split, n_split, static_cast<cudaStream_t>(stream)};
  return (int)by_instance(kv_dtype, D, [&](auto s, auto d) {
    return launch<decltype(s), decltype(d)::value>(a);
  });
}

// The same without a split: one block per (kv head, slot, 8 query rows)
// walks the whole context and writes its output.
int paged_attention_fwd(const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* block_table,
                        const void* pos, void* o, int q_dtype, int kv_dtype,
                        int out_dtype, int B, int C, int H, int KH, int D,
                        int block_len, int nbt, int window, float softcap,
                        float scale, void* stream) {
  return paged_attention_fwd_split(q, k_pool, v_pool, k_scale, v_scale,
                                   block_table, pos, o, q_dtype, kv_dtype,
                                   out_dtype, B, C, H, KH, D, block_len, nbt,
                                   window, softcap, scale, stream, nullptr,
                                   nullptr, 0, 1);
}

// The instance's keys per tile and dynamic shared memory per block.
int paged_attention_config(int kv_dtype, int D, int* tile_keys_out,
                           int* smem_bytes_out) {
  return (int)by_instance(kv_dtype, D, [&](auto s, auto d) {
    using K = Cfg<decltype(s), decltype(d)::value>;
    *tile_keys_out = K::TK;
    *smem_bytes_out = K::SMEM;
    return cudaSuccess;
  });
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
