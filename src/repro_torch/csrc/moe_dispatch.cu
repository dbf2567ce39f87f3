// Fused token permute/unpermute of a routed MoE layer:
//
//   out[dst_rows[i], :] += scale[i] * src[src_rows[i], :]     i = 0..R-1
//
// Replaces the Pallas TPU kernel repro/kernels/moe_dispatch/kernel.py
// (gather_scatter_add_rows / _gsa_kernel).  One primitive covers
// dispatch (tokens -> capacity slots, scale = keep), combine (slots ->
// tokens, scale = routing weight, 0 where dropped) and both backwards
// (the same movement with source and destination swapped).
//
// Order.  The TPU kernel walks the R rows in order with a read-modify-
// write of the destination row, so its f32 sums run in row order.
// Atomic adds on the card would reorder them from run to run.  So the
// wrapper (kernels/moe_dispatch/ops.py) groups the entries by
// destination once per routing (a layout: segment offsets seg[r] ..
// seg[r+1] into a stable order of the entries), and each output row's
// segment is summed in f32 in original row order, products and sums
// rounded separately (__fmul_rn / __fadd_rn, never a contracted FMA, as
// the plain version rounds them), the sum rounded once into the output
// dtype.  Rows with no segment are written as zeros.  The result equals
// the in-order f32 walk bit for bit.  Dropped assignments arrive with
// scale 0 and still add 0 * row, as in the reference.
//
// Bound.  Pure data movement: each source row that an entry names read
// once, each output row written once, 12 bytes of (row, scale, order) an
// entry.  At the tune path's shapes (4096 tokens x top-4 of 60 experts,
// capacity 548, D 2048, bf16; dispatch forward: 4096 rows read, 32,880
// written) that is 152 MB, 0.045 ms at 3.35 TB/s; the combine forward
// and the dispatch backward read at most 16,385 slot rows and write
// 4096 token rows (84 MB, 0.025 ms); the combine backward with its
// routing-weight gradient reads 4096 token rows and the 16,385 filled
// slots' rows of the forward's source and writes 32,880 slots (219 MB,
// 0.065 ms).
//
// Two instances, picked by ops.instance() before the launch:
//
// vec (rows whose bytes are whole 16-byte chunks on 16-byte-aligned
// bases).  A warp owns an output row.  Blocks are persistent: as many
// as fit on the card at once (the occupancy API), each warp walking rows
// r, r + W, ...  That is chosen over one warp per row in a sized grid so
// that a warp can prefetch its next row's segment bounds and the first
// entries' original indices while it moves the current row (each row
// otherwise waits on a chain of three dependent loads before a byte
// moves), and so that the long segments' units (below) run first on
// every warp of the same launch.  Each lane holds 8 chunks of 16 bytes
// a pass (2048 bf16 or 1024 f32 columns: the model's D in one pass);
// every load and store is 16 bytes a lane.  A segment's (row, scale)
// pairs are read by 32 lanes at once and broadcast by shuffles; all of
// an entry's loads are issued before any add, and the next entry's loads
// before the current entry's adds.  Source rows are read through the
// read-only path with an L2 evict_last policy (dispatch reads each token
// row top-k times); output rows are streamed with st.global.cs.  Empty
// rows are 16-byte zero stores that read nothing.  Source and output
// share one dtype: the backward reads dout in its own dtype (the forward
// output's, so src's) and writes dsrc in it, one rounding at the end:
// the same bits as an f32 copy of dout summed and then cast.  On an H100
// (700 W) the four movements take 0.067, 0.041, 0.041 and 0.098 ms
// against the bounds above (PERF.md).
//
// With dot_src (the backward with the scale's gradient), the same launch
// also computes dscale[i] = dot(dot_src[r], src[src_rows[i]]) for every
// entry i of output row r: the warp that owns r stages dot_src[r]'s pass
// in shared memory (4 KB a warp; in registers it spilled) beside the
// rows it already reads.  Each lane sums its columns' products in order
// (chunk by chunk, column by column), the 32 partials are folded by a
// fixed xor-shuffle tree (16, 8, 4, 2, 1), and passes are added in
// order: deterministic, though not .sum(-1)'s order.
//
// Long segments.  Dropped assignments all land in one segment (slot 0),
// 1 + drops entries long, which one warp would walk serially.  A finite
// row times scale 0 is +-0, and adding +-0 never changes an f32 sum that
// starts at +0, so in a segment longer than LONG the owning warp adds
// only the nonzero-scale entries, in order, and writes its f32 sums to
// scratch; the zero-scale entries are split into units of PIECE entries
// walked by every warp before its rows, each recording which columns
// hold an inf or NaN (which make 0 * row NaN) in a bitmap with atomicOr
// (order-free) and computing those entries' dscale.  Whichever of the
// owner and the units arrives last (a ticket per long row) writes the
// row: NaN where a bit is set, else the owner's sum; it leaves the
// scratch bitmap and ticket at zero for the next launch.  No warp waits
// on another.
//
// general (any other row length or base).  The first port's kernel:
// one block of 256 threads per output row, columns strided by 256,
// 2-byte loads (bf16), the same order and roundings, long segments
// walked whole.  With dot_src the block walks every column tile of its
// row itself and forms each entry's dscale in the same launch: a
// thread's columns in order, the shuffle tree, the 8 warps in order,
// tiles in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the fixed shuffle tree of the dot products: every lane ends with the
// same value (a + b == b + a)
__device__ __forceinline__ float tree_sum(float p) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
  return p;
}

// ---------------------------------------------------------------------------
// general: one block per output row
// ---------------------------------------------------------------------------

constexpr int NT = 256;   // threads per block
constexpr int CPT = 8;    // columns per thread (strided by NT)

// grid (n_out, tiles): block r sums entries seg[r]..seg[r+1] over the
// column tiles of NT * CPT it takes (one a block without the dot; with
// it, grid.y is 1 and the block walks them all, in order)
template <typename T, bool DOT>
__global__ void __launch_bounds__(NT)
    gsa_kernel(const T* __restrict__ src, const int* __restrict__ src_rows,
               const float* __restrict__ scale, const int* __restrict__ order,
               const int* __restrict__ seg, T* __restrict__ out, int D,
               const T* __restrict__ dot_src, float* __restrict__ dscale) {
  __shared__ float part[NT / 32];
  const int r = blockIdx.x;
  const int beg = seg[r], end = seg[r + 1];
  for (int t0 = blockIdx.y * (NT * CPT); t0 < D;
       t0 += gridDim.y * (NT * CPT)) {
    const int d0 = t0 + threadIdx.x;
    float acc[CPT], y[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = d0 + c * NT;
      acc[c] = 0.f;
      if constexpr (DOT)
        y[c] = d < D ? to_f(dot_src[(int64_t)r * D + d]) : 0.f;
    }
    for (int j = beg; j < end; ++j) {
      const int i = order ? order[j] : j;
      const float s = scale[i];
      const T* p = src + (int64_t)src_rows[i] * D;
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = d0 + c * NT;
        if (d < D) {
          const float x = to_f(p[d]);
          acc[c] = __fadd_rn(acc[c], __fmul_rn(s, x));
          if constexpr (DOT) q = __fadd_rn(q, __fmul_rn(y[c], x));
        }
      }
      if constexpr (DOT) {   // the block's sum, in a fixed order
        q = tree_sum(q);
        if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = q;
        __syncthreads();
        if (threadIdx.x == 0) {
          float t = part[0];
#pragma unroll
          for (int w = 1; w < NT / 32; ++w) t = __fadd_rn(t, part[w]);
          dscale[i] = t0 ? __fadd_rn(dscale[i], t) : t;
        }
        __syncthreads();
      }
    }
    T* o = out + (int64_t)r * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = d0 + c * NT;
      if (d < D) o[d] = from_f<T>(acc[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// vec: a warp per output row, 16-byte accesses
// ---------------------------------------------------------------------------

namespace vec {

constexpr int WARPS = 4;    // warps a block
constexpr int LONG = 64;    // segments longer than this split (> PIECE)
constexpr int PIECE = 32;   // entries of a unit of a long segment's walk
constexpr int SCAN = 8;     // groups of 32 entries an owner scans at once

// CW columns a chunk (one 16-byte access), NV chunks a lane a pass
template <typename T>
struct Cfg {
  static constexpr int CW = 16 / (int)sizeof(T);
  static constexpr int NV = 8;
  static constexpr int PASS = 32 * NV;      // chunks a pass
};

struct Args {
  const void* src;             // (Ns, D) T
  void* out;                   // (n_out, D) T
  const int* src_rows;         // (R,) source row of entry i
  const float* scale;          // (R,)
  const int* order;            // (R,) entry at sorted position j; null: j
  const int* seg;              // (n_out + 1,)
  const int* dst_sorted;       // (R,) destination at sorted position j;
                               // null: no segment is split
  float* long_sum;             // (ceil(R / PIECE), D) owners' f32 sums
  unsigned long long* long_bits;  // (ceil(R / PIECE), bits_stride), zero
  const void* dot_src;         // (n_out, D) T or null
  float* dscale;               // (R,) or null
  int n_out, D, R, n_pass, bits_stride;
};

__device__ __forceinline__ uint4 ld_keep(const void* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint4 ld_plain(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// a chunk's CW values, from its 16-byte load
template <typename T>
__device__ __forceinline__ void unpack(uint4 v, float (&x)[Cfg<T>::CW]) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// CW f32 values rounded once into T, as one 16-byte word
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&x)[Cfg<T>::CW]) {
  if constexpr (sizeof(T) == 2)
    return make_uint4(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                      bf16_bits(x[2]) | bf16_bits(x[3]) << 16,
                      bf16_bits(x[4]) | bf16_bits(x[5]) << 16,
                      bf16_bits(x[6]) | bf16_bits(x[7]) << 16);
  else
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
}

template <typename T>
struct Warp {
  using C = Cfg<T>;
  const Args& a;
  const int lane;
  const int nchunks;    // D / CW
  uint4* const staged;  // the warp's shared slot for dot_src's row
  uint64_t keep;        // L2 evict_last policy

  __device__ Warp(const Args& args, int l, uint4* slot)
      : a(args), lane(l), nchunks(args.D / C::CW), staged(slot) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  }

  __device__ __forceinline__ int chunk(int pass, int m) const {
    return pass * C::PASS + m * 32 + lane;
  }
  __device__ __forceinline__ int index(int j) const {
    return a.order ? __ldg(a.order + j) : j;
  }

  // one row's chunks of a pass: 16-byte loads, all issued at once
  __device__ __forceinline__ void load(uint4 (&v)[C::NV], const void* base,
                                       int row, int pass, bool keep_l2) const {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const char*>(base) + (int64_t)row * a.D * (int64_t)sizeof(T));
#pragma unroll
    for (int m = 0; m < C::NV; ++m) {
      const int c = chunk(pass, m);
      v[m] = c < nchunks ? (keep_l2 ? ld_keep(p + c, keep) : ld_plain(p + c))
                         : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void add(float (&acc)[C::NV][C::CW],
                                      const uint4 (&v)[C::NV], float s) const {
#pragma unroll
    for (int m = 0; m < C::NV; ++m) {
      float x[C::CW];
      unpack<T>(v[m], x);
#pragma unroll
      for (int k = 0; k < C::CW; ++k)
        acc[m][k] = __fadd_rn(acc[m][k], __fmul_rn(s, x[k]));
    }
  }

  // dot_src's row r, this pass's chunks, into the warp's shared slot:
  // each lane stages and later reads only its own chunks (no sync)
  __device__ __forceinline__ void stage(int r, int pass) const {
    uint4 v[C::NV];
    load(v, a.dot_src, r, pass, false);
#pragma unroll
    for (int m = 0; m < C::NV; ++m) staged[m * 32 + lane] = v[m];
  }

  // dscale[i] (+)= this pass's dot of the entry with the staged row
  __device__ __forceinline__ void dot(const uint4 (&v)[C::NV], int i,
                                      int pass) const {
    float p = 0.f;
#pragma unroll
    for (int m = 0; m < C::NV; ++m) {
      if (chunk(pass, m) >= nchunks) continue;
      float x[C::CW], y[C::CW];
      unpack<T>(v[m], x);
      unpack<T>(staged[m * 32 + lane], y);
#pragma unroll
      for (int k = 0; k < C::CW; ++k) p = __fadd_rn(p, __fmul_rn(y[k], x[k]));
    }
    p = tree_sum(p);
    if (lane == 0) a.dscale[i] = pass ? __fadd_rn(a.dscale[i], p) : p;
  }

  __device__ __forceinline__ void store(int r, int pass,
                                        const float (&acc)[C::NV][C::CW]) const {
    uint4* o = reinterpret_cast<uint4*>(
        static_cast<char*>(a.out) + (int64_t)r * a.D * (int64_t)sizeof(T));
#pragma unroll
    for (int m = 0; m < C::NV; ++m) {
      const int c = chunk(pass, m);
      if (c < nchunks) st_stream(o + c, pack<T>(acc[m]));
    }
  }

  __device__ void zero_row(int r) const {
    uint4* o = reinterpret_cast<uint4*>(
        static_cast<char*>(a.out) + (int64_t)r * a.D * (int64_t)sizeof(T));
    for (int c = lane; c < nchunks; c += 32)
      st_stream(o + c, make_uint4(0, 0, 0, 0));
  }

  // a segment of at most LONG entries: every entry in order, the next
  // entry's loads in flight during the current one's adds.  pi: the
  // lane's entry of the first group (prefetched), beg + lane < end.
  template <bool DOT>
  __device__ void walk(int r, int beg, int end, int pi) const {
    for (int pass = 0; pass < a.n_pass; ++pass) {
      float acc[C::NV][C::CW];
#pragma unroll
      for (int m = 0; m < C::NV; ++m)
#pragma unroll
        for (int k = 0; k < C::CW; ++k) acc[m][k] = 0.f;
      if constexpr (DOT) stage(r, pass);
      int gi = pass == 0 ? pi : (beg + lane < end ? index(beg + lane) : 0);
      int grow = 0;
      float gs = 0.f;
      if (beg + lane < end) {
        grow = __ldg(a.src_rows + gi);
        gs = __ldg(a.scale + gi);
      }
      int row = __shfl_sync(0xffffffffu, grow, 0);
      float s = __shfl_sync(0xffffffffu, gs, 0);
      int ii = __shfl_sync(0xffffffffu, gi, 0);
      uint4 cur[C::NV], nxt[C::NV];
      load(cur, a.src, row, pass, true);
      for (int j = beg; j < end; ++j) {
        const float sc = s;
        const int ic = ii;
        if (j + 1 < end) {
          const int l = (j + 1 - beg) & 31;
          if (l == 0) {
            const int jj = j + 1 + lane;
            if (jj < end) {
              gi = index(jj);
              grow = __ldg(a.src_rows + gi);
              gs = __ldg(a.scale + gi);
            }
          }
          row = __shfl_sync(0xffffffffu, grow, l);
          s = __shfl_sync(0xffffffffu, gs, l);
          ii = __shfl_sync(0xffffffffu, gi, l);
          load(nxt, a.src, row, pass, true);
        }
        add(acc, cur, sc);
        if constexpr (DOT) dot(cur, ic, pass);
#pragma unroll
        for (int m = 0; m < C::NV; ++m) cur[m] = nxt[m];
      }
      store(r, pass, acc);
    }
  }

  __device__ __forceinline__ unsigned long long* bits(int slot) const {
    return a.long_bits + (int64_t)slot * a.bits_stride;
  }

  // the last of a long row's contributors writes it: NaN where a zero-
  // scale row held an inf or NaN, else the owner's in-order sum; then
  // the slot's bitmap and ticket return to zero
  __device__ void finish(int r, int slot) const {
    const float* sum = a.long_sum + (int64_t)slot * a.D;
    for (int pass = 0; pass < a.n_pass; ++pass) {
      const unsigned long long b = __ldcg(bits(slot) + pass * 32 + lane);
      float acc[C::NV][C::CW];
#pragma unroll
      for (int m = 0; m < C::NV; ++m) {
        const int c = chunk(pass, m);
#pragma unroll
        for (int k = 0; k < C::CW; ++k) {
          const float v = c < nchunks ? __ldcg(sum + (int64_t)c * C::CW + k)
                                      : 0.f;
          acc[m][k] = (b >> (m * C::CW + k)) & 1ull ? __int_as_float(0x7fffffff)
                                                   : v;
        }
      }
      store(r, pass, acc);
      bits(slot)[pass * 32 + lane] = 0ull;
    }
    if (lane == 0) bits(slot)[a.bits_stride - 1] = 0ull;
  }

  // one contribution to long row r (first entry b, end e) is in place
  __device__ void arrive(int r, int b, int e) const {
    const int slot = b / PIECE;
    const unsigned long long want =
        (unsigned long long)((e - 1) / PIECE - b / PIECE + 2);
    __threadfence();
    __syncwarp();
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(bits(slot) + a.bits_stride - 1, 1ull);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t + 1 == want) {
      __threadfence();
      finish(r, slot);
    }
  }

  // the owner of a long segment: its nonzero-scale entries in order
  template <bool DOT>
  __device__ void own(int r, int beg, int end) const {
    const int slot = beg / PIECE;
    float* sum = a.long_sum + (int64_t)slot * a.D;
    for (int pass = 0; pass < a.n_pass; ++pass) {
      float acc[C::NV][C::CW];
#pragma unroll
      for (int m = 0; m < C::NV; ++m)
#pragma unroll
        for (int k = 0; k < C::CW; ++k) acc[m][k] = 0.f;
      if constexpr (DOT) stage(r, pass);
      for (int j0 = beg; j0 < end; j0 += 32 * SCAN) {
        int ii[SCAN];
        float ss[SCAN];
#pragma unroll
        for (int u = 0; u < SCAN; ++u) {
          const int j = j0 + 32 * u + lane;
          ii[u] = j < end ? index(j) : -1;
        }
#pragma unroll
        for (int u = 0; u < SCAN; ++u)
          ss[u] = ii[u] >= 0 ? __ldg(a.scale + ii[u]) : 0.f;
#pragma unroll
        for (int u = 0; u < SCAN; ++u) {
          unsigned mask = __ballot_sync(0xffffffffu, ii[u] >= 0 && ss[u] != 0.f);
          while (mask) {
            const int l = __ffs(mask) - 1;
            mask &= mask - 1;
            const int i = __shfl_sync(0xffffffffu, ii[u], l);
            const float s = __shfl_sync(0xffffffffu, ss[u], l);
            uint4 v[C::NV];
            load(v, a.src, __ldg(a.src_rows + i), pass, true);
            add(acc, v, s);
            if constexpr (DOT) dot(v, i, pass);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < C::NV; ++m) {
        const int c = chunk(pass, m);
        if (c >= nchunks) continue;
#pragma unroll
        for (int k = 0; k < C::CW; k += 4)
          *reinterpret_cast<float4*>(sum + (int64_t)c * C::CW + k) =
              make_float4(acc[m][k], acc[m][k + 1], acc[m][k + 2],
                          acc[m][k + 3]);
      }
    }
    arrive(r, beg, end);
  }

  // unit u of the entries: the zero-scale entries of long segments in it
  template <bool DOT>
  __device__ void unit(int u) const {
    const int j0 = u * PIECE;
    const int j1 = min(a.R, j0 + PIECE);
    const int r0 = __ldg(a.dst_sorted + j0);
    const int r1 = __ldg(a.dst_sorted + j1 - 1);
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (h && r1 == r0) break;
      const int b = __ldg(a.seg + r), e = __ldg(a.seg + r + 1);
      if (e - b <= LONG) continue;
      const int lo = max(j0, b), hi = min(j1, e);
      const int j = lo + lane;
      const int i = j < hi ? index(j) : 0;
      const float s = j < hi ? __ldg(a.scale + i) : 1.f;
      const int row = j < hi && s == 0.f ? __ldg(a.src_rows + i) : 0;
      const unsigned zero = __ballot_sync(0xffffffffu, j < hi && s == 0.f);
      for (int pass = 0; pass < a.n_pass; ++pass) {
        if constexpr (DOT) stage(r, pass);
        unsigned long long nonfinite = 0;
        uint4 cur[C::NV], nxt[C::NV];
        unsigned mask = zero;
        if (mask)
          load(cur, a.src, __shfl_sync(0xffffffffu, row, __ffs(mask) - 1),
               pass, true);
        while (mask) {   // the next entry's loads in flight meanwhile
          const int il = __shfl_sync(0xffffffffu, i, __ffs(mask) - 1);
          mask &= mask - 1;
          if (mask)
            load(nxt, a.src, __shfl_sync(0xffffffffu, row, __ffs(mask) - 1),
                 pass, true);
#pragma unroll
          for (int m = 0; m < C::NV; ++m) {
            float x[C::CW];
            unpack<T>(cur[m], x);
#pragma unroll
            for (int k = 0; k < C::CW; ++k)
              if (!isfinite(x[k])) nonfinite |= 1ull << (m * C::CW + k);
          }
          if constexpr (DOT) dot(cur, il, pass);
#pragma unroll
          for (int m = 0; m < C::NV; ++m) cur[m] = nxt[m];
        }
        if (nonfinite) atomicOr(bits(b / PIECE) + pass * 32 + lane, nonfinite);
      }
      arrive(r, b, e);
    }
  }
};

template <typename T, bool DOT>
__global__ void __launch_bounds__(WARPS * 32)
    gsa_vec_kernel(const __grid_constant__ Args a) {
  // dot_src's row a pass, kept in shared memory, not in registers
  constexpr int SLOT = 32 * Cfg<T>::NV;
  __shared__ uint4 staged[DOT ? WARPS * SLOT : 1];
  const Warp<T> w(a, threadIdx.x & 31,
                       staged + (DOT ? (threadIdx.x >> 5) * SLOT : 0));
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nw = gridDim.x * WARPS;
  if (a.dst_sorted) {
    const int n_units = (a.R + PIECE - 1) / PIECE;
    for (int u = gw; u < n_units; u += nw) w.template unit<DOT>(u);
  }
  int r = gw, beg = 0, end = 0, pi = 0;
  if (r < a.n_out) {
    beg = __ldg(a.seg + r);
    end = __ldg(a.seg + r + 1);
    if (beg + w.lane < end) pi = w.index(beg + w.lane);
  }
  while (r < a.n_out) {
    const int rn = r + nw;
    int nbeg = 0, nend = 0;
    if (rn < a.n_out) {   // the next row's bounds, in flight meanwhile
      nbeg = __ldg(a.seg + rn);
      nend = __ldg(a.seg + rn + 1);
    }
    if (end == beg)
      w.zero_row(r);
    else if (a.dst_sorted && end - beg > LONG)
      w.template own<DOT>(r, beg, end);
    else
      w.template walk<DOT>(r, beg, end, pi);
    // the next row's first entries (the order gather), in flight
    // across the loop's turn
    pi = nbeg + w.lane < nend ? w.index(nbeg + w.lane) : 0;
    r = rn;
    beg = nbeg;
    end = nend;
  }
}

}  // namespace vec

template <typename T>
cudaError_t launch_general(const void* src, const int* src_rows,
                           const float* scale, const int* order,
                           const int* seg, void* out, int n_out, int D,
                           const void* dot_src, float* dscale,
                           cudaStream_t s) {
  const T* ts = static_cast<const T*>(src);
  T* to = static_cast<T*>(out);
  if (dot_src)
    gsa_kernel<T, true><<<dim3(n_out, 1), NT, 0, s>>>(
        ts, src_rows, scale, order, seg, to, D,
        static_cast<const T*>(dot_src), dscale);
  else
    gsa_kernel<T, false>
        <<<dim3(n_out, (D + NT * CPT - 1) / (NT * CPT)), NT, 0, s>>>(
            ts, src_rows, scale, order, seg, to, D, nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T, bool DOT>
cudaError_t launch_vec_dot(const vec::Args& a, cudaStream_t s) {
  static std::atomic<int> per_sm[MAX_DEVICES];
  auto kernel = vec::gsa_vec_kernel<T, DOT>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int blocks = per_sm[dev].load();
  if (blocks == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        vec::WARPS * 32, 0);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev].store(blocks);
  }
  const int units = a.dst_sorted ? (a.R + vec::PIECE - 1) / vec::PIECE : 0;
  const int work = a.n_out > units ? a.n_out : units;
  const int64_t need = (work + vec::WARPS - 1) / vec::WARPS;
  const int64_t fit = (int64_t)blocks * sms;
  const int grid = (int)(need < fit ? need : fit);
  kernel<<<grid, vec::WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const vec::Args& a, cudaStream_t s) {
  return a.dot_src ? launch_vec_dot<T, true>(a, s)
                   : launch_vec_dot<T, false>(a, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype codes (src, out and dot_src share one): 0 = float32, 1 =
// bfloat16.  src_rows, scale: per entry i in original order; order
// (null: the identity) lists the entries grouped by destination, stably;
// seg: n_out + 1 offsets into it.  With dot_src ((n_out, D)) also
// dscale[i] = dot(dot_src[r], src[src_rows[i]]) for each entry i of
// output row r.  One launch; returns cudaGetLastError().

// general: any D and alignment
int gather_scatter_add_general(const void* src, int dtype,
                               const int* src_rows, const float* scale,
                               const int* order, const int* seg, void* out,
                               int n_out, int D, const void* dot_src,
                               float* dscale, void* stream) {
  if (n_out <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (dot_src && !dscale) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_general<float>(src, src_rows, scale, order, seg, out,
                                      n_out, D, dot_src, dscale, s);
  if (dtype == 1)
    return (int)launch_general<__nv_bfloat16>(src, src_rows, scale, order,
                                              seg, out, n_out, D, dot_src,
                                              dscale, s);
  return (int)cudaErrorInvalidValue;
}

// vec: refuses a row that is not whole 16-byte chunks (D % 8 in bf16,
// D % 4 in f32) and bases off 16-byte alignment.  dst_sorted (null:
// every segment is walked whole, however long) with its scratch:
// long_sum ceil(R / 32) x D floats, long_bits ceil(R / 32) x bits_stride
// words, zero, bits_stride >= 32 x passes + 1 (a pass: 2048 bf16 or
// 1024 f32 columns).
int gather_scatter_add_vec(const void* src, int dtype, void* out,
                           const int* src_rows, const float* scale,
                           const int* order, const int* seg,
                           const int* dst_sorted, float* long_sum,
                           void* long_bits, int bits_stride,
                           const void* dot_src, float* dscale, int n_out,
                           int D, int R, void* stream) {
  if (n_out <= 0 || D <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int cw = dtype == 1 ? 8 : 4;
  const int pass_cols = 32 * vec::Cfg<float>::NV * cw;
  const int n_pass = (D + pass_cols - 1) / pass_cols;
  if (D % cw != 0 || !aligned16(src) || !aligned16(out) ||
      (dot_src && (!aligned16(dot_src) || !dscale)))
    return (int)cudaErrorInvalidValue;
  if (dst_sorted && (!long_sum || !long_bits || bits_stride < 32 * n_pass + 1 ||
                     !aligned16(long_sum)))
    return (int)cudaErrorInvalidValue;
  vec::Args a{src, out, src_rows, scale, order, seg, dst_sorted, long_sum,
              static_cast<unsigned long long*>(long_bits), dot_src, dscale,
              n_out, D, R, n_pass, bits_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_vec<__nv_bfloat16>(a, s)
                          : launch_vec<float>(a, s));
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
