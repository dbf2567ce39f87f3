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
// Design.  The TPU kernel walks the R rows in order with a read-modify-
// write of the destination row, so its f32 sums run in row order.
// Atomic adds on the card would reorder them from run to run.  Here the
// wrapper (kernels/moe_dispatch/ops.py) sorts the row ids stably by
// destination and passes, per output row r, the segment
// seg[r] .. seg[r+1] of (source row, scale) pairs in original row order.
// One block per output row sums its segment in f32, in that order, with
// separately rounded products and sums (no FMA contraction), and writes
// the row once in src's dtype.  Rows with no segment are written as
// zeros.  So the result is deterministic and equals the in-order f32
// walk bit for bit.  Dropped assignments arrive with scale 0 and still
// add 0 * row, as in the reference.
//
// Bound.  Pure data movement: each moved source row read once, each
// output row written once.  On the path (dispatch 4096 tokens x top-4
// into 60 x 548 slots, D = 2048, bf16) that is 16384 rows read and
// 32880 rows written, about 202 MB: 0.060 ms at 3.35 TB/s.  Threads own
// strided columns, so a warp reads 64 contiguous bytes of a row per load
// and the writes are coalesced; wider vector loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int CPT = 8;    // columns per thread (strided by NT)

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

// grid (n_out, ceil(D / (NT * CPT))); block r sums rows seg[r]..seg[r+1]
template <typename T>
__global__ void __launch_bounds__(NT)
    gsa_kernel(const T* __restrict__ src, const int* __restrict__ rows,
               const float* __restrict__ scale, const int* __restrict__ seg,
               T* __restrict__ out, int D) {
  const int r = blockIdx.x;
  const int d0 = blockIdx.y * (NT * CPT) + threadIdx.x;
  const int beg = seg[r], end = seg[r + 1];
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  for (int j = beg; j < end; ++j) {
    const float s = scale[j];
    const T* p = src + (int64_t)rows[j] * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = d0 + c * NT;
      if (d < D) acc[c] = __fadd_rn(acc[c], __fmul_rn(s, to_f(p[d])));
    }
  }
  T* o = out + (int64_t)r * D;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = d0 + c * NT;
    if (d < D) o[d] = from_f<T>(acc[c]);
  }
}

template <typename T>
cudaError_t launch(const void* src, const int* rows, const float* scale,
                   const int* seg, void* out, int n_out, int D,
                   cudaStream_t s) {
  const dim3 grid(n_out, (D + NT * CPT - 1) / (NT * CPT));
  gsa_kernel<T><<<grid, NT, 0, s>>>(static_cast<const T*>(src), rows, scale,
                                    seg, static_cast<T*>(out), D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (src and out).  rows / scale: the R
// (source row, scale) pairs sorted stably by destination; seg: n_out + 1
// segment offsets into them.  Returns cudaGetLastError().
int gather_scatter_add(const void* src, int dtype, const int* rows,
                       const float* scale, const int* seg, void* out,
                       int n_out, int D, void* stream) {
  if (n_out <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(src, rows, scale, seg, out, n_out, D, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(src, rows, scale, seg, out, n_out, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
