// Row template, streaming layout (LAYOUT 2, row_stream_kernel): rows too
// wide to hold in registers, such as the fused softmax-CE loss over a
// vocabulary row (V = 32,000 to 262,144 columns).  Included by row.cuh,
// whose row_launch starts it.
//
// The warp layout keeps every row-wide value of the program in registers,
// V / 32 floats a lane per value: at V = 256,000 the loss's backward holds
// 11 of them, 352 KB of local memory a thread, more than the card can
// reserve for its resident threads.  Here no row-wide value is kept.
//
// Layout: a CTA of T threads per row, a persistent grid of CTAS CTAs per
// SM walking rows i = blockIdx.x, + gridDim.x, ...  cuda_src.py splits the
// program into passes at each row aggregate over a row-wide value: pass p
// folds the aggregates whose operands need only row scalars known after
// pass p - 1.  Each pass walks the row in column slices of 4T columns,
// thread t taking the 4-column group at 4t of each slice (one float4 load
// per row-wide bind; column by column, t, t + T, ..., where a row is not
// 16-byte aligned), re-reads the binds and recomputes the element-wise
// values that its aggregates need.  A pass's folds are deterministic: each
// thread folds its columns in order, a warp butterfly, then thread 0 folds
// the warps' partials in warp order (no float atomics, so a rerun gives
// the same bits); the result goes through shared memory to every thread,
// which keeps it in a register as a row scalar.  The last pass writes a
// row-wide root (no_agg); a row-scalar root is computed in the tail and
// written by thread 0.  row_agg folds the root in its own pass; full_agg
// keeps thread 0's fold of its rows across the grid stride and writes one
// partial per CTA, which rk::combine folds.
//
// Bound on the card: bytes.  The forward of the loss reads the row twice
// (its max, then Σ exp) where its bound counts it once; the backward reads
// it four times and writes it once.  An online max-and-sum and rows split
// over a cluster are later work.
//
// Prog contract (written by cuda_src.py):
//   LAYOUT = 2, NB, T, CTAS       binds, threads a CTA, CTAs per SM
//   NPASS, WRITE, PASSES, NS, N   fold passes, a write pass (0/1), reads
//                                 of the row, shared row scalars, columns
//   C = 1, KC = 0                 a partial is one value (full_agg)
//   VARIANT, AGG, MEAN
//   row(b, i, tid, rs, red, o) -> the row's value (no_agg scalar root,
//                                 the row_agg / full_agg fold of the row)
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include "common.cuh"

namespace rowstream {

__device__ __forceinline__ bool aligned(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The CTA's fold of one partial a thread: a warp butterfly, then thread 0
// over the warps in order; the result is in *slot (shared memory) for
// every thread when it returns.  red: T / 32 floats of shared memory.
template <int T>
__device__ __forceinline__ void fold(int op, float v, float* red,
                                     float* slot) {
  v = rk::lane_reduce<32>(op, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red[0];
    for (int w = 1; w < T / 32; ++w) a = rk::agg_comb(op, a, red[w]);
    *slot = a;
  }
  __syncthreads();
}

}  // namespace rowstream

template <class P>
__global__ void __launch_bounds__(P::T, P::CTAS)
row_stream_kernel(rk::BBinds<P::NB> bb, float* __restrict__ out,
                  long long ostride, float* __restrict__ part, long long m,
                  float count) {
  static_assert(P::T % 32 == 0 && P::T <= 1024, "row stream: whole warps");
  const rk::Binds<P::NB> b = bb.at(blockIdx.z);
  out += blockIdx.z * ostride;
  part += (long long)blockIdx.z * gridDim.x;
  __shared__ float red[P::T / 32];
  __shared__ float rs[P::NS];
  float acc = rk::agg_init(P::AGG);
  for (long long i = blockIdx.x; i < m; i += gridDim.x) {
    const float v = P::row(b, i, threadIdx.x, rs, red,
                           out + (P::WRITE ? i * P::N : i));
    if (threadIdx.x == 0) {
      if constexpr (P::VARIANT == 0) {          // no_agg, a row scalar
        if (!P::WRITE) out[i] = v;
      } else if constexpr (P::VARIANT == 1) {   // row_agg
        out[i] = P::MEAN ? v / count : v;
      } else {                                  // full_agg
        acc = rk::agg_comb(P::AGG, acc, v);
      }
    }
  }
  if constexpr (P::VARIANT == 3) {
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}
