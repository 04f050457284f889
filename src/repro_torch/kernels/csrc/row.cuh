// Row template skeleton: the fused row-wise program, one row at a time.
//
// Replaces repro/kernels/rowwise.py::row_pallas (all five variants, narrow
// in-program matmuls row @ side with side width <= NARROW_MAX, in-program
// row aggregates such as rowsums / rowmaxs).
//
// Bound on the card: bytes.  A row of the main input is read once and the
// program does O(n·k) flops on it with k <= 256 narrow; at L2SVM's shapes
// (n = 100, k = 1) that is ~0.5 flop/byte, far below the fp32 ridge, so the
// kernel is an HBM stream of X.  Design: L lanes per row (L = 32, one warp
// per row, for rows with vector values; L = 1, one thread per row, for
// programs whose values are all per-row scalars, e.g. the (m,1) mains of
// L2SVM's planned backward), rows strided over the grid.  A value of
// compile-time width w lives in registers, lane-distributed: element j on
// lane j % L, slot j / L, the ragged tail masked.  Row aggregates and
// narrow matmuls with few output columns reduce with warp butterflies;
// wider matmuls and the col_t_agg close stage the row in a per-warp shared
// buffer.  Sides are read through the read-only cache.  col_agg, full_agg
// and col_t_agg keep per-warp register accumulators, write one partial per
// warp, and rk::combine folds the partials in warp order: no float
// atomics.
//
// Prog contract (written by cuda_src.py):
//   NB, L, WPB, SMW           binds, lanes per row, warps per CTA, staging
//                             floats per warp (>= 1)
//   C, KC, TR, TK, TE         root width, closer width (col_t_agg), register
//                             slots of root / closer / accumulator
//   VARIANT, AGG, MEAN
//   eval(b, i, sub, sm, r[TR], c[TK])   the program on row i
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include "common.cuh"

namespace row {
enum { NO_AGG = 0, ROW_AGG = 1, COL_AGG = 2, FULL_AGG = 3, COL_T_AGG = 4 };
}

template <class P>
__global__ void __launch_bounds__(P::WPB * 32)
row_kernel(rk::Binds<P::NB> b, float* __restrict__ out,
           float* __restrict__ part, long long m, float count) {
  constexpr int L = P::L;
  __shared__ float smem[P::WPB][P::SMW];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int sub = (L == 32) ? lane : 0;          // lane within the row group
  float* sm = smem[wib];
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  float acc[P::TE];
#pragma unroll
  for (int t = 0; t < P::TE; ++t) acc[t] = rk::agg_init(P::AGG);

  // L = 32: the whole warp walks one row, so the loop is warp-uniform
  for (long long i = tid / L; i < m; i += nthreads / L) {
    float r[P::TR], c[P::TK];
    P::eval(b, i, sub, sm, r, c);
    if constexpr (P::VARIANT == row::NO_AGG) {
#pragma unroll
      for (int t = 0; t < P::TR; ++t) {
        const int j = t * L + sub;
        if (j < P::C) out[i * P::C + j] = r[t];
      }
    } else if constexpr (P::VARIANT == row::ROW_AGG) {
      float a = rk::agg_init(P::AGG);
#pragma unroll
      for (int t = 0; t < P::TR; ++t)
        if (t * L + sub < P::C) a = rk::agg_add(P::AGG, a, r[t]);
#ifdef RK_PLANTED_FAULT
      // a fault planted only in chip_smoke.py's own builds: the middle
      // lane's partial of every row is dropped
      if (L > 1 && sub == (P::C < L ? P::C : L) / 2) a = rk::agg_init(P::AGG);
#endif
      a = rk::lane_reduce<L>(P::AGG, a);
      if (sub == 0) out[i] = P::MEAN ? a / count : a;
    } else if constexpr (P::VARIANT == row::COL_AGG) {
#pragma unroll
      for (int t = 0; t < P::TR; ++t)
        if (t * L + sub < P::C) acc[t] = rk::agg_add(P::AGG, acc[t], r[t]);
    } else if constexpr (P::VARIANT == row::FULL_AGG) {
#pragma unroll
      for (int t = 0; t < P::TR; ++t)
        if (t * L + sub < P::C) acc[0] = rk::agg_add(P::AGG, acc[0], r[t]);
    } else {                                     // col_t_agg: closerᵀ @ val
      static_assert(L == 32, "col_t_agg stages the row: one warp per row");
      __syncwarp();
#pragma unroll
      for (int t = 0; t < P::TK; ++t)
        if (t * 32 + lane < P::KC) sm[t * 32 + lane] = c[t];
#pragma unroll
      for (int t = 0; t < P::TR; ++t)
        if (t * 32 + lane < P::C) sm[P::KC + t * 32 + lane] = r[t];
      __syncwarp();
#pragma unroll
      for (int t = 0; t < P::TE; ++t) {
        const int e = t * 32 + lane;
        if (e < P::KC * P::C)
          acc[t] += sm[e / P::C] * sm[P::KC + e % P::C];
      }
    }
  }

  // one partial per warp, in global warp order
  const long long warp_id = tid >> 5;
  if constexpr (P::VARIANT == row::FULL_AGG ||
                (P::VARIANT == row::COL_AGG && L == 1)) {
    const float a = rk::lane_reduce<32>(P::AGG, acc[0]);
    if (lane == 0) part[warp_id] = a;
  } else if constexpr (P::VARIANT == row::COL_AGG) {
#pragma unroll
    for (int t = 0; t < P::TE; ++t)
      if (t * 32 + lane < P::C) part[warp_id * P::C + t * 32 + lane] = acc[t];
  } else if constexpr (P::VARIANT == row::COL_T_AGG) {
#pragma unroll
    for (int t = 0; t < P::TE; ++t)
      if (t * 32 + lane < P::KC * P::C)
        part[warp_id * (P::KC * P::C) + t * 32 + lane] = acc[t];
  }
}

// nblocks: grid size; partials: nblocks·WPB warps x E elements
// (E = 1 full_agg, C col_agg, KC·C col_t_agg); aux: the mean count of the
// variant (row_agg: root width, col_agg: m, full_agg: m·width)
template <class P>
int row_launch(void* const* binds, float* out, float* part, long long m,
               int nblocks, double aux, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::Binds<P::NB> b = rk::pack_binds<P::NB>(binds);
  row_kernel<P><<<nblocks, P::WPB * 32, 0, s>>>(b, out, part, m, (float)aux);
  if constexpr (P::VARIANT == row::COL_AGG || P::VARIANT == row::FULL_AGG ||
                P::VARIANT == row::COL_T_AGG) {
    constexpr int E = P::VARIANT == row::FULL_AGG ? 1
                    : (P::VARIANT == row::COL_AGG ? P::C : P::KC * P::C);
    rk::combine<P><<<E, 256, 0, s>>>(part, out, nblocks * P::WPB, aux);
  }
  return (int)cudaGetLastError();
}
