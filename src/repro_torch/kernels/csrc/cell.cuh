// Cell template skeleton: the fused cell-wise program over the (m, N)
// domain, with broadcast sides read as (m,1), (1,N) and (1,1).
//
// Replaces repro/kernels/cellwise.py::cell_pallas.
//
// Bound on the card: bytes.  The program does a handful of flops per cell
// against at least 4 bytes read per cell of the main input, far below the
// H100's ~20 flop/byte fp32 ridge.  Design: no divisor tiles (pick_block's
// Pallas tiles shrink badly on ragged shapes such as 33x7) — the domain is
// walked with a grid-stride loop over cells and the ragged edge is masked
// by the loop bound; consecutive threads take consecutive cells so every
// row-major input coalesces.  Variants:
//   no_agg    grid-stride over m·N cells, one store per cell
//   row_agg   one warp per row, lanes stride the N columns, butterfly
//   col_agg   block (32 x 8): 32 columns by 8 row lanes over one row chunk
//             per blockIdx.y, folded in row-lane order into (R, N) partials
//   full_agg  the magg.cuh scan with K = 1
// then rk::combine folds the partials in order.  No float atomics.
//
// Prog contract (written by cuda_src.py): NB, N, K (= 1), VARIANT, AGG,
// MEAN, eval(b, i, j, r[1]), agg_of(k), fin(k, acc, aux).
#pragma once

#include "magg.cuh"

namespace cell {
enum { NO_AGG = 0, ROW_AGG = 1, COL_AGG = 2, FULL_AGG = 3 };
}

template <class P>
__global__ void __launch_bounds__(256)
cell_no_agg(rk::Binds<P::NB> b, float* __restrict__ out, long long m) {
  const long long total = m * P::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / P::N;
    const int j = (int)(idx - i * P::N);
    float r[1];
    P::eval(b, i, j, r);
    out[idx] = r[0];
  }
}

template <class P>
__global__ void __launch_bounds__(256)
cell_row_agg(rk::Binds<P::NB> b, float* __restrict__ out, long long m,
             float count) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = warp; i < m; i += nwarps) {       // uniform per warp
    float acc = rk::agg_init(P::AGG);
    for (int j = lane; j < P::N; j += 32) {
      float r[1];
      P::eval(b, i, j, r);
      acc = rk::agg_add(P::AGG, acc, r[0]);
    }
    acc = rk::lane_reduce<32>(P::AGG, acc);
    if (lane == 0) out[i] = P::MEAN ? acc / count : acc;
  }
}

template <class P>
__global__ void __launch_bounds__(256)
cell_col_agg(rk::Binds<P::NB> b, float* __restrict__ part, long long m) {
  __shared__ float sm[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long R = gridDim.y;
  const long long chunk = (m + R - 1) / R;
  const long long r0 = blockIdx.y * chunk;
  const long long r1 = r0 + chunk < m ? r0 + chunk : m;
  float acc = rk::agg_init(P::AGG);
  if (j < P::N) {
    for (long long i = r0 + threadIdx.y; i < r1; i += 8) {
      float r[1];
      P::eval(b, i, j, r);
      acc = rk::agg_add(P::AGG, acc, r[0]);
    }
  }
  sm[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < P::N) {
    float a = sm[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) a = rk::agg_comb(P::AGG, a, sm[y][threadIdx.x]);
    part[blockIdx.y * (long long)P::N + j] = a;
  }
}

// nblocks: grid size (no_agg, row_agg, full_agg) or row chunks R (col_agg);
// aux: the mean count (row_agg: N, col_agg: m, full_agg: m·N)
template <class P>
int cell_launch(void* const* binds, float* out, float* part, long long m,
                int nblocks, double aux, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::Binds<P::NB> b = rk::pack_binds<P::NB>(binds);
  if constexpr (P::VARIANT == cell::NO_AGG) {
    cell_no_agg<P><<<nblocks, 256, 0, s>>>(b, out, m);
  } else if constexpr (P::VARIANT == cell::ROW_AGG) {
    cell_row_agg<P><<<nblocks, 256, 0, s>>>(b, out, m, (float)aux);
  } else if constexpr (P::VARIANT == cell::COL_AGG) {
    cell_col_agg<P><<<dim3((P::N + 31) / 32, nblocks), dim3(32, 8), 0, s>>>(b, part, m);
    rk::combine<P><<<P::N, 256, 0, s>>>(part, out, nblocks, aux);
  } else {
    magg_scan<P><<<nblocks, 256, 0, s>>>(b, part, m);
    rk::combine<P><<<1, 256, 0, s>>>(part, out, nblocks, aux);
  }
  return (int)cudaGetLastError();
}
