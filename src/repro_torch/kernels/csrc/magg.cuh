// MAgg template skeleton: K full aggregates of K program roots in one scan.
//
// Replaces repro/kernels/multiagg.py::multiagg_pallas (and serves the
// single-root full_agg of repro/kernels/cellwise.py::cell_pallas, K = 1).
//
// Bound on the card: bytes.  Each cell of the bound inputs is read once and
// only K floats per CTA are written, so at L2SVM's shapes the scan is a
// pure HBM stream (the k = 2 `_search_terms` over (m,1) operands moves
// 2·m·4 bytes).  Design: one read pass, a grid-stride loop over the m·N
// cells (consecutive threads on consecutive cells, so loads coalesce) with
// K register accumulators per thread; a fixed warp butterfly and an
// in-order fold of the CTA's warps give one partial per CTA and root; the
// second pass (rk::combine) folds the partials in CTA order.  No float
// atomics: the Pallas grid accumulates in order, and so does this.
//
// Request axis (common.cuh): gridDim.z requests in one launch; request q
// scans its own binds, writes its nblocks * K partials after request
// q - 1's, and rk::combine folds them into out + q * ostride.
//
// Prog contract (written by cuda_src.py):
//   NB, N, K                     bind count, domain width, number of roots
//   eval(b, i, j, r[K])          the program at cell (i, j)
//   agg_of(k), fin(k, acc, aux)  per-root aggregation code and finalizer
#pragma once

#include "common.cuh"

template <class P>
__global__ void __launch_bounds__(256)
magg_scan(rk::BBinds<P::NB> bb, float* __restrict__ part, long long m) {
  __shared__ float sm[P::K][8];
  const rk::Binds<P::NB> b = bb.at(blockIdx.z);
  part += (long long)blockIdx.z * gridDim.x * P::K;
  float acc[P::K];
#pragma unroll
  for (int k = 0; k < P::K; ++k) acc[k] = rk::agg_init(P::agg_of(k));
  const long long total = m * P::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / P::N;
    const int j = (int)(idx - i * P::N);
    float r[P::K];
    P::eval(b, i, j, r);
#pragma unroll
    for (int k = 0; k < P::K; ++k) acc[k] = rk::agg_add(P::agg_of(k), acc[k], r[k]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < P::K; ++k) {
    const float a = rk::lane_reduce<32>(P::agg_of(k), acc[k]);
    if (lane == 0) sm[k][warp] = a;
  }
  __syncthreads();
  if (threadIdx.x < P::K) {
    const int k = threadIdx.x, op = P::agg_of(k);
    float a = sm[k][0];
    for (int w = 1; w < 8; ++w) a = rk::agg_comb(op, a, sm[k][w]);
    part[(long long)blockIdx.x * P::K + k] = a;
  }
}

// out (K,1) per request, request q's at out + q * ostride; part holds
// nblocks·K floats per request; binds / strides: bind pointers and
// per-request strides (floats); nreq requests (gridDim.z)
template <class P>
int magg_launch(void* const* binds, const long long* strides, int nreq,
                float* out, long long ostride, float* part, void* ticket,
                long long m, int nblocks, double aux, void* stream,
                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::BBinds<P::NB> b = rk::pack_bbinds<P::NB>(binds, strides);
  magg_scan<P><<<dim3(nblocks, 1, nreq), 256, 0, s>>>(b, part, m);
  rk::combine<P><<<dim3(P::K, 1, nreq), 256, 0, s>>>(part, out, nblocks, aux,
                                                     ostride);
  return (int)cudaGetLastError();
}
