// Outer template skeleton: block SDDMM over the non-zero blocks of a
// row-major BCSR main X, with the fused chain applied per cell.
//
// Replaces repro/kernels/outerprod.py::outer_pallas (right_mm and
// full_agg, the variants the dispatch routes to it).  For each non-zero
// (BS x BS) block b of X:
//   S_b   = U[rows[b]] . V[cols[b]]^T            (BS x BS, rank R)
//   chain = Prog::eval(x, s, sides) per cell
//   right_mm:  out[rows[b]] += chain @ closer[cols[b]]     (BS x K)
//   full_agg:  agg over every chain value                  (1 x 1)
//
// Bound on the card: about as much by fp32 operations as by bytes.  Per
// block the kernel reads BS^2 floats of X and does 2 BS^2 R flops for S
// (plus 2 BS^2 K for the right_mm close): at BS = 128, R = K = 20 that is
// ~20 flop/byte, near the ~20 flop/byte fp32 ridge (67 TFLOP/s over
// 3.35 TB/s).  IEEE fp32 FMAs on CUDA cores, no TF32.
//
// Design (simple and deterministic; TMA / wgmma come later):
// * one CTA of 256 threads (16 x 16) per block row, driven by the block-
//   row pointer: it walks the row's blocks in order, so right_mm
//   accumulates out[rows[b]] in registers with no atomics, and a CTA whose
//   row has no blocks writes zeros (the reference's `visited` mask);
// * the U panel of the block row (R x BS, transposed) is staged in shared
//   memory once and shared by every block of the row; per block the V
//   panel (R x BS) and the closer panel (BS x K) are staged;
// * thread (ty, tx) owns the cells (ty + 16a, tx + 16c), a, c < BS/16: it
//   computes its S cells as register outer products over R, reads its X
//   cells (16 consecutive floats per half-warp), evaluates the chain;
// * right_mm writes the chain tile to shared memory (row stride BS + 1)
//   and each thread computes rows ty + 16a x closer columns tx + 16e of
//   the block's chain @ closer, then adds that to the row's running sum:
//   the plain version's order (per-block products, summed over the
//   blocks in order).  A single FMA chain over all of a row's blocks
//   would round like a sequential sum of blocks x BS terms, an error that
//   grows with the ~938 blocks of a row of Xt;
// * full_agg folds each thread's values per block, adds the block's fold
//   to a running one, reduces the CTA with a fixed tree to one partial
//   per block row, and rk::combine folds the partials in block-row order.
// Shared memory: 4 (2 R BS + BS K + BS (BS + 1)) bytes for right_mm
// (96 KB at BS = 128, R = K = 20), opted into above 48 KB.
//
// Prog contract (written by cuda_src.py):
//   NB, BS, R, K, UB, VB     binds, block size, rank, closer width (0 for
//                            full_agg), bind positions of U and V
//   VARIANT (0 right_mm, 1 full_agg), AGG
//   eval(b, x, s, gi, gj, n) the chain at global cell (gi, gj)
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include "common.cuh"

namespace outer {
enum { RIGHT_MM = 0, FULL_AGG = 1 };
constexpr int THREADS = 256;

template <class P>
constexpr int smem_floats() {
  return 2 * P::R * P::BS +
         (P::VARIANT == RIGHT_MM ? P::BS * P::K + P::BS * (P::BS + 1)
                                 : THREADS);
}
}  // namespace outer

template <class P>
__global__ void __launch_bounds__(outer::THREADS)
outer_kernel(rk::Binds<P::NB> b, const float* __restrict__ xdata,
             const int* __restrict__ cols, const int* __restrict__ rowptr,
             const float* __restrict__ closer, float* __restrict__ out,
             float* __restrict__ part, long long n) {
  constexpr int BS = P::BS, R = P::R, K = P::K, T = BS / 16;
  constexpr int E = (K + 15) / 16 > 0 ? (K + 15) / 16 : 1;
  constexpr int LDC = BS + 1;
  constexpr bool RMM = P::VARIANT == outer::RIGHT_MM;
  extern __shared__ float smem[];
  float* Us = smem;                 // [R][BS]  U panel of this block row
  float* Vs = Us + R * BS;          // [R][BS]  V panel of the current block
  float* Cl = Vs + R * BS;          // [BS][K]  closer panel (right_mm)
  float* Cs = Cl + BS * K;          // [BS][LDC] chain tile (right_mm)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long br = blockIdx.x;
  const int start = rowptr[br], end = rowptr[br + 1];
  const float* U = b.p[P::UB];
  const float* V = b.p[P::VB];

  for (int e = tid; e < BS * R; e += outer::THREADS) {
    const int i = e / R, q = e % R;
    Us[q * BS + i] = U[(br * BS + i) * R + q];
  }
  float acc[T][E];
#pragma unroll
  for (int a = 0; a < T; ++a)
#pragma unroll
    for (int c = 0; c < E; ++c) acc[a][c] = 0.f;
  float agg = rk::agg_init(P::AGG);

  for (int blk = start; blk < end; ++blk) {
#ifdef RK_PLANTED_FAULT
    // a fault planted only in chip_smoke.py's own builds: right_mm skips
    // the middle block of every block row
    if (RMM && blk == start + (end - start) / 2) continue;
#endif
    const long long bc = cols[blk];
    __syncthreads();              // the previous block's readers are done
    for (int e = tid; e < BS * R; e += outer::THREADS) {
      const int j = e / R, q = e % R;
      Vs[q * BS + j] = V[(bc * BS + j) * R + q];
    }
    if constexpr (RMM) {
      const float* cp = closer + bc * BS * K;   // rows bc*BS.. contiguous
      for (int e = tid; e < BS * K; e += outer::THREADS) Cl[e] = cp[e];
    }
    __syncthreads();

    float s[T][T];
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < T; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int q = 0; q < R; ++q) {
      float u[T], v[T];
#pragma unroll
      for (int a = 0; a < T; ++a) u[a] = Us[q * BS + ty + 16 * a];
#pragma unroll
      for (int c = 0; c < T; ++c) v[c] = Vs[q * BS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < T; ++a)
#pragma unroll
        for (int c = 0; c < T; ++c) s[a][c] = fmaf(u[a], v[c], s[a][c]);
    }

    const float* xb = xdata + (long long)blk * BS * BS;
    const long long gi0 = br * BS, gj0 = bc * BS;
    float bagg = rk::agg_init(P::AGG);     // this block's fold (full_agg)
#pragma unroll
    for (int a = 0; a < T; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const int j = tx + 16 * c;
        const float val =
            P::eval(b, __ldg(xb + i * BS + j), s[a][c], gi0 + i, gj0 + j, n);
        if constexpr (RMM)
          Cs[i * LDC + j] = val;
        else
          bagg = rk::agg_add(P::AGG, bagg, val);
      }
    }
    agg = rk::agg_comb(P::AGG, agg, bagg);

    if constexpr (RMM) {
      __syncthreads();
      float bacc[T][E];             // this block's chain @ closer
#pragma unroll
      for (int a = 0; a < T; ++a)
#pragma unroll
        for (int c = 0; c < E; ++c) bacc[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < BS; ++j) {
        float cv[E];
#pragma unroll
        for (int c = 0; c < E; ++c) {
          const int col = tx + 16 * c;
          cv[c] = col < K ? Cl[j * K + col] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < T; ++a) {
          const float w = Cs[(ty + 16 * a) * LDC + j];
#pragma unroll
          for (int c = 0; c < E; ++c) bacc[a][c] = fmaf(w, cv[c], bacc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < T; ++a)
#pragma unroll
        for (int c = 0; c < E; ++c) acc[a][c] += bacc[a][c];
    }
  }

  if constexpr (RMM) {
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < E; ++c) {
        const int col = tx + 16 * c;
        if (col < K) out[(br * BS + ty + 16 * a) * K + col] = acc[a][c];
      }
  } else {
    float* red = Vs + R * BS;       // THREADS floats after the V panel
    __syncthreads();
    red[tid] = agg;
    __syncthreads();
    for (int w = outer::THREADS / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] = rk::agg_comb(P::AGG, red[tid], red[tid + w]);
      __syncthreads();
    }
    if (tid == 0) part[br] = red[0];
  }
}

// one CTA per block row (m / bs of them); the run-time bs, r, k must be the
// compiled ones (cudaErrorInvalidValue otherwise); full_agg: part holds one
// partial per block row and rk::combine folds them into out (1 x 1)
template <class P>
int outer_launch(void* const* binds, const void* xdata, const void* cols,
                 const void* rowptr, const void* closer, void* out,
                 void* part, long long m, long long n, int nblocks, int bs,
                 int r, int k, void* stream, int device) {
  if (bs != P::BS || r != P::R || k != P::K || m % P::BS || n % P::BS ||
      nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::Binds<P::NB> b = rk::pack_binds<P::NB>(binds);
  constexpr int bytes = outer::smem_floats<P>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(outer_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  const long long mb = m / P::BS;
  outer_kernel<P><<<(unsigned)mb, outer::THREADS, bytes, s>>>(
      b, static_cast<const float*>(xdata), static_cast<const int*>(cols),
      static_cast<const int*>(rowptr), static_cast<const float*>(closer),
      static_cast<float*>(out), static_cast<float*>(part), n);
  if constexpr (P::VARIANT == outer::FULL_AGG)
    rk::combine<P><<<1, 256, 0, s>>>(static_cast<const float*>(part),
                                     static_cast<float*>(out), (int)mb, 1.0);
  return (int)cudaGetLastError();
}
