// Cell template skeleton: the fused cell-wise program over the (m, N)
// domain, with broadcast sides read as (m,1), (1,N) and (1,1).
//
// Replaces repro/kernels/cellwise.py::cell_pallas.
//
// Bound on the card: bytes, and near it the issue rate.  A cell reads 4
// bytes per bound input and writes 4 (no_agg) or nothing (the reductions),
// while its program is a chain of a few to ~15 ops; but erff, expf, logf
// and IEEE division expand to tens of SASS instructions each, so a GLM
// chain issues ~100 SASS instructions per cell and its issue floor sits at
// or above its byte bound.  Design: keep the card's memory busy with few
// instructions per cell and enough independent work per thread.
//
// Two walks, chosen per CPlan by cuda_src.cell_source (Prog::WALK):
//
// * Vector walk (WALK 1): every bind has the domain's shape, is (1,1), or
//   is (1,N) with N % 4 == 0.  A thread takes groups of G = 4 consecutive
//   cells, one 16-byte load per bind (a (1,N) side loads the group's four
//   columns: N % 4 == 0 keeps a group in one row), and keeps U groups in
//   flight: all U·NV loads are issued before the first group's program
//   runs (Prog::vload, then Prog::veval on each group).  Consecutive
//   threads take consecutive groups, so a warp reads 512 contiguous bytes
//   per bind.  Each thread walks every (gridDim·T)-th group; the last round
//   with fewer than U groups left takes one group at a time, and the
//   m·N mod 4 cells past the last group are walked cell by cell, all in the
//   same kernel.  The wrapper checks every vector operand's 16-byte
//   alignment and raises on a misaligned one.
// * Scalar walk (WALK 0): every other CPlan (an (m,1) side over N > 1, a
//   column slice, a (1,N) side with N % 4 != 0): a grid-stride loop over
//   cells, consecutive threads on consecutive cells.
//
// Variants:
//   no_agg    (cell_no_agg) the walk, one store per cell (float4 per group)
//   full_agg  (cell_full_agg) the walk with a register accumulator per
//             thread; warp butterfly, the CTA's warps in order, one
//             partial per CTA; then the fold below (a grid of one CTA
//             writes its partial as the result: no ticket, no fold)
//   row_agg   (cell_row_agg) one warp per row, lanes stride the N columns,
//             butterfly; no partials
//   col_agg   (cell_col_agg) block (32 x 8): 32 columns by 8 row lanes over
//             one row chunk per blockIdx.y, folded in row-lane order into
//             (R, N) partials; then the fold below
// The grid of no_agg and full_agg is persistent: at most the SM count
// times CTAS (the __launch_bounds__ residency), no more than the work
// needs (cellwise.py sizes it from KernelSource).
//
// One launch per reducing call, deterministic: each CTA writes its
// partial(s), fences, and draws an integer ticket (atomicAdd on an
// unsigned; no float atomics).  The CTA that draws the last ticket folds
// every partial in CTA order with rk::combine's fixed tree (a thread per
// strided run of partials, then a 256-wide shared-memory tree), writes the
// output and resets the ticket, so the bits do not depend on which CTA
// finished last.  Ticket and partials live in a scratch buffer the wrapper
// allocates once per (device, stream) with the ticket zeroed: ticket at
// part[0], partials from part + 4.
//
// Prog contract (written by cuda_src.py):
//   NB, N, K (= 1), VARIANT, AGG, MEAN
//   WALK, G, U, T, CTAS, NV, PARTS   walk, cells per group, groups in
//                                    flight, threads, CTAs per SM, vector
//                                    binds, floats of partial per CTA
//   eval(b, i, j, r[1])              the program at cell (i, j)
//   vload(b, e, x[NV]), veval(b, x, r[G])   (WALK 1) the group at cell e
//   agg_of(k), fin(k, acc, aux)
#pragma once

#include "common.cuh"

namespace cell {
enum { NO_AGG = 0, ROW_AGG = 1, COL_AGG = 2, FULL_AGG = 3 };
#ifdef RK_PLANTED_GROUP
// a fault planted only in chip_smoke.py's own builds: the vector walk
// drops the second cell of every group (no_agg stores 0, a reduction
// leaves it out)
constexpr bool kPlantedGroup = true;
#else
constexpr bool kPlantedGroup = false;
#endif
constexpr int FOLD_THREADS = 256;

// The last CTA to finish folds the partials: out[e] = fin(e, combine over
// the nparts partials part[p * E + e], p in order), e < E.  Every CTA of
// the grid calls this after writing its partials; blockDim is 256.
template <class P>
__device__ __forceinline__ void fold_last(const float* part, float* out,
                                          unsigned* ticket, int nparts,
                                          int E, double aux) {
  __shared__ float sm[FOLD_THREADS];
  __shared__ bool last;
  const int tx = threadIdx.x + blockDim.x * threadIdx.y;
  const unsigned nctas = gridDim.x * gridDim.y;
  __threadfence();                    // this thread's partials, to the card
  __syncthreads();
  if (tx == 0) last = atomicAdd(ticket, 1u) == nctas - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                    // every CTA's partials are visible
  for (int e = 0; e < E; ++e) {
    const int op = P::agg_of(e);
    float acc = rk::agg_init(op);
    for (int p = tx; p < nparts; p += FOLD_THREADS) {
#ifdef RK_PLANTED_FAULT
      // a fault planted only in chip_smoke.py's own builds, to show that
      // its check rejects a reduction that lost one partial
      if (p == nparts / 2) continue;
#endif
      acc = rk::agg_comb(op, acc, __ldcg(part + (long long)p * E + e));
    }
    sm[tx] = acc;
    __syncthreads();
    for (int s = FOLD_THREADS / 2; s > 0; s >>= 1) {
      if (tx < s) sm[tx] = rk::agg_comb(op, sm[tx], sm[tx + s]);
      __syncthreads();
    }
    if (tx == 0) out[e] = P::fin(e, sm[0], aux);
    __syncthreads();                  // sm is read before the next e
  }
  if (tx == 0) *ticket = 0u;          // ready for the next call
}

// no_agg and full_agg: the walk of the module header; returns this
// thread's accumulator (full_agg) after storing every cell (no_agg)
template <class P>
__device__ __forceinline__ float walk(const rk::Binds<P::NB>& b,
                                      float* __restrict__ out, long long m) {
  constexpr bool RED = P::VARIANT == FULL_AGG;
  const long long total = m * P::N;
  const long long nt = (long long)gridDim.x * P::T;
  const long long tid = blockIdx.x * (long long)P::T + threadIdx.x;
  float acc = rk::agg_init(P::AGG);
  long long done = 0;
  if constexpr (P::WALK == 1) {
    constexpr int G = P::G, U = P::U;
    const long long ng = total / G;                // whole groups
    auto group = [&](long long e, float (&r)[G]) {
      if constexpr (kPlantedGroup) r[1] = RED ? rk::agg_init(P::AGG) : 0.f;
      if constexpr (RED) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc = rk::agg_add(P::AGG, acc, r[g]);
      } else {
        *reinterpret_cast<float4*>(out + e) = make_float4(r[0], r[1], r[2],
                                                          r[3]);
      }
    };
    long long q = tid;
    for (; q + (U - 1) * nt < ng; q += U * nt) {  // U groups in flight
      float4 x[U][P::NV];
#pragma unroll
      for (int u = 0; u < U; ++u) P::vload(b, (q + u * nt) * G, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float r[G];
        P::veval(b, x[u], r);
        group((q + u * nt) * G, r);
      }
    }
    for (; q < ng; q += nt) {                     // the last round
      float4 x[P::NV];
      P::vload(b, q * G, x);
      float r[G];
      P::veval(b, x, r);
      group(q * G, r);
    }
    done = ng * G;
  }
  for (long long e = done + tid; e < total; e += nt) {   // cell by cell
    const long long i = e / P::N;
    const int j = (int)(e - i * P::N);
    float r[1];
    P::eval(b, i, j, r);
    if constexpr (RED) acc = rk::agg_add(P::AGG, acc, r[0]);
    else out[e] = r[0];
  }
  return acc;
}
}  // namespace cell

template <class P>
__global__ void __launch_bounds__(P::T, P::CTAS)
cell_no_agg(rk::Binds<P::NB> b, float* __restrict__ out, long long m) {
  cell::walk<P>(b, out, m);
}

template <class P>
__global__ void __launch_bounds__(P::T, P::CTAS)
cell_full_agg(rk::Binds<P::NB> b, float* __restrict__ out,
              float* __restrict__ part, unsigned* ticket, long long m,
              double aux) {
  static_assert(P::T == cell::FOLD_THREADS, "the fold takes the whole CTA");
  __shared__ float ws[P::T / 32];
  const float acc = cell::walk<P>(b, out, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a = rk::lane_reduce<32>(P::AGG, acc);
  if (lane == 0) ws[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = ws[0];
    for (int w = 1; w < P::T / 32; ++w) s = rk::agg_comb(P::AGG, s, ws[w]);
    if (gridDim.x == 1) {         // the only partial: no ticket, no fold
#ifdef RK_PLANTED_FAULT
      s = rk::agg_init(P::AGG);   // the fold's planted fault drops it
#endif
      out[0] = P::fin(0, rk::agg_comb(P::AGG, rk::agg_init(P::AGG), s), aux);
    } else {
      part[blockIdx.x] = s;
    }
  }
  if (gridDim.x > 1) cell::fold_last<P>(part, out, ticket, gridDim.x, 1, aux);
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
cell_col_agg(rk::Binds<P::NB> b, float* __restrict__ out,
             float* __restrict__ part, unsigned* ticket, long long m,
             double aux) {
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
  cell::fold_last<P>(part, out, ticket, (int)R, P::N, aux);
}

// nblocks: grid size (no_agg, row_agg, full_agg) or row chunks R (col_agg);
// part: the scratch buffer (full_agg, col_agg): the ticket in its first
// word, partials from part + 4; aux: the mean count (row_agg: N, col_agg:
// m, full_agg: m·N)
template <class P>
int cell_launch(void* const* binds, float* out, float* part, long long m,
                int nblocks, double aux, void* stream, int device) {
  static_assert(P::WALK == 0 || (P::G == 4 && P::U >= 1 && P::NV >= 1),
                "vector walk: groups of four cells");
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::Binds<P::NB> b = rk::pack_binds<P::NB>(binds);
  if constexpr (P::VARIANT == cell::NO_AGG) {
    cell_no_agg<P><<<nblocks, P::T, 0, s>>>(b, out, m);
  } else if constexpr (P::VARIANT == cell::ROW_AGG) {
    cell_row_agg<P><<<nblocks, 256, 0, s>>>(b, out, m, (float)aux);
  } else if constexpr (P::VARIANT == cell::COL_AGG) {
    cell_col_agg<P><<<dim3((P::N + 31) / 32, nblocks), dim3(32, 8), 0, s>>>(
        b, out, part + 4, reinterpret_cast<unsigned*>(part), m, aux);
  } else {
    cell_full_agg<P><<<nblocks, P::T, 0, s>>>(
        b, out, part + 4, reinterpret_cast<unsigned*>(part), m, aux);
  }
  return (int)cudaGetLastError();
}
