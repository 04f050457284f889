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
// Bound on the card: fp32 operations for right_mm, bytes for full_agg.
// Per block the kernel reads BS^2 floats of X and does 2 BS^2 R flops for
// S plus 2 BS^2 K for the right_mm close: at BS = 128, R = K = 20 that is
// ~20 flop/byte, near the ~20 flop/byte fp32 ridge (67 TFLOP/s over
// 3.35 TB/s).  IEEE fp32 FMAs on CUDA cores, no TF32.
//
// Design:
// * Load balance.  The grid runs over pieces (BCSR.pieces): runs of at
//   most PIECE_BLOCKS consecutive blocks of one block row, empty rows
//   included, so a row of ~940 blocks (X^T's) is spread over ~30 CTAs.
//   right_mm: each piece writes its (BS x K) partial to scratch and
//   outer_fold adds a row's pieces in piece order (an empty row's one
//   empty piece holds zeros); full_agg: one partial per piece, folded in
//   order by rk::combine.  No atomics.
// * Registers, not shared-memory tiles.  Thread t takes RPT rows of the
//   block, t % (BS / RPT) + q BS / RPT, and column stripe
//   h = t / (BS / RPT).  It keeps those rows of U, and for right_mm their
//   running out rows and the block's out rows, in registers.  Per column
//   j it reads V[j, :] (and closer[j, :] unless the closer is V) as
//   warp-wide broadcasts, forms s per row with R FMAs, evaluates the chain
//   and adds val * closer[j, :] with K FMAs: no chain tile and no barrier
//   between S and the close.  Each float4 read hands 512 bytes to a warp,
//   so delivering V to registers is what shared memory spends; a V value
//   serves RPT cells.  full_agg takes RPT = 2, right_mm 1 (its 2K sums per
//   row would spill at two rows).
// * Asynchronous staging.  A block is cut into BS / SC column slices; each
//   slice (X[:, slice] at row stride SC + 4 -- float4 reads of 8 lanes
//   cover the 32 banks -- plus the slice's V rows and closer rows) is
//   copied with cp.async into a ring of STAGES buffers, STAGES - 1 slices
//   ahead of the one being computed, across block boundaries.
// * Order.  A thread sums its stripe of one block's product first, adds
//   the blocks of the piece in order, and the stripes are added in stripe
//   order at the end of the piece: the plain version's order (per block
//   products, then blocks in order) with the row cut into pieces.  Same
//   inputs, same bits: reruns are bit-identical.
// Shared memory: SMEM bytes, from cuda_src.py's layout (checked below);
// 62 KB at BS = 128, R = K = 20, 3 stages, so two CTAs share an SM.
// Registers: at most 128 a thread (__launch_bounds__), for the same.
//
// Prog contract (written by cuda_src.py):
//   NB, BS, R, K, UB, VB     binds, block size, rank, closer width (0 for
//                            full_agg), bind positions of U and V
//   VARIANT (0 right_mm, 1 full_agg), AGG
//   THREADS, RPT, SC, STAGES, SMEM, CLOSE_IS_V   the layout (see above)
//   eval(b, x, s, gi, gj, n) the chain at global cell (gi, gj)
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace outer {
enum { RIGHT_MM = 0, FULL_AGG = 1 };

template <class P>
struct Layout {
  static constexpr bool RMM = P::VARIANT == RIGHT_MM;
  static constexpr bool OWN_CLOSER = RMM && !P::CLOSE_IS_V;
  static constexpr int BS = P::BS, T = P::THREADS, SC = P::SC;
  static constexpr int RB = BS / P::RPT;    // threads per stripe
  static constexpr int H = T / RB;          // column stripes
  static constexpr int CW = SC / H;         // a stripe's columns per slice
  static constexpr int NS = BS / SC;        // slices per block
  static constexpr int LDX = SC + 4;        // X slice row stride (floats)
  static constexpr int RP = (P::R + 3) / 4 * 4, KP = (P::K + 3) / 4 * 4;
  static constexpr int XF = BS * LDX, VF = SC * RP;
  static constexpr int CF = OWN_CLOSER ? SC * KP : 0;
  static constexpr int STAGE = XF + VF + CF;
  static constexpr int RING = P::STAGES * STAGE;
  static constexpr int RED = RMM ? H * BS * P::K : T;
  static constexpr int FLOATS = RING > RED ? RING : RED;
  static_assert(BS % P::RPT == 0 && T % RB == 0 && BS % SC == 0 &&
                    SC % (4 * H) == 0,
                "outer layout: stripes of whole float4 column groups");
  static_assert(P::STAGES >= 2, "outer layout: a ring of 2+ slices");
  static_assert(!P::CLOSE_IS_V || P::K == P::R, "closer V: K == R");
  static_assert(FLOATS * 4 == P::SMEM,
                "outer layout differs from cuda_src.py's accounting");
};

using rk::cp16;
using rk::cp4;
using rk::cp_commit;
using rk::cp_wait;

// rows x W floats, contiguous in global memory, into rows of WP floats
template <int W, int WP, int T>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int tid) {
  if constexpr (W % 4 == 0) {
    for (int e = tid; e < rows * (W / 4); e += T)
      cp16(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = tid; e < rows * W; e += T)
      cp4(dst + (e / W) * WP + e % W, src + e);
  }
}

template <int WP>
__device__ __forceinline__ void load_row(float (&r)[WP], const float* src) {
#pragma unroll
  for (int q = 0; q < WP; q += 4) {
    const float4 t = *reinterpret_cast<const float4*>(src + q);
    r[q] = t.x; r[q + 1] = t.y; r[q + 2] = t.z; r[q + 3] = t.w;
  }
}
}  // namespace outer

template <class P>
__global__ void __launch_bounds__(P::THREADS, 2)
outer_kernel(rk::Binds<P::NB> b, const float* __restrict__ xdata,
             const int* __restrict__ cols, const int* __restrict__ rowptr,
             const int* __restrict__ pieces,
             const float* __restrict__ closer, float* __restrict__ out,
             float* __restrict__ part, long long n) {
  using L = outer::Layout<P>;
  constexpr int BS = P::BS, R = P::R, K = P::K, T = P::THREADS, SC = P::SC;
  constexpr int S = P::STAGES, NS = L::NS, CW = L::CW, LDX = L::LDX;
  constexpr int RP = L::RP, KP = L::KP, RT = P::RPT, RB = L::RB;
  constexpr int KA = K > 0 ? K : 1;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, g = tid % RB, h = tid / RB;
  const long long p = blockIdx.x;
  const int br = pieces[3 * p], first = pieces[3 * p + 1];
  const int end = pieces[3 * p + 2];
  const float* V = b.p[P::VB];
  // this thread's rows of the block: g + r RB, r < RT
  const long long gi0 = (long long)br * BS + g;

  float u[RT][R];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < R; ++q)
      u[r][q] = __ldg(b.p[P::UB] + (gi0 + r * RB) * R + q);
  float acc[RT][KA], bacc[RT][KA];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int k = 0; k < KA; ++k) acc[r][k] = 0.f;
  float agg = rk::agg_init(P::AGG), bagg = agg;

  // item it = slice it % NS of block first + it / NS
  const int items = (end - first) * NS;
  auto stage = [&](int it) {
    float* buf = smem + (it % S) * L::STAGE;
    const int blk = first + it / NS, s = it % NS;
    const long long j0 = (long long)cols[blk] * BS + s * SC;
    const float* xs = xdata + (long long)blk * BS * BS + s * SC;
    for (int e = tid; e < BS * (SC / 4); e += T) {
      const int r = e / (SC / 4), c = 4 * (e % (SC / 4));
      outer::cp16(buf + r * LDX + c, xs + (long long)r * BS + c);
    }
    outer::stage_rows<R, RP, T>(buf + L::XF, V + j0 * R, SC, tid);
    if constexpr (L::OWN_CLOSER)
      outer::stage_rows<K, KP, T>(buf + L::XF + L::VF, closer + j0 * K, SC,
                                  tid);
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < items) stage(it);
    outer::cp_commit();
  }

  for (int it = 0; it < items; ++it) {
    outer::cp_wait<S - 2>();        // this thread's copies of item it
    __syncthreads();                // everyone's; item it - 1 is done
    if (it + S - 1 < items) stage(it + S - 1);
    outer::cp_commit();
    const float* buf = smem + (it % S) * L::STAGE;
    const int blk = first + it / NS, s = it % NS;
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int k = 0; k < KA; ++k) bacc[r][k] = 0.f;
      bagg = rk::agg_init(P::AGG);
    }
    bool skip = false;
#ifdef RK_PLANTED_FAULT
    // a fault planted only in chip_smoke.py's own builds: right_mm skips
    // the middle block of every block row
    skip = L::RMM && blk == rowptr[br] + (rowptr[br + 1] - rowptr[br]) / 2;
#endif
    if (!skip) {
      const long long gj0 = (long long)cols[blk] * BS + s * SC + h * CW;
      const float* xr = buf + g * LDX + h * CW;
      const float* vr = buf + L::XF + h * CW * RP;
      const float* cr = buf + L::XF + L::VF + h * CW * KP;
#pragma unroll
      for (int c4 = 0; c4 < CW; c4 += 4) {
        float xv[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(xr + r * RB * LDX + c4);
          xv[r][0] = x4.x; xv[r][1] = x4.y; xv[r][2] = x4.z; xv[r][3] = x4.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = c4 + c;
          float v[RP];
          outer::load_row<RP>(v, vr + j * RP);
          float val[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            float sv = 0.f;
#pragma unroll
            for (int q = 0; q < R; ++q) sv = fmaf(u[r][q], v[q], sv);
            val[r] = P::eval(b, xv[r][c], sv, gi0 + r * RB, gj0 + j, n);
          }
          if constexpr (L::OWN_CLOSER) {
            float w[KP];
            outer::load_row<KP>(w, cr + j * KP);
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int k = 0; k < K; ++k)
                bacc[r][k] = fmaf(val[r], w[k], bacc[r][k]);
          } else if constexpr (L::RMM) {
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int k = 0; k < K; ++k)
                bacc[r][k] = fmaf(val[r], v[k], bacc[r][k]);
          } else {
#pragma unroll
            for (int r = 0; r < RT; ++r)
              bagg = rk::agg_add(P::AGG, bagg, val[r]);
          }
        }
      }
    }
    if (s == NS - 1) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int k = 0; k < KA; ++k) acc[r][k] += bacc[r][k];
      agg = rk::agg_comb(P::AGG, agg, bagg);
    }
  }
  outer::cp_wait<0>();
  __syncthreads();                  // the ring is free for the fold

  if constexpr (L::RMM) {
    // the stripes' sums as all[(h K + k) BS + row]; added in stripe
    // order into this piece's partial
    float* all = smem;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int k = 0; k < K; ++k)
        all[(h * K + k) * BS + g + r * RB] = acc[r][k];
    __syncthreads();
    float* dst = part + p * BS * K;
    for (int e = tid; e < BS * K; e += T) {
      const int k = e / BS, i = e % BS;
      float v = all[e];
#pragma unroll
      for (int q = 1; q < L::H; ++q) v += all[q * K * BS + e];
      dst[i * K + k] = v;
    }
  } else {
    float* red = smem;
    red[tid] = agg;
    __syncthreads();
    for (int w = 1; w < T; w <<= 1) {        // fixed tree, any T
      if (tid % (2 * w) == 0 && tid + w < T)
        red[tid] = rk::agg_comb(P::AGG, red[tid], red[tid + w]);
      __syncthreads();
    }
    if (tid == 0) part[p] = red[0];
  }
}

// right_mm, second pass: out[row] = the row's piece partials added in
// piece order (every row has at least one piece)
template <class P>
__global__ void __launch_bounds__(256)
outer_fold(const int* __restrict__ pieceptr, const float* __restrict__ part,
           float* __restrict__ out) {
  constexpr int E = P::BS * P::K;
  const long long br = blockIdx.x;
  const int p0 = pieceptr[br], p1 = pieceptr[br + 1];
  for (int e = threadIdx.x; e < E; e += 256) {
    float v = part[(long long)p0 * E + e];
    for (int q = p0 + 1; q < p1; ++q) {
#ifdef RK_PLANTED_FOLD
      // a fault planted only in chip_smoke.py's own builds: the fold
      // drops the middle piece of every row of two or more pieces
      if (q == p0 + (p1 - p0) / 2) continue;
#endif
      v += part[(long long)q * E + e];
    }
    out[br * E + e] = v;
  }
}

// one CTA per piece (npieces of them, at least one per block row); the
// run-time bs, r, k must be the compiled ones and the staged operands
// 16-byte aligned (cudaErrorInvalidValue / cudaErrorMisalignedAddress
// otherwise); right_mm: part holds npieces (BS x K) partials that
// outer_fold adds into out; full_agg: part holds one partial per piece
// and rk::combine folds them into out (1 x 1)
template <class P>
int outer_launch(void* const* binds, const void* xdata, const void* cols,
                 const void* rowptr, const void* pieces,
                 const void* pieceptr, long long npieces,
                 const void* closer, void* out, void* part, long long m,
                 long long n, int nblocks, int bs, int r, int k,
                 void* stream, int device) {
  using L = outer::Layout<P>;
  const long long mb = m / P::BS;
  if (bs != P::BS || r != P::R || k != P::K || m % P::BS || n % P::BS ||
      nblocks < 1 || npieces < mb || npieces > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (P::CLOSE_IS_V && closer != binds[P::VB])
    return (int)cudaErrorInvalidValue;
  auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (misaligned(xdata) || (P::R % 4 == 0 && misaligned(binds[P::VB])) ||
      (L::OWN_CLOSER && P::K % 4 == 0 && misaligned(closer)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::Binds<P::NB> b = rk::pack_binds<P::NB>(binds);
  err = cudaFuncSetAttribute(outer_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM);
  if (err != cudaSuccess) return (int)err;
  outer_kernel<P><<<(unsigned)npieces, P::THREADS, P::SMEM, s>>>(
      b, static_cast<const float*>(xdata), static_cast<const int*>(cols),
      static_cast<const int*>(rowptr), static_cast<const int*>(pieces),
      static_cast<const float*>(closer), static_cast<float*>(out),
      static_cast<float*>(part), n);
  if constexpr (L::RMM)
    outer_fold<P><<<(unsigned)mb, 256, 0, s>>>(
        static_cast<const int*>(pieceptr), static_cast<const float*>(part),
        static_cast<float*>(out));
  else
    rk::combine<P><<<1, 256, 0, s>>>(static_cast<const float*>(part),
                                     static_cast<float*>(out),
                                     (int)npieces, 1.0);
  return (int)cudaGetLastError();
}
