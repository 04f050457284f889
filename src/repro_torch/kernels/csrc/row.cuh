// Row template skeleton: the fused row-wise program, one row at a time.
//
// Replaces repro/kernels/rowwise.py::row_pallas (all five variants, narrow
// in-program matmuls row @ side, in-program row aggregates such as
// rowsums / rowmaxs).  The reference walks (bm x n) row panels resident in
// VMEM; the Hopper counterpart of a panel is a tile of whole rows in shared
// memory.
//
// Bound on the card: bytes.  A row of the main input is read once and the
// program does O(n·k) flops on it with k narrow: at MLogReg's n = 100,
// k = 5 that is 2.5 flop/byte for X @ B plus as much again for a col_t_agg
// close, far below the ~20 flop/byte fp32 ridge.  So the kernel has to
// stream X at HBM rate with few instructions per byte.
//
// Four layouts, chosen per CPlan by cuda_src.row_source and written into
// Prog::LAYOUT:
//
// * Tile layout (LAYOUT 1, row_tile_kernel), every program whose computed
//   row values are at most NARROW wide (cuda_src.py) -- all of the six
//   algorithms' Row CPlans.  A persistent grid of CTAS CTAs per SM walks
//   tiles of R rows in a fixed stride order.  The tile of the main and of
//   every side with m rows goes into a ring of STAGES buffers in dynamic
//   shared memory with 16-byte cp.async (4-byte copies where a width is not
//   a multiple of 4 or a base is not 16-byte aligned), STAGES - 1 tiles
//   ahead of the one computed; the ragged last tile copies its rows only.
//   Phase A: a thread per row (LT = 128 / R lanes per row when a tile has
//   fewer rows than the CTA threads: wide rows of few rows, such as the
//   autoencoder's 500 columns), every value in registers (float v[w]); the
//   main's row is read from the tile as float4 where its width is a
//   multiple of 4 (a 400-byte pitch puts a quarter-warp's 16-byte reads on
//   all 32 banks once), else as floats.  Elementwise values of the tile row
//   that are wider than NARROW (X ** 2, sigmoid(H + b)) are never stored:
//   they are evaluated per element where they are consumed.  Narrow
//   products row @ side keep one accumulator per output column and read
//   the side from shared memory (staged once per CTA, column-major, so one
//   float4 broadcast serves four FMAs); row aggregates are register loops.
//   Phase B, the CTA together, after a barrier:
//     - col_t_agg close (closer^T @ root): thread (g, s) owns closer
//       columns [KT g, KT g + KT) x all C root columns in registers over
//       the tile rows s, s + SL, ...; the root comes from a per-tile
//       shared-memory buffer gs written in phase A.  The accumulators live
//       across all of the CTA's tiles; at the end the SL row slices are
//       added in slice order into one partial per CTA.
//     - a no_agg root that is a wide product G @ B (the MLogReg gradient
//       G B^T back to n columns): thread t owns output column t % CW (B's
//       column in registers) and rows t / CW + PBR q of the tile; G's row
//       comes from gs as a broadcast; the stores of a row are coalesced.
//   col_agg and full_agg keep per-thread register accumulators across the
//   tiles and fold them in thread order into one partial per CTA.
//   Shared memory: SMEM bytes, from cuda_src.py's layout, checked below
//   against this header's own sum.
//
// * Warp layout (LAYOUT 0, row_kernel), programs with wide computed values
//   (e.g. tanh(X @ B) with 256 columns) whose row arrays fit
//   cuda_src.WARP_FLOATS_MAX register floats a lane, the most ptxas
//   compiled without spill (192), and the column aggregates and in-program
//   matmuls the wide-row layouts cannot express (up to
//   WARP_FLOATS_LIMIT): L lanes per row (L = 32, a warp
//   per row, for rows with vector values; L = 1 for programs of per-row
//   scalars), rows strided over the grid.  A value of width w lives
//   lane-distributed (element j on lane j % L, slot j / L).  Row
//   aggregates and narrow matmuls reduce with warp butterflies; wider
//   matmuls and the col_t_agg close stage the row in a per-warp shared
//   buffer.  Sides are read through the read-only cache.  One partial per
//   warp.
//
// * Staged layout (LAYOUT 3, row_staged_kernel in row_staged.cuh), rows
//   too wide for the warp layout's registers that a thread-block cluster
//   holds (the fused softmax-CE loss over a vocabulary, the LM rmsnorm):
//   each row copied once into shared memory by TMA bulk copies, split
//   across a cluster of up to 16 CTAs, every pass over it reading shared
//   memory, the row aggregates folded across the cluster through DSMEM;
//   see that header.
//
// * Streaming layout (LAYOUT 2, row_stream_kernel in row_stream.cuh),
//   rows wider than a cluster's shared memory holds (4 MB and more): a
//   CTA a row, the row read from HBM in column slices once a pass; see
//   that header.
//
// All: IEEE fp32 FMAs (no TF32, no fast-math); partials are folded in
// order by rk::combine, no float atomics, so a rerun gives the same bits.
//
// Request axis (common.cuh): gridDim.z requests in one launch, each with
// the persistent grid above in x (the wrapper shares it out over the
// requests) and its own tile geometry; request q reads its binds at their
// per-request strides, writes out + q * ostride (no_agg, row_agg) or its
// partials after request q - 1's, which rk::combine folds per request.
//
// Prog contract, warp layout (written by cuda_src.py):
//   LAYOUT = 0, NB, L, WPB, SMW   binds, lanes per row, warps per CTA,
//                                 staging floats per warp (>= 1)
//   C, KC, TR, TK, TE             root width, closer width (col_t_agg),
//                                 register slots of root / closer / acc
//   VARIANT, AGG, MEAN
//   eval(b, i, sub, sm, r[TR], c[TK])   the program on row i
//   agg_of(e), fin(e, acc, aux)
// Prog contract, tile layout:
//   LAYOUT = 1, NB, T, R, LT, STAGES, CTAS, SMEM   threads, rows per
//                                 tile, lanes per row in phase A, ring
//                                 depth, CTAs per SM, dynamic smem bytes
//   NT, tile_bind(k), tile_width(k), tile_off(k)   the tiled binds, their
//                                 widths and offsets (floats) in a stage
//   C, KC, TO, VARIANT, AGG, MEAN  root / closer width, phase-A outputs
//   GP, SBF, PHASE_B              gs floats per row, staged side floats,
//                                 phase B (0 none, 1 close, 2 wide root)
//   KT, NG, SL                    close: closer columns per thread, column
//                                 groups, row slices
//   K, CW, PBR, U                 wide root: inner width, column threads,
//                                 rows in parallel, columns per thread
//   stage_sides(b, sb, tid)       the matmul sides into shared memory
//   eval(b, buf, sb, gs, r, sub, o[TO])   phase A on tile row r, lane sub
//   closer_at / root_at (close), left_at / bcol (wide root)
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include "common.cuh"

namespace row {
enum { NO_AGG = 0, ROW_AGG = 1, COL_AGG = 2, FULL_AGG = 3, COL_T_AGG = 4 };
}

template <class P>
__global__ void __launch_bounds__(P::WPB * 32)
row_kernel(rk::BBinds<P::NB> bb, float* __restrict__ out, long long ostride,
           float* __restrict__ part, long long m, float count) {
  constexpr int L = P::L;
  constexpr int E = P::VARIANT == row::COL_AGG ? P::C
                    : P::VARIANT == row::COL_T_AGG ? P::KC * P::C : 1;
  const rk::Binds<P::NB> b = bb.at(blockIdx.z);
  out += blockIdx.z * ostride;
  part += (long long)blockIdx.z * gridDim.x * P::WPB * E;
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

namespace rowtile {
#ifdef RK_PLANTED_FAULT
// a fault planted only in chip_smoke.py's own builds: the tile layout's
// row_agg drops the middle element of each row (cuda_src.py reads this
// flag), and its col_t_agg close drops the middle row slice's partial; a
// warp-layout program's own row aggregates (the rmsnorm's row mean) drop
// the middle lane's partial
constexpr bool kPlanted = true;
#else
constexpr bool kPlanted = false;
#endif
enum { NONE = 0, CLOSE = 1, WIDE = 2 };

constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

// this header's own sum of the tile layout's shared memory
template <class P>
struct Layout {
  static constexpr int stage() {
    int s = 0;
    for (int k = 0; k < P::NT; ++k) s += pad4(P::R * P::tile_width(k));
    return s;
  }
  static constexpr bool offsets_agree() {
    int s = 0;
    for (int k = 0; k < P::NT; ++k) {
      if (P::tile_off(k) != s) return false;
      s += pad4(P::R * P::tile_width(k));
    }
    return true;
  }
  static constexpr int STAGE = stage();
  static constexpr int GSF = pad4(P::R * P::GP);
  static constexpr int MAIN = P::STAGES * STAGE + GSF + P::SBF;
  static constexpr int FOLD =
      P::VARIANT == row::FULL_AGG ? P::T
      : P::VARIANT == row::COL_AGG ? P::T * P::C
      : P::VARIANT == row::COL_T_AGG ? P::SL * P::KC * P::C : 0;
  static constexpr int FLOATS = MAIN > FOLD ? MAIN : FOLD;
  static constexpr int NACC = P::VARIANT == row::COL_AGG ? P::C
                              : P::VARIANT == row::COL_T_AGG ? P::KT * P::C
                                                             : 1;
  static_assert(offsets_agree(),
                "row tile offsets differ from cuda_src.py's accounting");
  static_assert(FLOATS * 4 == P::SMEM,
                "row tile layout differs from cuda_src.py's accounting");
  static_assert(P::SMEM <= 232448, "a CTA may have 227 KB");
  static_assert(P::STAGES >= 2 && P::T % 32 == 0, "row tile: 2+ stages");
  static_assert(P::LT == 1 || (P::LT <= 32 && 32 % P::LT == 0 &&
                               P::R % (P::T / P::LT) == 0),
                "row tile: LT lanes per row, whole rows per pass");
  static_assert(P::PHASE_B != CLOSE || P::NG * P::SL <= P::T,
                "row tile close: one thread per (group, slice)");
};

// rows x W floats of every tiled bind, from row row0, into a ring stage
template <class P>
__device__ __forceinline__ void load_tile(const rk::Binds<P::NB>& b,
                                          float* buf, long long row0,
                                          int rows, int tid) {
#pragma unroll
  for (int k = 0; k < P::NT; ++k) {
    const int W = P::tile_width(k);
    const float* src = b.p[P::tile_bind(k)] + row0 * W;
    float* dst = buf + P::tile_off(k);
    const int n = rows * W;
    if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int e = tid; e < n / 4; e += P::T) rk::cp16(dst + 4 * e, src + 4 * e);
    } else {
      for (int e = tid; e < n; e += P::T) rk::cp4(dst + e, src + e);
    }
  }
}
}  // namespace rowtile

#include "row_stream.cuh"
#include "row_staged.cuh"

template <class P>
__global__ void __launch_bounds__(P::T, P::CTAS)
row_tile_kernel(rk::BBinds<P::NB> bb, float* __restrict__ out,
                long long ostride, float* __restrict__ part, long long m,
                float count) {
  using L = rowtile::Layout<P>;
  constexpr int T = P::T, R = P::R, S = P::STAGES, C = P::C;
  constexpr int E = P::VARIANT == row::COL_AGG ? C
                    : P::VARIANT == row::COL_T_AGG ? P::KC * C : 1;
  const rk::Binds<P::NB> b = bb.at(blockIdx.z);
  out += blockIdx.z * ostride;
  part += (long long)blockIdx.z * gridDim.x * E;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem + S * L::STAGE;
  float* sb = gs + L::GSF;
  const int tid = threadIdx.x;
  P::stage_sides(b, sb, tid);       // read after the loop's first barrier

  const long long ntiles = (m + R - 1) / R;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long items =
      first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  auto stage = [&](long long it) {
    const long long row0 = (first + it * stride) * R;
    const long long left = m - row0;
    rowtile::load_tile<P>(b, smem + (it % S) * L::STAGE, row0,
                          (int)(left < R ? left : R), tid);
  };
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    if (it < items) stage(it);
    rk::cp_commit();
  }

  float acc[L::NACC];
#pragma unroll
  for (int t = 0; t < L::NACC; ++t)
    acc[t] = P::VARIANT == row::COL_T_AGG ? 0.f : rk::agg_init(P::AGG);
  // close: column group g, row slice s; wide root: column jt, first row r0
  const int g = tid % P::NG, sl = tid / P::NG;
  const bool closing = P::PHASE_B == rowtile::CLOSE && sl < P::SL;
  const int jt = tid % P::CW, r0 = tid / P::CW;
  const bool widening = P::PHASE_B == rowtile::WIDE && r0 < P::PBR;
  float bv[P::U][P::K];
#pragma unroll
  for (int u = 0; u < P::U; ++u)
#pragma unroll
    for (int q = 0; q < P::K; ++q) bv[u][q] = 0.f;
  if constexpr (P::PHASE_B == rowtile::WIDE) {
#pragma unroll
    for (int u = 0; u < P::U; ++u)
      if (widening && jt + u * P::CW < C) P::bcol(b, jt + u * P::CW, bv[u]);
  }

  for (long long it = 0; it < items; ++it) {
    rk::cp_wait<S - 2>();           // this thread's copies of tile it
    __syncthreads();                // everyone's; tile it - 1 is done
    if (it + S - 1 < items) stage(it + S - 1);
    rk::cp_commit();
    const float* buf = smem + (it % S) * L::STAGE;
    const long long row0 = (first + it * stride) * R;
    const int rows = (int)(m - row0 < R ? m - row0 : R);

    // phase A: a thread per row (LT lanes per row when the tile has fewer
    // rows than threads: every lane runs the same trips, so the lanes'
    // butterflies see the whole warp; a lane past the last row computes
    // on stale shared memory and writes nothing)
    auto row_a = [&](int r, int sub, bool valid) {
      const long long i = row0 + r;
      float o[P::TO];
      P::eval(b, buf, sb, gs, r, sub, o);
      if (!valid || sub != 0) return;
      if constexpr (P::VARIANT == row::NO_AGG &&
                    P::PHASE_B == rowtile::NONE) {
#pragma unroll
        for (int t = 0; t < C; ++t) out[i * C + t] = o[t];
      } else if constexpr (P::VARIANT == row::ROW_AGG) {
        out[i] = P::MEAN ? o[0] / count : o[0];
      } else if constexpr (P::VARIANT == row::FULL_AGG) {
        acc[0] = rk::agg_comb(P::AGG, acc[0], o[0]);
      } else if constexpr (P::VARIANT == row::COL_AGG) {
#pragma unroll
        for (int t = 0; t < C; ++t) acc[t] = rk::agg_add(P::AGG, acc[t], o[t]);
      }
    };
    if constexpr (P::LT == 1) {
      for (int r = tid; r < rows; r += T) row_a(r, 0, true);
    } else {
      for (int r = tid / P::LT; r < R; r += T / P::LT)
        row_a(r, tid % P::LT, r < rows);
    }

    // phase B: the CTA together on the tile
    if constexpr (P::PHASE_B == rowtile::CLOSE) {
      __syncthreads();
      if (closing) {
        for (int r = sl; r < rows; r += P::SL) {
          float cv[P::KT], rv[C];
          P::closer_at(b, buf, gs, r, g * P::KT, cv);
          P::root_at(b, buf, gs, r, rv);
#pragma unroll
          for (int kt = 0; kt < P::KT; ++kt)
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[kt * C + c] = fmaf(cv[kt], rv[c], acc[kt * C + c]);
        }
      }
    } else if constexpr (P::PHASE_B == rowtile::WIDE) {
      __syncthreads();
      if (widening) {
        for (int r = r0; r < rows; r += P::PBR) {
          float gv[P::K];
          P::left_at(b, buf, gs, r, gv);
          float* dst = out + (row0 + r) * C;
#pragma unroll
          for (int u = 0; u < P::U; ++u) {
            const int j = jt + u * P::CW;
            float v = 0.f;
#pragma unroll
            for (int q = 0; q < P::K; ++q) v = fmaf(gv[q], bv[u][q], v);
            if (j < C) dst[j] = v;
          }
        }
      }
    }
  }
  rk::cp_wait<0>();
  __syncthreads();                  // the ring is free for the fold

  // one partial per CTA, folded in a fixed order
  float* red = smem;
  if constexpr (P::VARIANT == row::FULL_AGG) {
    red[tid] = acc[0];
    __syncthreads();
    for (int w = 1; w < T; w <<= 1) {        // fixed tree, any T
      if (tid % (2 * w) == 0 && tid + w < T)
        red[tid] = rk::agg_comb(P::AGG, red[tid], red[tid + w]);
      __syncthreads();
    }
    if (tid == 0) part[blockIdx.x] = red[0];
  } else if constexpr (P::VARIANT == row::COL_AGG) {
#pragma unroll
    for (int t = 0; t < C; ++t) red[t * T + tid] = acc[t];
    __syncthreads();
    if (tid < C) {
      float a = red[tid * T];
      for (int q = 1; q < T; ++q) a = rk::agg_comb(P::AGG, a, red[tid * T + q]);
      part[(long long)blockIdx.x * C + tid] = a;
    }
  } else if constexpr (P::VARIANT == row::COL_T_AGG) {
    constexpr int E = P::KC * C;
    if (closing) {
#pragma unroll
      for (int kt = 0; kt < P::KT; ++kt) {
        const int col = g * P::KT + kt;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (col < P::KC) red[sl * E + col * C + c] = acc[kt * C + c];
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += T) {
      float v = red[e];
      for (int q = 1; q < P::SL; ++q)
        if (!(rowtile::kPlanted && q == P::SL / 2)) v += red[q * E + e];
      part[(long long)blockIdx.x * E + e] = v;
    }
  }
}

// binds / strides: bind pointers and per-request strides (floats); nreq:
// requests (gridDim.z); out + q * ostride: request q's output; nblocks:
// grid size per request (staged layout: the most it may use); partials:
// one per CTA (tile, streaming layout), per cluster (staged layout) or per
// warp (warp layout) x E elements (E = 1 full_agg, C col_agg, KC·C col_t_agg)
// per request; aux: the mean count of the variant (row_agg: root width,
// col_agg: m, full_agg: m·width)
template <class P>
int row_launch(void* const* binds, const long long* strides, int nreq,
               float* out, long long ostride, float* part, void* ticket,
               long long m, int nblocks, double aux, void* stream,
               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rk::BBinds<P::NB> b = rk::pack_bbinds<P::NB>(binds, strides);
  const dim3 grid(nblocks, 1, nreq);
  int nparts;
  if constexpr (P::LAYOUT == 1) {
    err = cudaFuncSetAttribute(row_tile_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::SMEM);
    if (err != cudaSuccess) return (int)err;
    row_tile_kernel<P><<<grid, P::T, P::SMEM, s>>>(b, out, ostride, part, m,
                                                   (float)aux);
    nparts = nblocks;
  } else if constexpr (P::LAYOUT == 2) {
    row_stream_kernel<P><<<grid, P::T, 0, s>>>(b, out, ostride, part, m,
                                               (float)aux);
    nparts = nblocks;
  } else if constexpr (P::LAYOUT == 3) {
    err = row_staged_launch<P>(b, nreq, out, ostride, part, m, nblocks, aux,
                               s, device, &nparts);
    if (err != cudaSuccess) return (int)err;
  } else {
    row_kernel<P><<<grid, P::WPB * 32, 0, s>>>(b, out, ostride, part, m,
                                               (float)aux);
    nparts = nblocks * P::WPB;
  }
  if constexpr (P::VARIANT == row::COL_AGG || P::VARIANT == row::FULL_AGG ||
                P::VARIANT == row::COL_T_AGG) {
    constexpr int E = P::VARIANT == row::FULL_AGG ? 1
                    : (P::VARIANT == row::COL_AGG ? P::C : P::KC * P::C);
    rk::combine<P><<<dim3(E, 1, nreq), 256, 0, s>>>(part, out, nparts, aux,
                                                    ostride);
  }
  return (int)cudaGetLastError();
}
