// Row template, staged layout (LAYOUT 3, row_staged_kernel): rows too wide
// for the warp layout's registers that fit, once, in the shared memory of
// one CTA or of a thread-block cluster -- the fused softmax-CE loss over a
// vocabulary row (V = 32,000 to 262,144) and the LM rmsnorm (2,048 to 4,096
// columns).  Included by row.cuh, whose row_launch starts it.
//
// Bound on the card: bytes.  Each row of every row-wide bind is read from
// HBM once (the streaming layout reads it once a pass: twice for the loss's
// forward, four times for its backward), a wide no_agg root is written
// once.  So the passes that cuda_src.py splits the program into read
// shared memory, not HBM.
//
// Layout: a cluster of K CTAs takes a row at a time; CTA rank r holds the
// columns [r NK, r NK + NK) of it.  A persistent grid of clusters
// (cudaOccupancyMaxActiveClusters, shared out over the requests) walks
// rows i = cluster, + clusters, ...  Dynamic shared memory holds a ring
// of S row stages, each the CTA's slice of every row-wide bind with m rows
// (NR of them, row_bind(k)), and the slice of every row-wide (1, N) bind
// (NSD, side_bind(k)), staged once and kept across the CTA's rows.
//
// * Filling: thread 0 issues one TMA bulk copy (cp.async.bulk) a chunk of
//   CHW columns a bind, CH chunks a slice, each chunk completing on its own
//   mbarrier (one a chunk a stage); rows 0 .. S-1 are issued ahead, row
//   it + S once every thread is done with row it's stage.  The first pass
//   of a row folds chunk c as soon as its barrier completes, so the copy
//   of the rest overlaps it; the later passes and the write pass read the
//   whole slice from shared memory.  The next rows of an SM load while a
//   row finishes its passes through the other CTAs the SM holds (a wide
//   row: S = 1, a CTA a third of the SM's shared memory) or through the
//   ring (a narrow row: S = 4, CH = 1).  A row whose width is not a
//   multiple of 4 or whose bind is not 16-byte aligned (a batched
//   request's, say) takes the scalar path: the threads copy the slice with
//   plain loads and every pass walks it column by column.  (No main path
//   has such a row: every vocabulary and model width there is a multiple
//   of 4.)
// * Folds, deterministic, one exchange a pass for all of its NA
//   aggregates (a fold costs the CTA about a microsecond whatever K is):
//   each thread folds its columns in order (groups of 4 at 4 tid, + 4T,
//   ...; the first pass walks them chunk by chunk, which is the same
//   order), a warp butterfly, thread a over the warps' partials of
//   aggregate a in order; then, with K > 1, every CTA puts its partials in
//   its own shared memory, barrier.cluster, lane r of warp a reads rank
//   r's partial of aggregate a through DSMEM (one round trip for all), and
//   lane 0 folds them in rank order 0 .. K-1.  Every CTA holds the same
//   bits, and a rerun gives the same bits; no float atomics.  The partials
//   are double-buffered by row parity: a peer still reading row it's
//   partial is past none of row it + 1's cluster barriers.
// * Results: the write pass stores the CTA's slice of a wide no_agg root;
//   rank 0's thread 0 writes a row scalar (no_agg, row_agg) or keeps the
//   full_agg fold of its rows and writes one partial a cluster, which
//   rk::combine folds.  A final cluster barrier keeps every CTA's shared
//   memory alive while a peer may still read it.
//
// A launch that the card refuses (too much shared memory, a cluster that
// cannot be scheduled) returns its error through row_launch; nothing falls
// back to another layout.
//
// Prog contract (written by cuda_src.py):
//   LAYOUT = 3, NB, T, K, S, CH, CHW   binds, threads a CTA, CTAs a cluster,
//                                 row stages, chunks a slice, columns a chunk
//   NR, NSD, NK, SMEM, VEC        row-staged binds, side binds, columns a
//                                 CTA, dynamic shared memory (bytes),
//                                 N % 4 == 0
//   NA                            most aggregates a pass folds
//   NPASS, WRITE, PASSES, NS, N   as the streaming layout's
//   C = 1, KC = 0, VARIANT, AGG, MEAN
//   row_bind(k), side_bind(k)     bind positions
//   row(b, i, tid, st, sd, n, vec, bars, par, rs, red, cp, o) -> the row's
//                                 value; st / sd: the stage's and the side
//                                 slices, n: the CTA's columns, bars: the
//                                 stage's chunk barriers at parity par, cp:
//                                 this row's cluster partials (NS), o: the
//                                 CTA's slice of the output row
//   agg_of(e), fin(e, acc, aux)
#pragma once

#include "common.cuh"

namespace rowstaged {

#ifdef RK_PLANTED_RANK
// a fault planted only in chip_smoke.py's own builds: the cluster fold
// leaves out rank K / 2's partial
constexpr bool kPlantedRank = true;
#else
constexpr bool kPlantedRank = false;
#endif

constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

// this header's own sum of the staged layout's shared memory (floats, then
// the barriers: one a chunk a stage, and the sides')
template <class P>
struct Layout {
  static constexpr int STAGE = P::NR * P::NK;
  static constexpr int SIDE = P::S * STAGE;
  static constexpr int RED = SIDE + P::NSD * P::NK;
  static constexpr int RS = RED + pad4(P::NA * (P::T / 32));
  static constexpr int CP = RS + pad4(P::NS);
  static constexpr int BAR = CP + pad4(2 * P::NS);
  static constexpr int NBAR = P::S * P::CH + 1;
  static_assert(4 * BAR + 8 * NBAR == P::SMEM,
                "row staged layout differs from cuda_src.py's accounting");
  static_assert(P::SMEM <= 232448, "a CTA may have 227 KB");
  static_assert(P::T % 32 == 0 && P::T <= 1024, "row staged: whole warps");
  static_assert(P::K >= 1 && P::K <= 16, "row staged: 1 to 16 CTAs");
  static_assert(P::NK % 4 == 0 && (long long)P::K * P::NK >= P::N,
                "row staged: K slices of NK columns cover the row");
  static_assert(P::CHW % (4 * P::T) == 0 && P::CH * P::CHW >= P::NK &&
                    (P::CH - 1) * P::CHW < P::NK,
                "row staged: chunks of whole 4T-column steps cover a slice");
  static_assert(4LL * P::CHW * (P::NR > 0 ? P::NR : 1) < (1 << 20) &&
                    4LL * P::NK * (P::NSD > 0 ? P::NSD : 1) < (1 << 20),
                "row staged: an mbarrier counts under 2^20 bytes");
  static_assert(P::PASSES >= 1, "row staged: some pass reads the row");
  static_assert(P::NA >= 1 && P::NA * 32 <= P::T && P::NA <= P::NS,
                "row staged: a warp for each aggregate of a pass");
};

__device__ __forceinline__ bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---- mbarriers and TMA bulk copies --------------------------------------
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   rk::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(rk::smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   rk::smem_addr(bar)) : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(rk::smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(rk::smem_addr(bar)) : "memory");
}
// spin until the phase of `bar` with parity `par` has completed
__device__ __forceinline__ void wait(uint64_t* bar, unsigned par) {
  const unsigned addr = rk::smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(par) : "memory");
  }
}

// ---- the cluster ---------------------------------------------------------
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster: writes before it are seen by
// reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at `p` in the shared memory of cluster rank `rank`
__device__ __forceinline__ float ld_rank(const float* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(rk::smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The cluster's fold of the NA aggregates of one pass, v[a] a thread
// folded with op[a] into slot sl[a]: a warp butterfly each, thread a over
// the warps' partials of aggregate a in order, then (K > 1) warp a over
// the K CTAs' partials in rank order; the results are in rs[sl[a]]
// (shared memory) for every thread of every CTA when it returns.  red:
// NA x T / 32 floats; cp: this row's partials of every slot (shared
// memory, read by the peers).
template <int T, int K, int NA>
__device__ __forceinline__ void fold(const int (&op)[NA], const int (&sl)[NA],
                                     float (&v)[NA], float* red, float* cp,
                                     float* rs) {
  constexpr int W = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const float x = rk::lane_reduce<32>(op[a], v[a]);
    if (lane == 0) red[a * W + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NA; ++a) {   // (unrolled: op and sl stay constants)
    if (tid == a) {
      float x = red[a * W];
      for (int w = 1; w < W; ++w) x = rk::agg_comb(op[a], x, red[a * W + w]);
      (K == 1 ? rs : cp)[sl[a]] = x;
    }
  }
  if constexpr (K > 1) {
    cluster_sync();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (warp == a) {          // lane r reads rank r's partial, lane 0 folds
        const float p = lane < K ? ld_rank(cp + sl[a], lane) : 0.f;
        float x = __shfl_sync(0xffffffffu, p, 0);
#pragma unroll
        for (int r = 1; r < K; ++r) {
          const float q = __shfl_sync(0xffffffffu, p, r);
          if (!(kPlantedRank && r == K / 2)) x = rk::agg_comb(op[a], x, q);
        }
        if (lane == 0) rs[sl[a]] = x;
      }
    }
  }
  __syncthreads();
}

}  // namespace rowstaged

template <class P>
__global__ void __launch_bounds__(P::T)
row_staged_kernel(rk::BBinds<P::NB> bb, float* __restrict__ out,
                  long long ostride, float* __restrict__ part, long long m,
                  float count) {
  using L = rowstaged::Layout<P>;
  constexpr int T = P::T, K = P::K, S = P::S, CH = P::CH, NK = P::NK;
  const rk::Binds<P::NB> b = bb.at(blockIdx.z);
  out += blockIdx.z * ostride;
  const long long cid = blockIdx.x / K, ncl = gridDim.x / K;
  part += (long long)blockIdx.z * ncl;
  const unsigned rank = K > 1 ? rowstaged::cluster_rank() : 0u;
  extern __shared__ __align__(16) float smem[];
  float* sd = smem + L::SIDE;
  float* red = smem + L::RED;
  float* rs = smem + L::RS;
  float* cpart = smem + L::CP;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* side_bar = bar + S * CH;
  const int tid = threadIdx.x;
  const long long col0 = (long long)rank * NK;
  const long long left = P::N - col0;
  const int n = (int)(left < NK ? (left > 0 ? left : 0) : NK);
  bool vec = P::VEC;
#pragma unroll
  for (int k = 0; k < P::NR; ++k)
    vec = vec && rowstaged::aligned(b.p[P::row_bind(k)]);
#pragma unroll
  for (int k = 0; k < P::NSD; ++k)
    vec = vec && rowstaged::aligned(b.p[P::side_bind(k)]);
  if (P::WRITE) vec = vec && rowstaged::aligned(out);
  const long long items = cid < m ? (m - 1 - cid) / ncl + 1 : 0;

  if (tid == 0) {
    for (int e = 0; e < L::NBAR; ++e) rowstaged::bar_init(bar + e, 1);
    rowstaged::fence_bar_init();
  }
  if constexpr (K > 1) rowstaged::cluster_sync(); else __syncthreads();

  // thread 0: row it's slices into stage it % S, chunk by chunk
  auto issue = [&](long long it) {
    const long long i = cid + it * ncl;
    float* st = smem + (it % S) * L::STAGE;
    uint64_t* cb = bar + (it % S) * CH;
    for (int c = 0; c < CH; ++c) {
      const int lo = c * P::CHW;
      const int w = n - lo < P::CHW ? (n - lo > 0 ? n - lo : 0) : P::CHW;
      if (rowtile::kPlanted && c == CH / 2) {
        // a fault planted only in chip_smoke.py's own builds: the middle
        // chunk is never copied (its barrier completes on stale memory)
        rowstaged::arrive(cb + c);
        continue;
      }
      rowstaged::arrive_tx(cb + c, (unsigned)(4 * w * P::NR));
      if (w > 0) {
#pragma unroll
        for (int k = 0; k < P::NR; ++k)
          rowstaged::bulk_load(st + k * NK + lo,
                               b.p[P::row_bind(k)] + i * P::N + col0 + lo,
                               (unsigned)(4 * w), cb + c);
      }
    }
  };
  if (vec) {
    if (tid == 0) {
      rowstaged::arrive_tx(side_bar, (unsigned)(4 * n * P::NSD));
      if (n > 0) {
#pragma unroll
        for (int k = 0; k < P::NSD; ++k)
          rowstaged::bulk_load(sd + k * NK, b.p[P::side_bind(k)] + col0,
                               (unsigned)(4 * n), side_bar);
      }
      for (long long it = 0; it < S && it < items; ++it) issue(it);
    }
    rowstaged::wait(side_bar, 0);
  } else {
#pragma unroll
    for (int k = 0; k < P::NSD; ++k)
      for (int j = tid; j < n; j += T)
        sd[k * NK + j] = __ldg(b.p[P::side_bind(k)] + col0 + j);
  }

  float acc = rk::agg_init(P::AGG);
  for (long long it = 0; it < items; ++it) {
    const long long i = cid + it * ncl;
    float* st = smem + (it % S) * L::STAGE;
    if (!vec) {                  // the scalar path: a plain copy of the row
#pragma unroll
      for (int k = 0; k < P::NR; ++k) {
        const float* src = b.p[P::row_bind(k)] + i * P::N + col0;
        for (int j = tid; j < n; j += T) st[k * NK + j] = __ldg(src + j);
      }
      __syncthreads();
    }
    const float v = P::row(b, i, tid, st, sd, n, vec, bar + (it % S) * CH,
                           (unsigned)((it / S) & 1), rs, red,
                           cpart + (it & 1) * P::NS,
                           out + (P::WRITE ? i * P::N + col0 : i));
    if (tid == 0 && rank == 0) {
      if constexpr (P::VARIANT == 0) {          // no_agg, a row scalar
        if (!P::WRITE) out[i] = v;
      } else if constexpr (P::VARIANT == 1) {   // row_agg
        out[i] = P::MEAN ? v / count : v;
      } else {                                  // full_agg
        acc = rk::agg_comb(P::AGG, acc, v);
      }
    }
    // every thread is done with this stage (its reads have returned), so
    // the bulk copies of row it + S may overwrite it
    __syncthreads();
    if (vec && tid == 0 && it + S < items) issue(it + S);
  }
  if constexpr (P::VARIANT == 3) {
    if (tid == 0 && rank == 0) part[cid] = acc;
  }
  // no CTA leaves while a peer may still read its partials
  if constexpr (K > 1) rowstaged::cluster_sync();
}

// The staged kernel's launch: a cluster of K CTAs, SMEM bytes of dynamic
// shared memory each, as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters, read once a device), shared out over
// the requests and at most nblocks / K of them; *ncl: the clusters a
// request got (its partials).  A cluster size above 8 is non-portable and
// opted into.  Returns the first error.
template <class P>
cudaError_t row_staged_launch(const rk::BBinds<P::NB>& b, int nreq,
                              float* out, long long ostride, float* part,
                              long long m, int nblocks, double aux,
                              cudaStream_t s, int device, int* ncl) {
  auto kern = row_staged_kernel<P>;
  static int active[64];
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  if (P::K > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P::K, 1, 1);
  cfg.blockDim = dim3(P::T, 1, 1);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = device >= 0 && device < 64 ? active[device] : 0;
  if (fit < 1) {
    err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (device >= 0 && device < 64) active[device] = fit;
  }
  int per = (fit + nreq - 1) / nreq;
  if (per > nblocks / P::K) per = nblocks / P::K;
  if (per < 1) per = 1;
  cfg.gridDim = dim3(per * P::K, 1, nreq);
  *ncl = per;
  return cudaLaunchKernelEx(&cfg, kern, b, out, ostride, part, m,
                            (float)aux);
}
