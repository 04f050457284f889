// Shared device helpers of the generated fused-operator kernels
// (cell.cuh, magg.cuh, row.cuh).
//
// Every kernel of this directory is a fixed template skeleton; the Python
// emitter (repro_torch/kernels/cuda_src.py) writes one `struct Prog` per
// CPlan — the program's __device__ body plus its compile-time widths — and
// an extern "C" launcher that instantiates the skeleton for it.  The
// semantics of every op below are those of repro_torch/kernels/ref.py
// (the torch-eager oracle); fp32 throughout, no TF32, no fast-math.
//
// Reductions are deterministic: no float atomics.  Partials are written
// in a fixed layout and combined by `combine` in partial order with a
// fixed tree, so a run gives the same bits as the run before it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rk {

template <int NB>
struct Binds {
  const float* p[NB > 0 ? NB : 1];
};

// aggregation codes; "mean" accumulates as AGG_SUM and divides at the end
enum { AGG_SUM = 0, AGG_MIN = 1, AGG_MAX = 2, AGG_SUMSQ = 3 };

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float agg_init(int op) {
  return op == AGG_MIN ? INFINITY : (op == AGG_MAX ? -INFINITY : 0.f);
}
// combine two partial aggregates
__device__ __forceinline__ float agg_comb(int op, float a, float b) {
  return op == AGG_MIN ? nmin(a, b) : (op == AGG_MAX ? nmax(a, b) : a + b);
}
// fold one raw value into an accumulator
__device__ __forceinline__ float agg_add(int op, float acc, float v) {
  return op == AGG_SUMSQ ? acc + v * v : agg_comb(op, acc, v);
}

// butterfly reduction over groups of L consecutive lanes (L = 32: the
// whole warp; L = 1: no-op).  Every lane of a group ends with the same
// bits: IEEE add/min/max are commutative, so each level pairs equal sums.
template <int L>
__device__ __forceinline__ float lane_reduce(int op, float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = agg_comb(op, v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- asynchronous copies into shared memory (the Outer and Row rings) ---
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- cell-wise op table (mirrors ref._UNARY / ref._BINARY) -------------
__device__ __forceinline__ float f_relu(float x) { return (x > 0.f || x != x) ? x : 0.f; }
__device__ __forceinline__ float f_sign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }
__device__ __forceinline__ float f_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float f_softplus(float x) { return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))); }
__device__ __forceinline__ float f_gelu(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
}
__device__ __forceinline__ float f_silu(float x) { return x * f_sigmoid(x); }
__device__ __forceinline__ float f_neq0(float x) { return x != 0.f ? 1.f : 0.f; }
__device__ __forceinline__ float f_cmp(bool c) { return c ? 1.f : 0.f; }
__device__ __forceinline__ float f_where(float c, float a, float b) { return c != 0.f ? a : b; }

// second pass of every reducing variant: out[e] = fin(e, combine over
// nparts partials part[p * E + e], in p order); E = gridDim.x
template <class P>
__global__ void __launch_bounds__(256)
combine(const float* __restrict__ part, float* __restrict__ out, int nparts,
        double aux) {
  __shared__ float sm[256];
  const int e = blockIdx.x, E = gridDim.x, tx = threadIdx.x;
  const int op = P::agg_of(e);
  float acc = agg_init(op);
  for (int p = tx; p < nparts; p += 256) {
#ifdef RK_PLANTED_FAULT
    // a fault planted only in chip_smoke.py's own builds, to show that its
    // check rejects a reduction that lost one partial
    if (p == nparts / 2) continue;
#endif
    acc = agg_comb(op, acc, part[(long long)p * E + e]);
  }
  sm[tx] = acc;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tx < s) sm[tx] = agg_comb(op, sm[tx], sm[tx + s]);
    __syncthreads();
  }
  if (tx == 0) out[e] = P::fin(e, sm[0], aux);
}

template <int NB>
__host__ inline Binds<NB> pack_binds(void* const* ptrs) {
  Binds<NB> b;
  for (int k = 0; k < NB; ++k) b.p[k] = static_cast<const float*>(ptrs[k]);
  return b;
}

}  // namespace rk
