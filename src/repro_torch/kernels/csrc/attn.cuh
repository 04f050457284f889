// Causal attention with an optional sliding window, grouped KV heads read
// by index, in IEEE fp32: a forward that saves (out, lse) and a backward
// that recomputes the scores (flash-attention structure).
//
// Replaces no kernel of the reference: the JAX package computes attention
// with einsums (repro/models/attention.py, its chunked online softmax over
// every key chunk); the port's plain version is
// repro_torch.models.attention._chunked_attention.  The kernel visits only
// the key blocks that hold a key inside a query block's causal window, so
// a window layer at 8,192 tokens and window 1,024 does 1/8 of a full
// layer's work, and keeps no score in device memory.
//
// Bound: fp32 operations (4·hd a visible query-key pair forward; the
// backward 8·hd needed, 14·hd done: the scores and dP are recomputed in
// both backward kernels) on the CUDA cores at 67 TFLOP/s; the bytes (q,
// k, v, out once) are two orders under it.  Design: 64 x 64 tiles, 256
// threads; a thread owns 4 x 4 scores (rows rg + 16i, columns cg + 16j) and
// 4 rows x DP/16 output columns, DP the head size rounded up to 64 (the
// columns past hd read as zeros and are never written); rows of shared
// memory are padded by 4
// floats so that a quarter-warp's 16-byte reads of 8 consecutive rows fall
// in 8 distinct bank groups, and the 16 lanes that share a row read it by
// broadcast; a row's max and sum are folded over those 16 lanes by
// shuffles.  No atomics: dK, dV of a KV head's key block are summed in one
// CTA over the heads of its group, dQ in another kernel, so a run gives the
// same bits as the run before it.  Query blocks are launched heaviest
// first (the last ones of a causal layer see the most keys).
//
// Over 128 (DP 192 or 256) four tiles no longer fit in shared memory: the
// backward kernels then keep K and V in one tile, loaded in turn for each
// block they meet (from L2), and dK's kernel writes P and dS into one
// score tile in turn.
//
// Layouts (contiguous): q, out, dq (B, S, H, D); k, v, dk, dv (B, S, KV,
// D); lse, delta (B, H, S); D a multiple of 4 up to 256.  Query head h
// reads KV head kv_of[h], or h / rep where kv_of is null.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef ATTN_D
#define ATTN_D 128
#endif

namespace attn {

constexpr int BQ = 64, BK = 64, NT = 256, PAD = 4;
constexpr int LP = BK + PAD;

struct Geo {
  const float* q;
  const float* k;
  const float* v;
  const int* kv_of;
  int S, H, KV, rep, window;
  float scale;
};

template <int D>
struct Dims {
  static_assert(D % 4 == 0 && D > 0 && D <= 256,
                "head_dim must be a multiple of 4 up to 256");
  static constexpr int DP = (D + 63) / 64 * 64;   // the columns computed
  static constexpr int LD = DP + PAD;    // a padded row of a tile
  static constexpr int NC = DP / 64;     // float4 columns a thread owns
  static constexpr bool stream = DP > 128;   // K and V share one tile
  static constexpr long long tile = (long long)BQ * LD;
};

// whether column c of a thread's float4 columns lies inside the head
template <int D>
__device__ __forceinline__ bool in_head(int c) {
  return D == Dims<D>::DP || c < D;
}

// rows r0 .. r0 + 63 of one head of a (B, S, heads, D) tensor into a padded
// shared tile; rows past S and columns past D read as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long tok, int r0, int S) {
  constexpr int C4 = Dims<D>::DP / 4, LD = Dims<D>::LD;
  for (int i = threadIdx.x; i < BQ * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && in_head<D>(c))
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * tok
                                             + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// acc[i][j] = A[rg + 16i] . B[cg + 16j] over DP
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int rg, int cg) {
  constexpr int LD = Dims<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dims<D>::DP; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][c][e] += sum_k P[rg + 16i][k] * V[k][4cg + 64c + e] over 64 k
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[4][Dims<D>::NC][4],
                                        const float* P, const float* V,
                                        int rg, int cg) {
  constexpr int LD = Dims<D>::LD, NC = Dims<D>::NC;
#pragma unroll 2
  for (int k = 0; k < BK; k += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p4[i] = *reinterpret_cast<const float4*>(P + (rg + 16 * i) * LP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 v4[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        v4[c] = *reinterpret_cast<const float4*>(V + (k + kk) * LD + 4 * cg
                                                 + 64 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y
                      : kk == 2 ? p4[i].z : p4[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c][0] = fmaf(p, v4[c].x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p, v4[c].y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p, v4[c].z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p, v4[c].w, acc[i][c][3]);
        }
      }
    }
  }
}

// fold over the 16 lanes that share a row (lanes 0-15 and 16-31)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int key, int query, int S,
                                        int window) {
  return key <= query && key < S && (window == 0 || key > query - window);
}

// the key blocks a query block sees: [lo, hi]
__device__ __forceinline__ void key_range(int q0, int S, int window,
                                          int* lo, int* hi) {
  const int first = window ? q0 - window + 1 : 0;
  *lo = first > 0 ? first / BK : 0;
  *hi = (min(q0 + BQ, S) - 1) / BK;
}

__device__ __forceinline__ int kv_head(const Geo& g, int h) {
  return g.kv_of ? g.kv_of[h] : h / g.rep;
}

template <int D>
__global__ void __launch_bounds__(NT, Dims<D>::NC > 2 ? 1 : 2)
attn_fwd_kernel(Geo g, float* __restrict__ out, float* __restrict__ lse) {
  constexpr int NC = Dims<D>::NC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + Dims<D>::tile;
  float* Ps = KVs + Dims<D>::tile;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 15, rg = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * BQ;
  const long long qtok = (long long)g.H * D, kvtok = (long long)g.KV * D;
  const int kvh = kv_head(g, h);
  const float* qp = g.q + (long long)b * g.S * qtok + (long long)h * D;
  const float* kp = g.k + (long long)b * g.S * kvtok + (long long)kvh * D;
  const float* vp = g.v + (long long)b * g.S * kvtok + (long long)kvh * D;
  load_tile<D>(Qs, qp, qtok, q0, g.S);

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  int lo, hi;
  key_range(q0, g.S, g.window, &lo, &hi);
  for (int kb = lo; kb <= hi; ++kb) {
    const int k0 = kb * BK;
    load_tile<D>(KVs, kp, kvtok, k0, g.S);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, Qs, KVs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(k0 + cg + 16 * j, qi, g.S, g.window)
                      ? s[i][j] * g.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      float corr = 1.f, sum = 0.f;
      if (mn == -INFINITY) {          // nothing visible to this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      } else {
        corr = expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          sum += s[i][j];
        }
      }
      l[i] = l[i] * corr + half_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(rg + 16 * i) * LP + cg + 16 * j] = s[i][j];
    }
    __syncthreads();                  // K read, P written
    load_tile<D>(KVs, vp, kvtok, k0, g.S);
    __syncthreads();
    pv_tile<D>(acc, Ps, KVs, rg, cg);
    __syncthreads();                  // V and P read
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= g.S) continue;
    float* op = out + ((long long)b * g.S + qi) * qtok + (long long)h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (in_head<D>(4 * cg + 64 * c))
        *reinterpret_cast<float4*>(op + 4 * cg + 64 * c) =
            make_float4(acc[i][c][0] / l[i], acc[i][c][1] / l[i],
                        acc[i][c][2] / l[i], acc[i][c][3] / l[i]);
    if (cg == 0)
      lse[((long long)b * g.H + h) * g.S + qi] = m[i] + logf(l[i]);
  }
}

// dK, dV of one KV head's key block, summed over the query heads of its
// group and the query blocks that see the block
template <int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dkdv_kernel(Geo g, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv) {
  constexpr int NC = Dims<D>::NC;
  constexpr bool ST = Dims<D>::stream;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = ST ? Ks : Ks + Dims<D>::tile;
  float* Qs = Vs + Dims<D>::tile;
  float* dOs = Qs + Dims<D>::tile;
  float* Pt = dOs + Dims<D>::tile;
  float* dSt = ST ? Pt : Pt + BK * LP;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 15, rg = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BK;
  const long long qtok = (long long)g.H * D, kvtok = (long long)g.KV * D;
  const long long kvoff = (long long)b * g.S * kvtok + (long long)kvh * D;
  if (!ST) {
    load_tile<D>(Ks, g.k + kvoff, kvtok, k0, g.S);
    load_tile<D>(Vs, g.v + kvoff, kvtok, k0, g.S);
  }

  float dK[4][NC][4], dV[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dK[i][c][e] = dV[i][c][e] = 0.f;
  const int klast = min(k0 + BK, g.S) - 1;
  const int qlast = g.window ? min(g.S - 1, klast + g.window - 1) : g.S - 1;
  const int qlo = k0 / BQ, qhi = qlast / BQ;
  for (int h = 0; h < g.H; ++h) {
    if (kv_head(g, h) != kvh) continue;
    const long long qoff = (long long)b * g.S * qtok + (long long)h * D;
    const float* lrow = lse + ((long long)b * g.H + h) * g.S;
    const float* drow = delta + ((long long)b * g.H + h) * g.S;
    for (int qb = qlo; qb <= qhi; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();                // the last tiles read
      load_tile<D>(Qs, g.q + qoff, qtok, q0, g.S);
      load_tile<D>(dOs, dout + qoff, qtok, q0, g.S);
      if (ST) load_tile<D>(Ks, g.k + kvoff, kvtok, k0, g.S);
      __syncthreads();
      float st[4][4], dpt[4][4];
      dot_tile<D>(st, Ks, Qs, rg, cg);
      if (ST) {
        __syncthreads();              // K read
        load_tile<D>(Vs, g.v + kvoff, kvtok, k0, g.S);
        __syncthreads();
      }
      dot_tile<D>(dpt, Vs, dOs, rg, cg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = q0 + cg + 16 * j;
        const float lj = qj < g.S ? lrow[qj] : 0.f;
        const float dj = qj < g.S ? drow[qj] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ki = k0 + rg + 16 * i;
          const bool keep = qj < g.S && visible(ki, qj, g.S, g.window);
          const float p = keep ? expf(st[i][j] * g.scale - lj) : 0.f;
          Pt[(rg + 16 * i) * LP + cg + 16 * j] = p;
          dpt[i][j] = p * (dpt[i][j] - dj);       // dS
          if (!ST) dSt[(rg + 16 * i) * LP + cg + 16 * j] = dpt[i][j];
        }
      }
      __syncthreads();
      pv_tile<D>(dV, Pt, dOs, rg, cg);
      if (ST) {
        __syncthreads();              // P read
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dSt[(rg + 16 * i) * LP + cg + 16 * j] = dpt[i][j];
        __syncthreads();
      }
      pv_tile<D>(dK, dSt, Qs, rg, cg);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + rg + 16 * i;
    if (ki >= g.S) continue;
    const long long at = kvoff + (long long)ki * kvtok;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * cg + 64 * c;
      if (!in_head<D>(d)) continue;
      *reinterpret_cast<float4*>(dk + at + d) = make_float4(
          dK[i][c][0] * g.scale, dK[i][c][1] * g.scale,
          dK[i][c][2] * g.scale, dK[i][c][3] * g.scale);
      *reinterpret_cast<float4*>(dv + at + d) = make_float4(
          dV[i][c][0], dV[i][c][1], dV[i][c][2], dV[i][c][3]);
    }
  }
}

// dQ of one query block of one head, over the key blocks it sees
template <int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_kernel(Geo g, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq) {
  constexpr int NC = Dims<D>::NC;
  constexpr bool ST = Dims<D>::stream;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + Dims<D>::tile;
  float* Ks = dOs + Dims<D>::tile;
  float* Vs = ST ? Ks : Ks + Dims<D>::tile;
  float* dS = Vs + Dims<D>::tile;
  const int lane = threadIdx.x & 31;
  const int cg = lane & 15, rg = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * BQ;
  const long long qtok = (long long)g.H * D, kvtok = (long long)g.KV * D;
  const int kvh = kv_head(g, h);
  const long long qoff = (long long)b * g.S * qtok + (long long)h * D;
  const long long kvoff = (long long)b * g.S * kvtok + (long long)kvh * D;
  load_tile<D>(Qs, g.q + qoff, qtok, q0, g.S);
  load_tile<D>(dOs, dout + qoff, qtok, q0, g.S);
  float li[4], di[4], dQ[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    const long long at = ((long long)b * g.H + h) * g.S + qi;
    li[i] = qi < g.S ? lse[at] : 0.f;
    di[i] = qi < g.S ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dQ[i][c][e] = 0.f;
  }
  int lo, hi;
  key_range(q0, g.S, g.window, &lo, &hi);
  for (int kb = lo; kb <= hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                  // the last K and dS read
    load_tile<D>(Ks, g.k + kvoff, kvtok, k0, g.S);
    if (!ST) load_tile<D>(Vs, g.v + kvoff, kvtok, k0, g.S);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, Qs, Ks, rg, cg);
    if (ST) {
      __syncthreads();                // K read
      load_tile<D>(Vs, g.v + kvoff, kvtok, k0, g.S);
      __syncthreads();
    }
    dot_tile<D>(dp, dOs, Vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = qi < g.S && visible(k0 + cg + 16 * j, qi, g.S,
                                              g.window);
        const float p = keep ? expf(s[i][j] * g.scale - li[i]) : 0.f;
        dS[(rg + 16 * i) * LP + cg + 16 * j] = p * (dp[i][j] - di[i]);
      }
    }
    if (ST) {
      __syncthreads();                // V read
      load_tile<D>(Ks, g.k + kvoff, kvtok, k0, g.S);
    }
    __syncthreads();
    pv_tile<D>(dQ, dS, Ks, rg, cg);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= g.S) continue;
    float* p = dq + qoff + (long long)qi * qtok;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (in_head<D>(4 * cg + 64 * c))
        *reinterpret_cast<float4*>(p + 4 * cg + 64 * c) = make_float4(
            dQ[i][c][0] * g.scale, dQ[i][c][1] * g.scale,
            dQ[i][c][2] * g.scale, dQ[i][c][3] * g.scale);
  }
}

template <int D>
constexpr int smem_bytes(int tiles, int score_tiles) {
  return (int)((tiles * Dims<D>::tile + score_tiles * BK * LP)
               * sizeof(float));
}

inline Geo geo(const float* q, const float* k, const float* v,
               const int* kv_of, int S, int H, int KV, int window,
               float scale) {
  Geo g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.kv_of = kv_of;
  g.S = S;
  g.H = H;
  g.KV = KV;
  g.rep = H / KV;
  g.window = window;
  g.scale = scale;
  return g;
}

}  // namespace attn

// out (B, S, H, D) and lse (B, H, S) of q, k, v
extern "C" int attn_fwd(const float* q, const float* k, const float* v,
                        const int* kv_of, float* out, float* lse, int B,
                        int S, int H, int KV, int window, float scale,
                        void* stream, int device) {
  using namespace attn;
  constexpr int D = ATTN_D;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = smem_bytes<D>(2, 1);
  err = cudaFuncSetAttribute(attn_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<D><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      geo(q, k, v, kv_of, S, H, KV, window, scale), out, lse);
  return (int)cudaGetLastError();
}

// dq, dk, dv of dout, given the forward's lse and delta = rowsum(dout * out)
extern "C" int attn_bwd(const float* q, const float* k, const float* v,
                        const int* kv_of, const float* dout,
                        const float* lse, const float* delta, float* dq,
                        float* dk, float* dv, int B, int S, int H, int KV,
                        int window, float scale, void* stream, int device) {
  using namespace attn;
  constexpr int D = ATTN_D;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr bool ST = Dims<D>::stream;
  constexpr int smem_kv = smem_bytes<D>(ST ? 3 : 4, ST ? 1 : 2),
                smem_q = smem_bytes<D>(ST ? 3 : 4, 1);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  const Geo g = geo(q, k, v, kv_of, S, H, KV, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attn_bwd_dkdv_kernel<D><<<dim3((S + BK - 1) / BK, KV, B), NT, smem_kv, s>>>(
      g, dout, lse, delta, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<D><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem_q, s>>>(
      g, dout, lse, delta, dq);
  return (int)cudaGetLastError();
}
