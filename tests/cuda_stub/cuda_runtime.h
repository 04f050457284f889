// Host declarations standing in for the CUDA ones that the generated
// kernels use (csrc/*.cuh), so that `g++ -fsyntax-only` parses a generated
// source where there is no nvcc (tests/test_torch_cell_layout.py).  The
// test rewrites each `kernel<<<grid, block, smem, stream>>>(args)` launch
// into a plain call before parsing; nothing here is ever run.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct float4 { float x, y, z, w; };
float4 make_float4(float x, float y, float z, float w);
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
cudaError_t cudaSetDevice(int device);
cudaError_t cudaGetLastError();
template <class F>
cudaError_t cudaFuncSetAttribute(F* fn, cudaFuncAttribute attr, int value);

template <class T> T __ldg(const T* p);
template <class T> T __ldcg(const T* p);
unsigned atomicAdd(unsigned* p, unsigned v);
void __threadfence();
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
float __shfl_xor_sync(unsigned mask, float v, int lane);
size_t __cvta_generic_to_shared(const void* p);
