// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:_rmsnorm_kernel
// (its pallas_call is in rmsnorm_pallas).  Same function, row by row:
// out = (x * rsqrt(mean(x^2) + eps)) * scale in fp32, rounded to x's
// dtype; scale is fp32.
//
// Bound on the H100: bytes.  A row is read once and written once (plus
// the fp32 scale): Mamba2-1.3B's gated norm, rows of d = 4096 in bf16,
// moves 16 KB a row, so 8 decode rows take 0.04 us at 3.35 TB/s and a
// 256-row prefill chunk 1.3 us; a few flops per byte.
//
// Design: one block of 128 threads per row, 16-byte loads, an fp32 sum
// of squares reduced through warp shuffles and shared memory, then a
// second pass over the row (from L1/L2) that scales and rounds.  At 8
// rows the launch and one round trip to memory set the time; many rows
// per block, or the norm fused into its producer, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
               int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float s_part[NWARPS];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  const int nvec = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + (size_t)i * V);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = to_float(e[k]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) total += s_part[w];
  const float r = rsqrtf(total / (float)d + eps);

  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + (size_t)i * V);
    const T* e = reinterpret_cast<const T*>(&u);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int k = 0; k < V; ++k) oe[k] = from_float<T>(to_float(e[k]) * r * scale[i * V + k]);
    *reinterpret_cast<uint4*>(orow + (size_t)i * V) = o;
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           cudaStream_t st) {
  rmsnorm_kernel<T><<<rows, THREADS, 0, st>>>(static_cast<const T*>(x),
                                              static_cast<const float*>(scale),
                                              static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); scale is float32 (d,).
// x and out are (rows, d), contiguous and 16-byte aligned, d a multiple
// of 16 bytes.  Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm(int dtype, const void* x, const void* scale, void* out, int rows, int d,
                       float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d % 4) return cudaErrorInvalidValue;
    return launch<float>(x, scale, out, rows, d, eps, st);
  }
  if (dtype == 1) {
    if (d % 8) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, st);
  }
  return cudaErrorInvalidValue;
}
