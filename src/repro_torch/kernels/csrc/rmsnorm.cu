// RMSNorm for Hopper (sm_90a), with an optional fused gate.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:_rmsnorm_kernel
// (its pallas_call is in rmsnorm_pallas).  Same function, row by row:
// out = (x * rsqrt(mean(x^2) + eps)) * scale in fp32, rounded to x's
// dtype; scale is fp32.  With a gate z (Mamba-2's gated norm) x is first
// replaced by the gated row as models/ssm.py computes it in plain ops:
// g = silu(fp32(z)) rounded to x's dtype, then x * g rounded to x's dtype.
//
// Bound on the H100: bytes.  A row is read once and written once (and z
// once where gated; the fp32 scale once for all rows): Mamba2-1.3B's
// gated norm, rows of d = 4096 in bf16, needs 0.06 us for 8 decode rows
// at 3.35 TB/s and 1.9 us for a 256-row prefill chunk; a few flops a byte.
// At decode's 8 rows the time is latency: the launch, one round trip to
// memory, the row's reduction and the store.
//
// Design: one pass, the row in registers.  Every thread issues all its
// 16-byte loads of x, z and the scale (as float4) before any arithmetic,
// the gate and the sum of squares follow in registers, one reduction
// (warp shuffles, one exchange through shared memory behind one barrier)
// gives the row's rsqrt, and the thread scales, rounds and stores what it
// holds, with no second read of x.  One row a block.  The elements a
// thread holds are a template constant, so `d / EPT` threads take a row:
// 16 without the gate (256 threads at d = 4096), 8 with it, where the
// gate's fp32 exp and division per element would otherwise lengthen each
// thread's chain.  Other widths take a loop over the row in the same
// kernel (two passes, the second re-reading the row from L1/L2).  z is
// read in place through its row stride (a column slice of the in_proj
// output), so the gate costs no copy and no extra launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LOOP_THREADS = 128;  // threads a row on the looped path

struct Args {
  const void* x;
  const void* z;  // gate (nullptr without)
  const float* scale;
  void* out;
  long long z_stride;  // elements between rows of z
  int d;
  float eps;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(dtype) does
}

// x rounded to T and back: where the plain version holds a T.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// The gated element as ssm_block computes it: silu in fp32 (PyTorch's
// formula, IEEE division), rounded to T; the product rounded to T.
template <typename T> __device__ __forceinline__ float gated(float y, float z) {
  const float g = round_to<T>(z / (1.0f + expf(-z)));
  return round_to<T>(y * g);
}

template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < int(16 / sizeof(T)); ++k) f[k] = to_float(e[k]);
}

// The block's sum of squares (one row a block, a whole number of warps):
// each warp reduces its part, and every thread adds the warps' parts.
__device__ __forceinline__ float row_sum(float ss) {
  __shared__ float s_part[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) total += s_part[w];
  return total;
}

// One pass: d == EPT * blockDim.x, the row's EPT elements a thread in
// registers (16 elements keep 512 threads at up to 128 registers each).
template <typename T, bool GATE>
__global__ void __launch_bounds__(GATE ? 1024 : 512) rmsnorm_regs(const Args a) {
  constexpr int EPT = GATE ? 8 : 16;  // elements a thread
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int NV = EPT / V;        // loads of x (and of z) a thread
  const int tpr = blockDim.x, lane = threadIdx.x;
  const T* xr = static_cast<const T*>(a.x) + (size_t)blockIdx.x * a.d;
  const T* zr = static_cast<const T*>(a.z) + (size_t)blockIdx.x * a.z_stride;

  uint4 xu[NV], zu[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k)
    xu[k] = __ldg(reinterpret_cast<const uint4*>(xr + (size_t)(k * tpr + lane) * V));
  if (GATE) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      zu[k] = __ldg(reinterpret_cast<const uint4*>(zr + (size_t)(k * tpr + lane) * V));
  }
  float sc[EPT];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float4* s4 = reinterpret_cast<const float4*>(a.scale + (size_t)(k * tpr + lane) * V);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 f = __ldg(s4 + j);
      sc[k * V + 4 * j] = f.x, sc[k * V + 4 * j + 1] = f.y;
      sc[k * V + 4 * j + 2] = f.z, sc[k * V + 4 * j + 3] = f.w;
    }
  }

  float v[EPT];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    unpack<T>(xu[k], v + k * V);
    if (GATE) {
      float zf[V];
      unpack<T>(zu[k], zf);
#pragma unroll
      for (int j = 0; j < V; ++j) v[k * V + j] = gated<T>(v[k * V + j], zf[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[k * V + j], v[k * V + j], ss);
  }
  const float r = rsqrtf(row_sum(ss) / (float)a.d + a.eps);

  T* orow = static_cast<T*>(a.out) + (size_t)blockIdx.x * a.d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < V; ++j) oe[j] = from_float<T>(v[k * V + j] * r * sc[k * V + j]);
    *reinterpret_cast<uint4*>(orow + (size_t)(k * tpr + lane) * V) = o;
  }
}

// Any d (a multiple of 16 bytes): a loop over the row, twice.
template <typename T, bool GATE>
__global__ void __launch_bounds__(LOOP_THREADS) rmsnorm_loop(const Args a) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = a.d / V;
  const T* xr = static_cast<const T*>(a.x) + (size_t)blockIdx.x * a.d;
  const T* zr = static_cast<const T*>(a.z) + (size_t)blockIdx.x * a.z_stride;

  auto load = [&](int i, float* v) {
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr + (size_t)i * V)), v);
    if (GATE) {
      float zf[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(zr + (size_t)i * V)), zf);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = gated<T>(v[j], zf[j]);
    }
  };

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += LOOP_THREADS) {
    float v[V];
    load(i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
  }
  const float r = rsqrtf(row_sum(ss) / (float)a.d + a.eps);

  T* orow = static_cast<T*>(a.out) + (size_t)blockIdx.x * a.d;
  for (int i = threadIdx.x; i < nvec; i += LOOP_THREADS) {
    float v[V];
    load(i, v);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < V; ++j) oe[j] = from_float<T>(v[j] * r * a.scale[(size_t)i * V + j]);
    *reinterpret_cast<uint4*>(orow + (size_t)i * V) = o;
  }
}

// The one-pass path where d is a whole number of warps of EPT elements
// within its launch bounds, else the loop; one block a row.
template <typename T, bool GATE>
int launch(const Args& a, int rows, cudaStream_t st) {
  constexpr int EPT = GATE ? 8 : 16;
  if (a.d % (32 * EPT) == 0 && a.d / EPT <= (GATE ? 1024 : 512))
    rmsnorm_regs<T, GATE><<<rows, a.d / EPT, 0, st>>>(a);
  else
    rmsnorm_loop<T, GATE><<<rows, LOOP_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int rows, cudaStream_t st) {
  return a.z != nullptr ? launch<T, true>(a, rows, st) : launch<T, false>(a, rows, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, z and out); scale is float32 (d,).
// x and out are (rows, d), contiguous and 16-byte aligned, d a multiple
// of 16 bytes; z (nullptr for no gate) is (rows, d) with row stride
// z_stride elements, contiguous in d, its base and row stride 16-byte
// aligned.  Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm(int dtype, const void* x, const void* z, long long z_stride,
                       const void* scale, void* out, int rows, int d, float eps,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  const Args a{x, z, static_cast<const float*>(scale), out, z_stride, d, eps};
  if (dtype == 0) {
    if (d % 4 || z_stride % 4) return cudaErrorInvalidValue;
    return launch<float>(a, rows, st);
  }
  if (dtype == 1) {
    if (d % 8 || z_stride % 8) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(a, rows, st);
  }
  return cudaErrorInvalidValue;
}
