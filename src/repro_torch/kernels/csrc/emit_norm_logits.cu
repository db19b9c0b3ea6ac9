// Fused decode emit for Hopper (sm_90a): final norm + LM-head product.
//
// Replaces the TPU kernels repro/kernels/emit_norm_logits/kernel.py:
// _emit_kernel_scaled and _emit_kernel_plain (their pallas_calls are in
// emit_norm_logits_pallas).  Same function: xn = rmsnorm(x) * scale or
// the non-parametric layernorm of x (biased variance), computed in fp32
// and rounded to x's dtype; logits = xn . W over d, accumulated in fp32
// and rounded to x's dtype (the product's output dtype in the JAX
// package), then written as fp32.  W is the untied head (d, V) or the
// tied embedding (V, d).  Rounding each logit to x's dtype is part of
// the function: greedy tokens on near-ties depend on it.
//
// Bound on the H100: bytes.  At decode batch B the product does 2*B
// flops per weight element read (16 at B=8), far below the ~295
// flop/byte the card needs to be compute bound: the least time is the
// head's bytes over 3.35 TB/s (206 MB, ~61 us, at OLMo-1B's d=2048,
// V=50304 in bf16).
//
// Design against that bound: every weight element is read once, with
// 16-byte loads, and used for all B rows; the (B, d) hidden state is
// tiny, so each block recomputes the norm into shared memory instead of
// writing a normalised copy to device memory and reading it back.
// Blocks own tiles of V; the last tile's edge is masked (V need not be
// a multiple of the tile: OLMo's V = 50304 = 128 * 393).
//   tied (V, d), bf16 (OLMo-1B's case): a warp owns 16 vocab rows and
//   multiplies them with 8 batch rows at a time on the tensor cores
//   (mma.sync m16n8k16, fp32 accumulation).  Done with FMAs, the
//   conversions and shared-memory reads of this product kept the CUDA
//   cores busy for 3x the bound (183 us on an H100 SXM at 700 W).
//   tied (V, d), fp32: a warp per vocab row, lanes along d;
//   untied (d, V): threads along V in 16-byte column chunks, the d axis
//   split over the block and summed through shuffles and shared memory.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int BCHUNK = 8;             // batch rows accumulated per pass over W
constexpr int TIED_ROWS_PER_WARP = 8; // vocab rows per warp (tied)
constexpr int UNTIED_CHUNKS = 8;      // threads across a tile's columns (untied)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// 16 bytes of T as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// xn_s[b * ld + i] = norm(x[b, :])[i] rounded to T, for all B rows, one
// warp per row.  norm: 0 = rmsnorm (x * rsqrt(mean(x^2) + eps) * scale),
// 1 = layernorm without parameters ((x - mean) * rsqrt(biased var + eps)).
template <typename T>
__device__ void normalize_rows(const T* __restrict__ x, const float* __restrict__ scale,
                               T* xn_s, int B, int d, int ld, int norm, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += NWARPS) {
    const T* xb = x + (size_t)b * d;
    T* out = xn_s + (size_t)b * ld;
    if (norm == 0) {
      float ss = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float v = to_float(xb[i]);
        ss += v * v;
      }
      const float r = rsqrtf(warp_sum(ss) / d + eps);
      for (int i = lane; i < d; i += 32) out[i] = from_float<T>(to_float(xb[i]) * r * scale[i]);
    } else {
      float s = 0.f;
      for (int i = lane; i < d; i += 32) s += to_float(xb[i]);
      const float mu = warp_sum(s) / d;
      float sq = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float c = to_float(xb[i]) - mu;
        sq += c * c;
      }
      const float r = rsqrtf(warp_sum(sq) / d + eps);
      for (int i = lane; i < d; i += 32) out[i] = from_float<T>((to_float(xb[i]) - mu) * r);
    }
  }
  __syncthreads();
}

// Tied head: W is (V, d).  grid: ceil(V / (NWARPS * TIED_ROWS_PER_WARP)).
template <typename T>
__global__ void __launch_bounds__(THREADS) emit_tied_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int B, int d, int V, int norm, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xn_s = reinterpret_cast<T*>(smem);
  normalize_rows<T>(x, scale, xn_s, B, d, d, norm, eps);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = (blockIdx.x * NWARPS + warp) * TIED_ROWS_PER_WARP;
  for (int vi = 0; vi < TIED_ROWS_PER_WARP; ++vi) {
    const int v = v0 + vi;
    if (v >= V) break;
    const T* wr = w + (size_t)v * d;
    for (int b0 = 0; b0 < B; b0 += BCHUNK) {
      const int nb = min(BCHUNK, B - b0);
      float acc[BCHUNK];
#pragma unroll
      for (int b = 0; b < BCHUNK; ++b) acc[b] = 0.f;
      for (int c = lane * N; c < d; c += 32 * N) {
        float wv[N];
        Vec<T>::load(wr + c, wv);
#pragma unroll
        for (int b = 0; b < BCHUNK; ++b) {
          if (b < nb) {
            float xv[N];
            Vec<T>::load(xn_s + (size_t)(b0 + b) * d + c, xv);
#pragma unroll
            for (int e = 0; e < N; ++e) acc[b] += xv[e] * wv[e];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BCHUNK; ++b) {
        if (b < nb) {
          const float s = warp_sum(acc[b]);
          if (lane == 0) out[(size_t)(b0 + b) * V + v] = to_float(from_float<T>(s));
        }
      }
    }
  }
}

// D (16 x 8, fp32) += A (16 x 16, bf16, rows) * B (16 x 8, bf16, columns).
__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int MMA_ROWS = 16;  // vocab rows per warp (the mma's M)
constexpr int MMA_B = 8;      // batch rows per mma (its N)
constexpr int XN_PAD = 32;    // bf16 elements of padding per xn row: no bank conflicts

// Tied head in bf16 on the tensor cores: W is (V, d), d % 32 == 0.  grid:
// ceil(V / (NWARPS * MMA_ROWS)).  Lane (g = lane / 4, t = lane % 4) of a
// warp feeds the mma rows g and g + 8 (vocab rows row0 + g, row0 + g + 8)
// and column g (batch row b0 + g).  The d axis is walked in chunks of 32:
// lane t reads 16 contiguous bytes, columns [c + 8t, c + 8t + 8), of both
// W rows and of the xn row, and feeds the first half to one mma and the
// second half to the next.  The mma's k slots (2t, 2t+1, 2t+8, 2t+9) thus
// hold other columns of d than their index says, but the same ones in A
// and in B, so every product W[v, k] * xn[b, k] is summed exactly once.
__global__ void __launch_bounds__(THREADS) emit_tied_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int B, int d, int V, int norm,
    float eps) {
  const int bpad = (B + MMA_B - 1) / MMA_B * MMA_B, ld = d + XN_PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xn_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (bpad, ld), rows >= B zero
  normalize_rows<__nv_bfloat16>(x, scale, xn_s, B, d, ld, norm, eps);
  for (int i = threadIdx.x; i < (bpad - B) * ld; i += THREADS)
    xn_s[(size_t)B * ld + i] = __float2bfloat16(0.f);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * NWARPS + warp) * MMA_ROWS;
  if (row0 >= V) return;  // no barrier follows
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  // rows past V read row V-1 and are not written
  const __nv_bfloat16* w_lo = w + (size_t)min(r_lo, V - 1) * d + 8 * t;
  const __nv_bfloat16* w_hi = w + (size_t)min(r_hi, V - 1) * d + 8 * t;
  for (int b0 = 0; b0 < B; b0 += MMA_B) {
    const __nv_bfloat16* xb = xn_s + (size_t)(b0 + g) * ld + 8 * t;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < d; k += 32) {
      const uint4 a_lo = *reinterpret_cast<const uint4*>(w_lo + k);
      const uint4 a_hi = *reinterpret_cast<const uint4*>(w_hi + k);
      const uint4 bx = *reinterpret_cast<const uint4*>(xb + k);
      mma_bf16_16816(c, a_lo.x, a_hi.x, a_lo.y, a_hi.y, bx.x, bx.y);
      mma_bf16_16816(c, a_lo.z, a_hi.z, a_lo.w, a_hi.w, bx.z, bx.w);
    }
    // c[0], c[1]: vocab row r_lo, batch rows b0 + 2t, b0 + 2t + 1; c[2], c[3]: row r_hi
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = i < 2 ? r_lo : r_hi, b = b0 + 2 * t + (i & 1);
      if (v < V && b < B)
        out[(size_t)b * V + v] = __bfloat162float(__float2bfloat16(c[i]));
    }
  }
}

// Untied head: W is (d, V).  A tile is UNTIED_CHUNKS * N columns; thread
// (k, c) reads columns [c*N, c*N + N) of the tile for rows d = k, k +
// KSPLIT, ...  grid: ceil(V / (UNTIED_CHUNKS * N)).
template <typename T>
__global__ void __launch_bounds__(THREADS) emit_untied_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int B, int d, int V, int norm, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int TV = UNTIED_CHUNKS * N;
  constexpr int KSPLIT = THREADS / UNTIED_CHUNKS;  // 32: 4 per warp x 8 warps
  extern __shared__ __align__(16) unsigned char smem[];
  T* xn_s = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(xn_s + (size_t)B * d);  // (NWARPS, BCHUNK, TV) sums
  normalize_rows<T>(x, scale, xn_s, B, d, d, norm, eps);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x % UNTIED_CHUNKS, k0 = threadIdx.x / UNTIED_CHUNKS;
  const int col = blockIdx.x * TV + c * N;
  const bool live = col < V;  // V % N == 0, so a chunk is all in or all out
  for (int b0 = 0; b0 < B; b0 += BCHUNK) {
    const int nb = min(BCHUNK, B - b0);
    float acc[BCHUNK][N];
#pragma unroll
    for (int b = 0; b < BCHUNK; ++b)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[b][e] = 0.f;
    if (live) {
      for (int k = k0; k < d; k += KSPLIT) {
        float wv[N];
        Vec<T>::load(w + (size_t)k * V + col, wv);
#pragma unroll
        for (int b = 0; b < BCHUNK; ++b) {
          if (b < nb) {
            const float xv = to_float(xn_s[(size_t)(b0 + b) * d + k]);
#pragma unroll
            for (int e = 0; e < N; ++e) acc[b][e] += xv * wv[e];
          }
        }
      }
    }
    // Sum the 4 d-splits inside each warp (lanes 8 apart), then the 8 warps.
#pragma unroll
    for (int b = 0; b < BCHUNK; ++b)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float v = acc[b][e];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[b][e] = v;
      }
    if (lane < UNTIED_CHUNKS) {
#pragma unroll
      for (int b = 0; b < BCHUNK; ++b)
#pragma unroll
        for (int e = 0; e < N; ++e) part[(warp * BCHUNK + b) * TV + c * N + e] = acc[b][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * TV; i += THREADS) {
      const int b = i / TV, t = i % TV;
      const int v = blockIdx.x * TV + t;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < NWARPS; ++wi) s += part[(wi * BCHUNK + b) * TV + t];
      if (v < V) out[(size_t)(b0 + b) * V + v] = to_float(from_float<T>(s));
    }
    __syncthreads();  // part is rewritten by the next batch chunk
  }
}

template <typename T>
cudaError_t launch(int norm, int tied, const void* x, const void* w, const void* scale,
                   void* out, int B, int d, int V, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (B <= 0 || d <= 0 || V <= 0 || d % N != 0 || V % N != 0 || (norm != 0 && norm != 1) ||
      (norm == 0 && scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t xn_bytes = (size_t)B * d * sizeof(T);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tied && d % 32 == 0) {
      const int bpad = (B + MMA_B - 1) / MMA_B * MMA_B;
      const size_t smem = (size_t)bpad * (d + XN_PAD) * sizeof(T);
      err = cudaFuncSetAttribute(emit_tied_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      const int rows = NWARPS * MMA_ROWS;
      emit_tied_mma_kernel<<<(V + rows - 1) / rows, THREADS, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
          static_cast<float*>(out), B, d, V, norm, eps);
      return cudaGetLastError();
    }
  }
  if (tied) {
    const size_t smem = xn_bytes;
    err = cudaFuncSetAttribute(emit_tied_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = NWARPS * TIED_ROWS_PER_WARP;
    emit_tied_kernel<T><<<(V + rows - 1) / rows, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
        static_cast<float*>(out), B, d, V, norm, eps);
  } else {
    constexpr int TV = UNTIED_CHUNKS * N;
    const size_t smem = xn_bytes + NWARPS * BCHUNK * TV * sizeof(float);
    err = cudaFuncSetAttribute(emit_untied_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    emit_untied_kernel<T><<<(V + TV - 1) / TV, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
        static_cast<float*>(out), B, d, V, norm, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; norm: 0 = rmsnorm (scale is (d,)
// fp32), 1 = non-parametric layernorm (scale unused); tied: W is (V, d)
// when nonzero, else (d, V).  out is (B, V) fp32.  Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int emit_norm_logits(int dtype, int norm, int tied, const void* x, const void* w,
                                const void* scale, void* out, int B, int d, int V, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(norm, tied, x, w, scale, out, B, d, V, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(norm, tied, x, w, scale, out, B, d, V, eps, st);
  return cudaErrorInvalidValue;
}
