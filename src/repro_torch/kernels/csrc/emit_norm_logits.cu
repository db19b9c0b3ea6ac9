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
// Design against that bound: every weight element is read once and used
// for all B rows; the (B, d) hidden state is tiny, so each block
// recomputes the norm into shared memory instead of writing a normalised
// copy to device memory and reading it back.
//   untied (d, V), bf16 and fp32 (Moonlight-16B-A3B and every other
//   untied model): a persistent grid of one block per SM, each owning a
//   contiguous share of the vocab in groups of 256 bytes of each row of W
//   (128 bf16 or 64 fp32 columns) and walking each group over all of d,
//   so no sum crosses blocks and each logit is rounded once.  A producer
//   warp keeps a ring of 2 to 16 stages full by TMA (a 2-d tensor map
//   over W, 128-byte swizzle; a stage is kc <= 256 rows of d by the
//   group's columns, two boxes side by side), x's rows arriving by bulk
//   copy ahead of the ring and normalised once per block in place.  Four
//   consumer warps take every stage, a quarter of its columns each, and
//   keep their columns' sums for all B rows in registers over the walk.
//   bf16: mma.sync m16n8k16 with the vocab as M (logits^T = W^T . xn^T:
//   W^T's fragments by ldmatrix.trans from the swizzled stage, xn^T's
//   straight from xn's rows by ldmatrix, one n8 tile a batch octet).
//   fp32: FMAs on the CUDA cores (TF32 would miss the 1e-4 tolerance),
//   from the same ring.  The stage plan (kc, stages, batch rows a launch)
//   is the wrapper's (`untied_plan` in emit_norm_logits/ops.py); a batch
//   whose normalised x does not fit beside two stages is split over
//   launches, each reading W once.  The design it replaced (threads along
//   V in 16-byte chunks, d split over the block and summed through
//   shuffles and shared memory, each of V / 64 blocks normalising x
//   first) took 0.6992 ms in bf16 and 0.7945 ms in fp32 at Moonlight's
//   shape (rmsnorm, B 8, d 2048, V 163840; NVIDIA H100 80GB HBM3, 700 W),
//   against a 0.2019 ms (bf16) and 0.4022 ms (fp32) bytes bound.
//   tied (V, d), bf16 (the main path: OLMo-1B, Mamba2-1.3B): a persistent
//   grid of one block per SM, each owning a contiguous share of the
//   vocab rows.  One producer warp keeps a ring of up to 16 shared-memory
//   stages (8 rows x up to 2048 columns) full with cp.async.bulk copies
//   completed on mbarriers; four consumer warps normalise x while the
//   first stages fly, then multiply each stage with the batch on the
//   tensor cores (mma.sync m16n8k16 from shared memory, fp32
//   accumulation) and release it.  Measured before this design: register
//   loads of 64 bytes a row stream W at ~70 % of the bytes rate, bulk
//   copies at ~90 %.
//   tied (V, d), fp32: a warp per vocab row, lanes along d.
// Earlier designs of the tied bf16 path, at OLMo-1B's shape on an H100
// SXM (700 W): 393 blocks, each normalising x first, then each warp
// streaming 16 rows 64 bytes at a time into mma.sync, 0.0895 ms; the
// same with FMAs on the CUDA cores, 0.183 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int BCHUNK = 8;             // batch rows accumulated per pass over W
constexpr int TIED_ROWS_PER_WARP = 8; // vocab rows per warp (tied)

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
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
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
  // rounded to nearest even, as astype does
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = o;
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
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One row of d values in shared memory, normalised in place by the
// calling warp (the function of normalize_rows): a lane takes 16 bytes at
// a time, d a multiple of them.  `scale` may point to shared or device
// memory.
template <typename T>
__device__ void normalize_row_smem(T* row, const float* scale, int d, int norm, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int i = lane * N; i < d; i += 32 * N) {
    float v[N];
    Vec<T>::load(row + i, v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s += v[e];
      ss += v[e] * v[e];
    }
  }
  float mu = 0.f, r;
  if (norm == 0) {
    r = rsqrtf(warp_sum(ss) / d + eps);
  } else {
    mu = warp_sum(s) / d;
    float sq = 0.f;
    for (int i = lane * N; i < d; i += 32 * N) {
      float v[N];
      Vec<T>::load(row + i, v);
#pragma unroll
      for (int e = 0; e < N; ++e) sq += (v[e] - mu) * (v[e] - mu);
    }
    r = rsqrtf(warp_sum(sq) / d + eps);
  }
  for (int i = lane * N; i < d; i += 32 * N) {
    float v[N];
    Vec<T>::load(row + i, v);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = norm == 0 ? v[e] * r * scale[i + e] : (v[e] - mu) * r;
    Vec<T>::store(row + i, v);
  }
}

constexpr int TMA_ROWS = 8;         // vocab rows a stage: the mma's N
constexpr int TMA_CONS = 4;         // consumer warps; warp TMA_CONS is the producer
constexpr int TMA_THREADS = (TMA_CONS + 1) * 32;
constexpr int TMA_MAX_STAGES = 16;
constexpr int TMA_MAX_MT = 4;       // batch tiles of 16 rows: B <= 64
constexpr int TMA_PAD = 32;         // bf16 elements of padding a shared row: no bank conflicts
constexpr int TMA_BAR_BYTES = 512;  // the ring's and x's barriers, ahead of the stages

// Tied head in bf16 on the tensor cores, fed by bulk copies: W is (V, d),
// V % 8 == 0, d % 32 == 0, B <= 64.  grid: one block per SM; block k
// owns the k-th contiguous share of the V / 8 groups of 8 vocab rows.
// Warp TMA_CONS keeps a ring of `stages` shared-memory stages full, one
// stage = 8 vocab rows x kc columns of d (8 cp.async.bulk row copies
// completed on the stage's `full` mbarrier).  Every consumer warp takes
// every stage, in order, a quarter of its columns each, and releases it
// on its `empty` mbarrier (4 arrivals); after a group's last stage the
// four partial sums meet in shared memory.  (A warp owning whole groups
// alone could wait on a slot's next phase before another warp's earlier
// phase of it had completed, and a phase-parity wait cannot tell the two
// apart.)  The consumers normalise x into shared memory while the first
// stages are in flight (x's rows arrive by bulk copy ahead of them: the
// consumers walking x in device memory themselves kept the ring waiting
// on their loads' latency).  Per stage the
// product is mma.sync m16n8k16 with the batch as M (16-row tiles, rows
// past B zero) and the stage's 8 rows as N.  The d axis is walked in
// chunks of 32: lane (g = lane / 4, t = lane % 4) reads 16 contiguous
// bytes, columns [c + 8t, c + 8t + 8), of W row g and of xn rows g and
// g + 8, and feeds the first half to one mma and the second half to the
// other.  The mma's k slots then hold other columns of d than their
// index says, but the same ones in A and in B, so every product
// W[v, k] * xn[b, k] is summed exactly once.
template <int MT>  // batch tiles of 16 rows
__global__ void __launch_bounds__(TMA_THREADS, 1) emit_tied_tma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int B, int d, int V, int norm,
    float eps, int kc, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + TMA_MAX_STAGES;
  uint64_t* x_bar = empty + TMA_MAX_STAGES;
  const int ldk = kc + TMA_PAD, ldx = d + TMA_PAD;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + TMA_BAR_BYTES);
  __nv_bfloat16* xn = ring + (size_t)stages * TMA_ROWS * ldk;  // (B, ldx)
  float* scale_s = reinterpret_cast<float*>(xn + (size_t)B * ldx);  // (d,), rmsnorm only
  float* red = scale_s + (norm == 0 ? d : 0);  // (2, TMA_CONS, MT, 32 lanes, 4) partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(full + s)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(empty + s)),
                   "n"(TMA_CONS));
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(x_bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int groups = V / TMA_ROWS, nk = (d + kc - 1) / kc;
  const int g0 = (int)((long long)groups * blockIdx.x / gridDim.x);
  const int g1 = (int)((long long)groups * (blockIdx.x + 1) / gridDim.x);
  if (warp == TMA_CONS) {  // producer: x's rows first, then the ring
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_u32(x_bar)), "r"(B * d * 2 + (norm == 0 ? d * 4 : 0)) : "memory");
    __syncwarp();
    if (norm == 0 && lane == 31)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(scale_s)), "l"(scale), "r"(d * 4), "r"(smem_u32(x_bar)) : "memory");
    for (int b = lane; b < B; b += 32)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(xn + (size_t)b * ldx)), "l"(x + (size_t)b * d), "r"(d * 2),
             "r"(smem_u32(x_bar))
          : "memory");
    const int total = (g1 - g0) * nk;
    for (int s = 0; s < total; ++s) {
      const int slot = s % stages;
      if (s >= stages) mbar_wait(empty + slot, ((s / stages) - 1) & 1);
      const int row = (g0 + s / nk) * TMA_ROWS, k0 = (s % nk) * kc, cols = min(kc, d - k0);
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_u32(full + slot)), "r"(TMA_ROWS * cols * 2) : "memory");
      __syncwarp();
      if (lane < TMA_ROWS)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(ring + ((size_t)slot * TMA_ROWS + lane) * ldk)),
               "l"(w + (size_t)(row + lane) * d + k0), "r"(cols * 2), "r"(smem_u32(full + slot))
            : "memory");
    }
    return;
  }

  // x (and the rmsnorm scale) arrive by bulk copy ahead of the ring; each
  // warp normalises its rows in place
  mbar_wait(x_bar, 0);
  for (int b = warp; b < B; b += TMA_CONS)
    normalize_row_smem(xn + (size_t)b * ldx, scale_s, d, norm, eps);
  asm volatile("bar.sync 1, %0;\n" :: "n"(TMA_CONS * 32) : "memory");  // consumers only

  const int g = lane >> 2, t = lane & 3;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int grp = 0; grp < g1 - g0; ++grp) {
    float acc[4][MT][4] = {};  // four chains: the chunks of a step
    for (int kb = 0; kb < nk; ++kb) {
      const int s = grp * nk + kb, slot = s % stages, k0 = kb * kc, cols = min(kc, d - k0);
      mbar_wait(full + slot, (s / stages) & 1);
      const __nv_bfloat16* ws = ring + ((size_t)slot * TMA_ROWS + g) * ldk + 8 * t;
      const __nv_bfloat16* xs = xn + k0 + 8 * t;
      // this warp's 32-column chunks of the stage: warp, warp + 4, ...;
      // a step loads four chunks, then multiplies them
      for (int k = 32 * warp; k < cols; k += 4 * 32 * TMA_CONS) {
        uint4 wv[4], xa[4][MT], xb[4][MT];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = k + 32 * TMA_CONS * u;
          const bool in = kk < cols;
          wv[u] = in ? *reinterpret_cast<const uint4*>(ws + kk) : z;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int lo = mt * 16 + g, hi = lo + 8;
            xa[u][mt] = in && lo < B ? *reinterpret_cast<const uint4*>(xs + (size_t)lo * ldx + kk) : z;
            xb[u][mt] = in && hi < B ? *reinterpret_cast<const uint4*>(xs + (size_t)hi * ldx + kk) : z;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[u][mt], xa[u][mt].x, xb[u][mt].x, xa[u][mt].y, xb[u][mt].y,
                           wv[u].x, wv[u].y);
            mma_bf16_16816(acc[u][mt], xa[u][mt].z, xb[u][mt].z, xa[u][mt].w, xb[u][mt].w,
                           wv[u].z, wv[u].w);
          }
      }
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(empty + slot))
                     : "memory");
    }
    // the warps' partial sums through shared memory (two buffers, by the
    // group's parity: one barrier a group), summed by warp grp % 4
    float* part = red + (size_t)(grp & 1) * TMA_CONS * MT * 128;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float4 p4;
      p4.x = (acc[0][mt][0] + acc[1][mt][0]) + (acc[2][mt][0] + acc[3][mt][0]);
      p4.y = (acc[0][mt][1] + acc[1][mt][1]) + (acc[2][mt][1] + acc[3][mt][1]);
      p4.z = (acc[0][mt][2] + acc[1][mt][2]) + (acc[2][mt][2] + acc[3][mt][2]);
      p4.w = (acc[0][mt][3] + acc[1][mt][3]) + (acc[2][mt][3] + acc[3][mt][3]);
      reinterpret_cast<float4*>(part)[(warp * MT + mt) * 32 + lane] = p4;
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(TMA_CONS * 32) : "memory");
    if (warp != grp % TMA_CONS) continue;
    // c[0], c[1]: batch row mt * 16 + g, vocab rows v, v + 1; c[2], c[3]: batch row + 8
    const int v = (g0 + grp) * TMA_ROWS + 2 * t;
    for (int mt = 0; mt < MT; ++mt) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int wi = 0; wi < TMA_CONS; ++wi) {
        const float4 q = reinterpret_cast<const float4*>(part)[(wi * MT + mt) * 32 + lane];
        sum.x += q.x; sum.y += q.y; sum.z += q.z; sum.w += q.w;
      }
      const float c[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = mt * 16 + g + 8 * h;
        if (b < B) {
          float2 o;
          o.x = __bfloat162float(__float2bfloat16(c[2 * h]));
          o.y = __bfloat162float(__float2bfloat16(c[2 * h + 1]));
          *reinterpret_cast<float2*>(out + (size_t)b * V + v) = o;
        }
      }
    }
  }
}

// The untied ring's layout, shared with the wrapper's plan
// (emit_norm_logits/ops.py: untied_plan, which holds the same formulas).
constexpr int U_MAX_ROWS = 64;      // batch rows a launch: 8 n8 tiles
constexpr int U_MAX_STAGES = 16;
constexpr int U_HEAD = 1024;        // the barriers, ahead of the 1024-aligned ring

template <typename T>
struct Untied {
  static constexpr int E = sizeof(T);
  // vocab columns a group: 256 bytes of each row of W.  (On an H100 at
  // Moonlight's shape, a draft with groups of 64 bf16 columns, 128 bytes
  // a row, read W at 0.64 of the bytes rate; 128 columns read it at 0.86.)
  static constexpr int COLS = 256 / E;
  static constexpr int MT = COLS / 64;         // m16 tiles a consumer warp (bf16)
  static constexpr int BOXC = 128 / E;         // columns a TMA box row: 128 bytes
  static constexpr int NBOX = COLS / BOXC;     // boxes a stage, side by side
  // shared elements a row of x: d padded to 64 (bf16: +8, so that the
  // eight rows an ldmatrix reads fall on distinct banks)
  static int ldx(int d) { return (d + 63) / 64 * 64 + (E == 2 ? 8 : 0); }
  static size_t smem(int rows, int d, int kc, int stages) {
    return 1024 + U_HEAD + (size_t)stages * kc * COLS * E + (size_t)rows * ldx(d) * E;
  }
};

struct UntiedParams {
  const void* x;       // (B, d): this launch's rows
  const float* scale;  // (d,) fp32, rmsnorm only
  float* out;          // (B, V): this launch's rows
  int B, d, V, norm;
  float eps;
  int kc, stages, ldx;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Untied head: W is (d, V), V % (16 / sizeof(T)) == 0.  A group is
// Untied<T>::COLS vocab columns (128 bf16, 64 fp32); grid: one block per
// SM (at most one per group); block k owns the k-th contiguous share of
// the groups and walks each over all of d in stages of kc rows (the last
// one ragged: TMA zero-fills rows past d, and x's rows are zero past d).
// A stage is two boxes of kc rows x 128 bytes side by side.  Warp
// TMA_CONS is the producer; consumer warp w takes columns [COLS w / 4,
// COLS (w + 1) / 4) of every stage and releases it on its `empty`
// mbarrier (4 arrivals).  N: bf16, n8 batch tiles (B <= 8N); fp32, batch
// rows held (B <= N).
//   bf16: per 32 rows of the stage and m16 tile, two ldmatrix.x4.trans
//   of W^T's 16x16 fragment (matrix j of lane l: stage row kk + 8 (j >>
//   1) + l % 8, 16-byte chunk 2 (tile % 4) + (j & 1) of the tile's
//   swizzled box) and per n8 tile one ldmatrix.x4 of xn's rows (matrix
//   j: columns kk + 8j), which is the mma's column-major B for two k16
//   steps.
//   fp32: lane (h = lane / 16, c = lane % 16) takes column 16w + c
//   and the rows 8i + 4h .. 8i + 4h + 3 of the stage; the two halves meet
//   by one shuffle at the group's end.  Rows r and r + 4 of a swizzled
//   box fall on disjoint banks.
template <typename T, int N>
__global__ void __launch_bounds__(TMA_THREADS, 1) emit_untied_tma_kernel(
    const __grid_constant__ CUtensorMap wmap, const UntiedParams p) {
  using U = Untied<T>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int COLS = U::COLS, NBOX = U::NBOX, MT = U::MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + U_MAX_STAGES;
  uint64_t* x_bar = empty + U_MAX_STAGES;
  unsigned char* ring = smem + U_HEAD;
  const int box = p.kc * 128, stage = NBOX * box;
  T* xn = reinterpret_cast<T*>(ring + (size_t)p.stages * stage);  // (B, ldx)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, TMA_CONS);
    }
    hopper::mbar_init(x_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int groups = (p.V + COLS - 1) / COLS, nk = (p.d + p.kc - 1) / p.kc;
  const int g0 = (int)((long long)groups * blockIdx.x / gridDim.x);
  const int ngrp = (int)((long long)groups * (blockIdx.x + 1) / gridDim.x) - g0;
  if (warp == TMA_CONS) {  // producer: x's rows first, then the ring
    if (lane == 0) {
      hopper::prefetch_map(&wmap);
      hopper::mbar_expect_tx(x_bar, p.B * p.d * U::E);
    }
    __syncwarp();
    const T* x = static_cast<const T*>(p.x);
    for (int b = lane; b < p.B; b += 32)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(xn + (size_t)b * p.ldx)), "l"(x + (size_t)b * p.d), "r"(p.d * U::E),
             "r"(smem_u32(x_bar))
          : "memory");
    if (lane == 0) {
      const int total = ngrp * nk;
      for (int s = 0; s < total; ++s) {
        const int slot = s % p.stages;
        if (s >= p.stages) hopper::mbar_wait(empty + slot, ((s / p.stages) - 1) & 1);
        hopper::mbar_expect_tx(full + slot, stage);  // boxes past V or d count in full
        const int col = (g0 + s / nk) * COLS, k0 = (s % nk) * p.kc;
        for (int bx = 0; bx < NBOX; ++bx)
          hopper::tma_load_4d(ring + (size_t)slot * stage + bx * box, &wmap, full + slot,
                              col + bx * U::BOXC, k0, 0, 0);
      }
    }
    return;
  }

  // x arrives ahead of the ring; each warp normalises its rows in place
  // and zeroes them past d (a ragged last stage meets zeros, not stale
  // shared memory).  The rmsnorm scale is read from device memory, once
  // a block: its shared copy (32 KB at d 8192) would cost a stage.
  hopper::mbar_wait(x_bar, 0);
  const int dpad = (p.d + 63) / 64 * 64;
  for (int b = warp; b < p.B; b += TMA_CONS) {
    T* row = xn + (size_t)b * p.ldx;
    normalize_row_smem<T>(row, p.scale, p.d, p.norm, p.eps);
    for (int i = p.d + lane; i < dpad; i += 32) row[i] = from_float<T>(0.f);
  }
  hopper::bar_sync(TMA_CONS * 32);  // consumers only

  for (int grp = 0; grp < ngrp; ++grp) {
    const int v0 = (g0 + grp) * COLS + 16 * MT * warp;  // this warp's first column
    if constexpr (BF16) {
      constexpr int CH = MT * N <= 4 ? 2 : 1;  // accumulator chains
      const int j = lane >> 3, r = lane & 7, g = lane >> 2, t = lane & 3;
      // xn's row for this lane's ldmatrix address in each n8 tile (rows
      // past B read row B - 1: their sums are never stored)
      const uint32_t xs = smem_u32(xn) + 2 * (8 * j);
      const int a_row = r + 8 * (j >> 1);
      // each m16 tile's box in the stage and this lane's 16-byte chunk in it
      int a_box[MT], a_chunk[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int q = MT * warp + mi;
        a_box[mi] = (q >> 2) * box;
        a_chunk[mi] = (2 * (q & 3) + (j & 1)) * 16;
      }
      float acc[CH][MT][N][4] = {};
      for (int kb = 0; kb < nk; ++kb) {
        const int s = grp * nk + kb, slot = s % p.stages, k0 = kb * p.kc;
        const int rows = min(p.kc, p.d - k0);
        hopper::mbar_wait(full + slot, (s / p.stages) & 1);
        const uint32_t st = smem_u32(ring + (size_t)slot * stage);
        for (int kk = 0; kk < rows; kk += 32) {
          uint32_t a[2][MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              ldmatrix_x4_trans(a[h][mi], st + a_box[mi] +
                                              hopper::swz<128>((kk + 16 * h + a_row) * 128 +
                                                               a_chunk[mi]));
#pragma unroll
          for (int nt = 0; nt < N; ++nt) {
            const int n = min(nt * 8 + r, p.B - 1);
            uint32_t bq[4];
            ldmatrix_x4(bq, xs + 2u * (uint32_t)(n * p.ldx + k0 + kk));
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mma_bf16_16816(acc[0][mi][nt], a[0][mi][0], a[0][mi][1], a[0][mi][2], a[0][mi][3],
                             bq[0], bq[1]);
              mma_bf16_16816(acc[CH - 1][mi][nt], a[1][mi][0], a[1][mi][1], a[1][mi][2],
                             a[1][mi][3], bq[2], bq[3]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + slot);
      }
      // c[0], c[1]: vocab column v0 + 16 mi + g, batch rows 8nt + 2t, + 1;
      // c[2], c[3]: column + 8.  Each logit rounded once, to bf16.
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < N; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = nt * 8 + 2 * t + (e & 1), v = v0 + 16 * mi + g + 8 * (e >> 1);
            float sum = acc[0][mi][nt][e];
            if (CH == 2) sum += acc[CH - 1][mi][nt][e];
            if (b < p.B && v < p.V)
              p.out[(size_t)b * p.V + v] = __bfloat162float(__float2bfloat16(sum));
          }
    } else {
      const int h = lane >> 4, c = lane & 15;
      const int bx = warp >> 1, q = (warp & 1) * 4 + (c >> 2);
      // byte offset in a box of this lane's column in row 8i + 4h + u:
      // the row's swizzle phase is 4h + u
      int off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) off[u] = (4 * h + u) * 128 + ((q ^ (4 * h + u)) << 4) + 4 * (c & 3);
      const float* xr = reinterpret_cast<const float*>(xn) + 4 * h;
      float acc[N] = {};
      for (int kb = 0; kb < nk; ++kb) {
        const int s = grp * nk + kb, slot = s % p.stages, k0 = kb * p.kc;
        const int rows = min(p.kc, p.d - k0);
        hopper::mbar_wait(full + slot, (s / p.stages) & 1);
        const unsigned char* wb = ring + (size_t)slot * stage + bx * box;
        for (int kk = 0; kk + 4 * h < rows; kk += 8) {
          float w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = *reinterpret_cast<const float*>(wb + kk * 128 + off[u]);
#pragma unroll
          for (int b = 0; b < N; ++b) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xr + min(b, p.B - 1) * p.ldx + k0 + kk);
            acc[b] = fmaf(w[0], xv.x, acc[b]);
            acc[b] = fmaf(w[1], xv.y, acc[b]);
            acc[b] = fmaf(w[2], xv.z, acc[b]);
            acc[b] = fmaf(w[3], xv.w, acc[b]);
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + slot);
      }
      const int v = v0 + c;
#pragma unroll
      for (int b = 0; b < N; ++b) {
        const float sum = acc[b] + __shfl_xor_sync(0xffffffffu, acc[b], 16);
        if (h == 0 && b < p.B && v < p.V) p.out[(size_t)b * p.V + v] = sum;
      }
    }
  }
}

cudaError_t sm_count(int* sms) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count;
  return cudaSuccess;
}

// Tied head (V, d): the bf16 ring where it applies, else the FMA kernel.
template <typename T>
cudaError_t launch_tied(int norm, const void* x, const void* w, const void* scale, void* out,
                        int B, int d, int V, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (B <= 0 || d <= 0 || V <= 0 || d % N != 0 || V % N != 0 || (norm != 0 && norm != 1) ||
      (norm == 0 && scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t xn_bytes = (size_t)B * d * sizeof(T);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d % 32 == 0 && B <= 16 * TMA_MAX_MT) {
      // the widest stage (kc columns: d, or a power of two from 2048 down to
      // 32 below it) that leaves room for two; whole rows when they fit
      // (on an H100, stages of 1024 columns measured ~2 % slower at d = 2048)
      // the normalised x, the rmsnorm scale in fp32, the partial sums
      const size_t xn_smem = (size_t)B * (d + TMA_PAD) * sizeof(T) + (norm == 0 ? d * 4 : 0) +
                             2 * TMA_CONS * ((B + 15) / 16) * 128 * sizeof(float);
      const size_t limit = 227 * 1024;
      int kc = 0, stages = 0;
      for (int cap = 2048; cap >= 32; cap /= 2) {
        kc = std::min(cap, d);
        const size_t stage = (size_t)TMA_ROWS * (kc + TMA_PAD) * sizeof(T);
        if (xn_smem + TMA_BAR_BYTES + 2 * stage <= limit) {
          stages = (int)std::min<size_t>(TMA_MAX_STAGES, (limit - xn_smem - TMA_BAR_BYTES) / stage);
          break;
        }
      }
      if (stages < 2) return cudaErrorInvalidValue;
      const size_t smem =
          TMA_BAR_BYTES + (size_t)stages * TMA_ROWS * (kc + TMA_PAD) * sizeof(T) + xn_smem;
      auto kernel = B <= 16 ? emit_tied_tma_kernel<1> : B <= 32 ? emit_tied_tma_kernel<2>
                  : B <= 48 ? emit_tied_tma_kernel<3> : emit_tied_tma_kernel<4>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      int sms = 0;
      err = sm_count(&sms);
      if (err != cudaSuccess) return err;
      kernel<<<min(sms, V / TMA_ROWS), TMA_THREADS, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
          static_cast<float*>(out), B, d, V, norm, eps, kc, stages);
      return cudaGetLastError();
    }
  }
  const size_t smem = xn_bytes;
  err = cudaFuncSetAttribute(emit_tied_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = NWARPS * TIED_ROWS_PER_WARP;
  emit_tied_kernel<T><<<(V + rows - 1) / rows, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), B, d, V, norm, eps);
  return cudaGetLastError();
}

// The untied kernel for `rows` batch rows a launch: bf16 by n8 tiles,
// fp32 by the rows held (1, 2, 4, then multiples of 8).
template <typename T>
auto untied_kernel(int rows) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch ((rows + 7) / 8) {
      case 1: return emit_untied_tma_kernel<T, 1>;
      case 2: return emit_untied_tma_kernel<T, 2>;
      case 3: return emit_untied_tma_kernel<T, 3>;
      case 4: return emit_untied_tma_kernel<T, 4>;
      case 5: return emit_untied_tma_kernel<T, 5>;
      case 6: return emit_untied_tma_kernel<T, 6>;
      case 7: return emit_untied_tma_kernel<T, 7>;
      default: return emit_untied_tma_kernel<T, 8>;
    }
  } else {
    if (rows <= 1) return emit_untied_tma_kernel<T, 1>;
    if (rows <= 2) return emit_untied_tma_kernel<T, 2>;
    if (rows <= 4) return emit_untied_tma_kernel<T, 4>;
    switch ((rows + 7) / 8) {
      case 1: return emit_untied_tma_kernel<T, 8>;
      case 2: return emit_untied_tma_kernel<T, 16>;
      case 3: return emit_untied_tma_kernel<T, 24>;
      case 4: return emit_untied_tma_kernel<T, 32>;
      case 5: return emit_untied_tma_kernel<T, 40>;
      case 6: return emit_untied_tma_kernel<T, 48>;
      case 7: return emit_untied_tma_kernel<T, 56>;
      default: return emit_untied_tma_kernel<T, 64>;
    }
  }
}

// Untied head (d, V) by the wrapper's plan: kc rows of d a stage,
// `stages` stages, `rows` batch rows a launch (ceil(B / rows) launches,
// each reading W once).
template <typename T>
cudaError_t launch_untied(int norm, const void* x, const void* w, const void* scale, void* out,
                          int B, int d, int V, float eps, int kc, int stages, int rows,
                          cudaStream_t stream) {
  using U = Untied<T>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  if (B <= 0 || d <= 0 || V <= 0 || d % Vec<T>::N != 0 || V % Vec<T>::N != 0 ||
      (norm != 0 && norm != 1) || (norm == 0 && scale == nullptr) || kc <= 0 || kc > 256 ||
      kc % 32 != 0 || stages < 2 || stages > U_MAX_STAGES || rows <= 0 || rows > U_MAX_ROWS)
    return cudaErrorInvalidValue;
  const size_t smem = U::smem(rows, d, kc, stages);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // W (d, V) as a 4-d map {V, d, 1, 1}; a box is kc rows of 128 bytes
  const cuuint64_t dims[4] = {(cuuint64_t)V, (cuuint64_t)d, 1, 1};
  const cuuint64_t row = (cuuint64_t)V * U::E;
  const cuuint64_t strides[3] = {row, row * d, row * d};
  const cuuint32_t box[4] = {(cuuint32_t)U::BOXC, (cuuint32_t)kc, 1, 1};
  CUtensorMap map;
  cudaError_t err = hopper::make_map(&map, BF16, w, dims, strides, box, 128);
  if (err != cudaSuccess) return err;
  auto kernel = untied_kernel<T>(rows);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int groups = (V + U::COLS - 1) / U::COLS;
  UntiedParams p{};
  p.scale = static_cast<const float*>(scale);
  p.d = d;
  p.V = V;
  p.norm = norm;
  p.eps = eps;
  p.kc = kc;
  p.stages = stages;
  p.ldx = U::ldx(d);
  for (int b0 = 0; b0 < B; b0 += rows) {
    p.x = static_cast<const T*>(x) + (size_t)b0 * d;
    p.out = static_cast<float*>(out) + (size_t)b0 * V;
    p.B = std::min(rows, B - b0);
    kernel<<<std::min(sms, groups), TMA_THREADS, smem, stream>>>(map, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; norm: 0 = rmsnorm (scale is (d,)
// fp32), 1 = non-parametric layernorm (scale unused); tied: W is (V, d)
// when nonzero, else (d, V).  kc, stages, rows: the untied plan
// (emit_norm_logits/ops.py: untied_plan; unused when tied).  out is
// (B, V) fp32.  Returns cudaGetLastError() after the launches (0 when
// they were accepted).
extern "C" int emit_norm_logits(int dtype, int norm, int tied, const void* x, const void* w,
                                const void* scale, void* out, int B, int d, int V, float eps,
                                int kc, int stages, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (tied)
    return dtype == 1 ? launch_tied<__nv_bfloat16>(norm, x, w, scale, out, B, d, V, eps, st)
                      : launch_tied<float>(norm, x, w, scale, out, B, d, V, eps, st);
  return dtype == 1 ? launch_untied<__nv_bfloat16>(norm, x, w, scale, out, B, d, V, eps, kc,
                                                   stages, rows, st)
                    : launch_untied<float>(norm, x, w, scale, out, B, d, V, eps, kc, stages,
                                           rows, st);
}
