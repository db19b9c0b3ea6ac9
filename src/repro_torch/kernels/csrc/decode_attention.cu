// Fused decode attention for Hopper (sm_90a): the new K/V row is
// substituted into the cache page on chip and one query row per head is
// read against it.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// _decode_attention_kernel (its pallas_call is in decode_attention_pallas).
// Same function: for each batch row, K/V = cache page with row `pos`
// replaced by the new row; fp32 scores q.k, scaled after the dot; rows
// s >= kv_len masked; softmax; a row with no valid key gives 0 (the NaN
// scrub); fp32 P.V; cast to q's dtype.  The caller writes the new row
// into the cache afterwards.
//
// Bound on the H100: bytes.  One decode step reads kv_len rows of K and
// V per (batch row, KV head) and does 4*g flops per element read (g =
// query heads per KV head), far below the ~295 flop/byte the card needs
// to be compute bound; the least time is the valid K/V bytes over
// 3.35 TB/s.
//
// Design against that bound: the Pallas kernel holds the whole (S, KV,
// dh) page in VMEM, which does not fit a Hopper SM (8 MB of K alone at
// S=1024, KV=16, dh=128).  Here the page is split over S (flash
// decoding).  One block per (64-row tile, KV head, batch row) copies its
// tile into shared memory with 16-byte cp.async copies, all in flight at
// once, substituting the new row where s == pos, and writes the tile's
// softmax statistics (max m, sum l) and unnormalised P.V for its g query
// heads; blocks whose tile lies past kv_len exit at once, so a short row
// reads only its valid rows.  A second kernel, one block per (head, batch
// row), merges the tiles' partials (log-sum-exp rescaling) and casts.
// The split spreads a long row over many SMs: one block per (row, KV
// head) streamed its tiles one after another on one SM and was latency
// bound (272 us for OLMo-1B's decode step at B=8, S=1024 on an H100 SXM
// at 700 W, 30x the bound).  The partials, (B, H, S/64, dh + 2) fp32, are
// ~1 MB of extra traffic at OLMo-1B's widths.  All of a block's g query
// heads share its K/V tile, so GQA reads the cache once per KV head.
// TMA and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // cache rows per block
constexpr int MAX_G = 16;     // query heads per KV head
constexpr int THREADS = 256;  // 8 warps

// 16 bytes global -> shared without a register round trip, so that all of
// a thread's loads of a tile are in flight at once.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int valid_rows(const int* kv_len, int b, int S) {
  return min(max(kv_len[b], 0), S);
}

// Shared memory, in order: K tile, V tile (T, TILE x dh each); q (g x dh
// fp32); scores/probabilities (g x TILE fp32); partial P.V sums of the
// thread groups other than the first ((groups - 1) x g x dh fp32).
size_t smem_bytes(size_t elem, int g, int dh) {
  const int groups = THREADS / dh;
  return 2 * TILE * dh * elem +
         sizeof(float) * ((size_t)g * dh + (size_t)g * TILE + (size_t)(groups - 1) * g * dh);
}

// grid (S / TILE rounded up, KV, B); THREADS threads.  dh is a multiple of
// 32 that divides THREADS; dh * sizeof(T) is a multiple of 16; g = H / KV
// is at most G, a power of two, so that the per-head loops are unrolled to
// G and not to MAX_G.  Writes, for each query head h of the block and its
// tile t, part_ml[(b, h, t)] = (m, l) and part_acc[(b, h, t), :] =
// sum_s exp(score_s - m) v_s.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS) decode_attention_tile_kernel(
    const T* __restrict__ q,         // (B, H, dh)
    const T* __restrict__ k_new,     // (B, KV, dh)
    const T* __restrict__ v_new,     // (B, KV, dh)
    const T* __restrict__ k_cache,   // (B, S, KV, dh)
    const T* __restrict__ v_cache,   // (B, S, KV, dh)
    const int* __restrict__ pos,     // (B,)
    const int* __restrict__ kv_len,  // (B,)
    float* __restrict__ part_ml,     // (B, H, NT, 2)
    float* __restrict__ part_acc,    // (B, H, NT, dh)
    int S, int H, int KV, int dh, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int NWARPS = THREADS / 32;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int s0 = tile * TILE;
  const int n = valid_rows(kv_len, b, S);
  if (s0 >= n) return;  // past this row's valid keys: the merge skips the tile
  const int rows = min(TILE, n - s0);
  const int p = pos[b];
  const int g = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + TILE * dh;
  float* q_s = reinterpret_cast<float*>(v_s + TILE * dh);
  float* p_s = q_s + g * dh;
  float* red_s = p_s + g * TILE;

  // This KV head's query heads are kvh*g .. kvh*g + g-1 (the JAX
  // package's (KV, G) grouping of the H axis).
  const T* qb = q + ((size_t)b * H + (size_t)kvh * g) * dh;
  for (int i = tid; i < g * dh; i += THREADS) q_s[i] = to_float(qb[i]);

  // Load the tile; the row at `pos` comes from the new K/V row.
  const size_t row_stride = (size_t)KV * dh;
  const T* kc = k_cache + ((size_t)b * S + s0) * row_stride + (size_t)kvh * dh;
  const T* vc = v_cache + ((size_t)b * S + s0) * row_stride + (size_t)kvh * dh;
  const T* kn = k_new + ((size_t)b * KV + kvh) * dh;
  const T* vn = v_new + ((size_t)b * KV + kvh) * dh;
  const int chunks = dh / VEC;
  for (int i = tid; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * VEC;
    const bool fresh = s0 + r == p;
    cp_async16(k_s + r * dh + c, (fresh ? kn : kc + (size_t)r * row_stride) + c);
    cp_async16(v_s + r * dh + c, (fresh ? vn : vc + (size_t)r * row_stride) + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // Scores, one warp per row: fp32 dot over dh, then the scale.
  for (int r = warp; r < rows; r += NWARPS) {
    float part[G];
#pragma unroll
    for (int j = 0; j < G; ++j) part[j] = 0.f;
    for (int e = lane; e < dh; e += 32) {
      const float kd = to_float(k_s[r * dh + e]);
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < g) part[j] += q_s[j * dh + e] * kd;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < g) {
        const float sc = warp_sum(part[j]);
        if (lane == 0) p_s[j * TILE + r] = sc * scale;
      }
    }
  }
  __syncthreads();

  // The tile's softmax statistics, one warp per head.  Every row < rows is
  // valid, so m is finite and l >= 1.
  float* ml = part_ml + (((size_t)b * H + (size_t)kvh * g) * gridDim.x + tile) * 2;
  for (int j = warp; j < g; j += NWARPS) {
    float mx = -INFINITY;
    for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[j * TILE + r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float e = expf(p_s[j * TILE + r] - mx);
      p_s[j * TILE + r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[(size_t)j * gridDim.x * 2] = mx;
      ml[(size_t)j * gridDim.x * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // P.V: thread (grp, d) owns output column d of every head for the tile
  // rows r with r % groups == grp; the groups' sums meet in shared memory.
  const int groups = THREADS / dh;
  const int d = tid % dh, grp = tid / dh;
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
  for (int r = grp; r < rows; r += groups) {
    const float vd = to_float(v_s[r * dh + d]);
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g) acc[j] += p_s[j * TILE + r] * vd;
  }
  if (grp > 0) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g) red_s[((grp - 1) * g + j) * dh + d] = acc[j];
  }
  __syncthreads();
  if (grp == 0) {
    float* pa = part_acc + (((size_t)b * H + (size_t)kvh * g) * gridDim.x + tile) * dh;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < g) {
        float a = acc[j];
        for (int o = 1; o < groups; ++o) a += red_s[((o - 1) * g + j) * dh + d];
        pa[(size_t)j * gridDim.x * dh + d] = a;
      }
    }
  }
}

// grid (H, B); dh threads.  Merges the tiles below kv_len:
// out = sum_t exp(m_t - M) acc_t / sum_t exp(m_t - M) l_t, M = max_t m_t;
// 0 where no tile is valid.
template <typename T>
__global__ void decode_attention_merge_kernel(const float* __restrict__ part_ml,
                                              const float* __restrict__ part_acc,
                                              const int* __restrict__ kv_len,
                                              T* __restrict__ out, int S, int H, int dh,
                                              int NT) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nt = (valid_rows(kv_len, b, S) + TILE - 1) / TILE;
  const size_t base = ((size_t)b * H + h) * NT;
  float m = -INFINITY;
  for (int t = 0; t < nt; ++t) m = fmaxf(m, part_ml[(base + t) * 2]);
  float l = 0.f, a = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float w = expf(part_ml[(base + t) * 2] - m);
    l += part_ml[(base + t) * 2 + 1] * w;
    a += part_acc[(base + t) * dh + d] * w;
  }
  out[((size_t)b * H + h) * dh + d] = from_float<T>(l > 0.f ? a / l : 0.f);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* k_cache,
                   const void* v_cache, const void* pos, const void* kv_len, void* out,
                   void* scratch, int B, int S, int H, int KV, int dh, float scale,
                   cudaStream_t stream) {
  const int g = H / KV;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || g > MAX_G || dh % 32 != 0 ||
      THREADS % dh != 0 || (dh * sizeof(T)) % 16 != 0)
    return cudaErrorInvalidValue;
  const int nt = (S + TILE - 1) / TILE;
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + (size_t)B * H * nt * 2;
  // the smallest power of two >= g
  auto kernel = g == 1 ? decode_attention_tile_kernel<T, 1>
                : g == 2 ? decode_attention_tile_kernel<T, 2>
                : g <= 4 ? decode_attention_tile_kernel<T, 4>
                : g <= 8 ? decode_attention_tile_kernel<T, 8>
                         : decode_attention_tile_kernel<T, MAX_G>;
  const size_t smem = smem_bytes(sizeof(T), g, dh);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nt, KV, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const int*>(pos), static_cast<const int*>(kv_len), part_ml, part_acc, S, H,
      KV, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_merge_kernel<T><<<dim3(H, B), dh, 0, stream>>>(
      part_ml, part_acc, static_cast<const int*>(kv_len), static_cast<T*>(out), S, H, dh, nt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch holds scratch_floats fp32
// values, at least B * H * ceil(S / 64) * (dh + 2) (the tiles' partials).
// Returns cudaGetLastError() after the launches (0 when they were
// accepted).
extern "C" int decode_attention(int dtype, const void* q, const void* k_new, const void* v_new,
                                const void* k_cache, const void* v_cache, const void* pos,
                                const void* kv_len, void* out, void* scratch,
                                long long scratch_floats, int B, int S, int H, int KV, int dh,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch_floats < (long long)B * H * ((S + TILE - 1) / TILE) * (dh + 2))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, pos, kv_len, out, scratch, B, S, H,
                         KV, dh, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, pos, kv_len, out, scratch,
                                 B, S, H, KV, dh, scale, st);
  return cudaErrorInvalidValue;
}
