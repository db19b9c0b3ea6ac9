// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py:_ssd_chunk_kernel
// (its pallas_call is in ssd_intra_chunk).  Same function, per (chunk,
// head), in fp32 from inputs in x's dtype:
//   cum   = inclusive cumsum of dt * a                      (Q,)
//   y     = (C.B^T * exp(cum_i - cum_j) * dt_j on j <= i).x + D.x
//                                                           (Q, P), x's dtype
//   state = (B * exp(total - cum) * dt)^T . x, total = cum[Q-1]
//                                                           (N, P), fp32
// and cum itself.  The cross-chunk recurrence stays outside (ops.py).
//
// Bound on the H100.  Mamba2-1.3B's prefill chunk (Q = 256, H = 64,
// P = 64, N = 128, one B/C group, bf16) moves ~6.3 MB (x and y 2 MB
// each, the fp32 state 2 MB), 1.9 us at 3.35 TB/s; its fp32 work, the
// lower triangle of C.B^T once per group and of W.x and the state
// product per head, is ~0.55 GFLOP, 8.2 us at the 67 TFLOP/s of fp32
// FMAs.  So it is bound by operations while the math stays fp32 outside
// the tensor cores.
//
// Design.  The TPU kernel holds a whole (Q, Q) score tile in VMEM (256
// KB in fp32 at Q = 256), more than an SM's shared memory; here the
// chunk is tiled into 64 x 64 tiles, and each thread of a 256-thread
// block owns a 4 x 4 block of a tile, reading its operands from shared
// memory as float4s:
//   ssd_cb_kernel: C.B^T does not depend on the head, so it is computed
//     once per (chunk, group) -- not once per head as on the TPU (64
//     times at G = 1) -- one block per lower-triangle (i, j) tile, both
//     operands staged whole (N = 128 deep: one load phase with many
//     loads in flight), into an fp32 (Q, Q) scratch the wrapper owns.
//   ssd_y_kernel: one block per (64-row tile i of y, 64-column tile of
//     P, head, chunk).  It scans the chunk's dt * a in shared memory
//     (no triangular product: that exists on the TPU only because
//     cumsum has no lowering there), then walks the j tiles up to the
//     diagonal (the tiles with the most to walk are issued first): the
//     C.B^T tile from the scratch (L2), weighted by the decay and dt_j
//     and masked above the diagonal into shared memory, then y_i +=
//     W.x_j.
//   ssd_state_kernel: one block per (64-row tile of N, 64-column tile
//     of P, head, chunk), the same scan and each row's weight exp(total
//     - cum) * dt once, then the state tile summed over the chunk in
//     64-deep steps; the blocks of the first tiles write cum.
// Earlier designs, at Mamba2-1.3B's chunk on an H100 SXM (700 W): C.B^T
// per head staged 16 deep (8 load phases and barrier pairs per j
// tile), 0.149 ms; staged 128 deep, 0.112 ms.  Tensor cores (TF32 mma
// / wgmma) and TMA are later work.  Q is any value from 1 to 256 (a
// prompt's ragged tail is a short chunk): every row and column edge is
// masked, zeros feed the products past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 block of a tile
constexpr int TILE = 64;      // output tile rows and columns
constexpr int NCH = 128;      // depth of one step of C.B^T (over N): all of Mamba-2's N
constexpr int KS = 64;        // depth of one step of the state product (over Q)
constexpr int MAXQ = THREADS; // the scan gives each thread one row of the chunk
constexpr int PAD = 4;        // floats of padding per shared row (keeps float4 alignment)
constexpr int LDT = TILE + PAD;
// ssd_cb_kernel's dynamic shared memory: C_i^T and B_j^T, NCH x LDT
// floats each (70 KB, three blocks an SM).
constexpr int CB_SMEM = 2 * NCH * LDT * sizeof(float);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// s_dt[t] = dt[t] (0 past Q); s_cum = inclusive cumsum of dt * a (flat
// past Q).  Hillis-Steele over the block's 256 threads.
__device__ __forceinline__ void chunk_scan(const float* dt, float a, int Q, float* s_dt,
                                           float* s_cum) {
  const int t = threadIdx.x;
  const float d = t < Q ? dt[t] : 0.f;
  s_dt[t] = d;
  float v = d * a;
  s_cum[t] = v;
  __syncthreads();
#pragma unroll
  for (int off = 1; off < MAXQ; off <<= 1) {
    const float add = t >= off ? s_cum[t - off] : 0.f;
    __syncthreads();
    v += add;
    s_cum[t] = v;
    __syncthreads();
  }
}

// acc[r][c] += sum_k A[k][ty*4 + r] * B[k][tx*4 + c] over `depth` rows
// of two k-major shared tiles with rows of LD floats.
template <int LD>
__device__ __forceinline__ void tile_fma(const float* A, const float* B, int depth, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < depth; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * LD + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(B + k * LD + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ b, const T* __restrict__ c, float* __restrict__ cb, int Q,
              int N) {
  const int i0 = blockIdx.x * TILE, j0 = blockIdx.y * TILE;
  if (j0 > i0) return;  // above the diagonal: masked out by the y kernel
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;              // C_i^T: k = n, rows i       (NCH x LDT)
  float* s_bt = smem + NCH * LDT;  // B_j^T: k = n, columns j    (NCH x LDT)
  const size_t group = blockIdx.z;  // bc * G + g
  const T* bg = b + group * Q * N;
  const T* cg = c + group * Q * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float sc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += NCH) {
#pragma unroll 4
    for (int e = tid; e < TILE * NCH; e += THREADS) {
      const int r = e / NCH, k = e % NCH, n = n0 + k;
      const int ri = i0 + r, rj = j0 + r;
      s_ct[k * LDT + r] = (ri < Q && n < N) ? to_float(cg[(size_t)ri * N + n]) : 0.f;
      s_bt[k * LDT + r] = (rj < Q && n < N) ? to_float(bg[(size_t)rj * N + n]) : 0.f;
    }
    __syncthreads();
    tile_fma<LDT>(s_ct, s_bt, min(NCH, N - n0), ty, tx, sc);
    __syncthreads();
  }
  float* out = cb + group * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Q) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx * 4 + cc;
      if (j < Q) out[(size_t)i * Q + j] = sc[r][cc];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cb, const float* __restrict__ a,
             const float* __restrict__ d_skip, T* __restrict__ y, int H, int G, int Q, int P) {
  __shared__ float s_dt[MAXQ];
  __shared__ float s_cum[MAXQ];
  __shared__ __align__(16) float s_wt[TILE][LDT];  // W^T: k = j, rows i
  __shared__ __align__(16) float s_x[TILE][LDT];   // x_j: k = j, columns p

  const int n_ptiles = (P + TILE - 1) / TILE, n_itiles = (Q + TILE - 1) / TILE;
  // the tiles with the most j tiles to walk first
  const int i0 = (n_itiles - 1 - (int)blockIdx.x / n_ptiles) * TILE;
  const int p0 = (blockIdx.x % n_ptiles) * TILE;
  const int h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  const T* xh = x + ((size_t)bc * H + h) * Q * P;
  const float* cbg = cb + ((size_t)bc * G + g) * Q * Q;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  chunk_scan(dt + ((size_t)bc * H + h) * Q, a[h], Q, s_dt, s_cum);

  float acc[4][4] = {};
  for (int j0 = 0; j0 <= i0; j0 += TILE) {
    // W = C.B^T * exp(cum_i - cum_j) * dt_j on the lower triangle, stored k-major
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + cc;
        const float w = (j <= i && i < Q)
                            ? cbg[(size_t)i * Q + j] * expf(s_cum[i] - s_cum[j]) * s_dt[j]
                            : 0.f;
        s_wt[tx * 4 + cc][ty * 4 + r] = w;
      }
    }
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, col = e % TILE;
      s_x[r][col] = (j0 + r < Q && p0 + col < P)
                        ? to_float(xh[(size_t)(j0 + r) * P + p0 + col]) : 0.f;
    }
    __syncthreads();
    tile_fma<LDT>(&s_wt[0][0], &s_x[0][0], TILE, ty, tx, acc);
    __syncthreads();
  }

  const float dsk = d_skip[h];
  T* yh = y + ((size_t)bc * H + h) * Q * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Q) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx * 4 + cc;
      if (p < P) {
        const size_t o = (size_t)i * P + p;
        yh[o] = from_float<T>(acc[r][cc] + to_float(xh[o]) * dsk);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ b,
                 const float* __restrict__ a, float* __restrict__ state, float* __restrict__ cum,
                 int H, int G, int Q, int P, int N) {
  __shared__ float s_dt[MAXQ];
  __shared__ float s_cum[MAXQ];
  __shared__ __align__(16) float s_b[KS][LDT];  // B * exp(total - cum) * dt: k = q, rows n
  __shared__ __align__(16) float s_x[KS][LDT];  // x: k = q, columns p

  const int n_ptiles = (P + TILE - 1) / TILE;
  const int n0 = (blockIdx.x / n_ptiles) * TILE, p0 = (blockIdx.x % n_ptiles) * TILE;
  const int h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  const T* xh = x + ((size_t)bc * H + h) * Q * P;
  const T* bg = b + ((size_t)bc * G + g) * Q * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  chunk_scan(dt + ((size_t)bc * H + h) * Q, a[h], Q, s_dt, s_cum);
  // each row's weight in the state, exp(total - cum) * dt, in place of dt
  // (0 past Q); every thread rewrites only its own row
  s_dt[tid] = tid < Q ? expf(s_cum[Q - 1] - s_cum[tid]) * s_dt[tid] : 0.f;
  __syncthreads();

  float acc[4][4] = {};
  for (int q0 = 0; q0 < Q; q0 += KS) {
#pragma unroll 4
    for (int e = tid; e < KS * TILE; e += THREADS) {
      const int k = e / TILE, col = e % TILE, q = q0 + k;
      float bw = 0.f, xv = 0.f;
      if (q < Q) {
        if (n0 + col < N) bw = to_float(bg[(size_t)q * N + n0 + col]) * s_dt[q];
        if (p0 + col < P) xv = to_float(xh[(size_t)q * P + p0 + col]);
      }
      s_b[k][col] = bw;
      s_x[k][col] = xv;
    }
    __syncthreads();
    tile_fma<LDT>(&s_b[0][0], &s_x[0][0], min(KS, Q - q0), ty, tx, acc);
    __syncthreads();
  }

  float* sh = state + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty * 4 + r;
    if (n >= N) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx * 4 + cc;
      if (p < P) sh[(size_t)n * P + p] = acc[r][cc];
    }
  }
  if (blockIdx.x == 0 && tid < Q) cum[((size_t)bc * H + h) * Q + tid] = s_cum[tid];
}

template <typename T>
int launch(const void* x, const void* dt, const void* b, const void* c, const void* a,
           const void* d_skip, void* y, void* state, void* cum, void* cb, int BC, int H, int G,
           int Q, int P, int N, cudaStream_t st) {
  static bool smem_set = false;  // once per instantiation: above 48 KB needs the opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_i = (Q + TILE - 1) / TILE, n_p = (P + TILE - 1) / TILE;
  ssd_cb_kernel<T><<<dim3(n_i, n_i, BC * G), THREADS, CB_SMEM, st>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(cb), Q, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_y_kernel<T><<<dim3(n_i * n_p, H, BC), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(cb),
      static_cast<const float*>(a), static_cast<const float*>(d_skip), static_cast<T*>(y), H, G,
      Q, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_s(((N + TILE - 1) / TILE) * n_p, H, BC);
  ssd_state_kernel<T><<<grid_s, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(b),
      static_cast<const float*>(a), static_cast<float*>(state), static_cast<float*>(cum), H, G,
      Q, P, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, y); dt, a, d_skip, state,
// cum and the scratch cb are float32.  x (BC,H,Q,P), dt (BC,H,Q), b and c
// (BC,G,Q,N), all contiguous; cb holds BC*G*Q*Q floats.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int ssd_intra_chunk(int dtype, const void* x, const void* dt, const void* b,
                               const void* c, const void* a, const void* d_skip, void* y,
                               void* state, void* cum, void* cb, int BC, int H, int G, int Q,
                               int P, int N, void* stream) {
  if (Q < 1 || Q > MAXQ || G < 1 || H % G || P < 1 || N < 1 || BC < 1 || BC > 65535 ||
      H > 65535 || (long long)BC * G > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, b, c, a, d_skip, y, state, cum, cb, BC, H, G, Q, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, b, c, a, d_skip, y, state, cum, cb, BC, H, G, Q, P, N,
                                 st);
  return cudaErrorInvalidValue;
}
