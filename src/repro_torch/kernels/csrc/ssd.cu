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
// P = 64, N = 128, one B/C group, bf16) moves ~6.5 MB (x and y 2 MB
// each, the fp32 state 2 MB), 1.96 us at 3.35 TB/s; its work, the lower
// triangle of C.B^T once per group and of W.x and the state product per
// head, is ~0.55 GFLOP of fp32-accurate products.  With bf16 inputs C.B^T
// is one bf16 product and W.x and the state product two (their fp32
// weights in two bf16 terms): ~1.1 GFLOP at 989 TFLOP/s, 1.1 us, so the
// bytes bound it.  fp32 inputs: 3.3 us at the 165 TFLOP/s of 3xTF32.
//
// Design: one launch, every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulation), 128-thread blocks of two
// roles, with the blocks that walk the most tiles issued first:
//   state blocks, one per (64-row N tile, 64-column P tile, head,
//     chunk): each warp sums 16 rows of the state over the chunk's 64-row
//     q steps; each row's weight exp(total - cum) * dt scales x's operand
//     fragments in registers (fp32, then split); the blocks of the first
//     tiles write cum.
//   y blocks, one per (64-row tile i of y, 64-column P tile, head,
//     chunk): for each j tile up to the diagonal, each warp computes its
//     16 rows of C_i.B_j^T (N deep, from shared memory), weights them in
//     registers by exp(cum_i - cum_j) * dt_j, masks above the diagonal,
//     and multiplies them with x_j straight from the accumulator
//     registers (the accumulator layout of m16n8 is the operand layout
//     of m16n8k16's A): W never touches shared memory.  C.B^T is
//     recomputed per head; on the tensor cores that costs less than the
//     scratch round trip and the launch it replaces.
// Both roles stage the next j (or q) step's tiles with cp.async while
// the current step is multiplied (two buffers).  Every block scans the
// chunk's dt * a itself (no triangular product: that exists on the TPU
// only because cumsum has no lowering there).
// Accuracy: bf16 x, B and C are exact as bf16 operands, so C.B^T is
// exact in its products; the fp32 products W and B * weight are split
// into two bf16 terms (about 2^-17 relative), each multiplied with x.
// With fp32 inputs every operand is split into three bf16 terms (all 24
// bits of the mantissa) and a product sums the six products of terms
// whose indices add up to at most 2: within a few fp32 roundings of an
// fp32 product, which 48 Mamba blocks in a row need (two terms of each,
// 2^-16 a product, moved Mamba2-1.3B's logits by 2x the fp32 allowance).
// Earlier designs, at Mamba2-1.3B's chunk on an H100 SXM (700 W): three
// launches on fp32 FMAs with C.B^T once per (chunk, group) in an L2
// scratch, 0.0840 ms (Q=37 tail 0.0265 ms); C.B^T per head staged 128
// deep, 0.112 ms; staged 16 deep, 0.149 ms.  Q is any value from 1 to 256
// (a prompt's ragged tail is a short chunk): every row and column edge
// is masked, zeros feed the products past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int TILE = 64;      // rows of a y tile, of a j tile and of a q step; columns of a P tile
constexpr int NCH = 128;      // columns of N staged at once (all of Mamba-2's N)
constexpr int STATE_N = 64;   // rows of the state a state block sums, 16 a warp
constexpr int MAXQ = 256;     // the scan gives each thread two rows of the chunk
constexpr int LDN = NCH + 8;  // bf16 row strides: 16 bytes of padding, so that the eight
constexpr int LDP = TILE + 8; //   rows an ldmatrix reads fall on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a = t[0] + t[1] + ... + t[NT-1] in bf16 terms, each the bf16 nearest
// to what the terms before it leave over (NT = 3 holds all 24 bits of
// an fp32 mantissa; NT = 2 about 17).  Pairs: the low half holds a.
template <int NT>
__device__ __forceinline__ void split(float a, float b, uint32_t (&t)[NT]) {
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    t[k] = *reinterpret_cast<const uint32_t*>(&h);
    a -= hf.x;
    b -= hf.y;
  }
}

// The products of an NA-term and an NB-term split that a sum keeps:
// terms i, j with i + j <= 2 (the others are below 2^-24 relative).
__device__ __forceinline__ constexpr bool kept(int i, int j) { return i + j <= 2; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// D (16 x 8, fp32) += A (16 x 16, bf16) * B (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [0, 64) x columns [0, width) of a shared tile from src (row
// r at src + r * ld): element (r, c) = src[r][c] for r < rows and c <
// cols, else 0, as NT bf16 terms, term k at dst + k * term_stride.
// width is a multiple of 8; vec: 16-byte aligned rows and cols % 8 == 0.
// bf16 in one term goes by cp.async (the caller waits with
// cp_async_wait_all); anything else through registers, loads batched.
template <typename T, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t ld, int rows, int cols,
                                      int width, bf16* dst, int ldd, int term_stride, bool vec) {
  const int groups = width / 8, total = TILE * groups;
  if constexpr (std::is_same<T, bf16>::value && NT == 1) {
    if (vec) {
      for (int e = threadIdx.x; e < total; e += THREADS) {
        const int r = e / groups, c = (e % groups) * 8;
        const bool in = r < rows && c < cols;
        cp_async16(dst + r * ldd + c, in ? src + (size_t)r * ld + c : src, in ? 16 : 0);
      }
      return;
    }
  }
  constexpr int BATCH = 4;
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * BATCH) {
    float v[BATCH][8];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * THREADS, r = e / groups, c = (e % groups) * 8;
      if (e < total && r < rows && vec && c + 8 <= cols) {
        const T* p = src + (size_t)r * ld + c;
        if constexpr (std::is_same<T, float>::value) {
          const float4 a = reinterpret_cast<const float4*>(p)[0];
          const float4 b = reinterpret_cast<const float4*>(p)[1];
          v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
          v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
        } else {
          const uint4 a = *reinterpret_cast<const uint4*>(p);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[u][2 * i] = f.x;
            v[u][2 * i + 1] = f.y;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[u][i] = (e < total && r < rows && c + i < cols) ? to_float(src[(size_t)r * ld + c + i])
                                                           : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * THREADS, r = e / groups, c = (e % groups) * 8;
      if (e >= total) break;
      uint32_t terms[4][NT];
#pragma unroll
      for (int i = 0; i < 4; ++i) split<NT>(v[u][2 * i], v[u][2 * i + 1], terms[i]);
#pragma unroll
      for (int k = 0; k < NT; ++k)
        *reinterpret_cast<uint4*>(dst + k * term_stride + r * ldd + c) =
            make_uint4(terms[0][k], terms[1][k], terms[2][k], terms[3][k]);
    }
  }
}

// s_dt[t] = dt[t] (0 past Q); s_cum = inclusive cumsum of dt * a (flat
// past Q).  Each thread owns rows 2t and 2t + 1; warp scans, then the
// warps' totals.
__device__ __forceinline__ void chunk_scan(const float* __restrict__ dt, float a, int Q,
                                           float* s_dt, float* s_cum, float* s_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float d0 = 2 * t < Q ? dt[2 * t] : 0.f, d1 = 2 * t + 1 < Q ? dt[2 * t + 1] : 0.f;
  const float v0 = d0 * a, pair = v0 + d1 * a;
  float incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_tot[warp] = incl;
  __syncthreads();
  float before = incl - pair;
  for (int w = 0; w < warp; ++w) before += s_tot[w];
  s_dt[2 * t] = d0;
  s_dt[2 * t + 1] = d1;
  s_cum[2 * t] = before + v0;
  s_cum[2 * t + 1] = before + pair;
  __syncthreads();
}

struct Shapes {
  int BC, H, G, Q, P, N, n_i, n_p, n_n;
};

// bf16 terms of x, B and C (exact in one when the inputs are bf16) and
// of the fp32 products W and weight * x.  Shared memory: the scan, one C
// tile, two B and two x tiles (the next j or q step is staged while this
// one is multiplied).
template <typename T> struct Terms {
  static constexpr int IN = std::is_same<T, float>::value ? 3 : 1;
  static constexpr int W = std::is_same<T, float>::value ? 3 : 2;
  static constexpr int SMEM = (3 * MAXQ + 8) * sizeof(float) +
                              IN * (3 * TILE * LDN + 2 * TILE * LDP) * sizeof(bf16);
};

// sacc (this warp's 16 rows x 64 columns of C_i.B_j^T) += C_i . B_j^T
// over `width` columns of N, skipping column tiles from nt_end on.
template <int TI>
__device__ __forceinline__ void cb_product(float (&sacc)[8][4], const bf16* s_c, const bf16* s_b,
                                           int width, int nt_end, int r0, int lane) {
  constexpr int CS = TILE * LDN;
  // each k step loads all its fragments, then multiplies: the loads are in
  // flight together
#pragma unroll 2
  for (int ks = 0; ks < width / 16; ++ks) {
    uint32_t ac[TI][4], bb[4][TI][4];
    const int row = r0 + (lane & 7) + 8 * ((lane >> 3) & 1), col = ks * 16 + 8 * (lane >> 4);
#pragma unroll
    for (int i = 0; i < TI; ++i) ldsm_x4(ac[i], s_c + i * CS + row * LDN + col);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt_end) continue;
      const int br = np * 16 + (lane & 7) + 8 * (lane >> 4), bcol = ks * 16 + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int j = 0; j < TI; ++j) ldsm_x4(bb[np][j], s_b + j * CS + br * LDN + bcol);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt_end) continue;
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j)
          if (kept(i, j)) {
            mma(sacc[2 * np], ac[i], bb[np][j][0], bb[np][j][1]);
            mma(sacc[2 * np + 1], ac[i], bb[np][j][2], bb[np][j][3]);
          }
    }
  }
}

// yacc += W . x_j, W = S * exp(cum_i - cum_j) * dt_j on j <= i, built in
// registers from S's accumulator fragments: k step nt / 2 of A holds a0
// (row g, k 2t), a1 (row g+8, k 2t), a2 (row g, k 2t+8), a3 (row g+8,
// k 2t+8), as TW bf16 terms.  Below the diagonal tile the decay factors
// through the tile's last column m: exp(cum_i - cum_m) * exp(cum_m -
// cum_j), both in [0, 1] (a <= 0, dt >= 0), the second (times dt_j) in
// s_g; the diagonal tile takes each exp whole.
template <int TI, int TW>
__device__ __forceinline__ void wx_product(float (&yacc)[8][4], const float (&sacc)[8][4],
                                           const bf16* s_x, const float* s_cum,
                                           const float* s_dt, const float* s_g, int i0, int j0,
                                           int r0, int nt_end, int lane) {
  constexpr int XS = TILE * LDP;
  const int g = lane >> 2, t = lane & 3;
  const bool diag = j0 == i0;
  float e_row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    e_row[half] = diag ? 0.f : exp2f((s_cum[i0 + r0 + g + 8 * half] - s_cum[j0 + TILE - 1]) * LOG2E);
  uint32_t wt[TW][4][4];
  // two branch-free copies of the loop, one per kind of tile
  auto build = [&](auto weight) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float w2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) w2[e] = weight(sacc[nt][2 * half + e], nt * 8 + 2 * t + e, half);
        uint32_t terms[TW];
        split<TW>(w2[0], w2[1], terms);
#pragma unroll
        for (int k = 0; k < TW; ++k) wt[k][nt >> 1][(nt & 1) * 2 + half] = terms[k];
      }
    }
  };
  if (diag) {
    const float ci[2] = {s_cum[i0 + r0 + g], s_cum[i0 + r0 + g + 8]};
    build([&](float sv, int jl, int half) {
      const int j = j0 + jl;
      // above the diagonal the exponent may overflow: the select drops it
      const float w = sv * exp2f((ci[half] - s_cum[j]) * LOG2E) * s_dt[j];
      return j <= i0 + r0 + g + 8 * half ? w : 0.f;
    });
  } else {
    build([&](float sv, int jl, int half) { return sv * e_row[half] * s_g[j0 + jl]; });
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (2 * ks >= nt_end) continue;
    uint32_t xb[4][TI][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int row = ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), col = np * 16 + 8 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < TI; ++j) ldsm_x4_t(xb[np][j], s_x + j * XS + row * LDP + col);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int i = 0; i < TW; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j)
          if (kept(i, j)) {
            mma(yacc[2 * np], wt[i][ks], xb[np][j][0], xb[np][j][1]);
            mma(yacc[2 * np + 1], wt[i][ks], xb[np][j][2], xb[np][j][3]);
          }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ b,
           const T* __restrict__ c, const float* __restrict__ a, const float* __restrict__ d_skip,
           T* __restrict__ y, float* __restrict__ state, float* __restrict__ cum, Shapes s) {
  constexpr int TI = Terms<T>::IN, TW = Terms<T>::W;
  constexpr int CS = TILE * LDN, XS = TILE * LDP;  // elements between terms
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dt = reinterpret_cast<float*>(smem);
  float* s_cum = s_dt + MAXQ;
  float* s_g = s_cum + MAXQ;                       // exp(cum_m - cum_j) * dt_j (y blocks)
  float* s_tot = s_g + MAXQ;                       // 4 warp totals (+ pad)
  bf16* s_c = reinterpret_cast<bf16*>(s_tot + 8);  // TI terms of 64 x LDN
  bf16* s_b[2] = {s_c + TI * CS, s_c + 2 * TI * CS};               // 2 x TI terms of 64 x LDN
  bf16* s_x[2] = {s_c + 3 * TI * CS, s_c + 3 * TI * CS + TI * XS};  // 2 x TI terms of 64 x LDP

  const int Q = s.Q, P = s.P, N = s.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // block -> role: first the state blocks, then the y blocks by
  // decreasing row tile (the most j tiles to walk first)
  const int per_state = s.n_n * s.n_p;
  const long long n_state = (long long)s.BC * s.H * per_state;
  long long blk = blockIdx.x;
  const bool is_state = blk < n_state;
  int bc, h, tile, p0;
  if (is_state) {
    const int head = (int)(blk / per_state), rem = (int)(blk % per_state);
    bc = head / s.H; h = head % s.H;
    tile = rem / s.n_p; p0 = (rem % s.n_p) * TILE;
  } else {
    blk -= n_state;
    const long long per_level = (long long)s.BC * s.H * s.n_p;
    tile = s.n_i - 1 - (int)(blk / per_level);
    const int rem = (int)(blk % per_level);
    const int head = rem / s.n_p;
    bc = head / s.H; h = head % s.H;
    p0 = (rem % s.n_p) * TILE;
  }
  const int grp = h / (s.H / s.G);
  const size_t bh = (size_t)bc * s.H + h;
  const T* xh = x + bh * Q * P;
  const T* bg = b + ((size_t)bc * s.G + grp) * Q * N;
  const T* cg = c + ((size_t)bc * s.G + grp) * Q * N;
  const bool vec_x = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_bc = N % 8 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  const int pc = min(TILE, P - p0);  // columns of x in this P tile

  chunk_scan(dt + bh * Q, a[h], Q, s_dt, s_cum, s_tot);

  if (is_state) {
    // ------------------------------------------------------------------
    // state[n, p] = sum_q B[q, n] (w_q x[q, p]), w_q = exp(total - cum_q) * dt_q:
    // the weight scales x's B fragments in registers, which then go to
    // the tensor cores as TW bf16 terms
    const int n0 = tile * STATE_N, nc = min(STATE_N, N - n0), width_n = (nc + 15) / 16 * 16;
    const float total = s_cum[Q - 1];
    float* s_w = s_dt;  // each row's weight, in place of dt
    for (int q = threadIdx.x; q < MAXQ; q += THREADS)
      s_w[q] = q < Q ? exp2f((total - s_cum[q]) * LOG2E) * s_dt[q] : 0.f;
    const int steps = (Q + TILE - 1) / TILE;
    stage<T, TI>(bg + n0, N, Q, nc, width_n, s_b[0], LDN, CS, vec_bc);
    stage<T, TI>(xh + p0, P, Q, pc, TILE, s_x[0], LDP, XS, vec_x);
    float acc[8][4] = {};
    const int m0 = warp * 16;  // this warp's rows of the state tile
    for (int st = 0; st < steps; ++st) {
      const int q0 = st * TILE, buf = st & 1;
      cp_async_wait_all();
      __syncthreads();
      if (st + 1 < steps) {  // the next q step, into the other buffers
        stage<T, TI>(bg + (size_t)(q0 + TILE) * N + n0, N, Q - q0 - TILE, nc, width_n,
                     s_b[buf ^ 1], LDN, CS, vec_bc);
        stage<T, TI>(xh + (size_t)(q0 + TILE) * P + p0, P, Q - q0 - TILE, pc, TILE,
                     s_x[buf ^ 1], LDP, XS, vec_x);
      }
      const int ksteps = (min(TILE, Q - q0) + 15) / 16;
      for (int ks = 0; ks < ksteps && m0 < width_n; ++ks) {
        // A = B^T (M = n, K = q) from the [q][n] tile
        uint32_t ab[TI][4];
        {
          const int row = ks * 16 + (lane & 7) + 8 * (lane >> 4), col = m0 + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int i = 0; i < TI; ++i) ldsm_x4_t(ab[i], s_b[buf] + i * CS + row * LDN + col);
        }
        // this lane's q rows of x's B fragments: 2t, 2t+1 (regs 0, 2), 2t+8, 2t+9 (regs 1, 3)
        const float* wq = s_w + q0 + ks * 16 + 2 * t;
        const float w_lo0 = wq[0], w_lo1 = wq[1], w_hi0 = wq[8], w_hi1 = wq[9];
        uint32_t xr[4][TI][4];  // all of the step's x fragments first: loads in flight together
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int row = ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), col = np * 16 + 8 * (lane >> 4);
#pragma unroll
          for (int j = 0; j < TI; ++j) ldsm_x4_t(xr[np][j], s_x[buf] + j * XS + row * LDP + col);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t xw[TW][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float2 f = make_float2(0.f, 0.f);
#pragma unroll
            for (int j = TI - 1; j >= 0; --j) {  // smallest term first: the sum is exact
              const float2 fj = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[np][j][r]));
              f.x += fj.x;
              f.y += fj.y;
            }
            const bool hi = r & 1;
            uint32_t terms[TW];
            split<TW>(f.x * (hi ? w_hi0 : w_lo0), f.y * (hi ? w_hi1 : w_lo1), terms);
#pragma unroll
            for (int k = 0; k < TW; ++k) xw[k][r] = terms[k];
          }
#pragma unroll
          for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TW; ++j)
              if (kept(i, j)) {
                mma(acc[2 * np], ab[i], xw[j][0], xw[j][1]);
                mma(acc[2 * np + 1], ab[i], xw[j][2], xw[j][3]);
              }
        }
      }
    }
    float* sh = state + bh * N * P;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + m0 + g + 8 * (i >> 1), p = p0 + nt * 8 + 2 * t + (i & 1);
        if (n < n0 + nc && p < P) sh[(size_t)n * P + p] = acc[nt][i];
      }
    if (tile == 0 && p0 == 0)
      for (int q = threadIdx.x; q < Q; q += THREADS) cum[bh * Q + q] = s_cum[q];
    return;
  }

  // --------------------------------------------------------------------
  // y_i = sum_{j tiles <= i} (C_i.B_j^T * exp(cum_i - cum_j) * dt_j, j <= i).x_j + D.x_i
  const int i0 = tile * TILE;
  const int r0 = warp * 16;  // this warp's rows of the tile
  // the column factors of the tiles below the diagonal (read after the
  // first step's barrier)
  for (int j = threadIdx.x; j < i0; j += THREADS)
    s_g[j] = exp2f((s_cum[j | (TILE - 1)] - s_cum[j]) * LOG2E) * s_dt[j];
  float yacc[8][4] = {};
  if (N <= NCH) {
    // C_i stays; B_j and x_j of the next j tile are staged while this one is multiplied
    const int width = (N + 15) / 16 * 16;
    stage<T, TI>(cg + (size_t)i0 * N, N, Q - i0, N, width, s_c, LDN, CS, vec_bc);
    stage<T, TI>(bg, N, Q, N, width, s_b[0], LDN, CS, vec_bc);
    stage<T, TI>(xh + p0, P, Q, pc, TILE, s_x[0], LDP, XS, vec_x);
    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      const int buf = (j0 / TILE) & 1;
      cp_async_wait_all();
      __syncthreads();
      if (j0 < i0) {
        stage<T, TI>(bg + (size_t)(j0 + TILE) * N, N, Q - j0 - TILE, N, width, s_b[buf ^ 1], LDN,
                     CS, vec_bc);
        stage<T, TI>(xh + (size_t)(j0 + TILE) * P + p0, P, Q - j0 - TILE, pc, TILE, s_x[buf ^ 1],
                     LDP, XS, vec_x);
      }
      // column tiles of 8 this warp needs: on the diagonal, none right of its last row
      const int nt_end = j0 == i0 ? min(8, 2 * warp + 2) : 8;
      float sacc[8][4] = {};
      cb_product<TI>(sacc, s_c, s_b[buf], width, nt_end, r0, lane);
      wx_product<TI, TW>(yacc, sacc, s_x[buf], s_cum, s_dt, s_g, i0, j0, r0, nt_end, lane);
    }
  } else {
    // N in chunks of NCH: C_i and B_j staged chunk by chunk, no overlap
    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      const int nt_end = j0 == i0 ? min(8, 2 * warp + 2) : 8;
      float sacc[8][4] = {};
      for (int k0 = 0; k0 < N; k0 += NCH) {
        const int kc = min(NCH, N - k0), width = (kc + 15) / 16 * 16;
        __syncthreads();  // the tiles are free
        stage<T, TI>(cg + (size_t)i0 * N + k0, N, Q - i0, kc, width, s_c, LDN, CS, vec_bc);
        stage<T, TI>(bg + (size_t)j0 * N + k0, N, Q - j0, kc, width, s_b[0], LDN, CS, vec_bc);
        if (k0 == 0)
          stage<T, TI>(xh + (size_t)j0 * P + p0, P, Q - j0, pc, TILE, s_x[0], LDP, XS, vec_x);
        cp_async_wait_all();
        __syncthreads();
        cb_product<TI>(sacc, s_c, s_b[0], width, nt_end, r0, lane);
      }
      wx_product<TI, TW>(yacc, sacc, s_x[0], s_cum, s_dt, s_g, i0, j0, r0, nt_end, lane);
    }
  }

  // + D.x_i, x_i from the diagonal step's tile (its terms sum to x exactly)
  const bf16* xi = N <= NCH ? s_x[(i0 / TILE) & 1] : s_x[0];
  const float dsk = d_skip[h];
  T* yh = y + bh * Q * P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1), col = nt * 8 + 2 * t + (i & 1);
      float xv = 0.f;
#pragma unroll
      for (int k = TI - 1; k >= 0; --k) xv += __bfloat162float(xi[k * XS + r * LDP + col]);
      if (i0 + r < Q && p0 + col < P)
        yh[(size_t)(i0 + r) * P + p0 + col] = from_float<T>(yacc[nt][i] + xv * dsk);
    }
}

template <typename T>
int launch(const void* x, const void* dt, const void* b, const void* c, const void* a,
           const void* d_skip, void* y, void* state, void* cum, int BC, int H, int G, int Q,
           int P, int N, cudaStream_t st) {
  static bool smem_set = false;  // once per instantiation: above 48 KB needs the opt-in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Terms<T>::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  Shapes s{BC, H, G, Q, P, N, (Q + TILE - 1) / TILE, (P + TILE - 1) / TILE, (N + STATE_N - 1) / STATE_N};
  const long long blocks = (long long)BC * H * s.n_p * (s.n_n + s.n_i);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_kernel<T><<<(unsigned)blocks, THREADS, Terms<T>::SMEM, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a), static_cast<const float*>(d_skip),
      static_cast<T*>(y), static_cast<float*>(state), static_cast<float*>(cum), s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c, y); dt, a, d_skip, state
// and cum are float32.  x (BC,H,Q,P), dt (BC,H,Q), b and c (BC,G,Q,N),
// all contiguous.  Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_intra_chunk(int dtype, const void* x, const void* dt, const void* b,
                               const void* c, const void* a, const void* d_skip, void* y,
                               void* state, void* cum, int BC, int H, int G, int Q, int P, int N,
                               void* stream) {
  if (Q < 1 || Q > MAXQ || G < 1 || H % G || P < 1 || N < 1 || BC < 1 || BC > 65535 ||
      H > 65535 || (long long)BC * G > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, b, c, a, d_skip, y, state, cum, BC, H, G, Q, P, N, st);
  if (dtype == 1)
    return launch<bf16>(x, dt, b, c, a, d_skip, y, state, cum, BC, H, G, Q, P, N, st);
  return cudaErrorInvalidValue;
}
