// Flash attention (forward) for Hopper (sm_90a): tiled online-softmax
// attention, causal or not, GQA, with the query offset and per-row valid
// key count of chunked prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// _flash_kernel (its pallas_call is in flash_attention_bhsd).  Same
// function: fp32 scores of q and k, scaled; keys past the causal
// diagonal masked; softmax; a row with no valid key gives 0 (the NaN
// scrub); P.V; cast to q's dtype.  Unlike the TPU kernel, which assumes
// that the queries start at position 0 and that every key is valid, it
// keeps the contract of layers.attention: the causal diagonal is shifted
// by q_offset (query row i sits at position q_offset + i), and keys at or
// past kv_len (a scalar, or one count per batch row) are masked.  Edges
// are masked inside the kernel, so no length has to be a multiple of a
// tile.
//
// Bound on the H100, at the shapes of the port's prompt path (OLMo-1B: H
// = KV = 16, dh = 128, bf16):
//   * a 128-row prefill chunk over a 1024-row cache: bytes.  It reads
//     kv_len rows of K and V per head (8.4 MB at kv_len 1024) and does
//     ~1.1 GFLOP: ~2.8 us of memory against ~1.1 us of tensor cores.
//   * forward over S = 2048, causal: operations.  ~17 GFLOP (half the
//     score matrix) against ~34 MB: ~17 us against ~10 us.
//
// Design against that bound: one block per (64-row query tile, query
// head, batch row), 4 warps.  A loop inside the block takes the place of
// the TPU grid's sequential KV dimension: it walks 64-row K/V tiles in
// order, carrying the running max m, the sum l and the accumulator in
// fp32 registers, and stops at the last key any row of the tile can see
// (min(kv_len, q_offset + last row + 1) when causal, kv_len otherwise).
// Tiles past it are neither loaded nor computed (the TPU kernel still
// DMAs the blocks above the diagonal).  K/V tiles are double-buffered in
// shared memory with cp.async, so the next tile's copy overlaps this
// tile's products; rows past the bound are zero-filled by the copy, so a
// masked probability never meets a NaN of an invalid cache row.
//   bf16: both products run on the tensor cores with mma.sync m16n8k16
//   and fp32 accumulation; each warp owns 16 query rows.  Q.K^T takes q
//   unscaled (the scale multiplies the fp32 scores), P is rounded to bf16
//   for P.V, as the JAX package's attention_chunked rounds it (the TPU
//   kernel keeps it in fp32): the output is within 2e-2 of the fp32
//   plain version (JAX's own bf16 tolerance for its flash kernel).  The softmax runs in base 2: one exp2f for each
//   probability instead of expf's longer sequence.  Shared-memory rows
//   are padded by 16 bytes, so the fragment loads (32-bit for K,
//   ldmatrix.trans for V) are free of bank conflicts.
//   fp32: CUDA-core FMAs, q scaled in fp32 before the product as the
//   plain version does; two threads per query row.
// Causal tiles are issued longest first.  A prefill chunk gives only
// (Sq / 64) * H blocks (32 for OLMo-1B's 128-row chunk), fewer than the
// 132 SMs: splitting the keys over blocks, wgmma, TMA and warp
// specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // 4 warps
static_assert(BQ == BK, "load_tile copies BK rows, for the Q tile as for K and V");

struct Params {
  const void* q;  // (B, Sq, H, dh) or (B, H, Sq, dh): strides below
  const void* k;  // (B, Sk, KV, dh) or (B, KV, Sk, dh)
  const void* v;  // as k
  void* out;      // as q
  const int* kv_len;  // (B,) or null: then kv_len_scalar for every row
  int kv_len_scalar;
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;  // strides of q and out, in elements: batch, row, head
  long long k_sb, k_ss, k_sh;  // strides of k and v
  int causal, q_offset;
  float scale;
};

// The block's query tile and the keys its rows can see.
struct Tile {
  int q0, rows, b, h, kvh;
  int klen;  // valid keys of this batch row: min(max(kv_len, 0), Sk)
  int hi;    // keys [0, hi) are valid for some row of the tile
};

__device__ __forceinline__ Tile block_tile(const Params& p) {
  Tile t;
  t.q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // causal: the longest tiles first
  t.rows = min(BQ, p.Sq - t.q0);
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  t.kvh = t.h / (p.H / p.KV);  // the JAX package's (KV, G) grouping of H
  const int n = p.kv_len ? p.kv_len[t.b] : p.kv_len_scalar;
  t.klen = min(max(n, 0), p.Sk);
  t.hi = p.causal ? min(t.klen, max(p.q_offset + t.q0 + t.rows, 0)) : t.klen;
  return t;
}

__device__ __forceinline__ bool key_valid(const Params& p, const Tile& t, int key, int row) {
  return key < t.klen && (!p.causal || key <= p.q_offset + row);
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy BK rows of DH elements (global row stride `stride`) into shared
// memory rows of `ld` elements; rows >= `valid` are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int valid,
                                          int ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DH / VEC;
  for (int i = threadIdx.x; i < BK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16 x 8, fp32) += A (16 x 16, bf16, rows) * B (16 x 8, bf16, columns).
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane l gives the row address of
// matrix l / 8; register i receives matrix i in the B-fragment layout.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int DH>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (DH + 8) * sizeof(__nv_bfloat16);  // Q, 2 x K, 2 x V
}

// grid (ceil(Sq / 64), H, B); THREADS threads.  Warp w owns query rows
// 16w .. 16w + 15 of the tile; lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of it in the mma accumulator layout.
template <int DH>
__global__ void __launch_bounds__(THREADS) flash_bf16_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DH + 8;       // padded shared-memory row, in elements
  constexpr int KSTEPS = DH / 16;  // k-steps of Q.K^T over dh
  constexpr int NT_D = DH / 8;     // 8-column tiles of the output
  constexpr int NT_K = BK / 8;     // 8-column tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BQ * LD;      // two buffers
  bf16* v_s = k_s + 2 * BK * LD;  // two buffers

  const Tile t = block_tile(p);
  const bf16* qp = static_cast<const bf16*>(p.q) + t.b * p.q_sb + t.q0 * p.q_ss + t.h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + t.b * p.k_sb + t.kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + t.b * p.k_sb + t.kvh * p.k_sh;
  const int ntiles = (t.hi + BK - 1) / BK;

  load_tile<bf16, DH>(q_s, qp, p.q_ss, t.rows, LD);
  cp_async_commit();
  if (ntiles > 0) {
    load_tile<bf16, DH>(k_s, kp, p.k_ss, min(BK, t.hi), LD);
    load_tile<bf16, DH>(v_s, vp, p.k_ss, min(BK, t.hi), LD);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  uint32_t qf[KSTEPS][4];
  {
    const bf16* r0 = q_s + (warp * 16 + g) * LD + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qf[ks][0] = lds32(r0 + ks * 16);
      qf[ks][1] = lds32(r0 + 8 * LD + ks * 16);
      qf[ks][2] = lds32(r0 + ks * 16 + 8);
      qf[ks][3] = lds32(r0 + 8 * LD + ks * 16 + 8);
    }
  }
  const int row[2] = {t.q0 + warp * 16 + g, t.q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * 1.4426950408889634f;  // log2(e)
  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1, k0 = (j + 1) * BK;
      load_tile<bf16, DH>(k_s + nb * BK * LD, kp + k0 * p.k_ss, p.k_ss, min(BK, t.hi - k0), LD);
      load_tile<bf16, DH>(v_s + nb * BK * LD, vp + k0 * p.k_ss, p.k_ss, min(BK, t.hi - k0), LD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (j & 1) * BK * LD;
    const bf16* vt = v_s + (j & 1) * BK * LD;
    const int k0 = j * BK;

    // S = Q.K^T (16 x 64 per warp), fp32
    float s[NT_K][4];
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
        const bf16* kr = kt + (nt * 8 + g) * LD + ks * 16 + 2 * tq;
        mma_bf16_16816(s[nt], qf[ks], lds32(kr), lds32(kr + 8));
      }
    }

    // scale, mask, online softmax (rows g and g + 8; a row's 4 lanes
    // share its max through shuffles), in base 2: m and the scores carry a
    // factor log2(e), so that each exponential is one exp2f
    const bool edge = k0 + BK > t.klen || (p.causal && k0 + BK - 1 > p.q_offset + t.q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        float x = s[nt][e] * scale_log2;
        if (edge && !key_valid(p, t, key, row[e >> 1])) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      msafe[r] = mn == -INFINITY ? 0.f : mn;  // no valid key yet
      alpha[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - msafe[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - msafe[e >> 1]);  // masked: exp2(-inf) = 0
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < NT_D; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += P.V: P (bf16) from the score registers as the A fragment,
    // V through ldmatrix.trans as the B fragment
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const bf16* vrow = vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + dn * 16);
        mma_bf16_16816(acc[2 * dn], a, b[0], b[1]);
        mma_bf16_16816(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites the other buffer
  }

  // out = acc / l; 0 where a row saw no valid key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* op = static_cast<bf16*>(p.out) + t.b * p.q_sb + t.h * p.q_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    bf16* orow = op + row[r] * p.q_ss + 2 * tq;
#pragma unroll
    for (int i = 0; i < NT_D; ++i) {
      const float lo = l[r] > 0.f ? acc[i][2 * r] / l[r] : 0.f;
      const float hi = l[r] > 0.f ? acc[i][2 * r + 1] / l[r] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) = __floats2bfloat162_rn(lo, hi);
    }
  }
}

template <int DH>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (DH + 4) + (size_t)BQ * (BK + 1));
}

// grid (ceil(Sq / 64), H, B); THREADS threads.  Thread 2r + half owns
// query row r of the tile: the scores of keys 2i + half and output
// columns [half * DH/2, (half + 1) * DH/2).
template <int DH>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(const Params p) {
  constexpr int LD = DH + 4;  // padded rows: conflict-free float4 reads of Q
  constexpr int LDP = BK + 1;
  constexpr int HALF = DH / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* p_s = v_s + BK * LD;

  const Tile t = block_tile(p);
  const float* qp = static_cast<const float*>(p.q) + t.b * p.q_sb + t.q0 * p.q_ss + t.h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + t.b * p.k_sb + t.kvh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + t.b * p.k_sb + t.kvh * p.k_sh;
  const int ntiles = (t.hi + BK - 1) / BK;

  // q * scale in fp32, as the plain version; rows past Sq are 0
  for (int i = threadIdx.x; i < BQ * (DH / 4); i += THREADS) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < t.rows) x = *reinterpret_cast<const float4*>(qp + r * p.q_ss + c);
    *reinterpret_cast<float4*>(q_s + r * LD + c) =
        make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
  }

  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qrow = t.q0 + r;
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is read (and q_s written)
    load_tile<float, DH>(k_s, kp + k0 * p.k_ss, p.k_ss, min(BK, t.hi - k0), LD);
    load_tile<float, DH>(v_s, vp + k0 * p.k_ss, p.k_ss, min(BK, t.hi - k0), LD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * LD + d);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + (2 * i + half) * LD + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (!key_valid(p, t, k0 + 2 * i + half, qrow)) s[i] = -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float msafe = mn == -INFINITY ? 0.f : mn;
    const float alpha = m == -INFINITY ? 0.f : expf(m - msafe);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pe = expf(s[i] - msafe);
      p_s[r * LDP + 2 * i + half] = pe;
      sum += pe;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
    __syncthreads();  // both halves of the row's probabilities are in p_s
    for (int c = 0; c < BK; ++c) {
      const float pc = p_s[r * LDP + c];
      const float* vr = v_s + c * LD + half * HALF;
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] += pc * vv.x;
        acc[d + 1] += pc * vv.y;
        acc[d + 2] += pc * vv.z;
        acc[d + 3] += pc * vv.w;
      }
    }
  }

  if (qrow < p.Sq) {
    float* orow = static_cast<float*>(p.out) + t.b * p.q_sb + qrow * p.q_ss + t.h * p.q_sh +
                  half * HALF;
#pragma unroll
    for (int d = 0; d < HALF; d += 4) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l > 0.f) o = make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
      *reinterpret_cast<float4*>(orow + d) = o;
    }
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, const Params& p, int B,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(int dtype, const Params& p, int B, cudaStream_t stream) {
  if (dtype == 1) return launch_kernel(flash_bf16_kernel<DH>, bf16_smem_bytes<DH>(), p, B, stream);
  return launch_kernel(flash_f32_kernel<DH>, f32_smem_bytes<DH>(), p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out share the strides q_s*
// (batch, row, head; in elements, the last dimension contiguous); k and v
// share k_s*.  kv_len is a (B,) int32 device array, or null to use
// kv_len_scalar for every batch row.  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                               const void* kv_len, int kv_len_scalar, int B, int Sq, int Sk,
                               int H, int KV, int dh, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                               int causal, int q_offset, float scale, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Params p{q,    k,    v,    out,  static_cast<const int*>(kv_len), kv_len_scalar,
                 Sq,   Sk,   H,    KV,   q_sb, q_ss,
                 q_sh, k_sb, k_ss, k_sh, causal, q_offset,
                 scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(dtype, p, B, st);
    case 64: return launch<64>(dtype, p, B, st);
    case 128: return launch<128>(dtype, p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
