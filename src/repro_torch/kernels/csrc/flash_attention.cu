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
//   * a 128-row prefill chunk at q_offset 512 (kv_len 640): bytes.  It
//     reads the 640 visible rows of K and V per head once (6.3 MB) and
//     does 0.6 GFLOP: 1.9 us of memory against 0.6 us of tensor cores.
//   * forward over S = 2048, causal: operations.  17.2 GFLOP (half the
//     score matrix) against 34 MB: 17.4 us against 10 us.
//
// Design against that bound, bf16 (the prompt path): one block per
// (query tile, split of the key axis, query head, batch row), one or two
// consumer warpgroups of 64 query rows and one producer warp.
//   * Split-KV: a 128-row chunk has only 2 query tiles of 64 rows a head,
//     32 blocks for 132 SMs, so the keys the tile can see are split over
//     blocks; flash_split in ops.py picks the split, at most one block an
//     SM.  The causal bound and kv_len decide which splits hold a valid
//     key; the others exit at once.  Each split leaves fp32 (m, l,
//     unnormalised acc) partials, and the last split of a query tile to
//     finish, found by an atomic ticket, merges them in the same launch,
//     in split order (its own partial read back like the others, so the
//     output is the same whichever split finished last), and resets the
//     ticket to 0 (a CUDA-graph replay finds it zeroed).
//     The tickets are kernels.merge_tickets, a per-device int32 buffer
//     allocated once: two calls running at once on two streams would
//     share it.  A tile whose keys fit one split writes its output
//     directly.
//   * Two warpgroups where the 128-row query tiles alone fill the card
//     (forward over a long prompt): they hold 128 query rows and share
//     each K/V tile, which halves what the blocks read from L2 (the
//     forward pass is bound by that traffic: with 64-row blocks it ran as
//     fast without either product).  The grid puts the longest query
//     tiles of every head first.
//   * TMA: the producer warp's elected lane loads the Q tile(s) and
//     streams the split's 64-row K and V tiles into a ring of 2-4 stages
//     (cp.async.bulk.tensor on 4-d maps of q, k and v, 128-byte swizzle;
//     64-byte at dh 32) completed on mbarriers; rows past a tensor's end
//     arrive as zeros.
//   * wgmma: a warpgroup owns 64 query rows.  S = Q.K^T is wgmma
//     m64n64k16 with Q and K from shared memory (K-major, swizzled
//     descriptors); the scale multiplies the fp32 scores, the softmax runs
//     in base 2 in registers; P is rounded to bf16 (as the JAX package's
//     attention_chunked rounds it; within 2e-2 of the fp32 plain version)
//     and is the A operand of P.V from registers, wgmma m64n(dh)k16 with
//     V from shared memory read transposed.  Rows of V past the block's
//     last valid key are zeroed before P.V, so a poisoned cache row
//     cannot reach the output.
// fp32 (off the prompt path): CUDA-core FMAs, one block per (64-row query
// tile, head, batch row), q scaled in fp32 before the product as the
// plain version does, K/V tiles copied with cp.async; two threads per
// query row.
// The design before this one (H100 SXM, 700 W): one block per (64-row
// query tile, head, row), four warps on mma.sync, K/V double-buffered
// with cp.async: 28.1 us at the chunk shape, 157.6 us for forward at
// S = 2048.  Tried for this design and dropped, both slower than the
// tickets at the chunk: the splits of a query tile as one thread block
// cluster merging through distributed shared memory (clusters of four
// 146 KB blocks); the merge's partials staged into the ring by bulk
// copies.
#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // fp32: 4 warps
constexpr int MAX_STAGES = 4;
constexpr int HEAD_BYTES = 1024;     // barriers and the ticket, ahead of the tiles
constexpr size_t SMEM_BUDGET = 200 * 1024;  // one block an SM
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

// bf16: the query rows of a block (64 or 128: one or two consumer
// warpgroups), the key axis split over blocks (split_keys keys a split,
// nsplit splits), the splits' partials and merge tickets, ring stages,
// and which of the tensor maps' dimensions 1 and 2 is the row (the other
// is the head)
struct SplitParams : Params {
  int block_rows, split_keys, nsplit, stages, q_row_dim, k_row_dim;
  float* part;
  int* tickets;
};

// The block's query tile and the keys its rows can see.
struct Tile {
  int q0, rows, b, h, kvh;
  int klen;  // valid keys of this batch row: min(max(kv_len, 0), Sk)
  int hi;    // keys [0, hi) are valid for some row of the tile
};

// fp32: the block's query tile (causal: the longest tiles first).
__device__ __forceinline__ Tile block_tile(const Params& p) {
  Tile t;
  t.q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
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


// ---------------------------------------------------------------------------
// bf16: split-KV on wgmma, fed by TMA
// ---------------------------------------------------------------------------

using hopper::smem_u32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets, swizzle (1 = 128 bytes, 2 = 64 bytes).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) = A (64 x 16) * B (64 x 16)^T (+ D when acc), A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 32, fp32) += A (64 x 16, registers) * B (16 x 32, shared memory,
// N-major: transposed on the way in).
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared memory,
// N-major: transposed on the way in).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, shared memory,
// N-major: transposed on the way in).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t b) {
  if constexpr (DH == 32) wgmma_rs_m64n32k16(o, a, b);
  else if constexpr (DH == 64) wgmma_rs_m64n64k16(o, a, b);
  else wgmma_rs_m64n128k16(o, a, b);
}

// A Q, K or V tile: NB boxes of 64 rows x BOXB bytes (BOXB bytes of dh
// each), swizzled over BOXB bytes.
template <int DH>
struct Tiles {
  static constexpr int BOXB = DH * 2 >= 128 ? 128 : DH * 2;
  static constexpr int NB = DH * 2 / BOXB;
  static constexpr int BOX = BK * BOXB;
  static constexpr int TILE = NB * BOX;
  static constexpr int SWIZZLE = BOXB == 128 ? 1 : 2;  // the descriptors' code
};

// grid (H, (NWG * 64)-row query tiles * nsplit, B), the longest query
// tiles of every head first; NWG * 128 + 32 threads: NWG consumer
// warpgroups, then the producer warp.  Warpgroup wg holds query rows
// 64 wg .. 64 wg + 63 of the block's; warp w of it rows 16w .. 16w + 15 of
// those, lane (g = lane / 4, t = lane % 4) rows g and g + 8, columns 8i +
// 2t (+1) of every 8-column block i, in the wgmma accumulator layout.
// The warpgroups read every K/V tile of the ring.
template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const SplitParams p) {
  using L = Tiles<DH>;
  constexpr int BM = NWG * BQ;      // query rows of the block
  constexpr int CONS = NWG * 128;   // consumer threads
  const int qtiles = (p.Sq + BM - 1) / BM;
  const int rev = blockIdx.y / p.nsplit, sp = blockIdx.y % p.nsplit, qt = qtiles - 1 - rev;
  Tile t;
  t.q0 = qt * BM;
  t.rows = min(BM, p.Sq - t.q0);
  t.h = blockIdx.x;
  t.b = blockIdx.z;
  t.kvh = t.h / (p.H / p.KV);  // the JAX package's (KV, G) grouping of H
  t.klen = min(max(p.kv_len ? p.kv_len[t.b] : p.kv_len_scalar, 0), p.Sk);
  t.hi = p.causal ? min(t.klen, max(p.q_offset + t.q0 + t.rows, 0)) : t.klen;
  const int nvalid = max(1, (t.hi + p.split_keys - 1) / p.split_keys);
  if (sp >= nvalid) return;  // no valid key in this split: nothing to load or merge
  const int k_begin = sp * p.split_keys, k_end = min(t.hi, k_begin + p.split_keys);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* q_bar = empty + MAX_STAGES;
  int* ticket_s = reinterpret_cast<int*>(q_bar + 1);
  unsigned char* q_s = smem + HEAD_BYTES;   // NWG Q tiles
  unsigned char* ring = q_s + NWG * L::TILE;  // stages x (K tile, V tile)
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONS / 32);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONS / 32) {  // producer: one lane issues every copy
    if (lane == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      auto coords = [](int row_dim, int row, int head, int& c1, int& c2) {
        c1 = row_dim == 1 ? row : head;
        c2 = row_dim == 1 ? head : row;
      };
      int c1, c2;
      hopper::mbar_expect_tx(q_bar, NWG * L::TILE);  // rows past Sq arrive as zeros
      for (int w = 0; w < NWG; ++w) {
        coords(p.q_row_dim, t.q0 + w * BQ, t.h, c1, c2);
        for (int bx = 0; bx < L::NB; ++bx)
          hopper::tma_load_4d(q_s + w * L::TILE + bx * L::BOX, &qmap, q_bar, bx * L::BOXB / 2, c1,
                              c2, t.b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int slot = j % p.stages;
        if (j >= p.stages) hopper::mbar_wait(empty + slot, ((j / p.stages) - 1) & 1);
        hopper::mbar_expect_tx(full + slot, 2 * L::TILE);
        unsigned char* st = ring + (size_t)slot * 2 * L::TILE;
        coords(p.k_row_dim, k_begin + j * BK, t.kvh, c1, c2);
        for (int bx = 0; bx < L::NB; ++bx) {
          hopper::tma_load_4d(st + bx * L::BOX, &kmap, full + slot, bx * L::BOXB / 2, c1, c2, t.b);
          hopper::tma_load_4d(st + L::TILE + bx * L::BOX, &vmap, full + slot, bx * L::BOXB / 2, c1,
                              c2, t.b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, w = warp % 4, g = lane >> 2, tq = lane & 3;
  const int wq0 = t.q0 + wg * BQ;  // this warpgroup's first query row
  // the keys this warpgroup's rows can see: [0, whi); none for rows past Sq
  const int whi = wq0 >= p.Sq ? 0
                  : p.causal ? min(t.klen, max(p.q_offset + wq0 + min(BQ, p.Sq - wq0), 0))
                             : t.klen;
  const int row[2] = {wq0 + w * 16 + g, wq0 + w * 16 + g + 8};
  const float scale_log2 = p.scale * 1.4426950408889634f;  // log2(e)
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const uint32_t qa = smem_u32(q_s + wg * L::TILE);
  hopper::mbar_wait(q_bar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int slot = j % p.stages;
    hopper::mbar_wait(full + slot, (j / p.stages) & 1);
    unsigned char* kt = ring + (size_t)slot * 2 * L::TILE;
    unsigned char* vt = kt + L::TILE;
    const int k0 = k_begin + j * BK;
    const bool need = k0 < whi;  // the same for the whole warpgroup
    uint32_t pa[BK / 16][4];

    if (need) {
      // S = Q.K^T: 16 dh columns a step, 32 bytes into a box row
      float s[32] = {};
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const uint32_t off = (ks * 32 / L::BOXB) * L::BOX + (ks * 32) % L::BOXB;
        wgmma_ss_m64n64k16(s, gmma_desc(qa + off, 16, 8 * L::BOXB, L::SWIZZLE),
                           gmma_desc(smem_u32(kt) + off, 16, 8 * L::BOXB, L::SWIZZLE), ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs<32>(s);

      // scale, mask, online softmax in base 2 (a row's 4 lanes share its
      // max through shuffles)
      const bool edge = k0 + BK > t.klen || (p.causal && k0 + BK - 1 > p.q_offset + wq0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + 2 * tq + (e & 1);
          float x = s[4 * i + e] * scale_log2;
          if (edge && !key_valid(p, t, key, row[e >> 1])) x = -INFINITY;
          s[4 * i + e] = x;
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
        alpha[r] = exp2f(m[r] - msafe[r]);     // 0 while m is -inf
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[4 * i + e] - msafe[e >> 1]);  // masked: exp2(-inf) = 0
          s[4 * i + e] = pe;
          l[e >> 1] += pe;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }

    // V rows past the block's last valid key hold whatever the cache holds
    // there: zero them (a swizzle permutes 16-byte chunks inside a row, so
    // a row stays where it is), then order these writes before the
    // products' reads of shared memory
    const int keep = t.hi - k0;
    if (keep < BK) {
      constexpr int CHUNKS = L::NB * (L::BOXB / 16);  // 16-byte chunks a row
      for (int i = tid; i < (BK - keep) * CHUNKS; i += CONS) {
        const int r = keep + i / CHUNKS, c = i % CHUNKS;
        *reinterpret_cast<uint4*>(vt + (c / (L::BOXB / 16)) * L::BOX + r * L::BOXB +
                                  (c % (L::BOXB / 16)) * 16) = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      hopper::bar_sync(CONS);
    }

    if (need) {
      // O += P.V: 16 keys a step, V read transposed (N-major: the boxes of
      // dh are LBO apart, groups of 8 keys SBO apart)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DH>(o, pa[kk], gmma_desc(smem_u32(vt) + kk * 16 * L::BOXB, L::BOX,
                                          8 * L::BOXB, L::SWIZZLE));
      wgmma_commit();
      wgmma_wait0();
      fence_regs<DH / 2>(o);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + slot);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int lrow[2] = {row[0] - t.q0, row[1] - t.q0};  // rows of the block's 128
  if (nvalid > 1) {
    // this split's partial; then the last split to finish merges them:
    // first the rows' largest m, then one weighted sum
    const size_t tile_id = ((size_t)t.b * p.H + t.h) * qtiles + qt;
    const size_t nparts = (size_t)gridDim.z * p.H * qtiles * p.nsplit;
    float* part_ml = p.part;  // (parts, 128 rows, 2)
    float4* part_acc = reinterpret_cast<float4*>(p.part + nparts * 2 * BM);  // (parts, DH/8, CONS)
    const size_t mine = tile_id * p.nsplit + sp;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      part_acc[(mine * (DH / 8) + c) * CONS + tid] =
          make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part_ml[(mine * BM + lrow[r]) * 2] = m[r];
        part_ml[(mine * BM + lrow[r]) * 2 + 1] = l[r];
      }
    }
    __threadfence();
    hopper::bar_sync(CONS);
    if (tid == 0) *ticket_s = atomicAdd(p.tickets + tile_id, 1);
    hopper::bar_sync(CONS);
    if (*ticket_s != nvalid - 1) return;
    __threadfence();
    // Every split's partial, this one's read back too, summed in split
    // order: the output does not depend on which split finished last.
    const float* ml0 = part_ml + tile_id * p.nsplit * BM * 2;
    float big[2] = {-INFINITY, -INFINITY};
#pragma unroll 4
    for (int s2 = 0; s2 < nvalid; ++s2)
#pragma unroll
      for (int r = 0; r < 2; ++r) big[r] = fmaxf(big[r], __ldcg(ml0 + (s2 * BM + lrow[r]) * 2));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      big[r] = big[r] == -INFINITY ? 0.f : big[r];
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    for (int s2 = 0; s2 < nvalid; ++s2) {
      float wr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wr[r] = exp2f(__ldcg(ml0 + (s2 * BM + lrow[r]) * 2) - big[r]);
        l[r] += __ldcg(ml0 + (s2 * BM + lrow[r]) * 2 + 1) * wr[r];
      }
      const float4* other = part_acc + (tile_id * p.nsplit + s2) * (DH / 8) * CONS + tid;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const float4 a = __ldcg(other + c * CONS);
        o[4 * c] += a.x * wr[0];
        o[4 * c + 1] += a.y * wr[0];
        o[4 * c + 2] += a.z * wr[1];
        o[4 * c + 3] += a.w * wr[1];
      }
    }
    if (tid == 0) p.tickets[tile_id] = 0;
  }

  // out = o / l; 0 where a row saw no valid key
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out) + t.b * p.q_sb + t.h * p.q_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Sq) continue;
    __nv_bfloat16* orow = op + row[r] * p.q_ss + 2 * tq;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// A 4-d map of a (B, rows, heads, dh) or (B, heads, rows, dh) operand
// with strides (batch, row, head) in elements: dims {dh, X, Y, B} with X
// the smaller stride of the two; a box is 64 rows of one head.  Returns
// which of dims 1 and 2 is the row.
template <int DH>
cudaError_t make_operand_map(CUtensorMap* map, const void* ptr, int rows, int heads, int B,
                             long long sb, long long ss, long long sh, int* row_dim) {
  using L = Tiles<DH>;
  const bool row_first = ss <= sh;
  *row_dim = row_first ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)(row_first ? rows : heads),
                              (cuuint64_t)(row_first ? heads : rows), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(row_first ? ss : sh) * 2,
                                 (cuuint64_t)(row_first ? sh : ss) * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(L::BOXB / 2), (cuuint32_t)(row_first ? BK : 1),
                             (cuuint32_t)(row_first ? 1 : BK), 1};
  return hopper::make_map(map, true, ptr, dims, strides, box, L::BOXB);
}

template <int DH, int NWG>
cudaError_t launch_wgmma(SplitParams p, int B, cudaStream_t stream) {
  constexpr int BM = NWG * BQ;
  using L = Tiles<DH>;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_operand_map<DH>(&qm, p.q, p.Sq, p.H, B, p.q_sb, p.q_ss, p.q_sh, &p.q_row_dim);
  if (err == cudaSuccess)
    err = make_operand_map<DH>(&km, p.k, p.Sk, p.KV, B, p.k_sb, p.k_ss, p.k_sh, &p.k_row_dim);
  if (err == cudaSuccess)
    err = make_operand_map<DH>(&vm, p.v, p.Sk, p.KV, B, p.k_sb, p.k_ss, p.k_sh, &p.k_row_dim);
  if (err != cudaSuccess) return err;
  const size_t fixed = 1024 + HEAD_BYTES + NWG * L::TILE, stage = 2 * L::TILE;
  p.stages = (int)((SMEM_BUDGET - fixed) / stage);
  p.stages = p.stages < 2 ? 2 : p.stages > MAX_STAGES ? MAX_STAGES : p.stages;
  const size_t smem = fixed + p.stages * stage;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<DH, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<DH, NWG><<<dim3(p.H, (p.Sq + BM - 1) / BM * p.nsplit, B), NWG * 128 + 32,
                                smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(int dtype, const SplitParams& p, int B, cudaStream_t stream) {
  if (dtype == 1)
    return p.block_rows == 2 * BQ ? launch_wgmma<DH, 2>(p, B, stream)
                                  : launch_wgmma<DH, 1>(p, B, stream);
  const size_t smem = f32_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<DH><<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), THREADS, smem, stream>>>(
      static_cast<const Params&>(p));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and out share the strides q_s*
// (batch, row, head; in elements, the last dimension contiguous); k and v
// share k_s*.  kv_len is a (B,) int32 device array, or null to use
// kv_len_scalar for every batch row.  bf16 takes block_rows (64 or 128)
// query rows a block and splits the keys a query can see into nsplit
// ranges of split_keys keys (a multiple of 64) that must cover them; with
// nsplit > 1, scratch holds at least B * H * ceil(Sq / block_rows) *
// nsplit * block_rows * (dh + 2) floats and tickets at least B * H *
// ceil(Sq / block_rows) int32 counters, zero before the first call
// (every call leaves them zero).  fp32 takes no split.  Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                               const void* kv_len, int kv_len_scalar, int B, int Sq, int Sk,
                               int H, int KV, int dh, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                               int causal, int q_offset, float scale, int block_rows,
                               int split_keys, int nsplit,
                               void* scratch, long long scratch_floats, void* tickets,
                               long long ticket_count, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (dtype == 1) {
    long long span = causal ? std::min<long long>(std::max(q_offset + Sq, 0), Sk) : Sk;
    if (kv_len == nullptr) span = std::min<long long>(span, std::max(std::min(kv_len_scalar, Sk), 0));
    const long long parts = (long long)B * H * ((Sq + block_rows - 1) / block_rows);
    if ((block_rows != BQ && block_rows != 2 * BQ) || split_keys <= 0 || split_keys % BK != 0 ||
        nsplit < 1 || (long long)split_keys * nsplit < span ||
        (nsplit > 1 &&
         (scratch_floats < parts * nsplit * block_rows * (dh + 2) || ticket_count < parts)))
      return cudaErrorInvalidValue;
  }
  SplitParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_len_scalar = kv_len_scalar;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  p.block_rows = block_rows;
  p.split_keys = split_keys;
  p.nsplit = dtype == 1 ? nsplit : 1;
  p.part = static_cast<float*>(scratch);
  p.tickets = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(dtype, p, B, st);
    case 64: return launch<64>(dtype, p, B, st);
    case 128: return launch<128>(dtype, p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
