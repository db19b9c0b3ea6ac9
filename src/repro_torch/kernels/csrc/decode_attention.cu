// Fused decode attention for Hopper (sm_90a): the new K/V row is
// substituted into the cache page on chip and one query row per head is
// read against it.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// _decode_attention_kernel (its pallas_call is in decode_attention_pallas).
// Same function: for each batch row, K/V = cache page with row `pos`
// replaced by the new row; fp32 scores q.k, scaled after the dot; rows
// s >= kv_len masked; softmax; a row with no valid key gives 0 (the NaN
// scrub); fp32-accurate P.V; cast to q's dtype.  The caller writes the
// new row into the cache afterwards.
//
// Bound on the H100: bytes.  One decode step reads kv_len rows of K and
// V per (batch row, KV head) and does 4*g flops per element read (g =
// query heads per KV head), far below the ~295 flop/byte the card needs
// to be compute bound; the least time is the valid K/V bytes over
// 3.35 TB/s (8.9 us for OLMo-1B's step at B=8 with 3643 valid rows).
//
// Design against that bound (flash decoding, one launch): the Pallas
// kernel holds the whole (S, KV, dh) page in VMEM, which fits no SM, so
// the S axis is split.  One block per (split of the S axis, KV head,
// batch row); the split's rows come from decode_split in ops.py, which
// sizes the grid from B * KV, S and the SM count.  A split that starts at
// or past kv_len exits before it loads anything.
//   * One producer warp, one elected lane, streams the split's 64-row K
//     and V tiles into a ring of 2-4 shared-memory stages with TMA
//     (cp.async.bulk.tensor on a 4-d map of the cache, 128-byte swizzle)
//     completed on mbarriers, so the next tiles are in flight while four
//     consumer warps compute on this one.
//   * The new row never touches the TMA buffers: the consumers stage
//     k_new / v_new in shared memory while the first tiles fly, and the
//     lane whose fragment row is pos takes its ldmatrix address there (a
//     select, no branch in the product chain).  Rows past kv_len are
//     masked in registers (the scores to -inf, the V fragment to 0), so a
//     poisoned cache row cannot reach the output.
//   * bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation); warp w takes keys [16w, 16w + 16) of every tile.
//     Scores: the block's g query heads are the 16 rows of A (g <= 16,
//     rows past g zero), K from shared memory through ldmatrix; scaled
//     after the product, online softmax in base 2.  P.V: P is split into
//     bf16 hi + lo terms (two products), so P keeps ~16 more bits, as the
//     TPU kernel's fp32 P.V does; V through ldmatrix.trans.
//   * fp32: the same grid and ring, CUDA-core FMAs (lanes split a key's
//     dot over dh, then own output columns for P.V).
//   * The four warps' (m, l, acc) meet in shared memory.  A row whose
//     keys fit one split writes its output there; otherwise each split
//     writes fp32 partials and the last split of a (row, KV head) to
//     finish, found by an atomic ticket, merges them (one weighted sum an
//     output element, the weights exp(m_s - M) / L computed once a head)
//     in the same launch and resets the ticket to 0, so a CUDA-graph
//     replay finds it zeroed.  The tickets are one int32 per (row, KV
//     head) in kernels.merge_tickets, a per-device buffer allocated once:
//     two calls running at once on two streams would share them (nothing
//     in the port does that).
// Earlier designs at OLMo-1B's shape (H100 SXM, 700 W): one block per
// (row, KV head) streaming its tiles in sequence, 272 us; one block per
// (64-row tile, KV head, row) loading its tile with cp.async and waiting
// for all of it, scores on the CUDA cores, and a second merge launch,
// 26.4 us.  Tried for this design and dropped, both slower than the
// parent at OLMo-1B's step: a persistent grid taking (split, head, row)
// items from an atomic counter (each block paid every item's counter,
// query and ticket latencies in turn); the new row patched into the
// fragments from global memory behind a branch in the ldmatrix/mma chain.
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::smem_u32;

constexpr int TILE = 64;              // cache rows a stage
constexpr int MAX_G = 16;             // query heads per KV head: the mma's M
constexpr int NCONS = 4;              // consumer warps; warp NCONS is the producer
constexpr int THREADS = (NCONS + 1) * 32;
constexpr int WARP_KEYS = TILE / NCONS;  // keys of a tile each consumer warp takes
constexpr int MAX_STAGES = 4;
constexpr int HEAD_BYTES = 1024;      // the barriers and the ticket, ahead of the ring
constexpr size_t STAGE_BUDGET = 72 * 1024;  // the ring aims at three blocks an SM

struct Params {
  const void* q;      // (B, H, dh)
  const void* k_new;  // (B, KV, dh)
  const void* v_new;
  const int* pos;     // (B,)
  const int* kv_len;  // (B,)
  void* out;          // (B, H, dh)
  float* part;        // partials: (B, H, nsplit, 2) (m, l), then (B, H, nsplit, dh) acc
  int* tickets;       // (B, KV) merge counters, zero between launches
  int B, S, H, KV, g, split_rows, nsplit, stages, red_floats;
  float scale;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
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

// Four 8x8 bf16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8; register i receives matrix i (trans: transposed).
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo to ~16 more bits than bf16: both halves of a fragment pair.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

template <bool BASE2>
__device__ __forceinline__ float ex(float x) {
  return BASE2 ? exp2f(x) : expf(x);
}

// The layout of one element type and head dim: a tile is NB boxes of
// TILE rows x BOXB bytes each (one per BOXB bytes of dh), K then V.
template <typename T, int DH>
struct Layout {
  static constexpr int E = sizeof(T);
  static constexpr int BOXB = DH * E >= 128 ? 128 : DH * E;
  static constexpr int NB = DH * E / BOXB;
  static constexpr int CPB = BOXB / 16;      // 16-byte chunks a box row
  static constexpr int BOX = TILE * BOXB;    // bytes a box
  static constexpr int HALF = NB * BOX;      // K (or V) of a stage
  static constexpr int STAGE = 2 * HALF;
  // Byte offset in a K or V tile of 16-byte chunk c (along dh) of row r.
  __device__ __forceinline__ static uint32_t chunk(int r, int c) {
    return (c / CPB) * BOX + hopper::swz<BOXB>(r * BOXB + (c % CPB) * 16);
  }
};

// A block's work: split sp of the S axis of (batch row b, KV head kvh).
struct Item {
  int b, kvh, sp, n, nvalid, ntiles;
};

__device__ __forceinline__ Item block_item(const Params& p) {
  Item it;
  it.sp = blockIdx.x;
  it.kvh = blockIdx.y;
  it.b = blockIdx.z;
  it.n = min(max(p.kv_len[it.b], 0), p.S);
  it.nvalid = max(1, (it.n + p.split_rows - 1) / p.split_rows);
  const int s0 = it.sp * p.split_rows;
  it.ntiles = (max(min(it.n, s0 + p.split_rows) - s0, 0) + TILE - 1) / TILE;
  return it;
}

// grid (nsplit, KV, B); THREADS threads.  G: the per-head register arrays
// of the fp32 path (a power of two >= g); the bf16 path always holds 16
// rows.  p.tickets[b * KV + kvh] counts the finished splits of a (row, KV
// head) and is 0 again when its merge is done.
template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const Params p) {
  using L = Layout<T, DH>;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  const Item it = block_item(p);
  if (it.sp >= it.nvalid) return;  // past kv_len: nothing to load or merge
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = p.g;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  int* ticket_s = reinterpret_cast<int*>(empty + MAX_STAGES);
  unsigned char* ring = smem + HEAD_BYTES;
  float* red = reinterpret_cast<float*>(ring + (size_t)p.stages * L::STAGE);  // p.red_floats
  float* red_ml = red + p.red_floats;  // (NCONS, MAX_G, 2)
  T* new_k = reinterpret_cast<T*>(red_ml + NCONS * MAX_G * 2);  // the new K and V rows
  T* new_v = new_k + DH;
  float* q_s = reinterpret_cast<float*>(new_v + DH);  // fp32: the block's g query rows

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, NCONS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int s0 = it.sp * p.split_rows, pos = p.pos[it.b];
  if (warp == NCONS) {  // producer: one lane streams the split's tiles into the ring
    if (lane == 0) {
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      for (int t = 0; t < it.ntiles; ++t) {
        const int slot = t % p.stages;
        if (t >= p.stages) hopper::mbar_wait(empty + slot, ((t / p.stages) - 1) & 1);
        hopper::mbar_expect_tx(full + slot, L::STAGE);
        unsigned char* st = ring + (size_t)slot * L::STAGE;
        for (int bx = 0; bx < L::NB; ++bx) {
          hopper::tma_load_4d(st + bx * L::BOX, &kmap, full + slot, bx * L::BOXB / L::E, it.kvh,
                              s0 + t * TILE, it.b);
          hopper::tma_load_4d(st + L::HALF + bx * L::BOX, &vmap, full + slot,
                              bx * L::BOXB / L::E, it.kvh, s0 + t * TILE, it.b);
        }
      }
    }
    return;
  }

  // Consumers.  The softmax runs in base 2 on the bf16 path (m carries a
  // factor log2(e)) and in base e on the fp32 path; ex<BF16> undoes either.
  const int gq = lane >> 2, tq = lane & 3;
  const size_t row = (size_t)it.b * p.KV + it.kvh;
  const size_t head0 = (size_t)it.b * p.H + (size_t)it.kvh * g;  // the JAX package's (KV, G) grouping
  const T* qb = static_cast<const T*>(p.q) + head0 * DH;
  // the new rows (and fp32 q) into shared memory while the first tiles
  // fly: a lane whose fragment row is pos reads them there
  for (int i = tid; i < DH; i += NCONS * 32) {
    new_k[i] = static_cast<const T*>(p.k_new)[row * DH + i];
    new_v[i] = static_cast<const T*>(p.v_new)[row * DH + i];
  }
  if constexpr (!BF16)
    for (int i = tid; i < g * DH; i += NCONS * 32) q_s[i] = qb[i];
  uint32_t qf[BF16 ? DH / 16 : 1][4];
  if constexpr (BF16) {
    const bf16* qlo = reinterpret_cast<const bf16*>(qb) + gq * DH + 2 * tq;
    const bf16* qhi = qlo + 8 * DH;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      auto ld = [&](const bf16* r, bool ok, int off) {
        return ok ? __ldg(reinterpret_cast<const unsigned int*>(r + ks * 16 + off)) : 0u;
      };
      qf[ks][0] = ld(qlo, gq < g, 0);
      qf[ks][1] = ld(qhi, gq + 8 < g, 0);
      qf[ks][2] = ld(qlo, gq < g, 8);
      qf[ks][3] = ld(qhi, gq + 8 < g, 8);
    }
  }
  float acc[BF16 ? DH / 8 : G][BF16 ? 4 : DH / 32];
  float m[BF16 ? 2 : G], l[BF16 ? 2 : G];
#pragma unroll
  for (int i = 0; i < (BF16 ? 2 : G); ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (BF16 ? DH / 8 : G); ++i)
#pragma unroll
    for (int e = 0; e < (BF16 ? 4 : DH / 32); ++e) acc[i][e] = 0.f;

  hopper::bar_sync(NCONS * 32);

  for (int t = 0; t < it.ntiles; ++t) {
    const int slot = t % p.stages;
    hopper::mbar_wait(full + slot, (t / p.stages) & 1);
    // keys [tile0, tile0 + 64), this warp's 16 of them
    const int tile0 = s0 + t * TILE, key0 = tile0 + WARP_KEYS * warp;
    const bool edge = key0 + WARP_KEYS > it.n;
    if constexpr (BF16) {
      const float scale = p.scale * 1.4426950408889634f;  // log2(e)
      const uint32_t kt = smem_u32(ring + (size_t)slot * L::STAGE), vt = kt + L::HALF;
      // ldmatrix rows: K as (key, dh chunk) for the scores' B fragments;
      // V transposed for P.V's
      const int rk = WARP_KEYS * warp + (lane >> 4) * 8 + (lane & 7);
      const int rv = WARP_KEYS * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
      const uint32_t nk = smem_u32(new_k), nv = smem_u32(new_v);
      const bool fresh_k = tile0 + rk == pos, fresh_v = tile0 + rv == pos;
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        const int c = 2 * ks + ((lane >> 3) & 1);
        uint32_t kb[4];
        ldmatrix_x4(kb, fresh_k ? nk + c * 16 : kt + L::chunk(rk, c));
        mma_bf16_16816(s[0], qf[ks], kb[0], kb[1]);
        mma_bf16_16816(s[1], qf[ks], kb[2], kb[3]);
      }

      // scale, mask keys >= n, online softmax (rows gq and gq + 8; a
      // row's four lanes share its max through shuffles)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if (edge && key0 + nt * 8 + 2 * tq + (e & 1) >= it.n) x = -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], msafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        msafe[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = exp2f(m[r] - msafe[r]);  // 0 while m is -inf
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[nt][e] - msafe[e >> 1]);
          s[nt][e] = pe;
          l[e >> 1] += pe;
        }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);

      // acc += P.V, P in two terms.  This lane's V fragments hold keys
      // key0 + 2tq (+1) in registers 0 and 2, key0 + 8 + 2tq (+1) in 1
      // and 3; keys past n are zeroed.
      uint32_t keep[2] = {0xffffffffu, 0xffffffffu};
      if (edge) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = key0 + 8 * h + 2 * tq;
          keep[h] = (k < it.n ? 0x0000ffffu : 0u) | (k + 1 < it.n ? 0xffff0000u : 0u);
        }
      }
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj) {
        const int c = 2 * jj + (lane >> 4);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, fresh_v ? nv + c * 16 : vt + L::chunk(rv, c));
        vb[0] &= keep[0];
        vb[2] &= keep[0];
        vb[1] &= keep[1];
        vb[3] &= keep[1];
        mma_bf16_16816(acc[2 * jj], ph, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * jj], pl, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * jj + 1], ph, vb[2], vb[3]);
        mma_bf16_16816(acc[2 * jj + 1], pl, vb[2], vb[3]);
      }
    } else {
      // fp32: lanes l and l + 16 take key 16 * warp + l % 16, each half
      // of dh
      const unsigned char* kt = ring + (size_t)slot * L::STAGE;
      const unsigned char* vt = kt + L::HALF;
      const int rk = WARP_KEYS * warp + (lane & 15), hf = lane >> 4;
      const bool fresh_k = tile0 + rk == pos;
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      float sc[G];
#pragma unroll
      for (int j = 0; j < G; ++j) sc[j] = 0.f;
#pragma unroll 4
      for (int c = hf * DH / 8; c < (hf + 1) * DH / 8; ++c) {
        const float4 k4 = fresh_k ? reinterpret_cast<const float4*>(new_k)[c]
                                  : *reinterpret_cast<const float4*>(kt + L::chunk(rk, c));
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < g) {
            const float4 qv = q4[j * DH / 4 + c];
            sc[j] += qv.x * k4.x + qv.y * k4.y + qv.z * k4.z + qv.w * k4.w;
          }
        }
      }
      const bool valid = tile0 + rk < it.n;
      float pk[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        pk[j] = 0.f;
        if (j >= g) continue;
        float x = sc[j] + __shfl_xor_sync(0xffffffffu, sc[j], 16);
        x = valid ? x * p.scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[j], mx);
        const float msafe = mn == -INFINITY ? 0.f : mn;
        const float alpha = expf(m[j] - msafe);
        const float pe = expf(x - msafe);
        float sum = pe;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[j] = l[j] * alpha + sum;
        m[j] = mn;
        pk[j] = pe;
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) acc[j][i] *= alpha;
      }
      // acc += P.V: lane owns columns lane + 32 i
      for (int k = 0; k < WARP_KEYS; ++k) {
        const int r = WARP_KEYS * warp + k;
        if (tile0 + r >= it.n) break;  // the same for every lane; keys past n add 0
        const bool fresh = tile0 + r == pos;
        float pv[G];
#pragma unroll
        for (int j = 0; j < G; ++j) pv[j] = __shfl_sync(0xffffffffu, pk[j], k);
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) {
          const int d = lane + 32 * i;
          const float v = fresh ? new_v[d]
                                : *reinterpret_cast<const float*>(
                                      vt + L::chunk(r, d / 4) + (d % 4) * 4);
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j < g) acc[j][i] += pv[j] * v;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + slot);
  }

  // The four warps' (m, l, acc) per head meet in shared memory; the
  // output when the row's keys fit one split, else this split's partial.
  if constexpr (BF16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
  hopper::bar_sync(NCONS * 32);
  if constexpr (BF16) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int head = gq + 8 * r;
      if (head >= g) continue;
      float* dst = red + ((size_t)warp * g + head) * DH + 2 * tq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
      if (tq == 0) {
        red_ml[(warp * MAX_G + head) * 2] = m[r];
        red_ml[(warp * MAX_G + head) * 2 + 1] = l[r];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= g) continue;
#pragma unroll
      for (int i = 0; i < DH / 32; ++i)
        red[((size_t)warp * g + j) * DH + lane + 32 * i] = acc[j][i];
      if (lane == 0) {
        red_ml[(warp * MAX_G + j) * 2] = m[j];
        red_ml[(warp * MAX_G + j) * 2 + 1] = l[j];
      }
    }
  }
  hopper::bar_sync(NCONS * 32);

  float* part_ml = p.part;
  float* part_acc = p.part + (size_t)p.B * p.H * p.nsplit * 2;
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < g * DH; i += NCONS * 32) {
    const int j = i / DH, d = i % DH;
    float mw[NCONS], big = -INFINITY;
#pragma unroll
    for (int w = 0; w < NCONS; ++w) {
      mw[w] = red_ml[(w * MAX_G + j) * 2];
      big = fmaxf(big, mw[w]);
    }
    const float msafe = big == -INFINITY ? 0.f : big;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NCONS; ++w) {
      const float f = ex<BF16>(mw[w] - msafe);
      lsum += red_ml[(w * MAX_G + j) * 2 + 1] * f;
      a += red[((size_t)w * g + j) * DH + d] * f;
    }
    if (it.nvalid == 1) {
      out[(head0 + j) * DH + d] = from_float<T>(lsum > 0.f ? a / lsum : 0.f);
    } else {
      const size_t at = (head0 + j) * p.nsplit + it.sp;
      part_acc[at * DH + d] = a;
      if (d == 0) {
        part_ml[at * 2] = big;
        part_ml[at * 2 + 1] = lsum;
      }
    }
  }
  if (it.nvalid == 1) return;

  // The last split of this (row, KV head) to finish merges every split's
  // partial and resets the ticket: first each head's weights exp(m_s -
  // M) / L, one warp a head and one lane a split, into shared memory,
  // then every output element as one weighted sum.
  __threadfence();
  hopper::bar_sync(NCONS * 32);
  if (tid == 0) *ticket_s = atomicAdd(p.tickets + row, 1);
  hopper::bar_sync(NCONS * 32);
  if (*ticket_s != it.nvalid - 1) return;
  __threadfence();
  const int nv = it.nvalid;
  float* wgt = red;  // (g, nvalid): red is read, and every warp passed a barrier since
  for (int j = warp; j < g; j += NCONS) {
    const size_t base = (head0 + j) * p.nsplit;
    float big = -INFINITY;
    for (int s2 = lane; s2 < nv; s2 += 32) big = fmaxf(big, __ldcg(part_ml + (base + s2) * 2));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));
    const float msafe = big == -INFINITY ? 0.f : big;
    float lsum = 0.f;
    for (int s2 = lane; s2 < nv; s2 += 32) {
      const float f = ex<BF16>(__ldcg(part_ml + (base + s2) * 2) - msafe);
      wgt[j * nv + s2] = f;
      lsum += __ldcg(part_ml + (base + s2) * 2 + 1) * f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    __syncwarp();
    for (int s2 = lane; s2 < nv; s2 += 32) wgt[j * nv + s2] *= inv;
  }
  hopper::bar_sync(NCONS * 32);
  for (int i = tid; i < g * DH; i += NCONS * 32) {
    const int j = i / DH, d = i % DH;
    const float* acc_j = part_acc + (head0 + j) * p.nsplit * DH + d;
    float a = 0.f;
#pragma unroll 4
    for (int s2 = 0; s2 < nv; ++s2) a += wgt[j * nv + s2] * __ldcg(acc_j + (size_t)s2 * DH);
    out[(head0 + j) * DH + d] = from_float<T>(a);
  }
  if (tid == 0) p.tickets[row] = 0;
}

// Shared memory after the ring: the four warps' per-head partial sums (or
// a merge's weights), their (m, l), the new K and V rows, fp32 q.
template <typename T, int DH>
size_t tail_bytes(int red_floats) {
  return 4 * ((size_t)red_floats + NCONS * MAX_G * 2) + 2 * DH * sizeof(T) +
         (std::is_same<T, float>::value ? (size_t)MAX_G * DH * 4 : 0);
}

template <typename T, int DH, int G>
cudaError_t launch_dh(const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
                      cudaStream_t stream) {
  using L = Layout<T, DH>;
  const size_t smem =
      1024 + HEAD_BYTES + (size_t)p.stages * L::STAGE + tail_bytes<T, DH>(p.red_floats);
  auto kernel = decode_attention_kernel<T, DH, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nsplit, p.KV, p.B), THREADS, smem, stream>>>(km, vm, p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const void* k_cache, const void* v_cache, Params p, cudaStream_t stream) {
  using L = Layout<T, DH>;
  // the caches (B, S, KV, dh) as 4-d maps {dh, KV, S, B}; a box is TILE
  // rows of one KV head and BOXB bytes of dh
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)p.KV, (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * L::E, (cuuint64_t)p.KV * DH * L::E,
                                 (cuuint64_t)p.S * p.KV * DH * L::E};
  const cuuint32_t box[4] = {(cuuint32_t)(L::BOXB / L::E), 1, TILE, 1};
  CUtensorMap km, vm;
  const bool is_bf16 = std::is_same<T, bf16>::value;
  cudaError_t err = hopper::make_map(&km, is_bf16, k_cache, dims, strides, box, L::BOXB);
  if (err == cudaSuccess) err = hopper::make_map(&vm, is_bf16, v_cache, dims, strides, box, L::BOXB);
  if (err != cudaSuccess) return err;
  // the partial sums of the four warps, or a merge's weights
  p.red_floats = std::max(NCONS * p.g * DH, p.g * p.nsplit);
  p.red_floats = (p.red_floats + 3) / 4 * 4;
  // ring stages: as many as fit STAGE_BUDGET, 1 to 4 (bf16 at dh 128: two
  // 32 KB stages; fp32: one 64 KB stage.  On an H100, three blocks an SM
  // measured faster than two blocks of three stages, or one of two.)
  const size_t fixed = 1024 + HEAD_BYTES + tail_bytes<T, DH>(p.red_floats);
  const int n = fixed < STAGE_BUDGET ? (int)((STAGE_BUDGET - fixed) / L::STAGE) : 0;
  p.stages = std::max(1, std::min(n, MAX_STAGES));
  if (fixed + (size_t)p.stages * L::STAGE > 227 * 1024) return cudaErrorInvalidValue;
  if (is_bf16 || p.g > 8) return launch_dh<T, DH, MAX_G>(km, vm, p, stream);
  if (p.g > 4) return launch_dh<T, DH, 8>(km, vm, p, stream);
  if (p.g > 2) return launch_dh<T, DH, 4>(km, vm, p, stream);
  if (p.g > 1) return launch_dh<T, DH, 2>(km, vm, p, stream);
  return launch_dh<T, DH, 1>(km, vm, p, stream);
}

template <typename T>
cudaError_t launch_t(const void* k_cache, const void* v_cache, const Params& p, int dh,
                     cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(k_cache, v_cache, p, stream);
    case 64: return launch<T, 64>(k_cache, v_cache, p, stream);
    case 128: return launch<T, 128>(k_cache, v_cache, p, stream);
    case 256: return launch<T, 256>(k_cache, v_cache, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  split_rows (a multiple of 64) rows
// of the S axis a block; scratch holds scratch_floats fp32 values, at
// least B * H * nsplit * (dh + 2) when nsplit = ceil(S / split_rows) > 1;
// tickets holds at least B * KV int32 counters, zero before the first call
// (every call leaves them zero).  Returns cudaGetLastError() after
// the launch (0 when it was accepted).
extern "C" int decode_attention(int dtype, const void* q, const void* k_new, const void* v_new,
                                const void* k_cache, const void* v_cache, const void* pos,
                                const void* kv_len, void* out, void* scratch,
                                long long scratch_floats, void* tickets, long long ticket_count,
                                int B, int S, int H, int KV, int dh, int split_rows, float scale,
                                void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAX_G || split_rows <= 0 ||
      split_rows % TILE != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int nsplit = (S + split_rows - 1) / split_rows;
  if (ticket_count < (long long)B * KV ||
      (nsplit > 1 && scratch_floats < (long long)B * H * nsplit * (dh + 2)))
    return cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k_new = k_new;
  p.v_new = v_new;
  p.pos = static_cast<const int*>(pos);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = out;
  p.part = static_cast<float*>(scratch);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.g = H / KV;
  p.split_rows = split_rows;
  p.nsplit = nsplit;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_t<bf16>(k_cache, v_cache, p, dh, st)
                    : launch_t<float>(k_cache, v_cache, p, dh, st);
}
