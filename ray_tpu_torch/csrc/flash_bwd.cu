// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: ray_tpu/ops/attention.py:_dq_kernel and :_dkv_kernel (the Pallas
// TPU kernels driven by _flash_backward, tied to the forward by
// _flash.defvjp).  Given q [B,H,Sq,D], k/v [B,Hkv,Sk,D], the forward's out
// and fp32 LSE [B,H,Sq] and dO [B,H,Sq,D], it recomputes
//   P  = exp(Q K^T * scale - LSE)        (causal mask shifted by q_offset)
//   dS = P * (dO V^T - delta) * scale,   delta = rowsum(dO * O) in fp32
// and writes dQ = dS K (dq kernel), dV = P^T dO and dK = dS^T Q (dk/dv
// kernel).  Query head h reads KV head h / (H/Hkv).
//
// What bounds it on the H100: operations.  Per causal (query, key) pair the
// dq kernel does three D-deep products (S, dP, dS K: 6*D flops) and the
// dk/dv kernel four (S, dP, P^T dO, dS^T Q: 8*D), against 2*D bytes of K/V
// or Q/dO that a whole tile shares, so above a few hundred keys the tensor
// cores (989 TFLOP/s bf16) are the limit, not the 3.35 TB/s of device memory.
//
// What the design does about it (bf16):
// - Every product is a warpgroup MMA (wgmma.mma_async, fp32 accumulate), the
//   only way to Hopper's full tensor-core rate.  Blocks of three warpgroups:
//   warpgroup 0 is the producer (setmaxnreg.dec 24; one warp issues TMA
//   loads from 3-D tensor maps {D, S, heads}, 128-byte swizzled and
//   zero-filled past S inside the head), warpgroups 1 and 2 are consumers
//   (setmaxnreg.inc 240), 64 rows each.  Streamed tiles pass through a ring
//   of stages with a "full" mbarrier (armed with its bytes) and an "empty"
//   one on which every consumer warp arrives once its products retired.
// - dq kernel: a block owns 128 query rows; Q and dO arrive once, K and V
//   stream in tiles of 64 keys.  S = Q K^T and dP = dO V^T are SS
//   m64n64k16 (A and B K-major); dS is formed in registers, packed to bf16
//   A fragments (the forward's register reuse) and dQ += dS K is RS
//   m64nDk16 with K read MN-major from the very tile that fed S.  Its
//   prologue reads O beside dO for its rows and computes delta in fp32,
//   uses it and writes it [B,H,Sq] for the dk/dv kernel, which runs after
//   it on the same stream: no separate reduction over O in device memory.
// - dk/dv kernel: a block owns 128 keys of one KV head (64 per consumer);
//   K and V arrive once, (Q, dO) tiles of 64 query rows stream with their
//   LSE and delta, which the producer warp's lanes stage beside them.
//   S^T = K Q^T and dP^T = V dO^T are SS m64n64k16; P^T and dS^T are formed
//   in registers with LSE and delta indexed by the accumulator's column and
//   packed to A fragments; dV += P^T dO and dK += dS^T Q are RS m64nDk16
//   with dO and Q read MN-major from the same swizzled tiles that fed the
//   SS products K-major.  No P or dS goes through shared memory.  GQA is
//   summed in the block (it loops over the group's query heads), so there
//   are no atomics and the result is deterministic.
// - Masks only on tiles that cross the shifted causal diagonal or the Sk
//   edge; a consumer skips a tile none of its rows can see.  Query rows
//   past Sq and rows whose forward had l == 0 (LSE = -inf) take LSE = +inf,
//   so their P is exactly 0 and no infinity enters the arithmetic.
// - Blocks in the order the forward uses: heads in groups whose streamed
//   operands fit 16 MB of L2, the heaviest causal tiles first (the last
//   query tiles for dq, the first key tiles for dk/dv).
// fp32: full-precision FMA on the CUDA cores (no TF32), so fp32 callers get
// the reference's numbers; delta is computed outside for them.

#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;  // [B*H, Sq], natural log
  float* delta;      // [B*H, Sq]: written by the bf16 dq kernel, else read
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk;
  float scale;
  int causal;
  int q_offset;
  // bf16 kernels only:
  float scale_log2;  // scale * log2(e)
  int heads;         // B * H (dq) or B * Hkv (dk/dv): the block order's heads
  int group;         // heads per group of the block order
};

// ---------------------------------------------------------------- bf16 path

constexpr int WG_THREADS = 128;
constexpr int THREADS_WG = 3 * WG_THREADS;
constexpr int HALF_ROW = 128;  // bytes of one 64-column half row
constexpr int DQ_ROWS = 128;   // dq: query rows per block, 64 per consumer
constexpr int DQ_KEYS = 64;    // dq: keys per K/V tile
constexpr int DKV_KEYS = 128;  // dk/dv: keys per block, 64 per consumer
constexpr int DKV_ROWS = 64;   // dk/dv: query rows per Q/dO tile
constexpr int STAGES = 4;

// A tile's width in shared memory: D, or 64 at D 32, whose TMA box keeps
// 64 columns with the 32 past the tensor's last column zero-filled by the
// copy engine (no bytes read for them).  The 128-byte swizzle, descriptors
// and fragment layouts of D 64 then serve D 32 unchanged: the D-deep
// products take D / 16 K-steps, and the products of N = D (dQ, dK, dV)
// run at N = 64 with zero upper columns, which are never stored.
template <int D>
constexpr int padded_width() { return D < 64 ? 64 : D; }

template <int D>
struct DqTiles {
  static constexpr int DP = padded_width<D>();
  static constexpr uint32_t Q_BYTES = DQ_ROWS * DP * 2;   // Q or dO
  static constexpr uint32_t KV_BYTES = DQ_KEYS * DP * 2;  // one K or V tile
  static constexpr uint32_t SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int D>
struct DkvTiles {
  static constexpr int DP = padded_width<D>();
  static constexpr uint32_t KV_BYTES = DKV_KEYS * DP * 2;  // K or V
  static constexpr uint32_t Q_BYTES = DKV_ROWS * DP * 2;   // one Q or dO tile
  static constexpr uint32_t SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * Q_BYTES;
};

using sm90::acc_col;
using sm90::acc_row;
using sm90::acc_to_a;
using sm90::ex2;

// Block L of the launch -> (head, tile rank): heads go in groups of
// p.group whose streamed operands fit in L2, and inside a group every
// head's tile of rank 0 (the heaviest) comes first.
__device__ __forceinline__ void block_order(const Params& p, int L,
                                            int n_tiles, int& head,
                                            int& rank) {
  const int gi = L / (p.group * n_tiles);
  const int gsize = min(p.group, p.heads - gi * p.group);
  const int local = L - gi * p.group * n_tiles;
  head = gi * p.group + local % gsize;
  rank = local / gsize;
}

// S = A B^T for one warpgroup: m64n64k16 over depth D, A and B K-major in
// swizzled tiles of A_ROWS and B_ROWS rows.
template <int D, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    sm90::wgmma_ss_n64(
        s, sm90::desc_sw128(a + (kk >> 2) * A_ROWS * HALF_ROW + col, 16, 1024),
        sm90::desc_sw128(b + (kk >> 2) * B_ROWS * HALF_ROW + col, 16, 1024),
        kk > 0);
  }
}

// d += A B: A the bf16 fragments of a 64 x 64 accumulator, B [64 x D]
// MN-major (the transposed descriptor) from a swizzled tile of 64 rows.
template <int D>
__device__ __forceinline__ void mma_ab(float (&d)[D / 2],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D>(d, a[kk],
                      sm90::desc_sw128(b + kk * 16 * HALF_ROW,
                                       64 * HALF_ROW, 1024), 1);
}

// Writes the first D columns of a warpgroup's 64 x N fp32 accumulator (NA =
// N / 2 floats a thread, N >= D) as bf16 rows row0.. of dst (row stride D);
// rows >= rows_valid are skipped.
template <int D, int NA>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[NA],
                                           int row0, int rows_valid, int warp,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= rows_valid) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + 8 * j + 2 * t) =
          sm90::pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// LSE * log2(e) of query row `row` of head bh, or +inf where P must be 0:
// past Sq, or a row whose forward saw no key (LSE = -inf).
__device__ __forceinline__ float lse_log2(const Params& p, int bh, int row) {
  if (row >= p.Sq) return INFINITY;
  const float l = p.lse[(size_t)bh * p.Sq + row];
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

template <int D>
__global__ void __launch_bounds__(THREADS_WG, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Params p) {
  using T = DqTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t sq = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + T::Q_BYTES;
  const uint32_t ring = sdo + T::Q_BYTES;  // stage s: K, then V
  const uint32_t full_q = sm90::smem_u32(bars);
  const uint32_t full = full_q + 8, empty = full + 8 * STAGES;

  const int n_qt = (p.Sq + DQ_ROWS - 1) / DQ_ROWS;
  int bh, rank;
  block_order(p, blockIdx.x, n_qt, bh, rank);
  const int q0 = (n_qt - 1 - rank) * DQ_ROWS;  // the last tiles first
  const int kvh = (bh / p.H) * p.Hkv + (bh % p.H) / (p.H / p.Hkv);
  constexpr int DP = T::DP;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, min(q0 + DQ_ROWS, p.Sq) + p.q_offset);
  const int n_tiles = kend <= 0 ? 0 : (kend + DQ_KEYS - 1) / DQ_KEYS;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ------------------------------------------------------ producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tmap(&tk);
      sm90::prefetch_tmap(&tv);
      sm90::mbar_arrive_expect_tx(full_q, 2 * T::Q_BYTES);
#pragma unroll
      for (int h = 0; h < DP / 64; ++h) {
        sm90::tma_load_3d(sq + h * DQ_ROWS * HALF_ROW, &tq, full_q, 64 * h,
                          q0, bh);
        sm90::tma_load_3d(sdo + h * DQ_ROWS * HALF_ROW, &tdo, full_q, 64 * h,
                          q0, bh);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ks = ring + s * 2 * T::KV_BYTES;
        // Stage s last held tile kt - STAGES: wait for its release.
        if (kt >= STAGES)
          sm90::mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        sm90::mbar_arrive_expect_tx(full + 8 * s, 2 * T::KV_BYTES);
#pragma unroll
        for (int h = 0; h < DP / 64; ++h) {
          sm90::tma_load_3d(ks + h * DQ_KEYS * HALF_ROW, &tk, full + 8 * s,
                            64 * h, kt * DQ_KEYS, kvh);
          sm90::tma_load_3d(ks + T::KV_BYTES + h * DQ_KEYS * HALF_ROW, &tv,
                            full + 8 * s, 64 * h, kt * DQ_KEYS, kvh);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::regs_inc<240>();
    const int wg = threadIdx.x / WG_THREADS - 1;  // rows 64 wg.. of the tile
    const int warp = (threadIdx.x % WG_THREADS) >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wg + 16 * warp + g;  // this thread's rows: r0, r0 + 8

    // delta = rowsum(dO * O) in fp32 for this thread's two rows (the four
    // threads of a row take every fourth 8-column chunk), and LSE.
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      float acc = 0.f;
      if (row < p.Sq) {
        const size_t off = ((size_t)bh * p.Sq + row) * D;
        const uint4* o4 = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.out) + off);
        const uint4* d4 = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.dout) + off);
#pragma unroll
        for (int c = t; c < D / 8; c += 4) {
          const uint4 ov = o4[c], dv = d4[c];
          const __nv_bfloat162* oh =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* dh =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(oh[e]);
            const float2 df = __bfloat1622float2(dh[e]);
            acc = fmaf(of.x, df.x, fmaf(of.y, df.y, acc));
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dl[r] = acc;
      lse2[r] = lse_log2(p, bh, row);
      if (row < p.Sq && t == 0) p.delta[(size_t)bh * p.Sq + row] = acc;
    }

    const int qrow0 = q0 + 64 * wg;  // the warpgroup's first row
    const bool live = qrow0 < p.Sq;
    // The warpgroup's smallest and largest query positions: a key tile
    // whose last key is at most qmin needs no causal mask; one whose first
    // key is past qmax is skipped.
    const int qmin = qrow0 + p.q_offset;
    const int qmax = min(qrow0 + 63, p.Sq - 1) + p.q_offset;
    const int qpos[2] = {q0 + r0 + p.q_offset, q0 + r0 + 8 + p.q_offset};
    const uint32_t qa = sq + 64 * wg * HALF_ROW;
    const uint32_t doa = sdo + 64 * wg * HALF_ROW;
    // The warpgroup's key tiles are the first n_mine: a causal tile whose
    // first key is past qmax is only released.
    int n_mine = live ? n_tiles : 0;
    if (p.causal) n_mine = qmax < 0 ? 0 : min(n_mine, qmax / DQ_KEYS + 1);
    auto stage_of = [&](int kt) { return ring + (kt % STAGES) * 2 * T::KV_BYTES; };
    auto release = [&](int kt) {
      if (lane == 0) sm90::mbar_arrive(empty + 8 * (kt % STAGES));
    };
    float dq[DP / 2], sc[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    // S and dP of key tile kt, committed as one group.
    auto issue_s_dp = [&](int kt) {
      sm90::mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);
      sm90::wgmma_fence();
      mma_abt<D, DQ_ROWS, DQ_KEYS>(sc, qa, stage_of(kt));
      mma_abt<D, DQ_ROWS, DQ_KEYS>(dp, doa, stage_of(kt) + T::KV_BYTES);
      sm90::wgmma_commit();
    };
    // dS of key tile kt from its S and dP, packed to A fragments in da.
    auto form_ds = [&](int kt) {
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      const int k0 = kt * DQ_KEYS;
      const bool mask =
          k0 + DQ_KEYS > p.Sk || (p.causal && k0 + DQ_KEYS - 1 > qmin);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i & 3) >> 1;
        float pr = ex2(fmaf(sc[i], p.scale_log2, -lse2[r]));
        if (mask) {
          const int kpos = k0 + acc_col(i, t);
          if (kpos >= p.Sk || (p.causal && kpos > qpos[r])) pr = 0.f;
        }
        sc[i] = pr * (dp[i] - dl[r]) * p.scale;
      }
    };
    sm90::mbar_wait(full_q, 0);
    if (n_mine > 0) {
      issue_s_dp(0);
      sm90::wgmma_wait<0>();
      form_ds(0);
      acc_to_a(sc, da);
      // Tile kt: its S and dP start together with dQ += dS K of tile
      // kt - 1, and its dS is formed while that product runs.
      for (int kt = 1; kt < n_mine; ++kt) {
        issue_s_dp(kt);
        sm90::fence_regs(dq);
        mma_ab<DP>(dq, da, stage_of(kt - 1));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        form_ds(kt);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        release(kt - 1);
        acc_to_a(sc, da);
      }
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
      mma_ab<DP>(dq, da, stage_of(n_mine - 1));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      release(n_mine - 1);
    }
    for (int kt = n_mine; kt < n_tiles; ++kt) {
      sm90::mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);
      release(kt);
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.Sq * D,
                  dq, qrow0, p.Sq, warp, g, t);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS_WG, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Params p) {
  using T = DkvTiles<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  // Each stage's LSE * log2(e) and delta, by query row of its tile.
  __shared__ __align__(16) float lse_s[STAGES][DKV_ROWS];
  __shared__ __align__(16) float dl_s[STAGES][DKV_ROWS];
  const uint32_t sk = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + T::KV_BYTES;
  const uint32_t ring = sv + T::KV_BYTES;  // stage s: Q, then dO
  const uint32_t full_kv = sm90::smem_u32(bars);
  const uint32_t full = full_kv + 8, empty = full + 8 * STAGES;

  const int n_kt = (p.Sk + DKV_KEYS - 1) / DKV_KEYS;
  int bkv, rank;
  block_order(p, blockIdx.x, n_kt, bkv, rank);
  const int k0b = rank * DKV_KEYS;  // the first key tiles first
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int group = p.H / p.Hkv;
  constexpr int DP = T::DP;
  // The first query tile that sees key k0b (q + q_offset >= k0b).
  const int qt0 =
      p.causal ? max(0, k0b - p.q_offset) / DKV_ROWS : 0;
  const int n_qt = (p.Sq + DKV_ROWS - 1) / DKV_ROWS;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      sm90::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ------------------------------------------------------ producer
    sm90::regs_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        sm90::prefetch_tmap(&tq);
        sm90::prefetch_tmap(&tdo);
        sm90::mbar_arrive_expect_tx(full_kv, 2 * T::KV_BYTES);
#pragma unroll
        for (int h = 0; h < DP / 64; ++h) {
          sm90::tma_load_3d(sk + h * DKV_KEYS * HALF_ROW, &tk, full_kv,
                            64 * h, k0b, bkv);
          sm90::tma_load_3d(sv + h * DKV_KEYS * HALF_ROW, &tv, full_kv,
                            64 * h, k0b, bkv);
        }
      }
      int it = 0;
      for (int hg = 0; hg < group; ++hg) {
        const int bh = b * p.H + kvh * group + hg;
        for (int qt = qt0; qt < n_qt; ++qt, ++it) {
          const int s = it % STAGES;
          const int q0 = qt * DKV_ROWS;
          // Stage s last held step it - STAGES: wait for its release.
          if (it >= STAGES)
            sm90::mbar_wait(empty + 8 * s, (it / STAGES - 1) & 1);
#pragma unroll
          for (int rr = lane; rr < DKV_ROWS; rr += 32) {
            const int row = q0 + rr;
            lse_s[s][rr] = lse_log2(p, bh, row);
            dl_s[s][rr] =
                row < p.Sq ? p.delta[(size_t)bh * p.Sq + row] : 0.f;
          }
          const uint32_t qs = ring + s * 2 * T::Q_BYTES;
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(full + 8 * s, 2 * T::Q_BYTES);
#pragma unroll
            for (int h = 0; h < DP / 64; ++h) {
              sm90::tma_load_3d(qs + h * DKV_ROWS * HALF_ROW, &tq,
                                full + 8 * s, 64 * h, q0, bh);
              sm90::tma_load_3d(qs + T::Q_BYTES + h * DKV_ROWS * HALF_ROW,
                                &tdo, full + 8 * s, 64 * h, q0, bh);
            }
          } else {
            sm90::mbar_arrive(full + 8 * s);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::regs_inc<240>();
    const int wg = threadIdx.x / WG_THREADS - 1;  // keys 64 wg.. of the block
    const int warp = (threadIdx.x % WG_THREADS) >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int k0w = k0b + 64 * wg;  // the warpgroup's first key
    const int kpos[2] = {k0w + 16 * warp + g, k0w + 16 * warp + g + 8};
    const uint32_t ka = sk + 64 * wg * HALF_ROW;
    const uint32_t va = sv + 64 * wg * HALF_ROW;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];       // S^T and dP^T: rows keys, columns queries
    uint32_t pa[4][4], sa[4][4];  // P^T and dS^T as A fragments
    const int nq = n_qt - qt0;
    const int n_steps = nq > 0 ? group * nq : 0;
    // The stage whose dV and dK products are in flight.  It is released
    // at the next step that is not skipped; at most one step a head is
    // skipped, so the producer never waits on it.
    int prev = -1;
    sm90::mbar_wait(full_kv, 0);

    // Step it is query tile qt0 + it % nq of the group's head it / nq.
    // Its S^T and dP^T start behind the previous step's dK; P^T is formed
    // while dP^T runs and dS^T while dV runs.
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % STAGES;
      const int q0 = (qt0 + it % nq) * DKV_ROWS;
      const uint32_t qs = ring + s * 2 * T::Q_BYTES, dos = qs + T::Q_BYTES;
      sm90::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      // Skipped where every key of the warpgroup is past Sk or past the
      // last query position of the tile.
      if (k0w >= p.Sk ||
          (p.causal && k0w > q0 + DKV_ROWS - 1 + p.q_offset)) {
        if (lane == 0) sm90::mbar_arrive(empty + 8 * s);
        continue;
      }
      if (prev >= 0) sm90::wgmma_wait<1>();  // the previous dV: pa is free
      sm90::wgmma_fence();
      mma_abt<D, DKV_KEYS, DKV_ROWS>(st, ka, qs);
      sm90::wgmma_commit();
      mma_abt<D, DKV_KEYS, DKV_ROWS>(dpt, va, dos);
      sm90::wgmma_commit();
      if (prev >= 0) {
        sm90::wgmma_wait<2>();  // the previous dK: sa and its stage free
        if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
      }
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);
      const bool mask = p.causal && k0w + 63 > q0 + p.q_offset;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;  // query row of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[s][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pr = ex2(fmaf(st[i], p.scale_log2, -(e & 1 ? l2.y : l2.x)));
          if (mask && kpos[e >> 1] > q0 + c + (e & 1) + p.q_offset) pr = 0.f;
          st[i] = pr;
        }
      }
      acc_to_a(st, pa);
      sm90::fence_regs(dv);
      sm90::wgmma_fence();
      mma_ab<DP>(dv, pa, dos);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(&dl_s[s][8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dpt[i] = st[i] * (dpt[i] - (e & 1 ? d2.y : d2.x)) * p.scale;
        }
      }
      acc_to_a(dpt, sa);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
      mma_ab<DP>(dk, sa, qs);
      sm90::wgmma_commit();
      prev = s;
    }
    if (prev >= 0) {
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
    }
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    const size_t base = (size_t)bkv * p.Sk * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + base, dk, k0w, p.Sk,
                  warp, g, t);
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + base, dv, k0w, p.Sk,
                  warp, g, t);
  }
}

// Test-only: one warpgroup runs each wgmma operand form of the kernels
// above with the same tensor maps, descriptors and fragment packing.  a is
// a [128 x n] tile (a warpgroup's A is its rows 64..127, as the second
// consumer's K in the dk/dv kernel), b a [64 x n] tile; n in {64, 128}.
//  FORM 0 (SS m64n64k16, A and B K-major, as S^T = K Q^T and S = Q K^T):
//    c[64 x 64] = a[64:128] b^T.
//  FORM 1 (RS m64nNk16, B MN-major, as dV += P^T dO and dQ += dS K):
//    c[64 x n] = bf16(a32[64 x 64]) b.
//  FORM 2 (both from one tile, as dK += dS^T Q reads Q after S^T did):
//    c[64 x n] = bf16(a[64:128] b^T) b.
template <int FORM, int N>
__global__ void __launch_bounds__(WG_THREADS)
flash_bwd_wgmma_check_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             const float* a32, float* c) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t sa = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + 128 * N * 2;
  const uint32_t bar = sm90::smem_u32(&bar_mem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, (FORM == 1 ? 64 : 128 + 64) * N * 2);
#pragma unroll
    for (int h = 0; h < N / 64; ++h) {
      if (FORM != 1)
        sm90::tma_load_3d(sa + h * 128 * HALF_ROW, &ta, bar, 64 * h, 0, 0);
      sm90::tma_load_3d(sb + h * 64 * HALF_ROW, &tb, bar, 64 * h, 0, 0);
    }
  }
  sm90::mbar_wait(bar, 0);
  float s[32];
  if constexpr (FORM == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = a32[acc_row(i, warp, g) * 64 + acc_col(i, t)];
  } else {
    sm90::wgmma_fence();
    mma_abt<N, 128, 64>(s, sa + 64 * HALF_ROW, sb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
  }
  if constexpr (FORM == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      c[acc_row(i, warp, g) * 64 + acc_col(i, t)] = s[i];
  } else {
    uint32_t pa[4][4];
    acc_to_a(s, pa);
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    sm90::fence_regs(d);
    sm90::wgmma_fence();
    mma_ab<N>(d, pa, sb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      c[acc_row(i, warp, g) * N + acc_col(i, t)] = d[i];
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // eight warps

// dq: number of key tiles query tile q0 must visit.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int kend = p.Sk;
  if (p.causal) kend = min(kend, min(q0 + BQ, p.Sq) + p.q_offset);
  return kend <= 0 ? 0 : (kend + BK - 1) / BK;
}

// dk/dv: first query tile that sees any key of tile k0.
__device__ __forceinline__ int first_query_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int first = k0 - p.q_offset;  // smallest q with q + q_offset >= k0
  return first <= 0 ? 0 : first / BQ;
}

// Per-row LSE and delta of query tile q0 into shared memory (zeros past Sq).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const Params& p, int bh, int q0,
                                          float lse_mul) {
  const int r = threadIdx.x;
  if (r < BQ) {
    const bool ok = q0 + r < p.Sq;
    const size_t i = (size_t)bh * p.Sq + q0 + r;
    lse_s[r] = ok ? p.lse[i] * lse_mul : 0.f;
    delta_s[r] = ok ? p.delta[i] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos + p.q_offset);
}


// 64 x D fp32 tile into shared memory (row stride D + 1: conflict-free
// row-wise reads); rows >= rows_valid become zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int rows_valid) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r < rows_valid ? src[(size_t)r * D + d] : 0.f;
  }
}

// fp32 tile step: thread (r = tid/4, c0 = tid%4) computes keys c0 + 4*j of
// query row r; P (if WRITE_P) and dS go to shared memory [query][key]
// (row stride BK + 1).
template <int D, bool WRITE_P>
__device__ __forceinline__ void tile_p_ds_f32(const Params& p, const float* Qs,
                                              const float* dOs,
                                              const float* Ks, const float* Vs,
                                              const float* lse_s,
                                              const float* delta_s, float* Ps,
                                              float* dSs, int q0, int k0) {
  constexpr int LDQ = D + 1;
  const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
  float s[16], dp[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = dp[j] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float qv = Qs[r * LDQ + d], ov = dOs[r * LDQ + d];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 4 * j;
      s[j] = fmaf(qv, Ks[c * LDQ + d], s[j]);
      dp[j] = fmaf(ov, Vs[c * LDQ + d], dp[j]);
    }
  }
  const bool row_ok = q0 + r < p.Sq;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + 4 * j;
    const bool ok = row_ok && visible(p, q0 + r, k0 + c);
    const float pr = ok ? expf(s[j] * p.scale - lse_s[r]) : 0.f;
    if (WRITE_P) Ps[r * (BK + 1) + c] = pr;
    dSs[r * (BK + 1) + c] = pr * (dp[j] - delta_s[r]) * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(Params p) {
  constexpr int LDQ = D + 1;
  constexpr int NC = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BQ * LDQ;
  float* Ks = dOs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* dSs = Vs + BK * LDQ;
  float* lse_s = dSs + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t q_base = ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = ((size_t)b * p.Hkv + kvh) * p.Sk * D;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;
  const int q_rows = min(BQ, p.Sq - q0);
  load_tile_f32<D>(Qs, static_cast<const float*>(p.q) + q_base, q_rows);
  load_tile_f32<D>(dOs, static_cast<const float*>(p.dout) + q_base, q_rows);
  load_rows(lse_s, delta_s, p, bh, q0, 1.f);

  const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  const int n_tiles = key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile_f32<D>(Ks, kg + (size_t)k0 * D, min(BK, p.Sk - k0));
    load_tile_f32<D>(Vs, vg + (size_t)k0 * D, min(BK, p.Sk - k0));
    __syncthreads();
    tile_p_ds_f32<D, false>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs,
                            q0, k0);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float ds = dSs[r * (BK + 1) + j];
      const float* kr = Ks + j * LDQ + c0;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(ds, kr[4 * c], acc[c]);
    }
  }
  if (r >= q_rows) return;
  float* out = static_cast<float*>(p.dq) + q_base + (size_t)r * D + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) out[4 * c] = acc[c];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int LDQ = D + 1;
  constexpr int NC = D / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BK * LDQ;
  float* Qs = Vs + BK * LDQ;
  float* dOs = Qs + BQ * LDQ;
  float* Ps = dOs + BQ * LDQ;
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;

  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, p.Sk - k0);
  const size_t kv_base = ((size_t)bkv * p.Sk + k0) * D;
  load_tile_f32<D>(Ks, static_cast<const float*>(p.k) + kv_base, k_rows);
  load_tile_f32<D>(Vs, static_cast<const float*>(p.v) + kv_base, k_rows);

  const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;  // key row, columns
  float dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk[c] = dv[c] = 0.f;
  const int qt0 = first_query_tile(p, k0);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  for (int hg = 0; hg < group; ++hg) {
    const int bh = b * p.H + kvh * group + hg;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      const size_t q_base = ((size_t)bh * p.Sq + q0) * D;
      const int q_rows = min(BQ, p.Sq - q0);
      __syncthreads();
      load_tile_f32<D>(Qs, static_cast<const float*>(p.q) + q_base, q_rows);
      load_tile_f32<D>(dOs, static_cast<const float*>(p.dout) + q_base,
                       q_rows);
      load_rows(lse_s, delta_s, p, bh, q0, 1.f);
      __syncthreads();
      tile_p_ds_f32<D, true>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0,
                             k0);
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float pr = Ps[i * (BK + 1) + r];
        const float ds = dSs[i * (BK + 1) + r];
        const float* orow = dOs + i * LDQ + c0;
        const float* qrow = Qs + i * LDQ + c0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[c] = fmaf(pr, orow[4 * c], dv[c]);
          dk[c] = fmaf(ds, qrow[4 * c], dk[c]);
        }
      }
    }
  }
  if (r >= k_rows) return;
  float* dkg = static_cast<float*>(p.dk) + kv_base + (size_t)r * D + c0;
  float* dvg = static_cast<float*>(p.dv) + kv_base + (size_t)r * D + c0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    dkg[4 * c] = dk[c];
    dvg[4 * c] = dv[c];
  }
}


// Returns this launch's own error (cudaGetLastError after a <<<>>> launch
// would also report one that other code left on the thread).
template <typename... Args>
int launch(void (*kernel)(Args...), dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* argv[] = {&args...};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                               dim3(threads), argv, smem, stream);
}

size_t smem_f32(int D, int n_pds) {
  return ((size_t)4 * 64 * (D + 1) + (size_t)n_pds * 64 * (BK + 1) + 2 * BQ) *
         sizeof(float);
}

// Heads per group of the block order: as many as fit 16 MB of the 50 MB L2
// with `bytes` of streamed operands each, in multiples of `whole`.
int order_group(int heads, size_t bytes, int whole) {
  const size_t fit = max((size_t)1, ((size_t)16 << 20) / bytes);
  return (int)min((size_t)heads, fit * whole);
}

// q, dO, k, v as 3-D tensor maps: q and dO in boxes of q_rows rows, k and
// v of kv_rows.
template <int D>
int make_maps(const Params& p, int B, int q_rows, int kv_rows,
              CUtensorMap (&m)[4]) {
  int err = sm90::make_tmap_bf16(&m[0], p.q, D, p.Sq, (uint64_t)B * p.H,
                                 q_rows);
  if (err == 0)
    err = sm90::make_tmap_bf16(&m[1], p.dout, D, p.Sq, (uint64_t)B * p.H,
                               q_rows);
  if (err == 0)
    err = sm90::make_tmap_bf16(&m[2], p.k, D, p.Sk, (uint64_t)B * p.Hkv,
                               kv_rows);
  if (err == 0)
    err = sm90::make_tmap_bf16(&m[3], p.v, D, p.Sk, (uint64_t)B * p.Hkv,
                               kv_rows);
  return err;
}

template <int D>
int launch_dq_bf16(Params p, int B, cudaStream_t st) {
  CUtensorMap m[4];
  const int err = make_maps<D>(p, B, DQ_ROWS, DQ_KEYS, m);
  if (err != 0) return err;
  // Streamed per query head: its KV head's K and V, shared by the group.
  p.heads = B * p.H;
  p.group = order_group(p.heads, (size_t)p.Sk * D * 2 * 2, p.H / p.Hkv);
  const dim3 grid(p.heads * ((p.Sq + DQ_ROWS - 1) / DQ_ROWS));
  return launch(flash_bwd_dq_wgmma_kernel<D>, grid, THREADS_WG,
                DqTiles<D>::SMEM, st, m[0], m[1], m[2], m[3], p);
}

template <int D>
int launch_dkv_bf16(Params p, int B, cudaStream_t st) {
  CUtensorMap m[4];
  const int err = make_maps<D>(p, B, DKV_ROWS, DKV_KEYS, m);
  if (err != 0) return err;
  // Streamed per KV head: Q and dO of each of its query heads.
  p.heads = B * p.Hkv;
  p.group = order_group(p.heads, (size_t)(p.H / p.Hkv) * p.Sq * D * 2 * 2,
                        1);
  const dim3 grid(p.heads * ((p.Sk + DKV_KEYS - 1) / DKV_KEYS));
  return launch(flash_bwd_dkv_wgmma_kernel<D>, grid, THREADS_WG,
                DkvTiles<D>::SMEM, st, m[0], m[1], m[2], m[3], p);
}

template <int FORM>
int launch_check(int n, const CUtensorMap& ta, const CUtensorMap& tb,
                 const float* a32, float* c, cudaStream_t st) {
  const size_t smem = 1024 + (128 + 64) * 128 * 2;
  const dim3 grid(1);
  return n == 64 ? launch(flash_bwd_wgmma_check_kernel<FORM, 64>, grid,
                          WG_THREADS, smem, st, ta, tb, a32, c)
                 : launch(flash_bwd_wgmma_check_kernel<FORM, 128>, grid,
                          WG_THREADS, smem, st, ta, tb, a32, c);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a cudaError_t.
// dq [B,H,Sq,D] in q's dtype.  delta [B,H,Sq] fp32: bfloat16 computes it
// from out and dout and writes it (for rt_flash_bwd_dkv); float32 reads it
// (out is then unused).
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, int dtype, int B, int H, int Hkv,
                    int Sq, int Sk, int D, float scale, int causal,
                    int q_offset, void* stream) {
  const Params p{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr, H,
                 Hkv, Sq, Sk, scale, causal, q_offset, scale * LOG2E, 0, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 128) return launch_dq_bf16<128>(p, B, st);
    if (D == 64) return launch_dq_bf16<64>(p, B, st);
    if (D == 32) return launch_dq_bf16<32>(p, B, st);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
    const size_t smem = smem_f32(D, 1);
    if (D == 128)
      return launch(flash_bwd_dq_f32_kernel<128>, grid, THREADS, smem, st, p);
    if (D == 64)
      return launch(flash_bwd_dq_f32_kernel<64>, grid, THREADS, smem, st, p);
    if (D == 32)
      return launch(flash_bwd_dq_f32_kernel<32>, grid, THREADS, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B,Hkv,Sk,D] in k's dtype, summed over each KV head's query heads.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int dtype, int B, int H, int Hkv,
                     int Sq, int Sk, int D, float scale, int causal,
                     int q_offset, void* stream) {
  const Params p{q, k, v, nullptr, dout, lse, const_cast<float*>(delta),
                 nullptr, dk, dv, H, Hkv, Sq, Sk, scale, causal, q_offset,
                 scale * LOG2E, 0, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 128) return launch_dkv_bf16<128>(p, B, st);
    if (D == 64) return launch_dkv_bf16<64>(p, B, st);
    if (D == 32) return launch_dkv_bf16<32>(p, B, st);
  } else if (dtype == 0) {
    const dim3 grid(B * Hkv, (Sk + BK - 1) / BK);
    const size_t smem = smem_f32(D, 2);
    if (D == 128)
      return launch(flash_bwd_dkv_f32_kernel<128>, grid, THREADS, smem, st,
                    p);
    if (D == 64)
      return launch(flash_bwd_dkv_f32_kernel<64>, grid, THREADS, smem, st, p);
    if (D == 32)
      return launch(flash_bwd_dkv_f32_kernel<32>, grid, THREADS, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

// Test-only: one wgmma operand form on bf16 inputs (see
// flash_bwd_wgmma_check_kernel): a [128, n], a32 [64, 64] fp32, b [64, n];
// c [64, 64] (form 0) or [64, n] (forms 1, 2).  n in {64, 128}.
int rt_bwd_wgmma_check(int form, const void* a, const float* a32,
                       const void* b, float* c, int n, void* stream) {
  if (form < 0 || form > 2 || (n != 64 && n != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = sm90::make_tmap_bf16(&tb, b, n, 64, 1, 64);
  if (err == 0)
    err = form == 1 ? sm90::make_tmap_bf16(&ta, b, n, 64, 1, 64)
                    : sm90::make_tmap_bf16(&ta, a, n, 128, 1, 128);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 0) return launch_check<0>(n, ta, tb, a32, c, st);
  if (form == 1) return launch_check<1>(n, ta, tb, a32, c, st);
  return launch_check<2>(n, ta, tb, a32, c, st);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
