// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: ray_tpu/ops/attention.py:_fwd_kernel (the Pallas TPU kernel
// driven by _flash_forward and exposed as flash_attention).  Computes causal
// (or full) GQA softmax(Q K^T * scale) V over q [B,H,Sq,D] and k/v
// [B,Hkv,Sk,D], query head h reading KV head h / (H/Hkv).  `q_offset` shifts
// the causal diagonal.  Optional fp32 LSE = m + log(l) [B,H,Sq], with l = 0
// guarded to 1 exactly as attention.py:140,145 do.
//
// What bounds it on the H100: operations.  Every (query, key) pair costs
// 4*D flops against 2*D bytes of K/V that a whole 128-row query tile
// shares, so above a few hundred keys the tensor cores (989 TFLOP/s bf16)
// are the limit, not the 3.35 TB/s of device memory, provided each K/V tile
// comes from L2 and not from device memory for every query tile that reads
// it.  The softmax exponentials run on the CUDA cores beside the products.
//
// What the design does about it (bf16):
// - Both products are warpgroup MMAs (wgmma.mma_async, fp32 accumulate),
//   the only way to Hopper's full tensor-core rate.  Blocks of three
//   warpgroups, one per SM, persistent.  Warpgroup 0 is the producer: it
//   gives up its registers (setmaxnreg.dec 24) and one thread starts TMA
//   loads and takes the block's next 128-row query tile from an atomic
//   counter.  Warpgroups 1 and 2 are consumers (setmaxnreg.inc 240), 64
//   query rows each.
// - Q (two buffers, so the next tile's Q loads during this one), K and V
//   arrive by TMA, K and V in tiles of 128 keys into rings of their own (2
//   stages each at D=128, 3 at D=64 and D=32, whose tiles are D 64's).  Every buffer has a "full" mbarrier
//   (armed with its bytes) and an "empty" one on which every consumer warp
//   arrives once its wgmma on it has retired.  3-D tensor maps {D, S, heads}
//   zero-fill a tile that runs past S inside its own head; tiles are
//   128-byte swizzled, as wgmma's descriptors read them.
// - S = Q K^T: m64n128k16 with Q (A) and K (B) K-major in shared memory.
//   O += P V: P stays in registers, the fp32 scores re-packed to bf16 as
//   wgmma's A fragments (FlashAttention-3's register reuse), and V is read
//   MN-major through a transposed descriptor.  S of key tile j and P V of
//   tile j - 1 are started together, and the two consumer warpgroups take
//   turns to start them (named barriers), so the softmax of one tile runs
//   beside the products of another.
// - Online softmax (running max m, sum l, exp2 of log2e-prescaled scores)
//   on the accumulator fragments; only tiles that cross the (shifted)
//   causal diagonal or the Sk edge are masked.  Causal: the key loop stops
//   at the last tile the query tile's diagonal reaches.
// - Query tiles are taken in groups of heads whose K/V fits in L2, the
//   heaviest causal tiles of the group first: K/V is read from device
//   memory about once, and the last tiles to start are the lightest.
// fp32: full-precision FMA on the CUDA cores (no TF32), so fp32 callers get
// the reference's numbers; 64-row blocks, two threads per query row.

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Hkv, Sq, Sk;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
  int q_offset;
  // bf16 kernel only:
  int BH;        // B * H
  int group;     // heads per group of the query-tile order
  int total;     // query tiles: B * H * ceil(Sq / 128)
  int* counter;  // tile tickets handed out past the grid's first tiles
};

// Number of BK-key tiles query rows [q0, q0 + BQ) must visit: all of them,
// or (causal) up to the one holding the key on the diagonal of the last row.
__device__ __forceinline__ int tile_count(const Params& p, int q0, int BQ,
                                          int BK) {
  int kend = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
    kend = min(kend, last_q + 1);
  }
  return kend <= 0 ? 0 : (kend + BK - 1) / BK;
}

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = 128;        // query rows per block, 64 per consumer
constexpr int BK = 128;        // keys per K/V tile
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;
constexpr int HALF_ROW = 128;  // bytes of one 64-column half row
static_assert(BQ == BK, "Q and K halves share one stride (mma_qk)");

// A tile's width in shared memory: D, or 64 at D 32.  A row of D 32 is 64
// bytes; its TMA box is still 64 columns, of which the 32 past the tensor's
// last column are zero-filled by the copy engine (no bytes read for them),
// so the 128-byte swizzle, the descriptors and the fragment layouts of D 64
// serve D 32 as they are.  Q K^T then takes D / 16 K-steps (the zero half
// is never multiplied) and P V an N of 64 whose upper 32 columns are zero
// and never stored.
template <int D>
struct Tiles {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int STAGES = DP == 128 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;  // one K (or V) tile
  // Two Q buffers, so the next tile's Q loads during this one.
  static constexpr uint32_t SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
};

using sm90::acc_col;
using sm90::acc_row;
using sm90::acc_to_a;
using sm90::ex2;

// S = Q K^T for one warpgroup's 64 rows x 128 keys (K-major A and B).
template <int D>
__device__ __forceinline__ void mma_qk(float (&sc)[64], uint32_t qa,
                                       uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk >> 2) * BK * HALF_ROW + (kk & 3) * 32;
    sm90::wgmma_ss_n128(sc, sm90::desc_sw128(qa + step, 16, 1024),
                        sm90::desc_sw128(ka + step, 16, 1024), kk > 0);
  }
}

// O += P V: P from registers, V MN-major (transposed descriptor).
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&pa)[8][4],
                                       uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::wgmma_rs<D>(o, pa[kk],
                      sm90::desc_sw128(va + kk * 16 * HALF_ROW,
                                       BK * HALF_ROW, 1024), 1);
}

// The online softmax on one tile of scores (raw Q K^T, this thread's two
// rows): masks the tile if `mask`, updates the running max m (log2 domain)
// and partial sums l, leaves exp2(s * scale_log2 - m) in sc and the factor
// the old O and l take in alpha.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool mask, int k0, int t,
                                             const int (&qpos)[2],
                                             const Params& p) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = k0 + acc_col(i, t);
      const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos[(i & 3) >> 1]);
      if (!ok) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], sc[i]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float mnew = fmaxf(m[r], mx[r] * p.scale_log2);
    base[r] = mnew == -INFINITY ? 0.f : mnew;  // all masked so far
    alpha[r] = ex2(m[r] - base[r]);
    m[r] = mnew;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], p.scale_log2, -base[(i & 3) >> 1]));
    rs[(i & 3) >> 1] += sc[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// Query tile L of the launch's order -> (b * H + h, first query row).
// Heads go in groups of p.group whose K/V fits in L2, so each K/V tile is
// read from device memory about once and then from L2 by every query tile
// of its head; inside a group the heaviest causal query tiles (most K/V
// tiles) of every head come first and the lightest last.
__device__ __forceinline__ void tile_coords(const Params& p, int L, int& bh,
                                            int& q0) {
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int gi = L / (p.group * n_qt);
  const int gsize = min(p.group, p.BH - gi * p.group);
  const int local = L - gi * p.group * n_qt;
  bh = gi * p.group + local % gsize;
  q0 = (n_qt - 1 - local / gsize) * BQ;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Params p) {
  using T = Tiles<D>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // Barriers: full and empty for each of the two Q buffers, each K stage
  // and each V stage.  K and V have rings of their own: a K tile is
  // released once S is computed, its V tile only after the next tile's S.
  __shared__ __align__(8) uint64_t bars[4 + 4 * STAGES];
  // The query tile each Q buffer holds (>= p.total: no more work).
  __shared__ int tile_of[2];
  const uint32_t sq = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + 2 * T::Q_BYTES;
  const uint32_t sv = sk + STAGES * T::KV_BYTES;
  const uint32_t full_q = sm90::smem_u32(bars), empty_q = full_q + 16;
  const uint32_t full_k = empty_q + 16, empty_k = full_k + 8 * STAGES;
  const uint32_t full_v = empty_k + 8 * STAGES;
  const uint32_t empty_v = full_v + 8 * STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(full_q + 8 * i, 1);
      sm90::mbar_init(empty_q + 8 * i, 8);  // every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full_k + 8 * s, 1);
      sm90::mbar_init(full_v + 8 * s, 1);
      sm90::mbar_init(empty_k + 8 * s, 8);
      sm90::mbar_init(empty_v + 8 * s, 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // Persistent: one block per SM.  Its first query tile is blockIdx.x; the
  // producer takes each next one from p.counter (heaviest first, in the
  // order of tile_coords) and hands it to the consumers in tile_of with
  // the Q load.  Stage and phase of the K/V rings run on across tiles.
  if (threadIdx.x < WG_THREADS) {
    // ------------------------------------------------------ producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tmap(&tq);
      sm90::prefetch_tmap(&tk);
      sm90::prefetch_tmap(&tv);
      int L = blockIdx.x, it = 0;
      for (int ti = 0;; ++ti) {
        const int qb = ti & 1;
        // Q buffer qb last held tile ti - 2: wait for its release.
        if (ti >= 2) sm90::mbar_wait(empty_q + 8 * qb, ((ti >> 1) - 1) & 1);
        *reinterpret_cast<volatile int*>(&tile_of[qb]) = L;
        if (L >= p.total) {
          sm90::mbar_arrive(full_q + 8 * qb);
          break;
        }
        int bh, q0;
        tile_coords(p, L, bh, q0);
        const int kvh = (bh / p.H) * p.Hkv + (bh % p.H) / (p.H / p.Hkv);
        sm90::mbar_arrive_expect_tx(full_q + 8 * qb, T::Q_BYTES);
#pragma unroll
        for (int h = 0; h < T::DP / 64; ++h)
          sm90::tma_load_3d(sq + qb * T::Q_BYTES + h * BQ * HALF_ROW, &tq,
                            full_q + 8 * qb, 64 * h, q0, bh);
        const int n_tiles = tile_count(p, q0, BQ, BK);
        for (int kt = 0; kt < n_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t off = s * T::KV_BYTES;
          // Stage s last held step it - STAGES: wait for its release.
          if (it >= STAGES)
            sm90::mbar_wait(empty_k + 8 * s, (it / STAGES - 1) & 1);
          sm90::mbar_arrive_expect_tx(full_k + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int h = 0; h < T::DP / 64; ++h)
            sm90::tma_load_3d(sk + off + h * BK * HALF_ROW, &tk,
                              full_k + 8 * s, 64 * h, kt * BK, kvh);
          if (it >= STAGES)
            sm90::mbar_wait(empty_v + 8 * s, (it / STAGES - 1) & 1);
          sm90::mbar_arrive_expect_tx(full_v + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int h = 0; h < T::DP / 64; ++h)
            sm90::tma_load_3d(sv + off + h * BK * HALF_ROW, &tv,
                              full_v + 8 * s, 64 * h, kt * BK, kvh);
        }
        L = p.total <= (int)gridDim.x ? p.total
                                        : gridDim.x + atomicAdd(p.counter, 1);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::regs_inc<240>();
    const int wg = threadIdx.x / WG_THREADS - 1;  // 0 or 1: rows 64 wg..
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // This thread's rows of a query tile: r0 and r0 + 8.
    const int r0 = 64 * wg + 16 * warp + g;
    // Ping-pong: a warpgroup starts its products between bar.sync on named
    // barrier 1 + wg and bar.arrive on the other's, so one warpgroup's
    // softmax runs beside the other's products.  Warpgroup 1 lets 0 go
    // first; 0 takes 1's last arrive at the end, so both are balanced.
    auto my_turn = [&]() { sm90::bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { sm90::bar_arrive(2 - wg, 256); };
    if (wg == 1) sm90::bar_arrive(1, 256);

    constexpr int NO = T::DP / 2;  // O accumulator floats per thread
    float o[NO], sc[64], alpha[2];
    uint32_t pa[8][4];
    int it = 0;
    for (int ti = 0;; ++ti) {
      const int qb = ti & 1;
      sm90::mbar_wait(full_q + 8 * qb, (ti >> 1) & 1);
      const int L = *reinterpret_cast<volatile int*>(&tile_of[qb]);
      if (L >= p.total) break;
      int bh, q0;
      tile_coords(p, L, bh, q0);
      const int n_tiles = tile_count(p, q0, BQ, BK);
      const int qpos[2] = {q0 + r0 + p.q_offset, q0 + r0 + 8 + p.q_offset};
      // The warpgroup's smallest query position: a tile whose last key is
      // at most this needs no causal mask.
      const int qmin = q0 + 64 * wg + p.q_offset;
      auto masked = [&](int kt) {
        const int k0 = kt * BK;
        return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qmin);
      };
      const uint32_t qa = sq + qb * T::Q_BYTES + 64 * wg * HALF_ROW;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns

      if (n_tiles > 0) {
        // Tile 0: S alone.
        int s = it % STAGES;
        sm90::mbar_wait(full_k + 8 * s, (it / STAGES) & 1);
        my_turn();
        sm90::wgmma_fence();
        mma_qk<D>(sc, qa, sk + s * T::KV_BYTES);
        sm90::wgmma_commit();
        your_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        if (lane == 0) sm90::mbar_arrive(empty_k + 8 * s);
        softmax_tile(sc, m, l, alpha, masked(0), 0, t, qpos, p);
        acc_to_a(sc, pa);
        // Tile kt: S of tile kt and P V of tile kt - 1 started together; the
        // softmax of tile kt runs while P V does.
        for (int kt = 1; kt < n_tiles; ++kt) {
          const int sp = it % STAGES, ip = it++;
          s = it % STAGES;
          sm90::mbar_wait(full_k + 8 * s, (it / STAGES) & 1);
          sm90::mbar_wait(full_v + 8 * sp, (ip / STAGES) & 1);
          my_turn();
          sm90::fence_regs(o);
          sm90::wgmma_fence();
          mma_qk<D>(sc, qa, sk + s * T::KV_BYTES);
          sm90::wgmma_commit();
          mma_pv<T::DP>(o, pa, sv + sp * T::KV_BYTES);
          sm90::wgmma_commit();
          your_turn();
          sm90::wgmma_wait<1>();
          sm90::fence_regs(sc);
          if (lane == 0) sm90::mbar_arrive(empty_k + 8 * s);
          softmax_tile(sc, m, l, alpha, masked(kt), kt * BK, t, qpos, p);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          if (lane == 0) sm90::mbar_arrive(empty_v + 8 * sp);
#pragma unroll
          for (int i = 0; i < NO; ++i) o[i] *= alpha[(i & 3) >> 1];
          acc_to_a(sc, pa);
        }
        // P V of the last tile.
        s = it % STAGES;
        sm90::mbar_wait(full_v + 8 * s, (it / STAGES) & 1);
        my_turn();
        sm90::fence_regs(o);
        sm90::wgmma_fence();
        mma_pv<T::DP>(o, pa, sv + s * T::KV_BYTES);
        sm90::wgmma_commit();
        your_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        if (lane == 0) sm90::mbar_arrive(empty_v + 8 * s);
        ++it;
      }
      // Done with this Q buffer; the producer may load tile ti + 2 into it.
      if (lane == 0) sm90::mbar_arrive(empty_q + 8 * qb);

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qrow = q0 + r0 + 8 * r;
        if (qrow >= p.Sq) continue;
        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                            ((size_t)bh * p.Sq + qrow) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(og + 8 * j + 2 * t) =
              sm90::pack_bf16x2(o[4 * j + 2 * r] * inv[r],
                                o[4 * j + 2 * r + 1] * inv[r]);
        if (p.lse != nullptr && t == 0)
          p.lse[(size_t)bh * p.Sq + qrow] =
              m[r] * LN2 + logf(l[r] == 0.f ? 1.f : l[r]);
      }
    }
    if (wg == 0) sm90::bar_sync(1, 256);
  }
}

// Test-only: one warpgroup checks each wgmma operand form this file uses,
// with the same tensor maps, descriptors and fragment layouts.
//  FORM 0 (K-major A and B from shared memory, as S = Q K^T):
//    c[64 x 128] = a[64 x N] b[128 x N]^T, N (the depth) in {64, 128}.
//  FORM 1 (A from registers, B MN-major, as O += P V):
//    c[64 x N] = bf16(a32[64 x 128]) b[128 x N], N in {64, 128}.
template <int FORM, int N>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_wgmma_check_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             const float* a32, float* c) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t sa = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + 64 * 128 * 2;
  const uint32_t bar = sm90::smem_u32(&bar_mem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, (FORM == 0 ? 64 + 128 : 128) * N * 2);
#pragma unroll
    for (int h = 0; h < N / 64; ++h) {
      if (FORM == 0)
        sm90::tma_load_3d(sa + h * 64 * HALF_ROW, &ta, bar, 64 * h, 0, 0);
      sm90::tma_load_3d(sb + h * 128 * HALF_ROW, &tb, bar, 64 * h, 0, 0);
    }
  }
  sm90::mbar_wait(bar, 0);
  if constexpr (FORM == 0) {
    float d[64];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t step = (kk & 3) * 32;
      sm90::wgmma_ss_n128(
          d, sm90::desc_sw128(sa + (kk >> 2) * 64 * HALF_ROW + step, 16, 1024),
          sm90::desc_sw128(sb + (kk >> 2) * 128 * HALF_ROW + step, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      c[acc_row(i, warp, g) * 128 + acc_col(i, t)] = d[i];
  } else {
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = a32[acc_row(i, warp, g) * 128 + acc_col(i, t)];
    uint32_t pa[8][4];
    acc_to_a(s, pa);
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    sm90::fence_regs(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_rs<N>(d, pa[kk],
                        sm90::desc_sw128(sb + kk * 16 * HALF_ROW,
                                         128 * HALF_ROW, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      c[acc_row(i, warp, g) * N + acc_col(i, t)] = d[i];
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int BQ32 = 64;       // query rows per block
constexpr int BK32 = 64;       // keys per K/V tile
constexpr int THREADS32 = 128;

// Two threads per query row: thread (r = tid/2, half = tid%2) scores keys
// 2*jj + half of each tile and owns output columns 2*cc + half.
template <int D>
__global__ void __launch_bounds__(THREADS32)
flash_fwd_f32_kernel(Params p) {
  constexpr int LDQ = D + 1;   // padded rows: conflict-free row-wise reads
  constexpr int LDP = BK32 + 1;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ32 * LDQ;
  float* Vs = Ks + BK32 * LDQ;
  float* Ps = Vs + BK32 * D;

  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ32;
  const float* qg = static_cast<const float*>(p.q) +
                    ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = ((size_t)b * p.Hkv + kvh) * p.Sk * D;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;

  const int q_rows = min(BQ32, p.Sq - q0);
  for (int i = tid; i < BQ32 * D; i += THREADS32) {
    const int rr = i / D, d = i % D;
    Qs[rr * LDQ + d] = rr < q_rows ? qg[(size_t)rr * D + d] : 0.f;
  }

  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = q0 + r + p.q_offset;

  const int n_tiles = tile_count(p, q0, BQ32, BK32);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK32;
    const int k_rows = min(BK32, p.Sk - k0);
    __syncthreads();
    for (int i = tid; i < BK32 * D; i += THREADS32) {
      const int rr = i / D, d = i % D;
      const bool ok = rr < k_rows;
      Ks[rr * LDQ + d] = ok ? kg[(size_t)(k0 + rr) * D + d] : 0.f;
      Vs[rr * D + d] = ok ? vg[(size_t)(k0 + rr) * D + d] : 0.f;
    }
    __syncthreads();

    float s[BK32 / 2];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < BK32 / 2; ++jj) {
      const int j = 2 * jj + half;
      const float* qr = Qs + r * LDQ;
      const float* kr = Ks + j * LDQ;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = k0 + j;
      const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos);
      s[jj] = ok ? dot * p.scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - base);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK32 / 2; ++jj) {
      const float pr = exp2f(s[jj] - base);
      rs += pr;
      Ps[r * LDP + 2 * jj + half] = pr;
    }
    l = l * alpha + rs;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
    __syncwarp();  // the row's two threads share one warp
    for (int j = 0; j < BK32; ++j) {
      const float pr = Ps[r * LDP + j];
      const float* vr = Vs + j * D + half;
#pragma unroll
      for (int c = 0; c < HALF; ++c) acc[c] = fmaf(pr, vr[2 * c], acc[c]);
    }
  }

  l += __shfl_xor_sync(FULL, l, 1);
  if (q0 + r >= p.Sq) return;
  const float inv = l == 0.f ? 1.f : 1.f / l;
  float* og = static_cast<float*>(p.o) + ((size_t)bh * p.Sq + q0 + r) * D;
#pragma unroll
  for (int c = 0; c < HALF; ++c) og[2 * c + half] = acc[c] * inv;
  if (p.lse != nullptr && half == 0)
    p.lse[(size_t)bh * p.Sq + q0 + r] =
        m * LN2 + logf(l == 0.f ? 1.f : l);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The current device's SM count, asked of the runtime once per device.
int sm_count(int* sms) {
  static std::atomic<int> known[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  *sms = dev < 64 ? known[dev].load(std::memory_order_relaxed) : 0;
  if (*sms > 0) return 0;
  err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0 && dev < 64) known[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int sms = 0;
  int err = sm90::make_tmap_bf16(&tq, p.q, D, p.Sq, (uint64_t)B * p.H, BQ);
  if (err == 0)
    err = sm90::make_tmap_bf16(&tk, p.k, D, p.Sk, (uint64_t)B * p.Hkv, BK);
  if (err == 0)
    err = sm90::make_tmap_bf16(&tv, p.v, D, p.Sk, (uint64_t)B * p.Hkv, BK);
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  // Heads per group: the K/V of their KV heads within 16 MB of the 50 MB
  // L2, and whole GQA groups (query heads that share a KV head).
  const int group_q = p.H / p.Hkv;
  const size_t kv_head = (size_t)p.Sk * D * 2 * 2;
  const int kv_heads = (int)max((size_t)1, ((size_t)16 << 20) / kv_head);
  Params pg = p;
  pg.BH = B * p.H;
  pg.group = min(pg.BH, kv_heads * group_q);
  pg.total = ((p.Sq + BQ - 1) / BQ) * pg.BH;
  // Where the grid covers every tile, no block takes a second one and the
  // counter is neither needed nor touched.
  if (pg.total > sms) {
    if (p.counter == nullptr) return (int)cudaErrorInvalidValue;
    err = (int)cudaMemsetAsync(p.counter, 0, sizeof(int), st);
    if (err != 0) return err;
  }
  const dim3 grid(min(pg.total, sms));
  return launch(flash_fwd_wgmma_kernel<D>, grid, THREADS, Tiles<D>::SMEM, st,
                tq, tk, tv, pg);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `counter`: scratch for one int32 on
// the device, zeroed here on the stream: the persistent bf16 kernel's tile
// tickets.  Needed only where its query tiles, B * H * ceil(Sq / 128),
// outnumber the SMs; may be null elsewhere.  Returns 0 or a cudaError_t.
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int dtype, int B, int H, int Hkv, int Sq, int Sk,
                 int D, float scale, int causal, int q_offset, void* counter,
                 void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), H, Hkv, Sq, Sk,
           scale * LOG2E, causal, q_offset, B * H, 1, 0,
           static_cast<int*>(counter)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 128) return launch_bf16<128>(p, B, st);
    if (D == 64) return launch_bf16<64>(p, B, st);
    if (D == 32) return launch_bf16<32>(p, B, st);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (Sq + BQ32 - 1) / BQ32);
    const size_t smem = ((size_t)(BQ32 + BK32) * (D + 1) +
                         (size_t)BK32 * D + BQ32 * (BK32 + 1)) * 4;
    if (D == 128)
      return launch(flash_fwd_f32_kernel<128>, grid, THREADS32, smem, st, p);
    if (D == 64)
      return launch(flash_fwd_f32_kernel<64>, grid, THREADS32, smem, st, p);
    if (D == 32)
      return launch(flash_fwd_f32_kernel<32>, grid, THREADS32, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

// Test-only: one wgmma operand form on bf16 inputs (see
// flash_fwd_wgmma_check_kernel).  form 0: c[64, 128] = a[64, n] b[128, n]^T;
// form 1: c[64, n] = bf16(a32[64, 128]) b[128, n].  n in {64, 128}.
int rt_wgmma_check(int form, const void* a, const float* a32, const void* b,
                   float* c, int n, void* stream) {
  if ((form != 0 && form != 1) || (n != 64 && n != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = sm90::make_tmap_bf16(&tb, b, n, 128, 1, 128);
  if (err == 0)
    err = form == 0 ? sm90::make_tmap_bf16(&ta, a, n, 64, 1, 64)
                    : sm90::make_tmap_bf16(&ta, b, n, 128, 1, 128);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 1024 + (64 + 128) * 128 * 2;
  const dim3 grid(1);
  if (form == 0)
    return n == 64
        ? launch(flash_fwd_wgmma_check_kernel<0, 64>, grid, WG_THREADS, smem,
                 st, ta, tb, a32, c)
        : launch(flash_fwd_wgmma_check_kernel<0, 128>, grid, WG_THREADS,
                 smem, st, ta, tb, a32, c);
  return n == 64
      ? launch(flash_fwd_wgmma_check_kernel<1, 64>, grid, WG_THREADS, smem,
               st, ta, tb, a32, c)
      : launch(flash_fwd_wgmma_check_kernel<1, 128>, grid, WG_THREADS, smem,
               st, ta, tb, a32, c);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
