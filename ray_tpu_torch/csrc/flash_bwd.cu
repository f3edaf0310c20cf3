// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: ray_tpu/ops/attention.py:_dq_kernel and :_dkv_kernel (the Pallas
// TPU kernels driven by _flash_backward, tied to the forward by
// _flash.defvjp).  Given q [B,H,Sq,D], k/v [B,Hkv,Sk,D], dO [B,H,Sq,D], the
// forward's fp32 LSE [B,H,Sq] and delta = rowsum(dO * O) [B,H,Sq] (fp32,
// computed outside as the JAX code does), it recomputes
//   P  = exp(Q K^T * scale - LSE)        (causal mask shifted by q_offset)
//   dS = P * (dO V^T - delta) * scale
// and writes dQ = dS K (dq kernel), dV = P^T dO and dK = dS^T Q (dk/dv
// kernel).  Query head h reads KV head h / (H/Hkv).
//
// What bounds it on the H100: operations.  Per (query, key) pair the dq
// kernel does three D-deep products (S, dP, dS K) and the dk/dv kernel four
// (S, dP, P^T dO, dS^T Q), against 2*D bytes of K/V or Q/dO that a whole
// 64-row tile shares, so above a few hundred keys the tensor cores (989
// TFLOP/s bf16) are the limit, not the 3.35 TB/s of device memory.
//
// What the design does about it (a simple, correct first version):
// - One block of eight warps per 64x64 (query, key) tile step.  The TPU
//   grid's sequential axis becomes a loop inside the block: the dq block
//   keeps its 64 query rows (Q, dO, LSE, delta) in shared memory and streams
//   64-key K/V tiles; the dk/dv block keeps its 64 keys (K, V) and streams
//   the query tiles of every query head of its KV group.
// - Both kernels share one tile step (tile_p_ds): each warp computes a 16x32
//   piece of S and dP with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
//   forms P and dS in fp32 registers and stages them in shared memory as
//   bf16 [query][key].  The second products read them back with ldmatrix:
//   .trans gives P^T and dS^T as A operands with no scalar transposes, and
//   the row-major [row][d] tiles of K, Q and dO as B operands.  Staging P
//   and dS also splits the 64xD accumulators over all eight warps (16 rows
//   by D/2 columns each), so dK and dV together hold 64 fp32 registers a
//   thread at D = 128 instead of spilling.
// - GQA is summed in the kernel: the dk/dv block loops over the group's
//   query heads and accumulates dK and dV across them in fp32 registers,
//   then writes them once in k's dtype (the TPU code writes per query head
//   and group-sums outside).  No atomics, so the result is deterministic.
// - Causal: the dq block stops at the last key tile its diagonal (shifted by
//   q_offset) reaches; the dk/dv block starts at the first query tile that
//   sees its first key.  Tiles above the diagonal cost nothing.  Keys past
//   Sk and queries past Sq are masked, so any Sq and Sk work.  P is set to
//   zero wherever masked, so a row whose forward had l == 0 (LSE = -inf)
//   never reaches the exponential.
// - fp32: full-precision FMA on the CUDA cores (no TF32) with the same tile
//   loop, so fp32 callers get the reference's numbers.
// Later work: wgmma with TMA-fed multi-stage buffers, and one fused kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // eight warps
constexpr int LDP = BK + 8;   // padded row of the bf16 P / dS tiles
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Sq], natural log
  const float* delta;  // [B*H, Sq]
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk;
  float scale;
  int causal;
  int q_offset;
};

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

// ---------------------------------------------------------------- bf16 path

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l names row (l & 7) of
// matrix (l >> 3).  Register i holds matrix i's (row g, cols 2t..2t+1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: register i holds matrix i's (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 x D bf16 tile from global (row-major, stride D) into shared memory
// (row stride D + 8); rows >= rows_valid become zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows_valid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
  for (int c = threadIdx.x; c < 64 * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// One 64x64 (query, key) tile: P (if WRITE_P) and dS into shared memory as
// bf16 [query][key].  Warp w computes query rows 16*(w&3).. and keys
// 32*(w>>2).. of S = Q K^T and dP = dO V^T.  lse_s holds LSE * log2(e).
template <int D, bool WRITE_P>
__device__ __forceinline__ void tile_p_ds(const Params& p, const bf16* Qs,
                                          const bf16* dOs, const bf16* Ks,
                                          const bf16* Vs, const float* lse_s,
                                          const float* delta_s, bf16* Ps,
                                          bf16* dSs, int q0, int k0) {
  constexpr int LD = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int li = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  const int mr = (warp & 3) * 16, nc = (warp >> 2) * 32;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4], da[4];
    const int a_off = (mr + lr + 8 * (li & 1)) * LD + kk * 16 + 8 * (li >> 1);
    ldsm_x4(qa, Qs + a_off);
    ldsm_x4(da, dOs + a_off);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t kb[4], vb[4];
      const int b_off =
          (nc + 16 * jj + lr + 8 * (li >> 1)) * LD + kk * 16 + 8 * (li & 1);
      ldsm_x4(kb, Ks + b_off);
      ldsm_x4(vb, Vs + b_off);
      mma16816(s[2 * jj], qa, kb[0], kb[1]);
      mma16816(s[2 * jj + 1], qa, kb[2], kb[3]);
      mma16816(dp[2 * jj], da, vb[0], vb[1]);
      mma16816(dp[2 * jj + 1], da, vb[2], vb[3]);
    }
  }

  const float scale_log2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = mr + g + 8 * i;
    const bool row_ok = q0 + r < p.Sq;
    const float lse2 = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = nc + 8 * j + 2 * t;
      float pr[2], ds[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = row_ok && visible(p, q0 + r, k0 + c + h);
        pr[h] = ok ? exp2f(s[j][2 * i + h] * scale_log2 - lse2) : 0.f;
        ds[h] = pr[h] * (dp[j][2 * i + h] - dl) * p.scale;
      }
      if (WRITE_P)
        *reinterpret_cast<uint32_t*>(Ps + r * LDP + c) = pack_f32(pr[0], pr[1]);
      *reinterpret_cast<uint32_t*>(dSs + r * LDP + c) = pack_f32(ds[0], ds[1]);
    }
  }
}

// Write a warp's 16 x D/2 fp32 accumulators (rows m0.., cols dc..) as bf16
// rows of dst (stride D); rows >= rows_valid are skipped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (*acc)[4],
                                          int m0, int dc, int rows_valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + g + 8 * i;
    if (r >= rows_valid) continue;
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * D + dc + 8 * n + 2 * t) =
          pack_f32(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  constexpr int NH = D / 16;  // n8 tiles in a warp's D/2 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  bf16* dSs = Vs + BK * LD;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDP);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane >> 3, lr = lane & 7;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t q_base = ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = ((size_t)b * p.Hkv + kvh) * p.Sk * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_base;

  const int q_rows = min(BQ, p.Sq - q0);
  load_tile<D>(Qs, static_cast<const bf16*>(p.q) + q_base, q_rows);
  load_tile<D>(dOs, static_cast<const bf16*>(p.dout) + q_base, q_rows);
  load_rows(lse_s, delta_s, p, bh, q0, LOG2E);

  const int m0 = (warp & 3) * 16, dc = (warp >> 2) * (D / 2);
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = key_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V and dS
    load_tile<D>(Ks, kg + (size_t)k0 * D, min(BK, p.Sk - k0));
    load_tile<D>(Vs, vg + (size_t)k0 * D, min(BK, p.Sk - k0));
    __syncthreads();
    tile_p_ds<D, false>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0,
                        k0);
    __syncthreads();
    // dQ[16 rows, D/2 cols] += dS[16 rows, 64 keys] K[64 keys, D/2 cols]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a,
              dSs + (m0 + lr + 8 * (li & 1)) * LDP + kk * 16 + 8 * (li >> 1));
#pragma unroll
      for (int np = 0; np < NH / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Ks + (kk * 16 + lr + 8 * (li & 1)) * LD + dc + 16 * np +
                          8 * (li >> 1));
        mma16816(acc[2 * np], a, kb[0], kb[1]);
        mma16816(acc[2 * np + 1], a, kb[2], kb[3]);
      }
    }
  }
  store_acc<D>(static_cast<bf16*>(p.dq) + q_base, acc, m0, dc, q_rows);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  constexpr int NH = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQ * LD;
  bf16* Ps = dOs + BQ * LD;
  bf16* dSs = Ps + BQ * LDP;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDP);
  float* delta_s = lse_s + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane >> 3, lr = lane & 7;
  const int bkv = blockIdx.x;  // b * Hkv + kvh
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int k_rows = min(BK, p.Sk - k0);
  const size_t kv_base = ((size_t)bkv * p.Sk + k0) * D;
  load_tile<D>(Ks, static_cast<const bf16*>(p.k) + kv_base, k_rows);
  load_tile<D>(Vs, static_cast<const bf16*>(p.v) + kv_base, k_rows);

  const int m0 = (warp & 3) * 16, dc = (warp >> 2) * (D / 2);
  float dk[NH][4], dv[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int qt0 = first_query_tile(p, k0);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  for (int hg = 0; hg < group; ++hg) {
    const int bh = b * p.H + kvh * group + hg;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      const size_t q_base = ((size_t)bh * p.Sq + q0) * D;
      const int q_rows = min(BQ, p.Sq - q0);
      __syncthreads();  // every warp is done with the previous Q/dO, P, dS
      load_tile<D>(Qs, static_cast<const bf16*>(p.q) + q_base, q_rows);
      load_tile<D>(dOs, static_cast<const bf16*>(p.dout) + q_base, q_rows);
      load_rows(lse_s, delta_s, p, bh, q0, LOG2E);
      __syncthreads();
      tile_p_ds<D, true>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0);
      __syncthreads();
      // dV[16 keys, D/2] += P^T[16 keys, 64 q] dO[64 q, D/2]
      // dK[16 keys, D/2] += dS^T[16 keys, 64 q] Q[64 q, D/2]
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t pa[4], sa[4];
        const int a_off =
            (kq * 16 + lr + 8 * (li >> 1)) * LDP + m0 + 8 * (li & 1);
        ldsm_x4_t(pa, Ps + a_off);
        ldsm_x4_t(sa, dSs + a_off);
#pragma unroll
        for (int np = 0; np < NH / 2; ++np) {
          uint32_t ob[4], qb[4];
          const int b_off =
              (kq * 16 + lr + 8 * (li & 1)) * LD + dc + 16 * np + 8 * (li >> 1);
          ldsm_x4_t(ob, dOs + b_off);
          ldsm_x4_t(qb, Qs + b_off);
          mma16816(dv[2 * np], pa, ob[0], ob[1]);
          mma16816(dv[2 * np + 1], pa, ob[2], ob[3]);
          mma16816(dk[2 * np], sa, qb[0], qb[1]);
          mma16816(dk[2 * np + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }
  store_acc<D>(static_cast<bf16*>(p.dk) + kv_base, dk, m0, dc, k_rows);
  store_acc<D>(static_cast<bf16*>(p.dv) + kv_base, dv, m0, dc, k_rows);
}

// ---------------------------------------------------------------- fp32 path

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

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

size_t smem_bf16(int D, int n_pds) {
  return (size_t)4 * 64 * (D + 8) * 2 + (size_t)n_pds * 64 * LDP * 2 +
         2 * BQ * sizeof(float);
}

size_t smem_f32(int D, int n_pds) {
  return ((size_t)4 * 64 * (D + 1) + (size_t)n_pds * 64 * (BK + 1) + 2 * BQ) *
         sizeof(float);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a cudaError_t.
// dq [B,H,Sq,D] in q's dtype.
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int dtype, int B, int H, int Hkv, int Sq, int Sk,
                    int D, float scale, int causal, int q_offset,
                    void* stream) {
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, H, Hkv, Sq, Sk,
           scale, causal, q_offset};
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t smem = smem_bf16(D, 1);
    if (D == 128)
      return launch(flash_bwd_dq_bf16_kernel<128>, grid, smem, st, p);
    if (D == 64)
      return launch(flash_bwd_dq_bf16_kernel<64>, grid, smem, st, p);
  } else if (dtype == 0) {
    const size_t smem = smem_f32(D, 1);
    if (D == 128)
      return launch(flash_bwd_dq_f32_kernel<128>, grid, smem, st, p);
    if (D == 64)
      return launch(flash_bwd_dq_f32_kernel<64>, grid, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

// dk, dv [B,Hkv,Sk,D] in k's dtype, summed over each KV head's query heads.
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int dtype, int B, int H, int Hkv,
                     int Sq, int Sk, int D, float scale, int causal,
                     int q_offset, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, H, Hkv, Sq, Sk,
           scale, causal, q_offset};
  const dim3 grid(B * Hkv, (Sk + BK - 1) / BK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t smem = smem_bf16(D, 2);
    if (D == 128)
      return launch(flash_bwd_dkv_bf16_kernel<128>, grid, smem, st, p);
    if (D == 64)
      return launch(flash_bwd_dkv_bf16_kernel<64>, grid, smem, st, p);
  } else if (dtype == 0) {
    const size_t smem = smem_f32(D, 2);
    if (D == 128)
      return launch(flash_bwd_dkv_f32_kernel<128>, grid, smem, st, p);
    if (D == 64)
      return launch(flash_bwd_dkv_f32_kernel<64>, grid, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
