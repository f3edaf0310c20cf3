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
// 4*D flops against 2*D bytes of K/V that a whole 64-row query tile shares,
// so above a few hundred keys the tensor cores (989 TFLOP/s bf16) are the
// limit, not the 3.35 TB/s of device memory.  The softmax exponentials run on
// the CUDA cores beside them.
//
// What the design does about it (a simple, correct first version):
// - One block of four warps per (b*h, 64-row query tile); each warp owns 16
//   query rows.  The TPU grid's sequential K/V axis becomes a loop inside the
//   block that streams 64-key K and V tiles through shared memory, so the
//   [Sq, Sk] score matrix never exists in device memory.
// - bf16: both products run on the tensor cores with mma.sync m16n8k16
//   (fp32 accumulate).  Q fragments stay in registers for the whole loop;
//   the score accumulators are re-packed in registers as the A operand of
//   P*V (the FlashAttention-2 register reuse), so P never touches shared
//   memory.  Shared-memory rows are padded by 16 bytes, which makes every
//   fragment load conflict-free.
// - fp32: full-precision FMA on the CUDA cores (no TF32), so fp32 callers
//   get the reference's numbers; two threads per query row.
// - Online softmax (running max m, partial row sums l) and the O accumulator
//   stay in fp32 registers; exponentials are exp2 of log2e-prescaled scores.
// - Causal: the key loop stops at the last tile the tile's diagonal
//   (shifted by q_offset) reaches, so tiles above it cost nothing.  Keys past
//   Sk and query rows past Sq are masked, so any Sq and Sk work.
// Later work: wgmma with TMA-fed multi-stage K/V buffers, and ldmatrix for V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // four warps
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
};

// Number of K/V tiles block row q0 must visit: all of them, or (causal) up
// to the one holding the key on the diagonal of the tile's last query row.
__device__ __forceinline__ int tile_count(const Params& p, int q0) {
  int kend = p.Sk;
  if (p.causal) {
    const int last_q = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
    kend = min(kend, last_q + 1);
  }
  return kend <= 0 ? 0 : (kend + BK - 1) / BK;
}

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// rows x D bf16 tile from global (row-major, stride D) into shared memory
// (row stride D + 8); rows >= rows_valid become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + 8;   // padded shared-memory row, in elements
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = ((size_t)b * p.Hkv + kvh) * p.Sk * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kv_base;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kv_base;

  load_tile<D>(Qs, qg, min(BQ, p.Sq - q0));
  __syncthreads();

  // This thread's rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* base = Qs + kk * 16 + 2 * t;
    qf[kk][0] = ld32(base + r0 * LD);
    qf[kk][1] = ld32(base + (r0 + 8) * LD);
    qf[kk][2] = ld32(base + r0 * LD + 8);
    qf[kk][3] = ld32(base + (r0 + 8) * LD + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  const int qpos[2] = {q0 + r0 + p.q_offset, q0 + r0 + 8 + p.q_offset};

  const int n_tiles = tile_count(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kg + (size_t)k0 * D, min(BK, p.Sk - k0));
    load_tile<D>(Vs, vg + (size_t)k0 * D, min(BK, p.Sk - k0));
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n8 tiles).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = Ks + (8 * j + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma16816(s[j], qf[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }

    // Scale into the log2 domain and mask (ragged edge, causal diagonal).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e >> 1;
        const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos[row]);
        s[j][e] = ok ? s[j][e] * p.scale_log2 : -INFINITY;
        mx[row] = fmaxf(mx[row], s[j][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // all masked so far
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - base[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V: P's accumulators, packed to bf16, are the A fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const __nv_bfloat16* c = vb + nd * 8;
        mma16816(o[nd], pa, pack_bf16(c[0], c[LD]),
                 pack_bf16(c[8 * LD], c[9 * LD]));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      ((size_t)bh * p.Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (q0 + r >= p.Sq) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<uint32_t*>(og + (size_t)r * D + nd * 8 + 2 * t) =
          pack_f32(o[nd][2 * i] * inv[i], o[nd][2 * i + 1] * inv[i]);
    }
    if (p.lse != nullptr && t == 0)
      p.lse[(size_t)bh * p.Sq + q0 + r] =
          m[i] * LN2 + logf(l[i] == 0.f ? 1.f : l[i]);
  }
}

// ---------------------------------------------------------------- fp32 path

// Two threads per query row: thread (r = tid/2, half = tid%2) scores keys
// 2*jj + half of each tile and owns output columns 2*cc + half.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(Params p) {
  constexpr int LDQ = D + 1;   // padded rows: conflict-free row-wise reads
  constexpr int LDP = BK + 1;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const float* qg = static_cast<const float*>(p.q) +
                    ((size_t)bh * p.Sq + q0) * D;
  const size_t kv_base = ((size_t)b * p.Hkv + kvh) * p.Sk * D;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;

  const int q_rows = min(BQ, p.Sq - q0);
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    Qs[rr * LDQ + d] = rr < q_rows ? qg[(size_t)rr * D + d] : 0.f;
  }

  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = q0 + r + p.q_offset;

  const int n_tiles = tile_count(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int k_rows = min(BK, p.Sk - k0);
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const bool ok = rr < k_rows;
      Ks[rr * LDQ + d] = ok ? kg[(size_t)(k0 + rr) * D + d] : 0.f;
      Vs[rr * D + d] = ok ? vg[(size_t)(k0 + rr) * D + d] : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
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
    for (int jj = 0; jj < BK / 2; ++jj) {
      const float pr = exp2f(s[jj] - base);
      rs += pr;
      Ps[r * LDP + 2 * jj + half] = pr;
    }
    l = l * alpha + rs;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
    __syncwarp();  // the row's two threads share one warp
    for (int j = 0; j < BK; ++j) {
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

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a cudaError_t.
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int dtype, int B, int H, int Hkv, int Sq, int Sk,
                 int D, float scale, int causal, int q_offset, void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), H, Hkv, Sq, Sk,
           scale * LOG2E, causal, q_offset};
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t smem = (size_t)(BQ + 2 * BK) * (D + 8) * 2;
    if (D == 128) return launch(flash_fwd_bf16_kernel<128>, grid, smem, st, p);
    if (D == 64) return launch(flash_fwd_bf16_kernel<64>, grid, smem, st, p);
  } else if (dtype == 0) {
    const size_t smem =
        ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * D + BQ * (BK + 1)) * 4;
    if (D == 128) return launch(flash_fwd_f32_kernel<128>, grid, smem, st, p);
    if (D == 64) return launch(flash_fwd_f32_kernel<64>, grid, smem, st, p);
  }
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
