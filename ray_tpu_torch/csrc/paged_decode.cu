// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the ragged paged attention kernel of Pallas's TPU library
// (jax.experimental.pallas.ops.tpu.ragged_paged_attention) that
// ray_tpu/ops/paged_attention.py:_ragged_path calls on every decode step.
// One query token per sequence attends over the pages its block table names:
// q [B,H,D], kv_pages [NP,page,2*Hkv,D] with K at combined index 2*kvh and V
// at 2*kvh+1, block_table [B,P] int32, seq_lens [B] int32 counting the new
// token.  Scale 1/sqrt(D), GQA.  A slot with seq_len 0 (inactive) writes
// zeros, which are finite.  The spec is _exact_path
// (ray_tpu/ops/paged_attention.py:86-109).
//
// What bounds it on the H100: bytes.  Each live cached token is read once
// (2*D values per KV head) and used for 4*D flops per query head of its
// group, a handful of flops per byte against the ~295 at which the tensor
// cores would become the limit; so the floor is the live KV bytes over
// 3.35 TB/s.
//
// What the design does about it (a simple, correct first version):
// - One block of four warps per (slot b, KV head).  The block reads only the
//   pages covering positions [0, seq_len) through the block table, each K/V
//   row exactly once, and serves all `group` query heads of that KV head from
//   it, so GQA costs no extra bytes.
// - The lanes of a warp split the head dimension (D/32 contiguous values per
//   lane, one vector load per row), so a warp reads a 256-byte K or V row
//   coalesced; the warps take interleaved runs of 4 tokens, and each warp
//   issues its 4 tokens' loads before using any of them.
// - Scores reduce across the warp with shuffles; online softmax (m, l) and
//   the accumulators stay in fp32 registers; the four warps' partial states
//   merge once through shared memory at the end.
// Later work: split-K over pages (flash-decoding) so one long sequence
// spreads over several SMs, and cp.async/TMA prefetch of the next pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;  // tokens a warp loads before it computes
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// N contiguous values at p (aligned to N * sizeof(T)) -> fp32.
template <typename T, int N>
struct Vec;
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf16_lo(u); x[1] = bf16_hi(u);
  }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
};
template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                    const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int Hkv, int P, int page_size, float scale_log2) {
  constexpr int PL = D / 32;  // head-dim values per lane
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(seq_lens[b], P * page_size);  // the table's reach
  T* o = out + ((size_t)b * H + (size_t)kvh * G) * D;
  if (len <= 0) {  // inactive slot: finite zeros
    for (int i = threadIdx.x; i < G * D; i += THREADS) store(o + i, 0.f);
    return;
  }

  // The group's query rows, prescaled into the log2 domain.
  float qv[G][PL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    Vec<T, PL>::load(q + ((size_t)b * H + (size_t)kvh * G + gi) * D +
                         lane * PL, qv[gi]);
#pragma unroll
    for (int e = 0; e < PL; ++e) qv[gi][e] *= scale_log2;
  }
  float m[G], l[G], acc[G][PL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < PL; ++e) acc[gi][e] = 0.f;
  }

  const int* bt = block_table + (size_t)b * P;
  const size_t tok_stride = (size_t)2 * Hkv * D;  // one token, all heads
  const T* kv_head = kv + (size_t)(2 * kvh) * D + lane * PL;
  for (int base = warp * UNROLL; base < len; base += WARPS * UNROLL) {
    float kx[UNROLL][PL], vx[UNROLL][PL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = base + u;
      if (pos < len) {
        const int page = bt[pos / page_size];
        const T* row =
            kv_head + ((size_t)page * page_size + pos % page_size) * tok_stride;
        Vec<T, PL>::load(row, kx[u]);
        Vec<T, PL>::load(row + D, vx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= len) break;  // uniform across the warp
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < PL; ++e) s = fmaf(qv[gi][e], kx[u][e], s);
        s = warp_sum(s);
        const float mn = fmaxf(m[gi], s);
        const float alpha = exp2f(m[gi] - mn);
        const float pr = exp2f(s - mn);
        l[gi] = l[gi] * alpha + pr;
#pragma unroll
        for (int e = 0; e < PL; ++e)
          acc[gi][e] = fmaf(pr, vx[u][e], acc[gi][e] * alpha);
        m[gi] = mn;
      }
    }
  }

  // Merge the four warps' partial softmax states.
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < PL; ++e) sm_acc[warp][gi][lane * PL + e] = acc[gi][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sm_m[w][gi] - mx);  // 0 for a warp with no token
      lsum = fmaf(sm_l[w][gi], f, lsum);
      osum = fmaf(sm_acc[w][gi][d], f, osum);
    }
    store(o + i, osum / lsum);
  }
}

template <typename T, int D>
int launch_group(int G, dim3 grid, cudaStream_t st, const T* q, const T* kv,
                 const int* bt, const int* sl, T* out, int H, int Hkv, int P,
                 int page_size, float scale_log2) {
  switch (G) {
    case 1:
      paged_decode_kernel<T, D, 1><<<grid, THREADS, 0, st>>>(
          q, kv, bt, sl, out, H, Hkv, P, page_size, scale_log2);
      break;
    case 2:
      paged_decode_kernel<T, D, 2><<<grid, THREADS, 0, st>>>(
          q, kv, bt, sl, out, H, Hkv, P, page_size, scale_log2);
      break;
    case 4:
      paged_decode_kernel<T, D, 4><<<grid, THREADS, 0, st>>>(
          q, kv, bt, sl, out, H, Hkv, P, page_size, scale_log2);
      break;
    case 8:
      paged_decode_kernel<T, D, 8><<<grid, THREADS, 0, st>>>(
          q, kv, bt, sl, out, H, Hkv, P, page_size, scale_log2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(int D, int G, dim3 grid, cudaStream_t st, const void* q,
                 const void* kv, const int* bt, const int* sl, void* out,
                 int H, int Hkv, int P, int page_size, float scale_log2) {
  const T* qt = static_cast<const T*>(q);
  const T* kvt = static_cast<const T*>(kv);
  T* ot = static_cast<T*>(out);
  if (D == 128)
    return launch_group<T, 128>(G, grid, st, qt, kvt, bt, sl, ot, H, Hkv, P,
                                page_size, scale_log2);
  if (D == 64)
    return launch_group<T, 64>(G, grid, st, qt, kvt, bt, sl, ot, H, Hkv, P,
                               page_size, scale_log2);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a cudaError_t.
int rt_paged_decode(const void* q, const void* kv_pages,
                    const void* block_table, const void* seq_lens, void* out,
                    int dtype, int B, int H, int Hkv, int D, int P,
                    int page_size, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  const float scale_log2 = scale * LOG2E;
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(D, H / Hkv, grid, st, q, kv_pages, bt,
                                       sl, out, H, Hkv, P, page_size,
                                       scale_log2);
  if (dtype == 0)
    return launch_dtype<float>(D, H / Hkv, grid, st, q, kv_pages, bt, sl,
                               out, H, Hkv, P, page_size, scale_log2);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
