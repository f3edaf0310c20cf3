// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the ragged paged attention kernel of Pallas's TPU library
// (jax.experimental.pallas.ops.tpu.ragged_paged_attention) that
// ray_tpu/ops/paged_attention.py:_ragged_path calls on every decode step.
// One query token per sequence attends over the pages its block table names:
// q [B,H,D], kv_pages [NP,page,2*Hkv,D] with K at combined index 2*kvh and V
// at 2*kvh+1, block_table [B,P] int32, seq_lens [B] int32 counting the new
// token.  Scale 1/sqrt(D), GQA; the reach is capped at P*page.  A slot with
// seq_len 0 (inactive) writes zeros, which are finite.  The spec is
// _exact_path (ray_tpu/ops/paged_attention.py:86-109); the split-and-merge
// it does is _split_path (ray_tpu_torch/ops/paged_attention.py).
//
// What bounds it on the H100: bytes.  Each live cached token is read once
// (2*D values per KV head) and used for 4*D flops per query head of its
// group, G flops per byte against the ~295 at which the tensor cores would
// become the limit; so the floor is the live KV bytes over 3.35 TB/s, and
// the work is to keep enough of those bytes in flight on every SM.
//
// What the design does about it:
// - Split-K over the live pages (flash-decoding).  The grid is
//   (splits, Hkv, B); the host picks `splits` from shapes alone
//   (decode_splits in ops/paged_attention.py).  Each block works out its
//   page-aligned range from seq_lens[b] on the device: the slot's live
//   pages n_live are cut into runs of pps = max(MIN_PAGES_PER_SPLIT,
//   ceil(n_live / splits)) pages, and split s takes run s.  A block whose
//   run is empty exits at once and is never merged: every block of the
//   slot computes the same number of non-empty runs, so the merge waits
//   for exactly those.  Short sequences at a wide table (P = 128, ~24 live
//   pages) therefore cost nothing for the table's dead width.
// - The block table read once: each block copies its run of the table into
//   shared memory before any K/V load, so no load waits on another.
// - Pages streamed into shared memory by bulk async copies
//   (cp.async.bulk ... mbarrier::complete_tx, no tensor map, so nothing is
//   encoded on the host per call).  One token's K and V of one KV head are
//   2*D contiguous values (512 bytes at D 128 bf16): one copy each, issued
//   by one lane.  Each of the four warps owns a ring of STAGES stages of
//   CHUNK = 16 tokens (one page at page 16) and takes every fourth chunk of
//   the block's run, so a warp waits on its own barriers only and the
//   warps never synchronise until the end.
// - Arithmetic on CUDA cores (at G <= 8 the tensor cores bring nothing).
//   Lanes lie over tokens and over D: 8 lanes a token (16 at G*D >= 1024,
//   to keep q and the accumulators in registers; 4 at D 32 bf16, whose row
//   is four 16-byte vectors), so a warp reads 4 (2, 8) tokens at once,
//   each lane 16-byte vectors laid so that a quarter warp reads 128
//   contiguous bytes, and the QK^T sum takes 3 (4, 2) shuffles.  The
//   online softmax (fp32 m, l, acc in the log2 domain) is rescaled once per
//   chunk, not once per token (twice a chunk at 16 lanes a token, to bound
//   the registers of the chunk's scores).
// - One launch a call, a deterministic merge.  With one non-empty run the
//   block writes the output itself.  Otherwise each block writes its fp32
//   partial (m, l, acc) to a workspace, and the last block of the (slot, KV
//   head) to arrive (an arrival counter, __threadfence before atomicAdd)
//   merges the partials in split order and resets the counter to 0 for the
//   next call.  The wrapper allocates one workspace per (device, stream)
//   with zeros, at the split rule's largest layout (ws_blocks =
//   BLOCKS_PER_SM * SMs split blocks: ws_blocks / 2 counters, then
//   ws_blocks partials), and never frees it, so a captured CUDA graph
//   keeps a live address; calls on one stream run in order, and calls in
//   flight on two streams never share counters.  Decode is host-bound, so a call does little on the host:
//   what depends on shapes alone (checks, split count, workspace, the
//   shared-memory opt-in) is prepared once per (device, shape) into a
//   struct Launch (rt_paged_decode_prepare), and a call passes its address
//   with the tensors and the stream, seven arguments.
// Later work: mma.sync m16n8k16 for G = 8 (~40% of the fp32 FMA rate at
// full bandwidth on CUDA cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 16;   // tokens in one ring stage
constexpr int STAGES = 2;   // ring stages of each warp
// A split takes at least this many pages of its slot, and at most
// MAX_SPLITS splits share a slot (the constants of ops/paged_attention.py,
// which tests/test_torch_build.py holds to these).
constexpr int MIN_PAGES_PER_SPLIT = 2;
constexpr int MAX_SPLITS = 32;
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D, int G>
struct Cfg {
  // Lanes a token: 16 at G*D >= 1024, else 8, but never more than a
  // token's row has 16-byte vectors (4 at D 32 bf16: 64 bytes a row).
  static constexpr int LPT_WANT = G * D >= 1024 ? 16 : 8;
  static constexpr int LPT_ROW = D * (int)sizeof(T) / 16;
  static constexpr int LPT = LPT_WANT < LPT_ROW ? LPT_WANT : LPT_ROW;
  static constexpr int TPW = 32 / LPT;                 // tokens a warp step
  static constexpr int E = 16 / (int)sizeof(T);        // values a vector
  static constexpr int VPL = D / LPT;                  // values a lane
  static constexpr int NV = VPL / E;                   // vectors a lane
  static constexpr int IT = CHUNK / TPW;               // steps a chunk
  static constexpr int ITS = IT < 4 ? IT : 4;          // steps a rescale
  static constexpr int ROW = 2 * D * (int)sizeof(T);   // one token's K, V
  static constexpr int RING = WARPS * STAGES * CHUNK * ROW;
  static_assert(NV >= 1 && IT % ITS == 0, "paged_decode: layout");
  // The end-of-block merges reuse the ring.
  static_assert(WARPS * G * (D + 2) * 4 <= RING &&
                    2 * MAX_SPLITS * G * 4 <= RING,
                "paged_decode: merge");
};

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// 16 bytes at p (16-byte aligned) -> fp32.
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
    x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
    x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
  }
};
template <>
struct Vec16<float> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A lane's values of one D-vector: vector v holds the values
// [(v * LPT + li) * E, +E), li = lane % LPT.
template <typename C, typename T>
__device__ __forceinline__ void load_row(const T* row, int li, float* x) {
#pragma unroll
  for (int v = 0; v < C::NV; ++v)
    Vec16<T>::load(row + (v * C::LPT + li) * C::E, x + v * C::E);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                          const int* __restrict__ block_table,
                          const int* __restrict__ seq_lens,
                          T* __restrict__ out, float* __restrict__ ws,
                          int ws_blocks, int H, int Hkv, int P,
                          int page_size, int splits, float scale_log2) {
  using C = Cfg<T, D, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sm_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(seq_lens[b], P * page_size);  // the table's reach
  const int n_live = len > 0 ? (len + page_size - 1) / page_size : 0;
  const int pps = max(MIN_PAGES_PER_SPLIT, (n_live + splits - 1) / splits);
  const int n_active = (n_live + pps - 1) / pps;  // non-empty runs
  T* o = out + ((size_t)b * H + (size_t)kvh * G) * D;
  if (n_active == 0) {  // inactive slot: finite zeros
    if (split == 0)
      for (int i = tid; i < G * D; i += THREADS) store(o + i, 0.f);
    return;
  }
  if (split >= n_active) return;  // an empty run: nothing to merge
  const int page_lo = split * pps;
  const int page_hi = min(n_live, page_lo + pps);
  const int tok_lo = page_lo * page_size;
  const int tok_hi = min(len, page_hi * page_size);
  const int n_chunks = (tok_hi - tok_lo + CHUNK - 1) / CHUNK;

  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::RING);
  int* table = reinterpret_cast<int*>(smem + C::RING + WARPS * STAGES * 8);
  const int* bt = block_table + (size_t)b * P;
  for (int i = tid; i < page_hi - page_lo; i += THREADS)
    table[i] = bt[page_lo + i];
  if (tid < WARPS * STAGES) {
    sm90::mbar_init(sm90::smem_u32(bars + tid), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const size_t tok_stride = (size_t)2 * Hkv * D;  // one token, all heads
  const T* kv_head = kv + (size_t)(2 * kvh) * D;
  // Chunk c of the run into this warp's stage st: lane 0 arms the barrier
  // with the bytes, lanes 0..n-1 copy one token's K and V each.
  auto issue = [&](int c, int st) {
    const int tok0 = tok_lo + c * CHUNK;
    const int n = min(CHUNK, tok_hi - tok0);
    const uint32_t bar = sm90::smem_u32(bars + warp * STAGES + st);
    if (lane == 0) sm90::mbar_arrive_expect_tx(bar, n * C::ROW);
    __syncwarp();
    if (lane < n) {
      const int pos = tok0 + lane;
      const int pg = table[pos / page_size - page_lo];
      const T* src =
          kv_head + ((size_t)pg * page_size + pos % page_size) * tok_stride;
      T* dst = ring + ((size_t)(warp * STAGES + st) * CHUNK + lane) * 2 * D;
      sm90::bulk_g2s(sm90::smem_u32(dst), src, C::ROW, bar);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    if (warp + st * WARPS < n_chunks) issue(warp + st * WARPS, st);

  // The group's query rows, prescaled into the log2 domain.
  const int li = lane % C::LPT, grp = lane / C::LPT;
  float qv[G][C::VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<C>(q + ((size_t)b * H + (size_t)kvh * G + g) * D, li, qv[g]);
#pragma unroll
    for (int e = 0; e < C::VPL; ++e) qv[g][e] *= scale_log2;
  }
  float m[G], l[G], acc[G][C::VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::VPL; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0;; ++j) {
    const int c = warp + j * WARPS;
    if (c >= n_chunks) break;
    const int st = j % STAGES;
    const int n = min(CHUNK, tok_hi - (tok_lo + c * CHUNK));
    sm90::mbar_wait(sm90::smem_u32(bars + warp * STAGES + st),
                    (j / STAGES) & 1);
    const T* rows = ring + (size_t)(warp * STAGES + st) * CHUNK * 2 * D;
#pragma unroll
    for (int h = 0; h < C::IT; h += C::ITS) {
      // Scores of ITS steps (tokens h*TPW .. (h+ITS)*TPW - 1), then one
      // rescale, then P.V.  Rows past n hold stale bytes: their scores
      // are replaced by -inf and their V is never read.
      float s[G][C::ITS];
#pragma unroll
      for (int i = 0; i < C::ITS; ++i) {
        const int t = (h + i) * C::TPW + grp;
        float kx[C::VPL];
        load_row<C>(rows + (size_t)t * 2 * D, li, kx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < C::VPL; ++e) dot = fmaf(qv[g][e], kx[e], dot);
#pragma unroll
          for (int off = 1; off < C::LPT; off <<= 1)
            dot += __shfl_xor_sync(FULL, dot, off);
          s[g][i] = t < n ? dot : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mc = s[g][0];
#pragma unroll
        for (int i = 1; i < C::ITS; ++i) mc = fmaxf(mc, s[g][i]);
#pragma unroll
        for (int off = C::LPT; off < 32; off <<= 1)
          mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
        // The warp's first chunk has a live token in its first step, so m
        // is finite from there on; a step wholly past n leaves it as is.
        const float mn = fmaxf(m[g], mc);
        const float alpha = exp2f(m[g] - mn);
        m[g] = mn;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < C::VPL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < C::ITS; ++i) {
        const int t = (h + i) * C::TPW + grp;
        if (t < n) {
          float vx[C::VPL];
          load_row<C>(rows + (size_t)t * 2 * D + D, li, vx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = exp2f(s[g][i] - m[g]);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < C::VPL; ++e)
              acc[g][e] = fmaf(p, vx[e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();
    const int next = c + STAGES * WARPS;
    if (next < n_chunks) {
      sm90::fence_proxy_async();  // the stage's reads before its refill
      issue(next, st);
    }
  }

  // The warp's token groups share m: sum their l and acc.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = C::LPT; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < C::VPL; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
  }
  // Then the four warps' states, through shared memory (the ring: every
  // copy issued has been waited for).
  __syncthreads();
  float* sm_ml = reinterpret_cast<float*>(smem);  // [WARPS][G][2]
  float* sm_acc = sm_ml + WARPS * G * 2;           // [WARPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_ml[(warp * G + g) * 2] = m[g];
      sm_ml[(warp * G + g) * 2 + 1] = l[g];
    }
    if (grp == 0) {
#pragma unroll
      for (int v = 0; v < C::NV; ++v)
#pragma unroll
        for (int e = 0; e < C::E; ++e)
          sm_acc[(warp * G + g) * D + (v * C::LPT + li) * C::E + e] =
              acc[g][v * C::E + e];
    }
  }
  __syncthreads();

  // The workspace: ws_blocks / 2 arrival counters, one per (slot, KV
  // head), then the fp32 partials [B, Hkv, splits, G * (D + 2)].  Counters
  // and partials never share words, so whatever shape used the workspace
  // before, a call finds its counters at 0.
  int* counter = reinterpret_cast<int*>(ws) + b * Hkv + kvh;
  const size_t part_floats = (size_t)G * (D + 2);
  float* part = ws + ws_blocks / 2 +
                ((size_t)(b * Hkv + kvh) * splits) * part_floats;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_ml[(w * G + g) * 2]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // 0 for a warp that had no chunk (m = -inf).
      const float f = exp2f(sm_ml[(w * G + g) * 2] - mx);
      lsum = fmaf(sm_ml[(w * G + g) * 2 + 1], f, lsum);
      osum = fmaf(sm_acc[(w * G + g) * D + i % D], f, osum);
    }
    if (n_active == 1) {
      store(o + i, osum / lsum);
    } else {
      float* mine = part + (size_t)split * part_floats;
      mine[i] = osum;
      if (i % D == 0) {
        mine[G * D + 2 * g] = mx;
        mine[G * D + 2 * g + 1] = lsum;
      }
    }
  }
  if (n_active == 1) return;

  // The last block of the (slot, KV head) to arrive merges the partials.
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // Every partial's (m, l) into shared memory at once; then each head's
  // weights w_s = exp2(m_s - max) / sum_s l_s exp2(m_s - max); then
  // out = sum_s w_s acc_s, each sum in split order.
  float* sm_w = reinterpret_cast<float*>(smem);  // [MAX_SPLITS][G]
  float* sm_l = sm_w + MAX_SPLITS * G;           // [MAX_SPLITS][G]
  for (int k = tid; k < n_active * G; k += THREADS) {
    const float* ml = part + (k / G) * part_floats + G * D + 2 * (k % G);
    sm_w[k] = __ldcg(ml);
    sm_l[k] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int s = 0; s < n_active; ++s) mx = fmaxf(mx, sm_w[s * G + tid]);
    float lsum = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float f = exp2f(sm_w[s * G + tid] - mx);
      sm_w[s * G + tid] = f;
      lsum = fmaf(sm_l[s * G + tid], f, lsum);
    }
    const float inv = 1.f / lsum;
    for (int s = 0; s < n_active; ++s) sm_w[s * G + tid] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const float* w = sm_w + i / D;
    float osum = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_active; ++s)
      osum = fmaf(__ldcg(part + s * part_floats + i), w[s * G], osum);
    store(o + i, osum);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// rt_paged_decode's arguments that depend on shapes alone: the wrapper
// builds one per (device, shape), rt_paged_decode_prepare checks it and
// fills smem and scale_log2, and every call passes its address.
struct Launch {
  float* ws;
  int ws_blocks, dtype, B, H, Hkv, D, P, page_size, splits;
  int smem;          // dynamic shared memory of a block, in bytes
  float scale_log2;  // log2(e) / sqrt(D)
};

// One call's tensors.
struct Call {
  const void* q;
  const void* kv;
  const int* bt;
  const int* sl;
  void* out;
};

// Launches the kernel for `c`; with c == nullptr, prepares `a` instead:
// sizes the block's shared memory and opts the kernel in above 48 KB on
// the current device (to the most a block may take, so no later shape
// needs another opt-in).
template <typename T, int D, int G>
int launch(Launch* a, const Call* c, cudaStream_t st) {
  using C = Cfg<T, D, G>;
  auto kernel = paged_decode_split_kernel<T, D, G>;
  if (c == nullptr) {
    // The rings, their barriers, and the longest run of the block table
    // a block can take.
    const int pps_max =
        max(MIN_PAGES_PER_SPLIT, (a->P + a->splits - 1) / a->splits);
    const size_t smem = C::RING + WARPS * STAGES * 8 + (size_t)pps_max * 4;
    if (smem > (size_t)MAX_SMEM - 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MAX_SMEM - 1024);
      if (err != cudaSuccess) return (int)err;
    }
    a->smem = (int)smem;
    return 0;
  }
  const dim3 grid(a->splits, a->Hkv, a->B);
  kernel<<<grid, THREADS, a->smem, st>>>(
      static_cast<const T*>(c->q), static_cast<const T*>(c->kv), c->bt,
      c->sl, static_cast<T*>(c->out), a->ws, a->ws_blocks, a->H, a->Hkv,
      a->P, a->page_size, a->splits, a->scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_group(Launch* a, const Call* c, cudaStream_t st) {
  switch (a->H / a->Hkv) {
    case 1: return launch<T, D, 1>(a, c, st);
    case 2: return launch<T, D, 2>(a, c, st);
    case 4: return launch<T, D, 4>(a, c, st);
    case 8: return launch<T, D, 8>(a, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dim(Launch* a, const Call* c, cudaStream_t st) {
  if (a->D == 128) return launch_group<T, 128>(a, c, st);
  if (a->D == 64) return launch_group<T, 64>(a, c, st);
  if (a->D == 32) return launch_group<T, 32>(a, c, st);
  return (int)cudaErrorInvalidValue;
}

int launch_dtype(Launch* a, const Call* c, cudaStream_t st) {
  if (a->dtype == 1) return launch_dim<__nv_bfloat16>(a, c, st);
  if (a->dtype == 0) return launch_dim<float>(a, c, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Checks and completes a Launch (struct above) on the current device: dtype
// 0 = float32, 1 = bfloat16; scale 1/sqrt(D).  splits > 1 needs B * Hkv *
// splits <= ws_blocks and the workspace ws: ws_blocks / 2 int32 arrival
// counters, 0 at the first call (each call leaves them 0), then ws_blocks
// * G * (D + 2) floats.  Returns 0 or a cudaError_t.
int rt_paged_decode_prepare(void* launch) {
  Launch* a = static_cast<Launch*>(launch);
  if (a->B <= 0 || a->Hkv <= 0 || a->H % a->Hkv || a->D <= 0 ||
      a->P <= 0 || a->page_size <= 0 || a->splits <= 0 ||
      a->splits > MAX_SPLITS || a->B > 65535 || a->Hkv > 65535 ||
      (a->splits > 1 && (a->ws == nullptr ||
                         (long long)a->B * a->Hkv * a->splits >
                             a->ws_blocks)))
    return (int)cudaErrorInvalidValue;
  a->scale_log2 = LOG2E / sqrtf((float)a->D);
  return launch_dtype(a, nullptr, nullptr);
}

// One call on a prepared Launch.  Returns 0 or a cudaError_t.
int rt_paged_decode(const void* q, const void* kv_pages,
                    const void* block_table, const void* seq_lens, void* out,
                    void* launch, void* stream) {
  const Call c{q, kv_pages, static_cast<const int*>(block_table),
               static_cast<const int*>(seq_lens), out};
  return launch_dtype(static_cast<Launch*>(launch), &c,
                      static_cast<cudaStream_t>(stream));
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
