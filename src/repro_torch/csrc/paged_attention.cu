// Paged-attention decode for sm_90a (H100): one query token per sequence
// over its KV, gathered page by page through a page table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:89
// (paged_attention_kernel, body _paged_kernel at :39), which every decode
// step of the serving engine runs once per layer through
// models/attention.py attn_decode_paged.
//
// What bounds it on this card: HBM bytes.  Each call reads the K and V of
// every visible token of every sequence once (2 * Kv * D elements per
// token) and does ~4 * G flops per element read, far below the ~295 flops
// per byte at which the H100 turns compute-bound.  G <= 8 query rows per
// kv head are far below wgmma's 64-row tile, so the CUDA cores, not the
// tensor cores, do the arithmetic.  At the timed shapes (chip_smoke.py
// phase 3, bf16, D 128, 8 kv heads):
//   * serve decode (8 sequences of 257-288 tokens): 9 MB, bound ~0.003 ms;
//     what is left is latency -- launch, one round of page loads, the
//     merge -- so every load of a block is in flight at once;
//   * a ragged batch with one 1,024-token sequence: bound 0.004 ms, set
//     in the first version by the longest sequence walked by one block;
//   * one 8,192-token sequence: 33.5 MB, bound 0.010 ms; 8 blocks of the
//     first version could not draw the card's bandwidth.
//
// What the design does about it:
//   * Split-K over the sequence (flash-decoding).  The grid is (kv head x
//     head group, sequence, split); a split is `pages_per_split` pages.
//     The split count is ceil(Pmax / pages_per_split), fixed by the page
//     table's shape and never by the values of `lengths`, so the launch
//     needs no host read and can be captured in a CUDA graph.  The wrapper
//     sizes splits at >= 128 tokens and so that the grid is about one wave
//     of two blocks a SM (kernels/paged_attention/kernel.py split_plan;
//     measured against fixed 64-, 128- and 256-token splits).  A split
//     past the sequence's length, or before its window, writes an empty
//     partial (m = -2^30, l = 0, acc = 0), which the merge weighs by
//     exactly 0.
//   * Pages stream in by bulk copies: a producer warp reads the split's
//     page-table entries (all at once, one per lane) and then one lane
//     issues cp.async.bulk for every contiguous run of a page's rows --
//     K and V, no tensor map -- into a ring of STAGES chunks of CT = 32
//     tokens with full/empty mbarriers, 128 tokens in flight.
//   * Math in registers: the G query rows are held in f32; K and V stay in
//     their storage type in shared memory.  A lane owns 8 elements of D,
//     D / 8 lanes make one token, so a warp takes 2 (D = 128) or 4
//     (D = 64) tokens at a time; dot products finish with __shfl_xor.  The
//     online softmax (m, l) and the P.V accumulator stay in registers and
//     are rescaled once per chunk.  Eight consumer warps (faster than four
//     when measured) take a chunk's tokens; token slots of a warp merge by shuffles, the warps
//     through shared memory, once at the end of the split.
//   * The merge of the splits runs in the same launch: each block writes
//     its f32 partial (m, l, acc) to scratch, and the last block of its
//     (sequence, kv head) to finish -- found by __threadfence and an
//     atomicAdd on a counter -- combines
//     out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, its threads
//     splitting the columns and the splits.  The counters lie in the
//     call's own scratch and are zeroed by a cudaMemsetAsync on the same
//     stream just before the kernel, so no state outlives a call: calls on
//     any streams, and CUDA graphs captured from them, never share a
//     counter.  One kernel launch a call, as before (and the memset where
//     there is more than one split).  With one split the block writes out
//     directly.
//
// Numerics follow the TPU kernel: sm_scale = D^-0.5, optional tanh
// soft-cap, token j visible iff j < length and (no window or
// j > length - 1 - window), masked scores -2^30 (a masked token is skipped,
// which is its weight exp(-2^30 - m) = 0 exactly), online softmax in f32,
// l == 0 guarded to 1, output in the input type.
//
// Layout: q (B, H, D); k_pages and v_pages (Kv, n_pages, page_size, D) of
// q's type, 16-byte aligned; page_table (B, Pmax) int32; lengths (B,)
// int32; out (B, H, D).  f32 or bf16, D in {64, 128}, any G = H / Kv.
// Every lengths[b] <= Pmax * page_size and every page index < n_pages (the
// serving engine guarantees both).  Scratch from the caller, where
// n_split > 1: part_ml (2, B, H, n_split) and part_acc (B, H, n_split, D)
// f32, and counters (B * Kv * ceil(G / 8) int32, zeroed here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int NCW = 8;                 // consumer warps
constexpr int NT = 32 * (NCW + 1);     // and one producer warp
constexpr int STAGES = 4;              // chunks in the ring
constexpr int MAX_SPLIT_PAGES = 128;   // page-table entries of one split
constexpr float NEG_INF = -1073741824.0f;   // -2^30
constexpr unsigned FULL = 0xffffffffu;

// Which 8 elements of a D-row lane j (of the D / 8 lanes of a token) owns:
// bf16 8 contiguous (one 16-byte load); f32 [4j, 4j+4) and [D/2 + 4j, ...)
// (two 16-byte loads, each conflict-free across the lanes).
template <typename T, int D>
struct Row;

template <int D>
struct Row<__nv_bfloat16, D> {
  static constexpr int CT = 32;   // tokens per chunk
  __device__ static int col(int j, int e) { return 8 * j + e; }
  __device__ static void load(const __nv_bfloat16* row, int j, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <int D>
struct Row<float, D> {
  static constexpr int CT = 32;
  __device__ static int col(int j, int e) {
    return e < 4 ? 4 * j + e : D / 2 + 4 * j + e - 4;
  }
  __device__ static void load(const float* row, int j, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * j);
    const float4 b = *reinterpret_cast<const float4*>(row + D / 2 + 4 * j);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  store1(p, v.x);
  store1(p + 1, v.y);
  store1(p + 2, v.z);
  store1(p + 3, v.w);
}

template <typename T, int D>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * 2 * Row<T, D>::CT * D * (int)sizeof(T);
}

// One block: GT query rows (a group of the G rows of kv head kvh) of
// sequence b over split blockIdx.z.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NT, 1)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int* __restrict__ counters, int H, int Kv, int n_pages,
                   int page_size, int pmax, int pages_per_split, int window,
                   int has_cap, float cap, float sm_scale) {
  using R = Row<T, D>;
  constexpr int CT = R::CT;
  constexpr int LPT = D / 8;             // lanes per token
  constexpr int TPW = 32 / LPT;          // tokens per warp step
  constexpr int NSTEP = CT / (NCW * TPW);
  constexpr int CHUNK = CT * D;          // elements of K (or V) per stage
  static_assert(NSTEP >= 1, "chunk too short for the warps");
  static_assert(NCW * GT * (D + 2) * 4 <= ring_bytes<T, D>(),
                "the warp merge reuses the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES][K | V][CT][D]
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ int s_pages[MAX_SPLIT_PAGES];
  __shared__ int s_last;
  __shared__ float4 red4[NCW * 32];

  const int G = H / Kv;
  const int n_hg = (G + GT - 1) / GT;
  const int kvh = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  const int b = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int B = gridDim.y;
  const int g_n = min(GT, G - hg * GT);  // live rows of this group
  const int h0 = kvh * G + hg * GT;      // its first query head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the split's visible tokens [lo, hi)
  const int len = lengths[b];
  const int split_tokens = pages_per_split * page_size;
  const int s_begin = split * split_tokens;
  const int lo = max(s_begin, window > 0 ? max(0, len - window) : 0);
  const int hi = min(s_begin + split_tokens, len);
  const int c_first = hi > lo ? (lo - s_begin) / CT : 0;
  const int n_chunks = hi > lo ? (hi - 1 - s_begin) / CT + 1 - c_first : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NCW);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: the split's page-table entries, then the bulk copies
    if (n_chunks == 0) return;
    const int p0 = s_begin / page_size;
    const int* pt = page_table + (int64_t)b * pmax;
    for (int p = lane; p < pages_per_split; p += 32)
      s_pages[p] = p0 + p < pmax ? pt[p0 + p] : 0;
    __syncwarp();
    if (lane != 0) return;
    const int64_t head = (int64_t)kvh * n_pages;
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % STAGES;
      if (i >= STAGES) sm90::mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
      const int c0 = s_begin + (c_first + i) * CT;
      const int t0 = max(c0, lo), t1 = min(c0 + CT, hi);
      sm90::mbar_expect_tx(&full[st],
                           (uint32_t)((t1 - t0) * D * sizeof(T) * 2));
      T* ks = ring + st * 2 * CHUNK;
      T* vs = ks + CHUNK;
      for (int t = t0; t < t1;) {
        const int off = t % page_size;
        const int run = min(page_size - off, t1 - t);
        const int64_t src =
            ((head + s_pages[t / page_size - p0]) * page_size + off) * D;
        const uint32_t bytes = (uint32_t)(run * D * sizeof(T));
        sm90::bulk_load(ks + (t - c0) * D, k_pages + src, bytes, &full[st]);
        sm90::bulk_load(vs + (t - c0) * D, v_pages + src, bytes, &full[st]);
        t += run;
      }
    }
    return;
  }

  // consumers: warp `warp`, token slot `slot`, lane `j` of the token
  const int j = lane % LPT, slot = lane / LPT;
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < g_n) {
      R::load(q + ((int64_t)b * H + h0 + g) * D, j, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES;
    const int c0 = s_begin + (c_first + i) * CT;
    const int t0 = max(c0, lo), t1 = min(c0 + CT, hi);
    const T* ks = ring + st * 2 * CHUNK;
    const T* vs = ks + CHUNK;
    sm90::mbar_wait(&full[st], (i / STAGES) & 1);

    float s[NSTEP][GT], cmax[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) cmax[g] = NEG_INF;
#pragma unroll
    for (int k = 0; k < NSTEP; ++k) {
      const int r = (k * NCW + warp) * TPW + slot;   // row in the chunk
      const bool ok = c0 + r >= t0 && c0 + r < t1;
      float kx[8];
      R::load(ks + r * D, j, kx);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
        float x = d * sm_scale;
        if (has_cap) x = cap * tanhf(x / cap);
        s[k][g] = ok ? x : NEG_INF;
        cmax[g] = fmaxf(cmax[g], s[k][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mn = fmaxf(m[g], cmax[g]);
      const float alpha = __expf(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      m[g] = mn;
    }
#pragma unroll
    for (int k = 0; k < NSTEP; ++k) {
      const int r = (k * NCW + warp) * TPW + slot;
      if (c0 + r >= t0 && c0 + r < t1) {   // never touch an unloaded row
        float vx[8];
        R::load(vs + r * D, j, vx);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float p = __expf(s[k][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }

  // merge the token slots of the warp (lanes LPT apart)
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo_ = __shfl_xor_sync(FULL, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = __expf(m[g] - mn), c = __expf(mo - mn);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], o) * c;
      m[g] = mn;
    }
  }

  // merge the warps through shared memory (the ring is consumed)
  sm90::named_barrier(1, NCW * 32);
  float* red_m = reinterpret_cast<float*>(smem);   // [NCW][GT]
  float* red_l = red_m + NCW * GT;                 // [NCW][GT]
  float* red_acc = red_l + NCW * GT;               // [NCW][GT][D]
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (j == 0) {
        red_m[warp * GT + g] = m[g];
        red_l[warp * GT + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red_acc[(warp * GT + g) * D + R::col(j, e)] = acc[g][e];
    }
  }
  sm90::named_barrier(1, NCW * 32);

  const int64_t bh0 = (int64_t)b * H + h0;
  for (int idx = tid; idx < g_n * D; idx += NCW * 32) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NCW; ++w) M = fmaxf(M, red_m[w * GT + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float c = __expf(red_m[w * GT + g] - M);
      L = fmaf(c, red_l[w * GT + g], L);
      A = fmaf(c, red_acc[(w * GT + g) * D + d], A);
    }
    if (n_split == 1) {
      store1(out + (bh0 + g) * D + d, A / (L == 0.f ? 1.f : L));
    } else {
      const int64_t row = (bh0 + g) * n_split + split;
      part_acc[row * D + d] = A;
      if (d == 0) {
        part_ml[row] = M;
        part_ml[(int64_t)B * H * n_split + row] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of (b, kv head group) to finish merges the splits
  __threadfence();
  sm90::named_barrier(1, NCW * 32);
  int* counter = counters + (int64_t)b * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(counter, 1) == n_split - 1;
  sm90::named_barrier(1, NCW * 32);
  if (!s_last) return;
  __threadfence();

  // split weights e^(m_s - M) / sum_s e^(m_s - M) l_s, per row, in the
  // ring's shared memory (the caller keeps GT * n_split floats within it)
  float* wts = reinterpret_cast<float*>(smem);     // [GT][n_split]
  for (int g = warp; g < g_n; g += NCW) {
    const float* pm = part_ml + (bh0 + g) * n_split;
    const float* pl = pm + (int64_t)B * H * n_split;
    float M = NEG_INF;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, __ldcg(pm + s));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float c = __expf(__ldcg(pm + s) - M);
      wts[g * n_split + s] = c;
      L = fmaf(c, __ldcg(pl + s), L);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(FULL, L, o);
    const float inv = 1.f / (L == 0.f ? 1.f : L);
    for (int s = lane; s < n_split; s += 32) wts[g * n_split + s] *= inv;
  }
  sm90::named_barrier(1, NCW * 32);
  // out = sum_s w_s acc_s: threads split the columns and, where there are
  // fewer columns than threads, the splits too (summed through smem)
  const int ncol = g_n * (D / 4);
  const int parts = ncol >= NCW * 32 ? 1 : (NCW * 32) / ncol;
  for (int idx = tid; idx < ncol * parts; idx += NCW * 32) {
    const int col = idx % ncol, part = idx / ncol;
    const int g = col / (D / 4), d4 = 4 * (col % (D / 4));
    const float* pa = part_acc + (bh0 + g) * n_split * D + d4;
    const float* w = wts + g * n_split;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = part; s < n_split; s += parts) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(pa + s * D));
      o.x = fmaf(w[s], a.x, o.x);
      o.y = fmaf(w[s], a.y, o.y);
      o.z = fmaf(w[s], a.z, o.z);
      o.w = fmaf(w[s], a.w, o.w);
    }
    if (parts == 1) {
      store4(out + (bh0 + g) * D + d4, o);
    } else {
      red4[idx] = o;
    }
  }
  if (parts > 1) {
    sm90::named_barrier(1, NCW * 32);
    for (int col = tid; col < ncol; col += NCW * 32) {
      float4 o = red4[col];
      for (int p = 1; p < parts; ++p) {
        const float4 a = red4[p * ncol + col];
        o.x += a.x;
        o.y += a.y;
        o.z += a.z;
        o.w += a.w;
      }
      store4(out + (bh0 + col / (D / 4)) * D + 4 * (col % (D / 4)), o);
    }
  }
}

template <typename T, int D, int GT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out,
                   void* part_ml, void* part_acc, void* counters, int B,
                   int H, int Kv, int n_pages, int page_size, int pmax,
                   int pages_per_split, int window, int has_cap, float cap,
                   float sm_scale, cudaStream_t stream) {
  constexpr int smem = ring_bytes<T, D>();
  auto kernel = paged_split_kernel<T, D, GT>;
  // the shared-memory opt-in, once per device (a host call every decode
  // layer would cost the host-bound serving path)
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted_in >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const int G = H / Kv;
  const int n_split = (pmax + pages_per_split - 1) / pages_per_split;
  if (n_split > 65535 || GT * n_split * 4 > smem)
    return cudaErrorInvalidValue;   // the merge's weights live in the ring
  const dim3 grid(Kv * ((G + GT - 1) / GT), B, n_split);
  if (n_split > 1) {
    err = cudaMemsetAsync(counters, 0, sizeof(int) * B * grid.x, stream);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int*>(counters), H, Kv, n_pages, page_size, pmax,
      pages_per_split, window, has_cap, cap, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* k_pages,
                     const void* v_pages, const void* page_table,
                     const void* lengths, void* out, void* part_ml,
                     void* part_acc, void* counters, int B, int H, int Kv,
                     int n_pages, int page_size, int pmax,
                     int pages_per_split, int window, int has_cap, float cap,
                     float sm_scale, cudaStream_t st) {
  // rows per block: G rounded up to a power of two, at most 8
#define PAGED_LAUNCH(GT)                                                    \
  launch<T, D, GT>(q, k_pages, v_pages, page_table, lengths, out, part_ml, \
                   part_acc, counters, B, H, Kv, n_pages, page_size, pmax,  \
                   pages_per_split, window, has_cap, cap, sm_scale, st)
  if (G == 1) return PAGED_LAUNCH(1);
  if (G == 2) return PAGED_LAUNCH(2);
  if (G <= 4) return PAGED_LAUNCH(4);
  return PAGED_LAUNCH(8);
#undef PAGED_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  One launch
// of ceil(Pmax / pages_per_split) splits, after zeroing the counters where
// there is more than one.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_ml,
    void* part_acc, void* counters, int B, int H, int Kv, int D, int n_pages,
    int page_size, int pmax, int pages_per_split, int dtype, int window,
    int has_cap, float cap, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Kv <= 0 || H % Kv != 0 || page_size <= 0 || pmax <= 0 ||
      pages_per_split <= 0 || pages_per_split > MAX_SPLIT_PAGES)
    return (int)cudaErrorInvalidValue;
  const int G = H / Kv;
#define PAGED_DISPATCH(T, DD)                                                 \
  return (int)launch_g<T, DD>(G, q, k_pages, v_pages, page_table, lengths,  \
                              out, part_ml, part_acc, counters, B, H, Kv,   \
                              n_pages, page_size, pmax, pages_per_split,    \
                              window, has_cap, cap, sm_scale, st)
  if (dtype == 0 && D == 64) PAGED_DISPATCH(float, 64);
  if (dtype == 0 && D == 128) PAGED_DISPATCH(float, 128);
  if (dtype == 1 && D == 64) PAGED_DISPATCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PAGED_DISPATCH(__nv_bfloat16, 128);
#undef PAGED_DISPATCH
  return (int)cudaErrorInvalidValue;
}
