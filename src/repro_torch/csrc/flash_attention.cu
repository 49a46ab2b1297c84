// Causal GQA flash attention, forward only, for sm_90a (H100).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:83
// (flash_attention_kernel, body _attn_kernel at :31), which the serving
// prefill runs once per layer through models/attention.py attn_apply.
//
// What it computes, in both branches: sm_scale = D^-0.5, optional tanh
// soft-cap before the mask, masked scores filled with -2^30 (finite, never
// -inf), online softmax (m, l, acc) in f32, l == 0 guarded to 1, output in
// the input type.  Layout: q (B, S, H, D), k and v (B, T, Kv, D), out
// (B, S, H, D), all contiguous, D in {64, 128}; query head h reads kv head
// h / G (G = H / Kv) directly, with no repeat.  Both branches visit only the
// key tiles between the window start of a query tile's first row and the
// causal diagonal of its last.
//
// bf16 branch (the serving path): a warp-specialised tensor-core kernel.
// What bounds it: a causal call does 2*2*B*H*S*(S+1)/2*D operations on
// 2*B*(2*S*H + 2*T*Kv)*D bytes.  At the serving prefill's (4, 512, 16, 8,
// 128) that is 4.3 GFLOP on 25.2 MB, so the bytes bound it (0.0075 ms)
// and what is left is latency: each block walks at most 8 key tiles, and a
// short pipeline has to fill quickly (STAGES = 3 K/V stages in flight).
// At (1, 4096, 16, 8, 128) it is 68.7 GFLOP on 50.3 MB, bound by the bf16
// tensor-core rate (0.0695 ms).
// What the design does about it:
//  - QK^T and PV run on wgmma (m64n64k16 from shared memory for the scores,
//    m64nDk16 with P from registers for the output), f32 accumulators in
//    registers.  P is rounded to bf16 for the second product (the f32
//    kernel and the TPU kernel multiply in f32); the reference's bf16
//    tolerance, 2e-2, holds it.
//  - One producer warp feeds the tensor cores by TMA: Q once, K and V
//    through a ring of STAGES stages with full/empty mbarriers, K and V on
//    separate barriers so that the scores start before V has landed.  Boxes
//    are 64 columns (128 bytes) wide with 128-byte swizzle, so a D = 128
//    tile is two boxes, and the wgmma descriptors read that layout; TMA's
//    zero fill pads the ragged last tiles of S and T.
//  - Two consumer warpgroups of 64 query rows share every K/V tile: where G
//    is even they are two query heads of one kv head on the same rows,
//    where G is odd two consecutive 64-row tiles of one head.  Blocks start
//    with the latest query tiles, which under a causal mask have the most
//    keys.
//  - Inside a warpgroup each step issues tile t's QK^T and tile t-1's PV
//    together, and runs tile t's softmax while that PV runs.  The first
//    and last tiles are peeled off the loop so that no wgmma sits in a
//    conditional branch: ptxas otherwise serialises every wgmma (C7520).
//  - The softmax runs on the accumulator fragment (each thread holds two
//    rows; row max across the quad by shuffles, row sums kept per thread
//    until the end).  The mask has no branch: per tile each row's kept
//    column offsets [lo, hi] are set once, and a score costs two integer
//    compares against immediates; exponentials are ex2.approx.
//  - The output goes through the warpgroup's Q buffer (XOR-swizzled, no
//    bank conflicts) and out in 16-byte stores, clipped at S.
// Measured on the H100 (chip_smoke.py phase 3), the tensor cores run at
// about 40 % of their peak at (1, 4096, 16, 8, 128); at the serving shape
// a call takes about 3x the bytes bound, the pipeline's fill and drain.
//
// f32 branch: the first version, kept unchanged (neither TF32 nor bf16
// products hold the f32 tolerance of 2e-4): plain f32 FMA loops over
// shared-memory tiles, one block of 128 threads per (64-row query tile,
// query head, batch), two threads per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key/value rows per tile
constexpr int NT = 128;   // threads per block: two per query row
constexpr float NEG_INF = -1073741824.0f;   // -2^30

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Copies `rows` (<= 64) rows of D elements, `stride` elements apart, into a
// 64 x (D + 4) f32 tile in shared memory; rows past `rows` become zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long stride, int rows) {
  constexpr int LD = D + 4, PER_ROW = D / 8;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    float x[8];
    if (r < rows) {
      load8(src + r * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * LD + c);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int Kv, int causal, int window, int has_cap,
                 float cap, float sm_scale) {
  constexpr int LD = D + 4;     // padded row stride of the q/k/v tiles
  constexpr int LDP = BK + 4;   // padded row stride of the probability tile
  constexpr int DH = D / 2;     // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = q0 + r;

  load_tile<T, D>(sQ, q + ((long)(b * S + q0) * H + h) * D, (long)H * D,
                  min(BQ, S - q0));

  // Key tiles this block needs: up to the causal diagonal of its last row,
  // from the window start of its first row.  Every row keeps at least its
  // diagonal, so skipping the rest gives the numbers masking would.
  const int hi = causal ? min(Tk, q0 + BQ) : Tk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = lo / BK, t_end = (hi + BK - 1) / BK;

  float m = NEG_INF, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    __syncthreads();   // the previous tile is consumed; sQ is loaded
    const long base = ((long)(b * Tk + c0) * Kv + kvh) * D;
    load_tile<T, D>(sK, k + base, (long)Kv * D, min(BK, Tk - c0));
    load_tile<T, D>(sV, v + base, (long)Kv * D, min(BK, Tk - c0));
    __syncthreads();

    // scores of this thread's columns c0 + 2j + half
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + r * LD + d);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (2 * j + half) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = c0 + 2 * j + half;
      float x = s[j] * sm_scale;
      if (has_cap) x = cap * tanhf(x / cap);
      bool ok = col < Tk;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      s[j] = ok ? x : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      s[j] = expf(s[j] - m_new);
      l_tile += s[j];
      sP[r * LDP + 2 * j + half] = s[j];
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l = alpha * l + l_tile;
    m = m_new;
    __syncwarp();   // a row's two threads (one warp) share sP row r

#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(sP + r * LDP + c);
      const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sV + (c + cc) * LD;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * (2 * i + half));
          acc[4 * i + 0] = fmaf(pc[cc], vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pc[cc], vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pc[cc], vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pc[cc], vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  if (row < S) {
    const float denom = l == 0.f ? 1.f : l;   // fully-masked row guard
    T* o = out + ((long)(b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store1(o + 4 * (2 * i + half) + e, acc[4 * i + e] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int Tk, int H, int Kv,
                       int causal, int window, int has_cap, float cap,
                       float sm_scale, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem =
      (int)sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, Kv, causal,
      window, has_cap, cap, sm_scale);
  return cudaGetLastError();
}

// ---- bf16: wgmma fed by TMA -------------------------------------------------

namespace wg {

constexpr int NWG = 2;                 // consumer warpgroups, 64 rows each
constexpr int NT = NWG * 128 + 32;     // and one producer warp
constexpr int STAGES = 3;              // K/V ring depth
constexpr int BOX = 64 * 64 * 2;       // bytes of one 64 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {                          // byte offsets from a 1024-aligned base
  static constexpr int TILE = 64 * D * 2;          // a Q, K or V tile
  static constexpr int K = NWG * TILE;             // after the Q tiles
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;    // q, k[], v[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// key tiles [lo, hi) that rows [q0, q0 + 64) can see; empty past S
__device__ __forceinline__ void key_range(int q0, int S, int Tk, int causal,
                                          int window, int& lo, int& hi) {
  if (q0 >= S) {
    lo = hi = 0;
    return;
  }
  const int last = causal ? min(Tk, min(S, q0 + BQ)) : Tk;
  hi = (last + BK - 1) / BK;
  lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
}

template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void pv_wgmma<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  sm90::wgmma_m64n64k16_rs(o, a, db, 1);
}

template <>
__device__ __forceinline__ void pv_wgmma<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  sm90::wgmma_m64n128k16_rs(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int B, int S, int Tk, int H,
                int Kv, int n_x, int n_y, int causal, int window, int has_cap,
                float cap, float sm_scale) {
  using L = Smem<D>;
  constexpr int NBOX = D / 64;       // 64-column boxes per tile row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + STAGES;
  uint64_t* empty = bar + 1 + 2 * STAGES;

  // block -> (query tile(s), heads, batch), latest query tiles first
  const int G = H / Kv;
  const int x = n_x - 1 - static_cast<int>(blockIdx.x) / (n_y * B);
  const int rest = static_cast<int>(blockIdx.x) % (n_y * B);
  const int y = rest % n_y, b = rest / n_y;
  int kvh, h[NWG], q0[NWG];
  if (G % 2 == 0) {                  // two heads of kv head kvh, same rows
    kvh = y / (G / 2);
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      h[w] = kvh * G + 2 * (y % (G / 2)) + w;
      q0[w] = x * BQ;
    }
  } else {                           // one head, two consecutive row tiles
    kvh = y / G;
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      h[w] = y;
      q0[w] = (2 * x + w) * BQ;
    }
  }
  int lo[NWG], hi[NWG];
#pragma unroll
  for (int w = 0; w < NWG; ++w)
    key_range(q0[w], S, Tk, causal, window, lo[w], hi[w]);
  const int t_lo = hi[1] > lo[1] ? min(lo[0], lo[1]) : lo[0];
  const int t_hi = max(hi[0], hi[1]);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 4);   // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == NWG * 4) {
    // ---- producer: one thread issues every TMA load
    if (lane == 0) {
      sm90::prefetch_map(&tk);
      sm90::prefetch_map(&tv);
      uint32_t q_bytes = 0;
#pragma unroll
      for (int w = 0; w < NWG; ++w) q_bytes += q0[w] < S ? L::TILE : 0;
      sm90::mbar_expect_tx(q_full, q_bytes);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        if (q0[w] >= S) continue;
#pragma unroll
        for (int bx = 0; bx < NBOX; ++bx)
          sm90::tma_load_4d(smem + w * L::TILE + bx * BOX, &tq, q_full,
                            64 * bx, h[w], q0[w], b);
      }
      for (int i = 0, t = t_lo; t < t_hi; ++i, ++t) {
        const int s = i % STAGES;
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&k_full[s], L::TILE);
#pragma unroll
        for (int bx = 0; bx < NBOX; ++bx)
          sm90::tma_load_4d(smem + L::K + s * L::TILE + bx * BOX, &tk,
                            &k_full[s], 64 * bx, kvh, t * BK, b);
        sm90::mbar_expect_tx(&v_full[s], L::TILE);
#pragma unroll
        for (int bx = 0; bx < NBOX; ++bx)
          sm90::tma_load_4d(smem + L::V + s * L::TILE + bx * BOX, &tv,
                            &v_full[s], 64 * bx, kvh, t * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroup w: 64 query rows of head h[w]
    const int w = warp / 4, wl = warp % 4;
    const int qw = w ? q0[1] : q0[0], hw = w ? h[1] : h[0];
    const int my_lo = w ? lo[1] : lo[0], my_hi = w ? hi[1] : hi[0];
    unsigned char* sq = smem + w * L::TILE;
    const int r0 = qw + 16 * wl + lane / 4, r1 = r0 + 8;   // this thread's rows
    const uint64_t dq = sm90::desc_sw128(sm90::smem_addr(sq), 0);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float sc[BK / 2];                  // scores, then probabilities
    uint32_t pa[BK / 16][4];           // P as the A operand of P V

    // S = Q K^T over one stage: D / 16 steps of 16 columns, 4 per box
    auto qk = [&](int stage) {
      const uint64_t dk = sm90::desc_sw128(
          sm90::smem_addr(smem + L::K + stage * L::TILE), 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t off = (kk / 4) * (BOX >> 4) + (kk % 4) * 2;
        sm90::wgmma_m64n64k16_ss(sc, dq + off, dk + off, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // O += P V over one stage: BK / 16 steps of 16 keys (16 rows of 128
    // bytes of the MN-major V tile, its 64-column boxes BOX bytes apart)
    auto pv = [&](int stage) {
      const uint64_t dv = sm90::desc_sw128(
          sm90::smem_addr(smem + L::V + stage * L::TILE), BOX);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv_wgmma<D>(o, pa[kk], dv + kk * (16 * 128 >> 4));
      sm90::wgmma_commit();
    };
    // online softmax of key tile t on sc: scale, cap, mask (sc[4j + e] is
    // row (e < 2 ? r0 : r1), column c0 + 8j + 2 (lane % 4) + (e & 1)), new
    // row maxima, probabilities in sc, row sums; returns the factors the
    // accumulator is rescaled by
    auto softmax = [&](int t, float& a0, float& a1) {
      const int c0 = t * BK;
      // this thread's columns are c0 + 2 (lane % 4) + off, off = 8j + (e & 1);
      // row r keeps off in [lo_r, hi_r]
      const int cb = c0 + 2 * (lane % 4);
      const int hi0 = (causal ? min(r0, Tk - 1) : Tk - 1) - cb;
      const int hi1 = (causal ? min(r1, Tk - 1) : Tk - 1) - cb;
      const int lo0 = (window > 0 ? r0 - window + 1 : -(1 << 30)) - cb;
      const int lo1 = (window > 0 ? r1 - window + 1 : -(1 << 30)) - cb;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * j + e] * sm_scale;
          if (has_cap) v = cap * tanhf(v / cap);
          const int off = 8 * j + (e & 1);
          const bool ok = e < 2 ? (off <= hi0 && off >= lo0)
                                : (off <= hi1 && off >= lo1);
          v = ok ? v : NEG_INF;
          sc[4 * j + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      a0 = ex2((m0 - mn0) * LOG2E);
      a1 = ex2((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      // a row that has seen only masked keys subtracts 0, not -2^30, so
      // its masked scores give exp(-2^30) = 0
      const float ms0 = (mn0 == NEG_INF ? 0.f : mn0) * LOG2E;
      const float ms1 = (mn1 == NEG_INF ? 0.f : mn1) * LOG2E;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ex2(fmaf(sc[4 * j + e], LOG2E, e < 2 ? -ms0 : -ms1));
          sc[4 * j + e] = p;
          if (e < 2) ls0 += p; else ls1 += p;
        }
      }
      l0 = l0 * a0 + ls0;              // per-thread partial sums of the row
      l1 = l1 * a1 + ls1;
    };
    // rescale O, and P to bf16 A fragments: the m64n64 accumulator's 16
    // columns of step kk are the m64k16 A fragment of that step
    auto rescale_pack = [&](float a0, float a1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    };
    // a tile of the block's range outside this warpgroup's: waiting on K
    // keeps it from arriving on `empty` for a later round before the other
    // warpgroup does
    auto pass = [&](int round) {
      sm90::mbar_wait(&k_full[round % STAGES], (round / STAGES) & 1);
      release(round % STAGES);
    };

    int i = 0, t = t_lo;
    for (; t < my_lo; ++i, ++t) pass(i);
    if (my_hi > my_lo) {
      sm90::mbar_wait(q_full, 0);
      // the first tile alone; then each step issues tile t's Q K^T and
      // tile t-1's P V together, and runs t's softmax while P V does
      float a0, a1;
      int s = i % STAGES, s_prev;
      sm90::mbar_wait(&k_full[s], (i / STAGES) & 1);
      sm90::wgmma_fence();
      qk(s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax(t, a0, a1);
      rescale_pack(a0, a1);
      sm90::mbar_wait(&v_full[s], (i / STAGES) & 1);
      for (++i, ++t, s_prev = s; t < my_hi; ++i, ++t, s_prev = s) {
        s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        sm90::mbar_wait(&k_full[s], ph);
        sm90::fence_regs(o);
        sm90::wgmma_fence();
        qk(s);
        pv(s_prev);
        sm90::wgmma_wait<1>();         // the scores; P V may still run
        sm90::fence_regs(sc);
        softmax(t, a0, a1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(pa);
        release(s_prev);
        rescale_pack(a0, a1);
        sm90::mbar_wait(&v_full[s], ph);
      }
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      pv(s_prev);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      release(s_prev);
    }
    for (; t < t_hi; ++i, ++t) pass(i);
    if (qw >= S) return;

    // epilogue: O / l to bf16, through this warpgroup's Q buffer
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);   // fully-masked guard
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + w, 128);   // every warp is done reading Q
    const int rr0 = 16 * wl + lane / 4, rr1 = rr0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // 16-byte granule j of a row
      *reinterpret_cast<uint32_t*>(sq + rr0 * D * 2 + (j ^ (rr0 & 7)) * 16 +
                                   4 * (lane % 4)) =
          pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(sq + rr1 * D * 2 + (j ^ (rr1 & 7)) * 16 +
                                   4 * (lane % 4)) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    sm90::named_barrier(1 + w, 128);
    constexpr int GR = D / 8;          // granules per row
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int c = tid; c < BQ * GR; c += 128) {
      const int row = c / GR, g = c % GR;
      if (qw + row < S) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            sq + row * D * 2 + (g ^ (row & 7)) * 16);
        *reinterpret_cast<uint4*>(
            out + ((static_cast<long>(b) * S + qw + row) * H + hw) * D +
            8 * g) = val;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int Kv, int causal,
                   int window, int has_cap, float cap, float sm_scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::map_bf16_4d(&tq, q, D, H, S, B, BQ) ||
      !sm90::map_bf16_4d(&tk, k, D, Kv, Tk, B, BK) ||
      !sm90::map_bf16_4d(&tv, v, D, Kv, Tk, B, BK))
    return cudaErrorInvalidValue;
  const int G = H / Kv, n_qt = (S + BQ - 1) / BQ;
  const int n_x = G % 2 == 0 ? n_qt : (n_qt + 1) / 2;
  const int n_y = G % 2 == 0 ? H / 2 : H;
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<D><<<n_x * n_y * B, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, S, Tk, H, Kv, n_x,
      n_y, causal, window, has_cap, cap, sm_scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int Tk, int H, int Kv, int D, int dtype,
                                   int causal, int window, int has_cap,
                                   float cap, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Kv <= 0 || H % Kv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return (int)launch_fma<float, 64>(q, k, v, out, B, S, Tk, H, Kv, causal,
                                      window, has_cap, cap, sm_scale, st);
  if (dtype == 0 && D == 128)
    return (int)launch_fma<float, 128>(q, k, v, out, B, S, Tk, H, Kv,
                                       causal, window, has_cap, cap,
                                       sm_scale, st);
  if (dtype == 1 && D == 64)
    return (int)wg::launch<64>(q, k, v, out, B, S, Tk, H, Kv, causal, window,
                               has_cap, cap, sm_scale, st);
  if (dtype == 1 && D == 128)
    return (int)wg::launch<128>(q, k, v, out, B, S, Tk, H, Kv, causal,
                                window, has_cap, cap, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
