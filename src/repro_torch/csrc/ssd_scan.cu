// Mamba-2 chunked SSD scan (state-space duality), forward only, for sm_90a
// (H100).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:75
// (ssd_scan_kernel, body _ssd_kernel at :29), which the full-sequence
// forward of the ssm family runs once per layer through
// models/mamba2.py mamba2_apply(impl="pallas").  Per (batch b, head h),
// over chunks of L steps, with cum the within-chunk cumsum of dA = dt * A:
//
//   y_t  = sum_{u<=t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u     (intra)
//        + exp(cum_t) C_t . H_in                                  (inter)
//   H    = exp(cum_end) H + sum_u exp(cum_end - cum_u) dt_u B_u x_u^T
//
// y is returned in x's type (float32 here) and the final state in float32.
//
// What bounds it on this card: at mamba2-1.3b (H 64, P 64, N 128, L 128)
// a call at b = 1, s = 2048 needs 7.56 GFLOP as the reference computes it
// (per chunk and head the causal half of C B^T and of M (dt x), plus
// C H_in^T and the chunk state B^T (w x)), 5.43 GFLOP with C B^T once per
// chunk and group (it does not depend on the head), against ~72 MB of
// inputs and outputs.  In plain f32 that is 0.081 ms at 67 TFLOP/s; on
// the tensor cores TF32 keeps ~3 digits, so each product is taken as
// 3xTF32 -- a = a_hi + a_lo, both TF32 (hi = rna(a), lo = rna(a - hi)),
// and a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi -- which errs by up to
// ~1.5e-5 of max-abs where single TF32 errs by ~5e-4 (the tests hold the
// tensor-core branch to 5e-5), at 3 x 5.43 GFLOP over 495 TFLOP/s =
// 0.033 ms (0.046 ms with C B^T per head).  3xTF32 operations bound it.
//
// What this version does about that, and how the TPU design changes:
//   * The TPU kernel carries the (N, P) state in VMEM scratch across a
//     SEQUENTIAL chunk axis of its grid.  Blocks on a GPU run in no order,
//     so the scan is split as in the SSD paper's GPU algorithm, into three
//     launches per call:
//       1. chunk states: every chunk's local state
//          S_c = sum_u exp(cum_end - cum_u) dt_u x_u B_u^T and its total
//          decay cum_end, in parallel over (chunk, head, batch);
//       2. ssd_state_pass: the short sequential pass over chunks, parallel
//          over the P * N state elements of each (b, h): it overwrites S_c
//          with the state ENTERING chunk c and writes h_final;
//       3. chunk outputs: y, in parallel over (row tile, chunk, head,
//          batch): the inter-chunk term from the entering state, then the
//          intra-chunk term over the key tiles at or below the row tile
//          (tiles above the diagonal are skipped, not masked).
//   * Tensor-core branch (L = 64 or 128, and N % 64 == 0), 256 threads =
//     two warpgroups: every product is three wgmma.m64nNk8.f32.tf32.tf32
//     a reduction step of 8, from shared memory, f32 accumulators in
//     registers.  TF32 operands must both be K-major (the transpose bits
//     exist only for 16-bit types), and wgmma reads a TF32 operand by
//     ignoring its low 13 bits, so hi and lo are separate tiles: the
//     loading threads split each f32 as it arrives (integer rounding, two
//     operations, where cvt.rna.tf32 issues slowly) and store both parts
//     into 128-byte-swizzled K-major tiles (wgmma's canonical layout).  C
//     (steps x n), B (keys x n) and H_in (p x n) are K-major as stored and
//     come in row by row; dt x, w x and B for the chunk state are MN-major
//     as stored and are staged transposed (lanes along p or n read
//     contiguous rows).  A TMA box cannot split an operand into hi and lo,
//     so no TMA.  Each thread issues all its loads of a tile before any
//     store, so a block waits on memory once a tile, not once a row.
//       - ssd_chunk_state_tc: 64-step tiles of u; each warpgroup owns 64
//         rows of S^T (n).  The scores C B^T do not depend on the head,
//         so G more rows of its grid compute them once per (chunk, group)
//         into scratch (64x fewer than once per head at H 64, G 1).
//       - ssd_chunk_out_pair: one block a chunk and head.  At L = 128
//         (mamba2-1.3b's chunk) each warpgroup takes one of the chunk's
//         two 64-row tiles; at L = 64 (what chunk_len makes of 128 where
//         s is an odd multiple of 64) the two split the one tile's
//         columns.  C H_in^T runs slab by slab (32 columns of n) through
//         two buffers, the next slab's loads in flight and its stores
//         issued while the current one is multiplied; then the scores,
//         decayed and masked for this head, go through shared memory as
//         the A operand M of M (dt x) (the TF32 A-fragment layout is not
//         the accumulator's), and the inter- and intra-chunk terms of y
//         share one accumulator.  160 KB of shared memory at P 64, N 128,
//         L 128.
//     At (1, 2048, 64, 64, 1, 128) the products issue at about half the
//     TF32 rate, and shared-memory staging and the tiles' latency take
//     most of the rest (one block a SM): see PERF.md.
//   * FMA branch (any other L or N: s = 1000 runs L = 8, d_state 16 or 32,
//     and an explicit chunk of 256, whose M tiles would not fit beside
//     the rest in shared memory without a loop over keys): the first
//     version's f32 FMA loops over 32-row shared-memory tiles,
//     ssd_chunk_state and ssd_chunk_out, unchanged.
//   * Underflow: A = -exp(A_log) reaches -16 at full width, so cum falls to
//     ~-1,400 within a chunk and exp(cum) underflows to 0.  Every decay
//     between two steps is formed from the DIFFERENCE, exp(cum_t - cum_u)
//     and exp(cum_end - cum_u), never as exp(cum_t) * exp(-cum_u)
//     (inf * 0 = NaN); the exponent is masked before exp (u > t never
//     reaches exp).
//   * Groups without copies: x, dt, B and C are read in their (b, s, h, .)
//     and (b, s, g, .) layouts, taking group g = h / (H / G) directly,
//     where the TPU wrapper transposes to (BH, S, .) and materialises the
//     per-head repeat of B and C.
//
// cum is a block-wide scan (warp shuffles) in a fixed order, computed by
// the same function in phases 1 and 3, so both see the same values; its
// order differs from a sequential cumsum by float32 rounding only.
//
// Layout: x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C (Bt, S, G, N),
// y (Bt, S, H, P), h_final (Bt, H, P, N), all contiguous float32 with
// 16-byte-aligned starts; scratch: states (Bt, nc, H, P, N), chunk decays
// (Bt, H, nc) and, at L = 64 or 128 and N % 64 == 0, scores (Bt, nc, G,
// L, L), float32, allocated by the caller.  S = nc * L,
// L <= 256, P in {32, 64}, N in {16, 32, 64, 128}.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;      // threads per block, every phase
constexpr int TT = 32;       // rows (steps) per tile
constexpr int LMAX = 256;    // longest chunk
constexpr int PAD = 4;       // row padding of the shared tiles (floats)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Inclusive scan of dA_u = dt_u * A over the L <= 256 steps of one chunk
// into cum[0 .. L); thread u owns step u.  Every thread must call it.
__device__ void chunk_cumsum(const float* dt, int64_t dt_stride, float a,
                             int L, float* cum, float* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = tid < L ? dt[(int64_t)tid * dt_stride] * a : 0.0f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NT / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < NT / 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < NT / 32) warp_sums[lane] = w;   // inclusive warp totals
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  if (tid < L) cum[tid] = v;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// phase 1: chunk-local states S_c[p][n] = sum_u (w_u x_u[p]) B_u[n]
// ---------------------------------------------------------------------------

template <int P, int N>
struct StateTile {
  static constexpr int R = P * N / NT;         // outputs per thread
  static constexpr int RP = R < 4 ? R : 4;     // p values per thread
  static constexpr int RN = R / RP;            // n values per thread
  static constexpr int PG = P / RP;            // p groups
  static constexpr int NG = N / RN;            // n groups
  static_assert(PG * NG == NT, "thread layout");
  static constexpr int LD = TT + PAD;          // u-major tiles, transposed
};

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_chunk_state(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ chunk_cum, int S, int H,
    int G, int L, int nc) {
  using T = StateTile<P, N>;
  __shared__ float cum[LMAX];
  __shared__ float w[LMAX];
  __shared__ float warp_sums[NT / 32];
  __shared__ __align__(16) float xsT[P * T::LD];   // [p][u]: w_u x_u[p]
  __shared__ __align__(16) float bsT[N * T::LD];   // [n][u]: B_u[n]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;   // first step's row

  chunk_cumsum(dt + t0 * H + h, H, A[h], L, cum, warp_sums);
  const float cum_end = cum[L - 1];
  if (tid < L) w[tid] = __expf(cum_end - cum[tid]) * dt[(t0 + tid) * H + h];
  if (tid == 0) chunk_cum[((int64_t)b * H + h) * nc + c] = cum_end;

  const int pg = tid / T::NG, ng = tid % T::NG;
  float acc[T::RP][T::RN];
#pragma unroll
  for (int i = 0; i < T::RP; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j) acc[i][j] = 0.0f;

  for (int u0 = 0; u0 < L; u0 += TT) {
    __syncthreads();   // w ready (first pass); tiles free (later passes)
    for (int e = tid; e < TT * P; e += NT) {
      const int u = e / P, p = e % P;
      xsT[p * T::LD + u] =
          u0 + u < L ? x[((t0 + u0 + u) * H + h) * P + p] * w[u0 + u] : 0.0f;
    }
    for (int e = tid; e < TT * N; e += NT) {
      const int u = e / N, n = e % N;
      bsT[n * T::LD + u] =
          u0 + u < L ? Bm[((t0 + u0 + u) * G + g) * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int u = 0; u < TT; u += 4) {
      float4 xv[T::RP], bv[T::RN];
#pragma unroll
      for (int i = 0; i < T::RP; ++i)
        xv[i] = ld4(&xsT[(pg + i * T::PG) * T::LD + u]);
#pragma unroll
      for (int j = 0; j < T::RN; ++j)
        bv[j] = ld4(&bsT[(ng + j * T::NG) * T::LD + u]);
#pragma unroll
      for (int i = 0; i < T::RP; ++i)
#pragma unroll
        for (int j = 0; j < T::RN; ++j) {
          float a = acc[i][j];
          a = fmaf(xv[i].x, bv[j].x, a);
          a = fmaf(xv[i].y, bv[j].y, a);
          a = fmaf(xv[i].z, bv[j].z, a);
          a = fmaf(xv[i].w, bv[j].w, a);
          acc[i][j] = a;
        }
    }
  }
  float* out = states + (((int64_t)b * nc + c) * H + h) * (P * N);
#pragma unroll
  for (int i = 0; i < T::RP; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j)
      out[(pg + i * T::PG) * N + ng + j * T::NG] = acc[i][j];
}

// ---------------------------------------------------------------------------
// phase 2: sequential pass over chunks; states[c] <- state entering chunk c
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) ssd_state_pass(
    float* __restrict__ states, const float* __restrict__ chunk_cum,
    float* __restrict__ h_final, int H, int PN, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PN) return;
  const float* dec = chunk_cum + ((int64_t)b * H + h) * nc;
  const int64_t stride = (int64_t)H * PN;              // one chunk apart
  float* s = states + ((int64_t)b * nc * H + h) * PN + e;
  // the loads do not depend on the carry: start a batch of them before the
  // dependent chain, so each batch waits on memory once, not once a chunk
  constexpr int KB = 16;
  float carry = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += KB) {
    float local[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (c0 + k < nc) local[k] = s[(c0 + k) * stride];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (c0 + k < nc) {
        s[(c0 + k) * stride] = carry;
        carry = fmaf(carry, __expf(dec[c0 + k]), local[k]);
      }
    }
  }
  h_final[((int64_t)b * H + h) * PN + e] = carry;
}

// ---------------------------------------------------------------------------
// phase 3: y for one 32-row tile of one chunk
// ---------------------------------------------------------------------------

template <int P, int N>
struct OutTile {
  static constexpr int RC = P / 32;            // p columns per thread
  static constexpr int RI = TT / (NT / 32);    // rows per thread (4)
  static constexpr int LDN = N + PAD;
  static constexpr int LDP = P + PAD;
  static constexpr int LDT = TT + PAD;
  // floats of dynamic shared memory: C rows, H_in, B rows, dt x, scores
  static constexpr int SMEM =
      TT * LDN + P * LDN + TT * LDN + TT * LDP + TT * LDT;
};

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_chunk_out(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ states,
    float* __restrict__ y, int S, int H, int G, int L, int nc) {
  using T = OutTile<P, N>;
  __shared__ float cum[LMAX];
  __shared__ float warp_sums[NT / 32];
  extern __shared__ float4 smem_f4[];
  float* Cs = reinterpret_cast<float*>(smem_f4);   // [TT][LDN]
  float* Hs = Cs + TT * T::LDN;                     // [P][LDN]
  float* Bs = Hs + P * T::LDN;                      // [TT][LDN]
  float* Xs = Bs + TT * T::LDN;                     // [TT][LDP]: dt_u x_u
  float* Ms = Xs + TT * T::LDP;                     // [TT][LDT]

  const int n_rt = (L + TT - 1) / TT;
  const int c = blockIdx.x / n_rt, rt = blockIdx.x % n_rt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, rg = tid >> 5;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  const int r0 = rt * TT;                           // first row in the chunk

  chunk_cumsum(dt + t0 * H + h, H, A[h], L, cum, warp_sums);

  // C rows of this tile and the state entering the chunk
  for (int e = tid; e < TT * (N / 4); e += NT) {
    const int i = e / (N / 4), n4 = 4 * (e % (N / 4));
    const float4 v = r0 + i < L
        ? ld4(&Cm[((t0 + r0 + i) * G + g) * N + n4])
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&Cs[i * T::LDN + n4]) = v;
  }
  const float* hin = states + (((int64_t)b * nc + c) * H + h) * (P * N);
  for (int e = tid; e < P * (N / 4); e += NT) {
    const int p = e / (N / 4), n4 = 4 * (e % (N / 4));
    *reinterpret_cast<float4*>(&Hs[p * T::LDN + n4]) = ld4(&hin[p * N + n4]);
  }
  __syncthreads();

  // thread (rg, lane) owns rows rg + 8 k and columns lane + 32 q
  float acc[T::RI][T::RC];
#pragma unroll
  for (int k = 0; k < T::RI; ++k)
#pragma unroll
    for (int q = 0; q < T::RC; ++q) acc[k][q] = 0.0f;

  // inter-chunk: exp(cum_t) C_t . H_in[p]
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 cv[T::RI], hv[T::RC];
#pragma unroll
    for (int k = 0; k < T::RI; ++k)
      cv[k] = ld4(&Cs[(rg + 8 * k) * T::LDN + n]);
#pragma unroll
    for (int q = 0; q < T::RC; ++q)
      hv[q] = ld4(&Hs[(lane + 32 * q) * T::LDN + n]);
#pragma unroll
    for (int k = 0; k < T::RI; ++k)
#pragma unroll
      for (int q = 0; q < T::RC; ++q) {
        float a = acc[k][q];
        a = fmaf(cv[k].x, hv[q].x, a);
        a = fmaf(cv[k].y, hv[q].y, a);
        a = fmaf(cv[k].z, hv[q].z, a);
        a = fmaf(cv[k].w, hv[q].w, a);
        acc[k][q] = a;
      }
  }
#pragma unroll
  for (int k = 0; k < T::RI; ++k) {
    const int t = r0 + rg + 8 * k;
    const float d = t < L ? __expf(cum[t]) : 0.0f;
#pragma unroll
    for (int q = 0; q < T::RC; ++q) acc[k][q] *= d;
  }

  // intra-chunk: the key tiles at or below the diagonal
  for (int ut = 0; ut <= rt; ++ut) {
    const int u0 = ut * TT;
    __syncthreads();                                // Bs, Xs, Ms free
    for (int e = tid; e < TT * (N / 4); e += NT) {
      const int j = e / (N / 4), n4 = 4 * (e % (N / 4));
      const float4 v = u0 + j < L
          ? ld4(&Bm[((t0 + u0 + j) * G + g) * N + n4])
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&Bs[j * T::LDN + n4]) = v;
    }
    for (int e = tid; e < TT * (P / 4); e += NT) {
      const int j = e / (P / 4), p4 = 4 * (e % (P / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u0 + j < L) {
        const float d = dt[(t0 + u0 + j) * H + h];
        v = ld4(&x[((t0 + u0 + j) * H + h) * P + p4]);
        v.x *= d; v.y *= d; v.z *= d; v.w *= d;
      }
      *reinterpret_cast<float4*>(&Xs[j * T::LDP + p4]) = v;
    }
    __syncthreads();

    // scores of rows rg + 8 k against key column `lane`, decayed and masked
    float sc[T::RI];
#pragma unroll
    for (int k = 0; k < T::RI; ++k) sc[k] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 bv = ld4(&Bs[lane * T::LDN + n]);
#pragma unroll
      for (int k = 0; k < T::RI; ++k) {
        const float4 cv = ld4(&Cs[(rg + 8 * k) * T::LDN + n]);
        float a = sc[k];
        a = fmaf(cv.x, bv.x, a);
        a = fmaf(cv.y, bv.y, a);
        a = fmaf(cv.z, bv.z, a);
        a = fmaf(cv.w, bv.w, a);
        sc[k] = a;
      }
    }
    const int u = u0 + lane;
#pragma unroll
    for (int k = 0; k < T::RI; ++k) {
      const int i = rg + 8 * k, t = r0 + i;
      // mask before exp: u > t (and the rows past L) never reach __expf
      Ms[i * T::LDT + lane] =
          (u <= t && t < L) ? sc[k] * __expf(cum[t] - cum[u]) : 0.0f;
    }
    __syncthreads();

    // acc[t][p] += sum_u M[t][u] (dt_u x_u[p])
#pragma unroll 2
    for (int j = 0; j < TT; j += 4) {
      float4 mv[T::RI];
#pragma unroll
      for (int k = 0; k < T::RI; ++k)
        mv[k] = ld4(&Ms[(rg + 8 * k) * T::LDT + j]);
      float xv[4][T::RC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int q = 0; q < T::RC; ++q)
          xv[jj][q] = Xs[(j + jj) * T::LDP + lane + 32 * q];
#pragma unroll
      for (int k = 0; k < T::RI; ++k)
#pragma unroll
        for (int q = 0; q < T::RC; ++q) {
          float a = acc[k][q];
          a = fmaf(mv[k].x, xv[0][q], a);
          a = fmaf(mv[k].y, xv[1][q], a);
          a = fmaf(mv[k].z, xv[2][q], a);
          a = fmaf(mv[k].w, xv[3][q], a);
          acc[k][q] = a;
        }
    }
  }

#pragma unroll
  for (int k = 0; k < T::RI; ++k) {
    const int t = r0 + rg + 8 * k;
    if (t < L) {
#pragma unroll
      for (int q = 0; q < T::RC; ++q)
        y[((t0 + t) * H + h) * P + lane + 32 * q] = acc[k][q];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core branch (L = 64 or 128, N % 64 == 0): the products in 3xTF32
// ---------------------------------------------------------------------------

constexpr int KT = 64;       // steps per tile of a product over u

__device__ __forceinline__ float* align1024(void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<float*>((a + 1023) & ~uintptr_t(1023));
}

// Float offset of element (r, k) in a K-major, 128-byte-swizzled f32 tile
// of ROWS rows: K / 32 boxes of ROWS rows x 128 bytes, the 16-byte chunks
// of each row XORed with the row's index in its 8-row group (wgmma's
// canonical layout, which desc() describes).
template <int ROWS>
__device__ __forceinline__ int km_off(int r, int k) {
  return (k >> 5) * (ROWS * 32) + r * 32 + ((((k & 31) >> 2) ^ (r & 7)) << 2) +
         (k & 3);
}

// wgmma descriptor of rows [r0, r0 + 64) (or the B operand's N rows) of such
// a tile at reduction step k (a multiple of 8)
template <int ROWS>
__device__ __forceinline__ uint64_t desc(const float* tile, int r0, int k) {
  return sm90::desc_sw128(
      sm90::smem_addr(tile + (k >> 5) * (ROWS * 32) + r0 * 32) +
          (k & 31) * 4,
      0);
}

// v into the hi and lo TF32 tiles at (r, k), k a multiple of 4:
// hi = rna(v), lo = rna(v - hi), so that hi + lo carries v to ~2^-22
template <int ROWS>
__device__ __forceinline__ void put4(float* hi, float* lo, int r, int k,
                                     float4 v) {
  const int o = km_off<ROWS>(r, k);
  const float4 h = make_float4(sm90::tf32_rna(v.x), sm90::tf32_rna(v.y),
                               sm90::tf32_rna(v.z), sm90::tf32_rna(v.w));
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(lo + o) = make_float4(
      sm90::tf32_rna(v.x - h.x), sm90::tf32_rna(v.y - h.y),
      sm90::tf32_rna(v.z - h.z), sm90::tf32_rna(v.w - h.w));
}

template <int ROWS>
__device__ __forceinline__ void put1(float* hi, float* lo, int r, int k,
                                     float v) {
  const int o = km_off<ROWS>(r, k);
  const float h = sm90::tf32_rna(v);
  hi[o] = h;
  lo[o] = sm90::tf32_rna(v - h);
}

// Stages ROWS x K of a source whose row r starts at src + r * stride (K
// contiguous: K-major as stored) into the hi and lo tiles.  Every load of a
// thread's share is issued before any store, so the block waits on memory
// once, not once a row.
template <int ROWS, int K>
__device__ __forceinline__ void stage_rows(float* hi, float* lo,
                                           const float* __restrict__ src,
                                           int64_t stride) {
  constexpr int ITER = ROWS * (K / 4) / NT;
  static_assert(ITER * NT == ROWS * (K / 4), "whole passes of the block");
  float4 v[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int e = threadIdx.x + i * NT;
    v[i] = ld4(src + (e / (K / 4)) * stride + 4 * (e % (K / 4)));
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int e = threadIdx.x + i * NT;
    put4<ROWS>(hi, lo, e / (K / 4), 4 * (e % (K / 4)), v[i]);
  }
}

// The same for an MN-major source, element (r, k) = src[k * stride + r] *
// scale[k], staged transposed: lanes along r read contiguous rows.
template <int ROWS, int K>
__device__ __forceinline__ void stage_cols(float* hi, float* lo,
                                           const float* __restrict__ src,
                                           int64_t stride,
                                           const float* scale) {
  constexpr int ITER = ROWS * (K / 4) / NT;
  static_assert(ITER * NT == ROWS * (K / 4), "whole passes of the block");
  float v[ITER][4];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int e = threadIdx.x + i * NT;
    const float* col = src + (int64_t)(4 * (e / ROWS)) * stride + e % ROWS;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[i][q] = col[q * stride];
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int e = threadIdx.x + i * NT;
    const int k = 4 * (e / ROWS);
    float4 f = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    if (scale != nullptr) {
      f.x *= scale[k];
      f.y *= scale[k + 1];
      f.z *= scale[k + 2];
      f.w *= scale[k + 3];
    }
    put4<ROWS>(hi, lo, e % ROWS, k, f);
  }
}

// Issues d[64 x NN] += A[64 x (k1 - k0)] B[NN x (k1 - k0)]^T in 3xTF32
// (a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first) over reduction
// steps [k0, k1) (multiples of 8): A rows [ar0, ar0 + 64) of an AR-row
// tile, B rows [br0, br0 + NN) of a BR-row tile.  One warpgroup issues it;
// the caller fences, commits and waits (or mma3 does).
template <int NN, int AR, int BR>
__device__ __forceinline__ void mma3_issue(float (&d)[NN / 2],
                                           const float* a_hi,
                                           const float* a_lo, int ar0,
                                           const float* b_hi,
                                           const float* b_lo, int br0,
                                           int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; k += 8) {
    sm90::wgmma_tf32_ss<NN>(d, desc<AR>(a_lo, ar0, k), desc<BR>(b_hi, br0, k),
                            1);
    sm90::wgmma_tf32_ss<NN>(d, desc<AR>(a_hi, ar0, k), desc<BR>(b_lo, br0, k),
                            1);
    sm90::wgmma_tf32_ss<NN>(d, desc<AR>(a_hi, ar0, k), desc<BR>(b_hi, br0, k),
                            1);
  }
}

// mma3_issue over [0, K), fenced, committed and waited for
template <int NN, int AR, int BR, int K>
__device__ __forceinline__ void mma3(float (&d)[NN / 2], const float* a_hi,
                                     const float* a_lo, int ar0,
                                     const float* b_hi, const float* b_lo,
                                     int br0) {
  sm90::fence_regs(d);
  sm90::wgmma_fence();
  mma3_issue<NN, AR, BR>(d, a_hi, a_lo, ar0, b_hi, b_lo, br0, 0, K);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
}

// As mma3_issue, with each of the three terms in its own accumulator
// (d0 += a_hi b_hi, d1 += a_hi b_lo, d2 += a_lo b_hi): three independent
// chains keep the tensor cores busy where one chain waits on each step
template <int NN, int AR, int BR>
__device__ __forceinline__ void mma3_issue_split(
    float (&d0)[NN / 2], float (&d1)[NN / 2], float (&d2)[NN / 2],
    const float* a_hi, const float* a_lo, int ar0, const float* b_hi,
    const float* b_lo, int br0, int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; k += 8) {
    const uint64_t ah = desc<AR>(a_hi, ar0, k), bh = desc<BR>(b_hi, br0, k);
    sm90::wgmma_tf32_ss<NN>(d0, ah, bh, 1);
    sm90::wgmma_tf32_ss<NN>(d1, ah, desc<BR>(b_lo, br0, k), 1);
    sm90::wgmma_tf32_ss<NN>(d2, desc<AR>(a_lo, ar0, k), bh, 1);
  }
}

// row and column of accumulator element j of thread t of a warpgroup
__device__ __forceinline__ int acc_row(int t, int j) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int j) {
  return 8 * (j >> 2) + 2 * (t & 3) + (j & 1);
}

constexpr int SW = 32;       // n columns of a slab of C and B: one box

template <int P, int N>
struct StateTC {
  static constexpr int MT = N / 64;              // 64-row tiles of S^T
  static constexpr int NW = MT == 2 ? P : P / 2;  // S^T columns per warpgroup
  // floats: B^T (N x KT) and (w x)^T (P x KT), hi and lo; or, in a scores
  // block, a slab of C and of B (L <= 128 rows x SW each, hi and lo); +
  // alignment
  static constexpr int STATE = 2 * N * KT + 2 * P * KT, SCORES = 4 * 128 * SW;
  static constexpr int SMEM = (STATE > SCORES ? STATE : SCORES) + 256;
};

// C B^T of one L-step chunk (L = 64 or 128) of group gg: the scores that
// every head of the group shares, computed once here and not once a head,
// and written whole (L x L, f32) for ssd_chunk_out_pair.  At L = 128
// warpgroup wg takes rows [64 wg, 64 wg + 64), at L = 64 columns
// [32 wg, 32 wg + 32); the reduction over n runs in slabs of SW.
template <int N, int L>
__device__ __forceinline__ void chunk_scores(const float* __restrict__ Bm,
                                             const float* __restrict__ Cm,
                                             float* __restrict__ scores,
                                             float* smem, int S, int G,
                                             int nc, int gg) {
  constexpr int NN = L == 128 ? L : L / 2;     // columns a warpgroup
  const int c = blockIdx.x, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int r0 = L == 128 ? 64 * wg : 0, k0 = L == 128 ? 0 : NN * wg;
  float* c_hi = smem;
  float* c_lo = c_hi + L * SW;
  float* b_hi = c_lo + L * SW;
  float* b_lo = b_hi + L * SW;
  const int64_t row0 = ((int64_t)b * S + (int64_t)c * L) * G + gg;
  const int64_t stride = (int64_t)G * N;
  float sc[NN / 2];
#pragma unroll
  for (int j = 0; j < NN / 2; ++j) sc[j] = 0.f;
  for (int sl = 0; sl < N / SW; ++sl) {
    __syncthreads();                               // the last slab is read
    stage_rows<L, SW>(c_hi, c_lo, Cm + row0 * N + sl * SW, stride);
    stage_rows<L, SW>(b_hi, b_lo, Bm + row0 * N + sl * SW, stride);
    sm90::fence_proxy_async();
    __syncthreads();
    mma3<NN, L, L, SW>(sc, c_hi, c_lo, r0, b_hi, b_lo, k0);
  }
  float* out = scores + (((int64_t)b * nc + c) * G + gg) * (L * L);
#pragma unroll
  for (int j = 0; j < NN / 2; j += 2)
    *reinterpret_cast<float2*>(
        &out[(r0 + acc_row(t, j)) * L + k0 + acc_col(t, j)]) =
        make_float2(sc[j], sc[j + 1]);
}

// phase 1 on the tensor cores: S_c^T[n][p] = sum_u B_u[n] (w_u x_u[p]),
// over KT-step tiles of u; warpgroup wg takes n rows [64 wg, 64 wg + 64)
// (N = 128) or p columns [wg P / 2, ...) (N = 64)
template <int P, int N>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_state_tc(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ states,
    float* __restrict__ chunk_cum, float* __restrict__ scores, int S, int H,
    int G, int L, int nc) {
  using T = StateTC<P, N>;
  __shared__ float cum[LMAX];
  __shared__ float w[LMAX];
  __shared__ float warp_sums[NT / 32];
  extern __shared__ float4 smem_f4[];
  if (blockIdx.y >= H) {   // the grid's last G rows: the shared scores
    if (L == 128)
      chunk_scores<N, 128>(Bm, Cm, scores, align1024(smem_f4), S, G, nc,
                           blockIdx.y - H);
    else
      chunk_scores<N, 64>(Bm, Cm, scores, align1024(smem_f4), S, G, nc,
                          blockIdx.y - H);
    return;
  }
  float* bt_hi = align1024(smem_f4);            // [N rows][KT]
  float* bt_lo = bt_hi + N * KT;
  float* xt_hi = bt_lo + N * KT;                // [P rows][KT]
  float* xt_lo = xt_hi + P * KT;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;

  chunk_cumsum(dt + t0 * H + h, H, A[h], L, cum, warp_sums);
  const float cum_end = cum[L - 1];
  if (tid < L) w[tid] = __expf(cum_end - cum[tid]) * dt[(t0 + tid) * H + h];
  if (tid == 0) chunk_cum[((int64_t)b * H + h) * nc + c] = cum_end;

  const int m0 = T::MT == 2 ? 64 * wg : 0;
  const int p0 = T::MT == 2 ? 0 : wg * T::NW;
  float acc[T::NW / 2];
#pragma unroll
  for (int j = 0; j < T::NW / 2; ++j) acc[j] = 0.f;

  for (int u0 = 0; u0 < L; u0 += KT) {
    __syncthreads();   // w ready (first pass); tiles free (later passes)
    // transposed: B (u, n) -> rows n; w x (u, p) -> rows p
    stage_cols<N, KT>(bt_hi, bt_lo, Bm + ((t0 + u0) * G + g) * N,
                      (int64_t)G * N, nullptr);
    stage_cols<P, KT>(xt_hi, xt_lo, x + ((t0 + u0) * H + h) * P,
                      (int64_t)H * P, w + u0);
    sm90::fence_proxy_async();
    __syncthreads();
    mma3<T::NW, N, P, KT>(acc, bt_hi, bt_lo, m0, xt_hi, xt_lo, p0);
  }
  float* out = states + (((int64_t)b * nc + c) * H + h) * (P * N);
#pragma unroll
  for (int j = 0; j < T::NW / 2; ++j)
    out[(p0 + acc_col(t, j)) * N + m0 + acc_row(t, j)] = acc[j];
}

template <int P, int N, int L>
struct PairTC {
  static_assert(L == 64 || L == 128, "one or two 64-row tiles a chunk");
  static constexpr int NS = N / SW;             // slabs
  // y columns a warpgroup: at L = 128 each takes a row tile whole, at
  // L = 64 the two split the one tile's columns
  static constexpr int NY = L == 128 ? P : P / 2;
  // floats of one slab buffer: C (L x SW) and H_in (P x SW), hi and lo
  static constexpr int C_SL = L * SW, H_SL = P * SW;
  static constexpr int SLAB = 2 * (C_SL + H_SL);
  // after the slabs, in the same memory: M of row tile 0 (64 x 64 keys)
  // and, at L = 128, of row tile 1 (64 x 128 keys), then (dt x)^T (P x L),
  // hi and lo
  static constexpr int M0_AT = 0, M1_AT = 2 * 64 * 64;
  static constexpr int X_AT = M1_AT + (L == 128 ? 2 * 64 * 128 : 0);
  static constexpr int END = X_AT + 2 * P * L;
  static_assert(NS % 2 == 0, "the last slab lies in the second buffer");
  static constexpr int SMEM = (2 * SLAB > END ? 2 * SLAB : END) + 256;
};

// Slab sl (n columns [SW sl, SW sl + SW)) of C (L rows) and H_in (P rows)
// of one chunk, loaded into registers together, so that they are in
// flight while the previous slab is multiplied, then split and stored.
template <int P, int N, int L>
struct Slab {
  using T = PairTC<P, N, L>;
  static constexpr int PER_ROW = SW / 4;                     // float4s a row
  static constexpr int IC = L * PER_ROW / NT, IH = P * PER_ROW / NT;
  float4 c[IC], hh[IH];

  __device__ __forceinline__ void load(const float* Cc, int64_t gstride,
                                       const float* hin, int sl) {
    const int col = SW * sl;
#pragma unroll
    for (int i = 0; i < IC; ++i) {
      const int e = threadIdx.x + i * NT;
      c[i] = ld4(Cc + (e / PER_ROW) * gstride + col + 4 * (e % PER_ROW));
    }
#pragma unroll
    for (int i = 0; i < IH; ++i) {
      const int e = threadIdx.x + i * NT;
      hh[i] = ld4(hin + (e / PER_ROW) * N + col + 4 * (e % PER_ROW));
    }
  }

  __device__ __forceinline__ void store(float* buf) const {
    float* c_hi = buf;
    float* h_hi = buf + 2 * T::C_SL;
#pragma unroll
    for (int i = 0; i < IC; ++i) {
      const int e = threadIdx.x + i * NT;
      put4<L>(c_hi, c_hi + T::C_SL, e / PER_ROW, 4 * (e % PER_ROW), c[i]);
    }
#pragma unroll
    for (int i = 0; i < IH; ++i) {
      const int e = threadIdx.x + i * NT;
      put4<P>(h_hi, h_hi + T::H_SL, e / PER_ROW, 4 * (e % PER_ROW), hh[i]);
    }
  }
};

// (dt x)^T of one L-step chunk (P rows x L keys, staged transposed) and
// the chunk's shared scores for M (rows 0-63 x keys 0-63 and, at L = 128,
// rows 64-127 x keys 0-127), loaded into registers while the last slab is
// multiplied, then scaled, decayed, masked, split and stored
template <int P, int L>
struct TailStage {
  static constexpr int IX = P * (L / 4) / NT;
  static constexpr int IM = (64 * 16 + (L == 128 ? 64 * 32 : 0)) / NT;
  float v[IX][4];
  float4 m[IM];

  __device__ __forceinline__ static void m_at(int i, int& row, int& u) {
    const int e = threadIdx.x + i * NT;
    if (e < 64 * 16) {
      row = e / 16;
      u = 4 * (e % 16);
    } else {
      row = 64 + (e - 64 * 16) / 32;
      u = 4 * ((e - 64 * 16) % 32);
    }
  }

  __device__ __forceinline__ void load(const float* __restrict__ xc,
                                       int64_t stride,
                                       const float* __restrict__ sc) {
#pragma unroll
    for (int i = 0; i < IX; ++i) {
      const int e = threadIdx.x + i * NT;
      const float* col = xc + (int64_t)(4 * (e / P)) * stride + e % P;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[i][q] = col[q * stride];
    }
#pragma unroll
    for (int i = 0; i < IM; ++i) {
      int row, u;
      m_at(i, row, u);
      // keys wholly above the diagonal are never read
      m[i] = u <= row ? ld4(sc + row * L + u)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float* base, const float* dts,
                                        const float* cum, int m0_at,
                                        int m1_at, int x_at) const {
#pragma unroll
    for (int i = 0; i < IX; ++i) {
      const int e = threadIdx.x + i * NT, k = 4 * (e / P);
      put4<P>(base + x_at, base + x_at + P * L, e % P, k,
              make_float4(v[i][0] * dts[k], v[i][1] * dts[k + 1],
                          v[i][2] * dts[k + 2], v[i][3] * dts[k + 3]));
    }
#pragma unroll
    for (int i = 0; i < IM; ++i) {
      int row, u;
      m_at(i, row, u);
      const bool t1 = row >= 64;
      float* hi = base + (t1 ? m1_at : m0_at);
      const float ct = cum[row];
      // mask before exp: u > row never reaches __expf
      const float4 a = m[i];
      const float4 f = make_float4(
          u <= row ? a.x * __expf(ct - cum[u]) : 0.f,
          u + 1 <= row ? a.y * __expf(ct - cum[u + 1]) : 0.f,
          u + 2 <= row ? a.z * __expf(ct - cum[u + 2]) : 0.f,
          u + 3 <= row ? a.w * __expf(ct - cum[u + 3]) : 0.f);
      put4<64>(hi, hi + 64 * (t1 ? 128 : 64), row & 63, u, f);
    }
  }
};

// phase 3 on the tensor cores for L = 64 or 128: one block a (chunk,
// head, batch).  At L = 128 warpgroup wg takes row tile wg (rows
// 64 wg .. 64 wg + 63); at L = 64 the two warpgroups take the one row
// tile's y columns [wg P / 2, wg P / 2 + P / 2).  The inter-chunk product
// C H_in^T runs slab by slab (SW columns of n) through two buffers: while
// one slab is multiplied, the next is loaded, split and stored.  The
// scores C B^T come from the chunk-state launch, which computes them once
// for all the heads of a group; here they are decayed for this head into
// M, and y += M (dt x).
template <int P, int N, int L>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_out_pair(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Cm,
    const float* __restrict__ states, const float* __restrict__ scores,
    float* __restrict__ y, int S, int H, int G, int nc) {
  using T = PairTC<P, N, L>;
  constexpr int NY = T::NY;
  __shared__ float cum[L];
  __shared__ float dts[L];
  __shared__ float warp_sums[NT / 32];
  extern __shared__ float4 smem_f4[];
  float* base = align1024(smem_f4);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  // this warpgroup's row tile and y columns
  const int r0 = L == 128 ? 64 * wg : 0, y0 = L == 128 ? 0 : NY * wg;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t gstride = (int64_t)G * N;
  const float* Cc = Cm + (t0 * G + g) * N;
  const float* hin = states + (((int64_t)b * nc + c) * H + h) * (P * N);

  Slab<P, N, L> slab;
  slab.load(Cc, gstride, hin, 0);
  chunk_cumsum(dt + t0 * H + h, H, A[h], L, cum, warp_sums);
  if (tid < L) dts[tid] = dt[(t0 + tid) * H + h];
  slab.store(base);
  sm90::fence_proxy_async();
  __syncthreads();

  float acc[NY / 2];   // y of this warpgroup's tile: inter, then + intra
#pragma unroll
  for (int j = 0; j < NY / 2; ++j) acc[j] = 0.f;
  TailStage<P, L> tail;
#pragma unroll
  for (int sl = 0; sl < T::NS; ++sl) {
    const float* c_hi = base + (sl & 1) * T::SLAB;
    const float* h_hi = c_hi + 2 * T::C_SL;
    if (sl + 1 < T::NS) {
      slab.load(Cc, gstride, hin, sl + 1);
    } else {
      tail.load(x + (t0 * H + h) * P, (int64_t)H * P,
                scores + (((int64_t)b * nc + c) * G + g) * (L * L));
    }
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    mma3_issue<NY, L, P>(acc, c_hi, c_hi + T::C_SL, r0, h_hi,
                         h_hi + T::H_SL, y0, 0, SW);
    sm90::wgmma_commit();
    if (sl + 1 < T::NS) slab.store(base + ((sl + 1) & 1) * T::SLAB);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (sl + 1 == T::NS) {
      __syncthreads();                             // both slab buffers free
      tail.store(base, dts, cum, T::M0_AT, T::M1_AT, T::X_AT);
    }
    sm90::fence_proxy_async();
    __syncthreads();
  }

  // inter-chunk term exp(cum_t) C_t . H_in, then the intra-chunk term
  // acc[t][p] += sum_u M[t][u] (dt_u x_u[p]) over the keys up to the tile
  const int kw = r0 + 64;
#pragma unroll
  for (int j = 0; j < NY / 2; ++j) acc[j] *= __expf(cum[r0 + acc_row(t, j)]);
  const float* m_hi = base + (r0 == 0 ? T::M0_AT : T::M1_AT);
  const float* x_hi = base + T::X_AT;
  float acc1[NY / 2], acc2[NY / 2];
#pragma unroll
  for (int j = 0; j < NY / 2; ++j) acc1[j] = acc2[j] = 0.f;
  sm90::fence_regs(acc);
  sm90::fence_regs(acc1);
  sm90::fence_regs(acc2);
  sm90::wgmma_fence();
  mma3_issue_split<NY, 64, P>(acc, acc1, acc2, m_hi, m_hi + 64 * kw, 0, x_hi,
                              x_hi + P * L, y0, 0, kw);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::fence_regs(acc1);
  sm90::fence_regs(acc2);
#pragma unroll
  for (int j = 0; j < NY / 2; ++j) acc[j] += acc1[j] + acc2[j];

#pragma unroll
  for (int j = 0; j < NY / 2; j += 2) {
    const int i = acc_row(t, j), p = y0 + acc_col(t, j);
    *reinterpret_cast<float2*>(&y[((t0 + r0 + i) * H + h) * P + p]) =
        make_float2(acc[j], acc[j + 1]);
  }
}

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* h_final,
                   float* states, float* chunk_cum, float* scores, int Bt,
                   int S, int H, int G, int L, cudaStream_t stream) {
  const int nc = S / L;
  constexpr int PN = P * N;
  // the branch is chosen by shape: the tensor-core kernels take chunks of
  // one or two 64-row wgmma tiles (L = 64 or 128; mamba2's chunk is 128
  // and chunk_len halves it to 64 where s is an odd multiple of 64), and
  // the chunk state's 64-row tiles of n need N % 64 == 0
  bool tc = false;
  if constexpr (N % 64 == 0) tc = L == 64 || L == 128;
  cudaError_t err;
  if constexpr (N % 64 == 0) {
    if (tc) {
      const int smem = (int)sizeof(float) * StateTC<P, N>::SMEM;
      err = cudaFuncSetAttribute(ssd_chunk_state_tc<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      ssd_chunk_state_tc<P, N><<<dim3(nc, H + G, Bt), NT, smem, stream>>>(
          x, dt, A, Bm, Cm, states, chunk_cum, scores, S, H, G, L, nc);
    }
  }
  if (!tc)
    ssd_chunk_state<P, N><<<dim3(nc, H, Bt), NT, 0, stream>>>(
        x, dt, A, Bm, states, chunk_cum, S, H, G, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ssd_state_pass<<<dim3((PN + NT - 1) / NT, H, Bt), NT, 0, stream>>>(
      states, chunk_cum, h_final, H, PN, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (N % 64 == 0) {
    if (tc) {
      auto kernel = L == 128 ? ssd_chunk_out_pair<P, N, 128>
                             : ssd_chunk_out_pair<P, N, 64>;
      const int smem = (int)sizeof(float) * (L == 128
                                                 ? PairTC<P, N, 128>::SMEM
                                                 : PairTC<P, N, 64>::SMEM);
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(nc, H, Bt), NT, smem, stream>>>(x, dt, A, Cm, states,
                                                    scores, y, S, H, G, nc);
      return cudaGetLastError();
    }
  }
  const int smem = (int)sizeof(float) * OutTile<P, N>::SMEM;
  err = cudaFuncSetAttribute(ssd_chunk_out<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_rt = (L + TT - 1) / TT;
  ssd_chunk_out<P, N><<<dim3(nc * n_rt, H, Bt), NT, smem, stream>>>(
      x, dt, A, Bm, Cm, states, y, S, H, G, L, nc);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(int N, const float* x, const float* dt, const float* A,
                     const float* Bm, const float* Cm, float* y,
                     float* h_final, float* states, float* chunk_cum,
                     float* scores, int Bt, int S, int H, int G, int L,
                     cudaStream_t st) {
#define SSD_LAUNCH(NN)                                                       \
  launch<P, NN>(x, dt, A, Bm, Cm, y, h_final, states, chunk_cum, scores, Bt, \
                S, H, G, L, st)
  switch (N) {
    case 16:
      return SSD_LAUNCH(16);
    case 32:
      return SSD_LAUNCH(32);
    case 64:
      return SSD_LAUNCH(64);
    case 128:
      return SSD_LAUNCH(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef SSD_LAUNCH
}

}  // namespace

// Three kernel launches on `stream`: chunk states, the state pass, chunk
// outputs.  states: (Bt, S / L, H, P, N) and chunk_cum: (Bt, H, S / L)
// float32 scratch; scores: (Bt, S / L, G, L, L) float32 scratch where L
// is 64 or 128 and N % 64 == 0 (the shared C B^T of each chunk and group),
// else unused.  Returns the cudaError_t of the launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* h_final, void* states, void* chunk_cum,
                            void* scores, int Bt, int S, int H, int G, int P,
                            int N, int L, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bt == 0 || S == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || L <= 0 || L > LMAX || S % L != 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_final);
  float* sf = static_cast<float*>(states);
  float* cf = static_cast<float*>(chunk_cum);
  float* scf = static_cast<float*>(scores);
  if (P == 32)
    return (int)launch_n<32>(N, xf, dtf, Af, Bf, Cf, yf, hf, sf, cf, scf, Bt,
                             S, H, G, L, st);
  if (P == 64)
    return (int)launch_n<64>(N, xf, dtf, Af, Bf, Cf, yf, hf, sf, cf, scf, Bt,
                             S, H, G, L, st);
  return (int)cudaErrorInvalidValue;
}
