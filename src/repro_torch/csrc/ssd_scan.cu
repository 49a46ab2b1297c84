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
// a chunk needs ~7.4 MFLOP (the causal half of C B^T and of M (dt x), plus
// C H_in and the chunk state B^T (w x)) against ~70 KB of inputs and
// outputs, ~100 FLOP per byte: float32 arithmetic bounds it (67 TFLOP/s
// outside the tensor cores; TF32's ~3 digits would break the reference's
// 1e-3 tolerance, so no tensor cores in this version).
//
// What this version does about that, and how the TPU design changes:
//   * The TPU kernel carries the (N, P) state in VMEM scratch across a
//     SEQUENTIAL chunk axis of its grid.  Blocks on a GPU run in no order,
//     so the scan is split as in the SSD paper's GPU algorithm, into three
//     launches per call:
//       1. ssd_chunk_state: every chunk's local state
//          S_c = sum_u exp(cum_end - cum_u) dt_u x_u B_u^T and its total
//          decay cum_end, in parallel over (chunk, head, batch);
//       2. ssd_state_pass: the short sequential pass over chunks, parallel
//          over the P * N state elements of each (b, h): it overwrites S_c
//          with the state ENTERING chunk c and writes h_final;
//       3. ssd_chunk_out: y, in parallel over (row tile of 32 steps, chunk,
//          head, batch): the inter-chunk term from the entering state, then
//          the intra-chunk term over the 32-step key tiles at or below the
//          row tile (tiles above the diagonal are skipped, not masked).
//     At b = 1, S = 2048 that is 1,024 blocks for phase 1 and 4,096 for
//     phase 3 against 132 SMs, where one block per (b, h) would give 64.
//   * Shared memory: a whole chunk's C, B, x and L x L score tile would not
//     fit in a block's 227 KB with room to spare.  Phase 3 keeps a 32-row
//     tile of C, the entering state (P x N), and one 32-row key tile of B,
//     dt x and scores at a time (80 KB at P 64, N 128, opted in above
//     48 KB); phase 1 streams B and w x through 32-row tiles (29 KB).
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
//   * The products are float32 FMA loops over shared-memory tiles, with
//     the row operand of each read as a broadcast float4.  wgmma with 3xTF32
//     and TMA-fed tiles is the next step.
//
// cum is a block-wide scan (warp shuffles) in a fixed order, computed by
// the same function in phases 1 and 3, so both see the same values; its
// order differs from a sequential cumsum by float32 rounding only.
//
// Layout: x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C (Bt, S, G, N),
// y (Bt, S, H, P), h_final (Bt, H, P, N), all contiguous float32 with
// 16-byte-aligned starts; scratch: states (Bt, nc, H, P, N) and chunk
// decays (Bt, H, nc), float32, allocated by the caller.  S = nc * L,
// L <= 256, P in {32, 64}, N in {16, 32, 64, 128}.

#include <cuda_runtime.h>

#include <cstdint>

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

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* h_final,
                   float* states, float* chunk_cum, int Bt, int S, int H,
                   int G, int L, cudaStream_t stream) {
  const int nc = S / L;
  ssd_chunk_state<P, N><<<dim3(nc, H, Bt), NT, 0, stream>>>(
      x, dt, A, Bm, states, chunk_cum, S, H, G, L, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int PN = P * N;
  ssd_state_pass<<<dim3((PN + NT - 1) / NT, H, Bt), NT, 0, stream>>>(
      states, chunk_cum, h_final, H, PN, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

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
                     float* h_final, float* states, float* chunk_cum, int Bt,
                     int S, int H, int G, int L, cudaStream_t st) {
  switch (N) {
    case 16:
      return launch<P, 16>(x, dt, A, Bm, Cm, y, h_final, states, chunk_cum,
                           Bt, S, H, G, L, st);
    case 32:
      return launch<P, 32>(x, dt, A, Bm, Cm, y, h_final, states, chunk_cum,
                           Bt, S, H, G, L, st);
    case 64:
      return launch<P, 64>(x, dt, A, Bm, Cm, y, h_final, states, chunk_cum,
                           Bt, S, H, G, L, st);
    case 128:
      return launch<P, 128>(x, dt, A, Bm, Cm, y, h_final, states, chunk_cum,
                            Bt, S, H, G, L, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Three kernel launches on `stream`: chunk states, the state pass, chunk
// outputs.  states: (Bt, S / L, H, P, N) and chunk_cum: (Bt, H, S / L)
// float32 scratch.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* h_final, void* states, void* chunk_cum,
                            int Bt, int S, int H, int G, int P, int N, int L,
                            void* stream) {
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
  if (P == 32)
    return (int)launch_n<32>(N, xf, dtf, Af, Bf, Cf, yf, hf, sf, cf, Bt, S,
                             H, G, L, st);
  if (P == 64)
    return (int)launch_n<64>(N, xf, dtf, Af, Bf, Cf, yf, hf, sf, cf, Bt, S,
                             H, G, L, st);
  return (int)cudaErrorInvalidValue;
}
