// Causal GQA flash attention, forward only, for sm_90a (H100).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:83
// (flash_attention_kernel, body _attn_kernel at :31), which the serving
// prefill runs once per layer through models/attention.py attn_apply.
//
// What bounds it on this card: a causal call does 2*2*B*H*S*(S+1)/2*D
// floating-point operations on B*(S*H + 2*T*Kv)*D input elements, so its
// intensity grows with S and tensor-core FLOPs bound it at the prefill
// lengths of the serving path (hundreds of tokens and up).
//
// What this first version does about that: it keeps every intermediate out
// of device memory (scores, probabilities and the running softmax state
// live in shared memory and registers, as on the TPU), reads each K/V tile
// once per 64 query rows, reads the kv head h / G directly instead of
// materialising the G-fold repeat the TPU wrapper builds, and skips the key
// tiles past the causal diagonal and before the sliding window instead of
// masking them.  The products are plain f32 FMA loops over shared-memory
// tiles (no tensor cores yet), so it is far from the bound: moving QK^T and
// PV onto wgmma with TMA-fed tiles is the next step.
//
// Numerics follow the TPU kernel: sm_scale = D^-0.5, optional tanh
// soft-cap, masked scores filled with -2^30 (finite, never -inf), online
// softmax (m, l, acc) in f32, l == 0 guarded to 1, output in the input type.
//
// Layout: q (B, S, H, D), k and v (B, T, Kv, D), out (B, S, H, D), all
// contiguous, f32 or bf16, D in {64, 128}.  One block of 128 threads per
// (64-row query tile, query head, batch); two threads share a query row,
// each owning 32 of a key tile's 64 columns and half of the D output
// columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int Kv, int causal,
                   int window, int has_cap, float cap, float sm_scale,
                   cudaStream_t stream) {
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
    return (int)launch<float, 64>(q, k, v, out, B, S, Tk, H, Kv, causal,
                                  window, has_cap, cap, sm_scale, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, out, B, S, Tk, H, Kv, causal,
                                   window, has_cap, cap, sm_scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Tk, H, Kv,
                                          causal, window, has_cap, cap,
                                          sm_scale, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, B, S, Tk, H, Kv,
                                           causal, window, has_cap, cap,
                                           sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
