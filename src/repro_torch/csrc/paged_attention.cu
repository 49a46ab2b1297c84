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
// token) and does only ~4 * G flops per element read, far below the
// ~295 flops per byte at which the H100 turns compute-bound.
//
// What this first version does about that: each block reads only the
// pages a sequence can see -- from the page holding the first token inside
// the sliding window to ceil(length / page_size) -- where the TPU kernel
// walks all Pmax pages and masks; the G = H / Kv query rows of a kv head
// share every page load (one block per (kv head, sequence)); scores and the
// online-softmax state stay in shared memory.  Tokens are gathered in
// chunks of 64 with 16-byte loads.  It does not yet split a long sequence
// across blocks (flash-decoding) or overlap the next chunk's loads with the
// current chunk's math, so at small batch it leaves most SMs idle and
// waits on memory latency: those are the next steps.
//
// Numerics follow the TPU kernel: sm_scale = D^-0.5, optional tanh
// soft-cap, token j visible iff j < length and (no window or
// j > length - 1 - window), masked scores filled with -2^30, online softmax
// in f32, l == 0 guarded to 1, output in the input type.
//
// Layout: q (B, H, D); k_pages and v_pages (Kv, n_pages, page_size, D) of
// q's type; page_table (B, Pmax) int32; lengths (B,) int32; out (B, H, D).
// f32 or bf16, D in {64, 128}.  Every lengths[b] <= Pmax * page_size and
// every page index < n_pages (the serving engine guarantees both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;    // tokens gathered per chunk
constexpr int NT = 128;   // threads per block
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

__device__ __forceinline__ void store8(float* dst, const float* x) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(x[0], x[1], x[2], x[3]);
  d[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths, T* __restrict__ out, int H,
                 int Kv, int n_pages, int page_size, int pmax, int window,
                 int has_cap, float cap, float sm_scale) {
  constexpr int LD = D + 4;   // padded row stride of the q/k/v tiles
  constexpr int PER_ROW = D / 8;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem_f4[];
  float* sK = reinterpret_cast<float*>(smem_f4);   // CH x LD
  float* sV = sK + CH * LD;                         // CH x LD
  float* sQ = sV + CH * LD;                         // G x LD
  float* sS = sQ + G * LD;                          // G x CH scores, then p
  float* sAcc = sS + G * CH;                        // G x D accumulator
  float* sM = sAcc + G * D;                         // G running max
  float* sL = sM + G;                               // G running denominator
  float* sAlpha = sL + G;                           // G rescale of a chunk

  const int len = lengths[b];
  const int* pt = page_table + (long)b * pmax;
  const T* qb = q + ((long)b * H + (long)kvh * G) * D;
  for (int i = tid; i < G * PER_ROW; i += NT) {
    const int g = i / PER_ROW, c = (i % PER_ROW) * 8;
    float x[8];
    load8(qb + (long)g * D + c, x);
    store8(sQ + g * LD + c, x);
  }
  for (int i = tid; i < G * D; i += NT) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  // visit only the pages this sequence can see
  const int first = window > 0 ? max(0, len - window) : 0;
  const int t_begin = (first / page_size) * page_size;
  const long pool_head = (long)kvh * n_pages * page_size * D;
  const T* kb = k_pages + pool_head;
  const T* vb = v_pages + pool_head;

  for (int c0 = t_begin; c0 < len; c0 += CH) {
    __syncthreads();   // the previous chunk is consumed; set-up is visible
    for (int i = tid; i < CH * PER_ROW; i += NT) {
      const int j = i / PER_ROW, c = (i % PER_ROW) * 8;
      const int tok = c0 + j;
      float xk[8], xv[8];
      if (tok < len) {
        const long off =
            ((long)pt[tok / page_size] * page_size + tok % page_size) * D + c;
        load8(kb + off, xk);
        load8(vb + off, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xk[e] = xv[e] = 0.f;
      }
      store8(sK + j * LD + c, xk);
      store8(sV + j * LD + c, xv);
    }
    __syncthreads();

    for (int i = tid; i < G * CH; i += NT) {
      const int g = i / CH, j = i % CH;
      const float* qr = sQ + g * LD;
      const float* kr = sK + j * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(a.x, c.x, dot);
        dot = fmaf(a.y, c.y, dot);
        dot = fmaf(a.z, c.z, dot);
        dot = fmaf(a.w, c.w, dot);
      }
      const int col = c0 + j;
      float x = dot * sm_scale;
      if (has_cap) x = cap * tanhf(x / cap);
      bool ok = col < len;
      if (window > 0) ok = ok && col > len - 1 - window;
      sS[i] = ok ? x : NEG_INF;
    }
    __syncthreads();

    // online-softmax statistics: one warp per query row, two columns a lane
    for (int g = warp; g < G; g += NT / 32) {
      const float x0 = sS[g * CH + lane], x1 = sS[g * CH + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      sS[g * CH + lane] = p0;
      sS[g * CH + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();   // every lane has read sM[g] before lane 0 rewrites it
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = alpha * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      const float* pr = sS + g * CH;
      float a = sAcc[i] * sAlpha[g];
#pragma unroll 8
      for (int j = 0; j < CH; ++j) a = fmaf(pr[j], sV[j * LD + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((long)b * H + (long)kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const float l = sL[i / D];
    store1(ob + i, sAcc[i] / (l == 0.f ? 1.f : l));   // fully-masked guard
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out,
                   int B, int H, int Kv, int n_pages, int page_size, int pmax,
                   int window, int has_cap, float cap, float sm_scale,
                   cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int G = H / Kv;
  const int smem = (int)sizeof(float) *
                   (2 * CH * LD + G * LD + G * CH + G * D + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Kv, B);
  paged_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Kv, n_pages,
      page_size, pmax, window, has_cap, cap, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* page_table,
                                   const void* lengths, void* out, int B,
                                   int H, int Kv, int D, int n_pages,
                                   int page_size, int pmax, int dtype,
                                   int window, int has_cap, float cap,
                                   float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Kv <= 0 || H % Kv != 0 || page_size <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k_pages, v_pages, page_table, lengths,
                                  out, B, H, Kv, n_pages, page_size, pmax,
                                  window, has_cap, cap, sm_scale, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k_pages, v_pages, page_table, lengths,
                                   out, B, H, Kv, n_pages, page_size, pmax,
                                   window, has_cap, cap, sm_scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k_pages, v_pages, page_table,
                                          lengths, out, B, H, Kv, n_pages,
                                          page_size, pmax, window, has_cap,
                                          cap, sm_scale, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k_pages, v_pages, page_table,
                                           lengths, out, B, H, Kv, n_pages,
                                           page_size, pmax, window, has_cap,
                                           cap, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
