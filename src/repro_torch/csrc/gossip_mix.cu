// Gossip mix -- the weighted combine after every gossip permute -- for
// sm_90a (H100).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix/kernel.py:34
// (gossip_mix_kernel, body _mix_kernel at :24), which the training step runs
// on every static Shifts/Matching round through core/gossip.py _combine:
//
//   out = w_self * x + sum_d w_d * recv_d     (f32 accumulation, out in x's
//                                              type: f32 or bf16)
//
// What bounds it on this card: it does 2 * (1 + degree) floating-point
// operations per element on (2 + degree) * sizeof(T) bytes of traffic, far
// below the card's ~20 FLOP/byte f32 balance, so memory bandwidth bounds
// it: (2 + degree) * N * sizeof(T) / 3.35 TB/s.  At the training payload of
// full-width qwen3-0.6b cut to 8 layers on 4 nodes (x and one receive of
// 4 x 562.8M f32) that is 27 GB, about 8 ms.
//
// What this first version does about that: one pass over the flat buffer,
// each element read once from every input and written once, with no
// intermediate in device memory (the TPU kernel's reason to exist: XLA would
// materialise the f32 upcasts).  Each thread moves 16 bytes per access
// (float4, or 8 bf16 as a uint4) in a grid-stride loop, and the grid is
// sized to keep every one of the SMs busy (8 blocks of 256 threads each), so
// enough loads are in flight to saturate HBM.  The TPU's (8, 1024) tiling is
// not kept: the buffer is walked flat, and a scalar loop takes the tail that
// does not fill a 16-byte vector.
//
// The degree is a run-time value.  The receive pointers and the weights
// arrive in one table in device memory (degree pointers, then degree
// doubles), which each block copies to shared memory first (12 bytes per
// receive), so any degree up to 4096 runs with the default 48 KB of shared
// memory -- ceca over a prime n <= 1024, the largest degree any topology
// reaches there, has 1020 shifts.
//
// Counts and indices are 64-bit: the training payload exceeds 2^31
// elements.
//
// Rounding: every receive term is accumulated with an explicit fmaf (one
// rounding per term), as the plain version's add_(alpha=w) does on the
// card; the JAX reference rounds the product and the sum separately.
// Either is within the reference's tolerance (1e-5, tests/test_kernels.py).
//
// Layout: x, every receive and out are contiguous, of one type, with
// 16-byte-aligned starts (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int BLOCKS_PER_SM = 8;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float one(float v) { return v; }
  __device__ static float cast(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
  __device__ static float one(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
};

// table: deg receive pointers (8 bytes each), then deg weights (doubles)
template <typename T>
__global__ void __launch_bounds__(NT)
gossip_mix_kernel(const T* __restrict__ x, const void* __restrict__ table,
                  int deg, float w_self, T* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T** recv = reinterpret_cast<const T**>(smem);
  float* w = reinterpret_cast<float*>(smem + sizeof(void*) * deg);
  const uint64_t* tab = static_cast<const uint64_t*>(table);
  const double* wtab = reinterpret_cast<const double*>(tab + deg);
  for (int d = threadIdx.x; d < deg; d += NT) {
    recv[d] = reinterpret_cast<const T*>(tab[d]);
    w[d] = static_cast<float>(wtab[d]);
  }
  __syncthreads();

  using V = Vec<T>;
  constexpr int VN = V::N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t n_vec = n / VN;
  for (int64_t v = first; v < n_vec; v += stride) {
    const int64_t at = v * VN;
    float acc[VN], r[VN];
    V::load(x + at, acc);
#pragma unroll
    for (int i = 0; i < VN; ++i) acc[i] *= w_self;
    for (int d = 0; d < deg; ++d) {
      V::load(recv[d] + at, r);
      const float wd = w[d];
#pragma unroll
      for (int i = 0; i < VN; ++i) acc[i] = fmaf(wd, r[i], acc[i]);
    }
    V::store(out + at, acc);
  }
  // the tail that does not fill a vector (fewer than VN elements)
  for (int64_t i = n_vec * VN + first; i < n; i += stride) {
    float acc = V::one(x[i]) * w_self;
    for (int d = 0; d < deg; ++d) acc = fmaf(w[d], V::one(recv[d][i]), acc);
    out[i] = V::cast(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* table, int deg, float w_self,
                   void* out, int64_t n, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n_vec = (n + Vec<T>::N - 1) / Vec<T>::N;
  const int64_t want = (n_vec + NT - 1) / NT;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const size_t shmem = (sizeof(void*) + sizeof(float)) * deg;
  gossip_mix_kernel<T><<<blocks, NT, shmem, st>>>(
      static_cast<const T*>(x), table, deg, w_self, static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (kernels/build.py DTYPE_CODES).
// Returns the launch's cudaError_t (0 on success).
extern "C" int gossip_mix(const void* x, const void* table, int deg,
                          float w_self, void* out, long long n, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (n < 0 || deg < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, table, deg, w_self, out, n, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, table, deg, w_self, out, n, st);
  return (int)cudaErrorInvalidValue;
}
