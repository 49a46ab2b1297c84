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
// What the design does about that: one pass over the flat buffer, each
// element read once from every input and written once, with no
// intermediate in device memory (the TPU kernel's reason to exist: XLA would
// materialise the f32 upcasts).  Accesses are 16 bytes (float4, or 8 bf16
// as a uint4).  The TPU's (8, 1024) tiling is not kept: the buffer is walked
// flat, and a scalar loop takes the tail that does not fill a 16-byte
// vector.
//
// Degrees 1 and 2 -- every one-peer exponential Shifts and every Matching
// is degree 1 -- have their own kernels: the receive pointers and weights
// are read from the table once, into registers, the loop over the receives
// is unrolled, and the grid is full (one vector of each input per thread,
// as PyTorch's own elementwise kernels launch).  On the H100, at (4, 2^27)
// f32 degree 1, variants measured slower than this: one resident wave
// walking the buffer in grid-stride steps (whatever the loads in flight per
// thread, 1 to 8 vectors), streaming hints (__ldcs / __stcs) on top of that,
// and four vectors per thread instead of one.  The full grid reaches
// torch.lerp, which computes the same degree-1 function.
//
// Any other degree takes the generic kernel: the degree is a run-time value,
// and the receive pointers and weights (degree pointers, then degree
// doubles, in one table in device memory) are copied to shared memory first
// (12 bytes per receive), so any degree up to 4096 runs with the default
// 48 KB of shared memory -- ceca over a prime n <= 1024, the largest degree
// any topology reaches there, has 1020 shifts.
//
// Counts and indices are 64-bit: the training payload exceeds 2^31
// elements.
//
// Rounding: every receive term is accumulated with an explicit fmaf (one
// rounding per term, in table order), as the plain version's add_(alpha=w)
// does on the card, so the fast kernels give the generic one's bits; the
// JAX reference rounds the product and the sum separately.
// Either is within the reference's tolerance (1e-5, tests/test_kernels.py).
//
// Layout: x, every receive and out are contiguous, of one type, with
// 16-byte-aligned starts (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int BLOCKS_PER_SM = 8;  // generic kernel: a grid-stride pass

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

// Degree DEG (1 or 2): the receive pointers and weights in registers, the
// loop over them unrolled, and a full grid of one 16-byte vector per input
// per thread.  The arithmetic per element is the generic kernel's, term for
// term.
template <typename T, int DEG>
__global__ void __launch_bounds__(NT)
gossip_mix_fast(const T* __restrict__ x, const void* __restrict__ table,
                float w_self, T* __restrict__ out, int64_t n) {
  const uint64_t* tab = static_cast<const uint64_t*>(table);
  const double* wtab = reinterpret_cast<const double*>(tab + DEG);
  const T* recv[DEG];
  float w[DEG];
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    recv[d] = reinterpret_cast<const T*>(tab[d]);
    w[d] = static_cast<float>(wtab[d]);
  }

  using V = Vec<T>;
  constexpr int VN = V::N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t n_vec = n / VN;
  for (int64_t v = first; v < n_vec; v += stride) {   // once, on a full grid
    const int64_t at = v * VN;
    float acc[VN], r[VN];
    V::load(x + at, acc);
#pragma unroll
    for (int i = 0; i < VN; ++i) acc[i] *= w_self;
#pragma unroll
    for (int d = 0; d < DEG; ++d) {
      V::load(recv[d] + at, r);
#pragma unroll
      for (int i = 0; i < VN; ++i) acc[i] = fmaf(w[d], r[i], acc[i]);
    }
    V::store(out + at, acc);
  }
  // the tail that does not fill a vector (fewer than VN elements)
  for (int64_t i = n_vec * VN + first; i < n; i += stride) {
    float acc = V::one(x[i]) * w_self;
#pragma unroll
    for (int d = 0; d < DEG; ++d) acc = fmaf(w[d], V::one(recv[d][i]), acc);
    out[i] = V::cast(acc);
  }
}

template <typename T, int DEG>
cudaError_t launch_fast(const void* x, const void* table, float w_self,
                        void* out, int64_t n, cudaStream_t st) {
  const int64_t n_vec = (n + Vec<T>::N - 1) / Vec<T>::N;
  const int64_t want = (n_vec + NT - 1) / NT;
  const int blocks = static_cast<int>(want < INT_MAX ? want : INT_MAX);
  gossip_mix_fast<T, DEG><<<blocks, NT, 0, st>>>(
      static_cast<const T*>(x), table, w_self, static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* table, int deg, float w_self,
                   void* out, int64_t n, cudaStream_t st) {
  if (deg == 1) return launch_fast<T, 1>(x, table, w_self, out, n, st);
  if (deg == 2) return launch_fast<T, 2>(x, table, w_self, out, n, st);
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
