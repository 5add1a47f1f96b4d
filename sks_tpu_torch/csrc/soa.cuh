// Shared pieces of the batched 4-point solve kernels (K1, K3, K4).
//
// Layout: plain component-major SoA.  A batch of B minimal sets is (8, B):
// component k of hypothesis i at ptr[k * B + i]; the output is (9, B), the
// up-to-scale H row-major.  No 128-lane padding: the kernel masks the ragged
// edge.  Storage is float32 or bfloat16; arithmetic is always float32.
//
// One thread per hypothesis: 16 coalesced loads, the solver's core in
// registers, 9 coalesced stores.  A core is a struct with
//   static __device__ void run(const float (&s)[8], const float (&t)[8],
//                              float (&h)[9]);
// that follows its PyTorch core (sks_tpu_torch/ops/*.py) op for op, in the
// same order: built with -fmad=false and without fast math, every product,
// sum, IEEE division and sqrt rounds as the eager op does, so a kernel and
// its plain version agree bit for bit.
//
// Everything here has internal linkage: each .cu that includes it gets its
// own copy, and the sources link into one library without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as Tensor.to(bfloat16)
}

// max(v, lo) that keeps a NaN, as torch.clamp(v, min=lo) and jnp.maximum do
// (fmaxf would return lo).
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return (v > lo || v != v) ? v : lo;
}

// The smallest normal float32, torch.finfo(torch.float32).tiny.
constexpr float kTiny = 1.17549435082228750797e-38f;

template <typename T, typename Core, int THREADS>
__global__ void __launch_bounds__(THREADS)
solve_soa_kernel(const T* __restrict__ src, const T* __restrict__ tar,
                 T* __restrict__ out, long long b) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= b) return;
  float s[8], t[8], h[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = load_f32(src + k * b + i);
    t[k] = load_f32(tar + k * b + i);
  }
  Core::run(s, t, h);
#pragma unroll
  for (int k = 0; k < 9; ++k) store_f32(out + k * b + i, h[k]);
}

// Launches on the given stream, allocates nothing, does not synchronise;
// returns cudaGetLastError().
template <typename T, typename Core, int THREADS>
int launch_solve_soa(const void* src, const void* tar, void* out, long long b,
                     void* stream) {
  const long long blocks = (b + THREADS - 1) / THREADS;
  solve_soa_kernel<T, Core, THREADS>
      <<<static_cast<unsigned>(blocks), THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(src), static_cast<const T*>(tar),
          static_cast<T*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The two exported C entry points of one solver (float32 and bfloat16
// storage): sks_<name>_f32 and sks_<name>_bf16.
#define SKS_EXPORT_SOLVE(name, Core, THREADS)                                 \
  extern "C" int sks_##name##_f32(const void* src, const void* tar,           \
                                  void* out, long long b, void* stream) {     \
    return launch_solve_soa<float, Core, THREADS>(src, tar, out, b, stream);  \
  }                                                                           \
  extern "C" int sks_##name##_bf16(const void* src, const void* tar,          \
                                   void* out, long long b, void* stream) {    \
    return launch_solve_soa<__nv_bfloat16, Core, THREADS>(src, tar, out, b,   \
                                                          stream);            \
  }
