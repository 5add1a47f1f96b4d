// Shared pieces of the batched 4-point solve kernels (K1, K3, K4, K5).
//
// Layout: plain component-major SoA.  A batch of B minimal sets is (8, B):
// component k of hypothesis i at ptr[k * B + i]; the output is (9, B), H
// row-major.  No 128-lane padding: the kernel masks the ragged edge.
//   K1, K3, K4: float32 or bfloat16 storage in and out, float32 arithmetic,
//               H up to scale.
//   K5:         float32 or float64 storage in, float64 arithmetic and
//               output, H divided by its h22.
//
// One thread per hypothesis: 16 coalesced loads, the solver's core in
// registers, 9 coalesced stores.  A core is a struct with
//   using T = <its arithmetic type>;
//   static __device__ void run(const T (&s)[8], const T (&t)[8], T (&h)[9]);
// or, with `static constexpr bool kTakesLoader = true`, a run(loader, h)
// that reads its minimal set itself, as often as it likes (SetLoader below);
// `static constexpr int kSmemFloats` asks for that many floats of dynamic
// shared memory per thread of the block.  A core follows its PyTorch core (sks_tpu_torch/ops/*.py) op for op, in the
// same order: built with -fmad=false and without fast math, every product,
// sum, IEEE division and sqrt rounds as the eager op does, in float32 and in
// float64 alike, so a kernel and its plain version agree bit for bit.  The
// cores are templates on T (aca.cuh, sks.cuh, baselines.cuh), single-source
// over float32 and float64 as the JAX cores are over f32 and DF.
//
// Everything here has internal linkage: each .cu that includes it gets its
// own copy, and the sources link into one library without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void load(const float* p, float& v) { v = *p; }
__device__ __forceinline__ void load(const __nv_bfloat16* p, float& v) {
  v = __bfloat162float(*p);
}
// Widening is exact, as Tensor.double() is.
__device__ __forceinline__ void load(const float* p, double& v) {
  v = static_cast<double>(*p);
}
__device__ __forceinline__ void load(const double* p, double& v) { v = *p; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as Tensor.to(bfloat16)
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// IEEE sqrt and |v| in the arithmetic type (no fast math: sqrtf rounds
// correctly, as torch.sqrt does).
__device__ __forceinline__ float ieee_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ieee_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float absval(float v) { return fabsf(v); }
__device__ __forceinline__ double absval(double v) { return fabs(v); }

// max(v, lo) that keeps a NaN, as torch.clamp(v, min=lo) and jnp.maximum do
// (fmaxf would return lo).
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return (v > lo || v != v) ? v : lo;
}

// The smallest normal float32, torch.finfo(torch.float32).tiny.
constexpr float kTiny = 1.17549435082228750797e-38f;

// What a core may declare (see above), with the defaults of one that does not.
template <typename Core, typename = void>
struct CoreTakesLoader : std::false_type {};
template <typename Core>
struct CoreTakesLoader<Core, std::void_t<decltype(Core::kTakesLoader)>>
    : std::integral_constant<bool, Core::kTakesLoader> {};
template <typename Core, typename = void>
struct CoreSmemFloats : std::integral_constant<int, 0> {};
template <typename Core>
struct CoreSmemFloats<Core, std::void_t<decltype(Core::kSmemFloats)>>
    : std::integral_constant<int, Core::kSmemFloats> {};

// Reads hypothesis i's minimal set from the (8, B) inputs.  Every call reads
// device memory anew: the index passes through an empty asm, so the compiler
// cannot take a second call's values from the registers of the first and
// keep them alive in between.
template <typename In>
struct SetLoader {
  const In* __restrict__ src;
  const In* __restrict__ tar;
  long long b, i;
  template <typename T>
  __device__ __forceinline__ void operator()(T (&s)[8], T (&t)[8]) const {
    long long j = i;
    asm volatile("" : "+l"(j));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      load(src + k * b + j, s[k]);
      load(tar + k * b + j, t[k]);
    }
  }
};

// MIN_BLOCKS is __launch_bounds__'s second argument: the resident blocks per
// SM the compiler must leave registers for; 0 leaves the choice to it (an
// explicit 1 is not the same: it takes it as leave to use every register).
template <typename In, typename Out, typename Core, int THREADS,
          bool NORMALIZE, int MIN_BLOCKS = 0>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
solve_soa_kernel(const In* __restrict__ src, const In* __restrict__ tar,
                 Out* __restrict__ out, long long b) {
  using T = typename Core::T;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= b) return;
  T h[9];
  if constexpr (CoreTakesLoader<Core>::value) {
    const SetLoader<In> loader{src, tar, b, i};
    Core::run(loader, h);
  } else {
    T s[8], t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      load(src + k * b + i, s[k]);
      load(tar + k * b + i, t[k]);
    }
    Core::run(s, t, h);
  }
  if constexpr (NORMALIZE) {
    // K5's epilogue (df64_pallas.py:103): every entry, h22 included, over
    // the h22 the core returned, by a true division (h / h[8] in PyTorch).
    const T h22 = h[8];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = h[k] / h22;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) store(out + k * b + i, h[k]);
}

// Launches on the given stream, allocates nothing, does not synchronise;
// returns cudaGetLastError().  The dynamic shared memory a core asks for
// stays under the 48 KB that need no cudaFuncSetAttribute (static_assert).
template <typename In, typename Out, typename Core, int THREADS,
          bool NORMALIZE, int MIN_BLOCKS = 0>
int launch_solve_soa(const void* src, const void* tar, void* out, long long b,
                     void* stream) {
  constexpr size_t smem = sizeof(float) * CoreSmemFloats<Core>::value * THREADS;
  static_assert(smem <= 48 * 1024, "needs cudaFuncSetAttribute");
  const long long blocks = (b + THREADS - 1) / THREADS;
  solve_soa_kernel<In, Out, Core, THREADS, NORMALIZE, MIN_BLOCKS>
      <<<static_cast<unsigned>(blocks), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const In*>(src), static_cast<const In*>(tar),
          static_cast<Out*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The two exported C entry points of one float32-arithmetic solver (K1, K3,
// K4; float32 and bfloat16 storage): sks_<name>_f32 and sks_<name>_bf16.
#define SKS_EXPORT_SOLVE(name, Core, THREADS)                                 \
  extern "C" int sks_##name##_f32(const void* src, const void* tar,           \
                                  void* out, long long b, void* stream) {     \
    return launch_solve_soa<float, float, Core, THREADS, false>(              \
        src, tar, out, b, stream);                                            \
  }                                                                           \
  extern "C" int sks_##name##_bf16(const void* src, const void* tar,          \
                                   void* out, long long b, void* stream) {    \
    return launch_solve_soa<__nv_bfloat16, __nv_bfloat16, Core, THREADS,      \
                            false>(src, tar, out, b, stream);                 \
  }

// The two exported C entry points of one K5 kind (float64 arithmetic and
// output, h22-normalized; float32 or float64 storage in):
// sks_fp64_<kind>_f32 and sks_fp64_<kind>_f64.  MIN_BLOCKS as in
// solve_soa_kernel.
#define SKS_EXPORT_FP64_BOUNDED(kind, Core, THREADS, MIN_BLOCKS)              \
  extern "C" int sks_fp64_##kind##_f32(const void* src, const void* tar,      \
                                       void* out, long long b,                \
                                       void* stream) {                        \
    return launch_solve_soa<float, double, Core, THREADS, true, MIN_BLOCKS>(  \
        src, tar, out, b, stream);                                            \
  }                                                                           \
  extern "C" int sks_fp64_##kind##_f64(const void* src, const void* tar,      \
                                       void* out, long long b,                \
                                       void* stream) {                        \
    return launch_solve_soa<double, double, Core, THREADS, true, MIN_BLOCKS>( \
        src, tar, out, b, stream);                                            \
  }
#define SKS_EXPORT_FP64(kind, Core, THREADS) \
  SKS_EXPORT_FP64_BOUNDED(kind, Core, THREADS, 0)
