// Timing instruments for K4-NDLT, K5-ndlt, K4-HO and K5-ho, not kernels of
// any path: instances of the NDLT and HO solves that differ from the shipped
// ones (../baselines.cu, ../fp64.cu) in one thing each, so that a run on the
// card can say what sets their time.  bench/ndlt_ablation.py and
// bench/ho_ablation.py build the sources of this directory into a library of
// their own, when they are asked to, and drive them; the package's kernel
// library does not hold them.
//
// NDLT, sks_ndlt_abl_<tag>:
//   regs_s<S>_l<L>       (sweeps.cu, full.cu) the form K4-NDLT had before
//                        its redesign, with v and the normal matrix in
//                        registers, at S seed sweeps and L inverse-iteration
//                        solves.  regs_s3_l3 is that kernel; fewer sweeps or
//                        solves compute another function and are only timed.
//   regs_s3_l3_mb<K>     (caps.cu) regs_s3_l3 under __launch_bounds__(64, K):
//                        K = 6 caps a thread at 168 registers, K = 8 at 128,
//                        spills and all.
//   regs_roll            (rolled.cu) v in registers, the 3 sweeps a loop
//                        instead of unrolled (a third of the seed's code).
//   regs_roll_reload_mb6 (rolled.cu) the same with the normal matrix rebuilt
//                        after the seed, capped at 168 registers: the form
//                        K5-ndlt ships, in float32.
//   f64_regs             (f64.cu) K5-ndlt as it stood before its redesign.
//   f64_smem_reload      (f64.cu) K5-ndlt in the form K4-NDLT ships.
//   ieee, f64_ieee       (ieee.cu) the shipped K4-NDLT and K5-ndlt with the
//                        rotation as it was before HO's redesign (AngleIeee).
// All the others rotate by the shipped Rotation<DivIeee> (../baselines.cuh).
//
// HO, sks_ho_abl_<tag> (128 threads a block unless the tag says t<T>).
// "ieee" is the rotation as HO ran it before its redesign: sgn as a factor,
// sqrtf, 1.0f / x and the division as the compiler's IEEE sequences
// (AngleIeee below).
//   before                  (ho_sweeps.cu) K4-HO before its redesign: ieee, the
//                        10 sweeps unrolled.
//   unroll_s<S>          (ho_sweeps.cu) the same at S = 0, 2, 5 sweeps: other
//                        functions, only timed.
//   noeig                (ho_sweeps.cu) the core without its eigensolver.
//   roll_s<S>            (ho_rolled.cu) ieee, S = 2, 5, 10 sweeps as a loop.
//   roll_abs             (ho_rolled.cu) roll_s10 with |tau| and the sign flip
//                        as operand modifiers (AngleAbs).
//   roll_unit            (ho_rolled.cu) roll_abs with the second sqrt and
//                        the reciprocal in their [1, 2] forms
//                        (Rotation<DivIeee>, what the NDLT seeds run).
//   roll_div64           (ho_rolled.cu) roll_unit with every division
//                        through float64 (DivAlways64).
//   roll_tiny64          (ho_rolled.cu) roll_unit with only the numerators
//                        under 2^-100 through float64 (DivTiny64).
//   tiny_t<T>            (ho_rolled.cu) the shipped form (Rotation<DivTiny>:
//                        those numerators by an exact float32 sequence) at
//                        64 and 256 threads a block.
//   roll_approx          (ho_rolled.cu) NOT HO: the rotation through
//                        rcp.approx and rsqrt.approx, what giving up correct
//                        rounding buys.
//   f64_before              (ho_f64.cu) K5-ho before its redesign: ieee, the 4
//                        seed sweeps unrolled, no register cap.
//   f64_seed_only,       (ho_f64.cu) that form's float32 seed without the
//   f64_refine_only      float64 LDL^T solves, and the solves without the
//                        seed: other functions, only timed.
//   f64_roll             (ho_f64.cu) f64_before with the seed a loop.
//   f64_unit             (ho_f64.cu) the seed a loop with Rotation<DivIeee>,
//   f64_unit_mb<K>       uncapped and under __launch_bounds__(128, K),
//                        K = 4, 5.
//   f64_tiny64_mb4       (ho_f64.cu) the same with Rotation<DivTiny64>.
//   f64_tiny             (ho_f64.cu) the seed a loop with Rotation<DivTiny>,
//   f64_tiny_mb<K>       uncapped, under __launch_bounds__(128, K), K = 3, 4,
//   f64_tiny_t64_mb<K>   5, and under (64, K), K = 7, 8, 9.
// angle_check.cu holds no solve: it compares sqrt_1to2 and rcp_1to2 with
// sqrtf and 1.0f / x over every float32 of [1, 2], DivTiny, DivTiny64 and
// DivAlways64 with the IEEE division on 2^28 pairs, and the rotations with
// AngleIeee on special values.
//
// Each solve is <symbol>(src, tar, out, B, stream) on (8, B) minimal sets,
// as the solve kernels (../soa.cuh): float32 in and out, or, for the f64_
// tags, float64 in and out with H over its h22.  bench/*_ablation.py say
// which tags compute the shipped function and must equal its plain version.

#pragma once

#include "../baselines.cuh"

namespace {

constexpr int kAblationThreads = 64;

// InvitF32 (../baselines.cuh) with the sweeps, the solves, the rolling and
// the rotation of the seed left open.
template <template <int> class VStore, bool ROLL, int SWEEPS = 3,
          int SOLVES = 3, typename Rot = Rotation<DivIeee>>
struct AblationInvitF32 {
  using T = float;
  static constexpr int kSmemFloats = VStore<9>::kSmemFloats;
  static __device__ __forceinline__ float floor(float v) {
    return clamp_min_nan(v, kTiny);
  }
  template <int N>
  static __device__ __forceinline__ void seed(float (&a)[N][N],
                                              float (&x)[N]) {
    VStore<N> v;
    jacobi_smallest_col<N, SWEEPS, ROLL, Rot>(a, x, v);
  }
  template <int N>
  static __device__ __forceinline__ void refine(const float (&a)[N][N],
                                                float (&x)[N]) {
    invit_solves<float, N, SOLVES>(a, 0x1p-22f, x);
  }
};

// NdltCore (../baselines.cuh) as it was before the redesign: the normal
// matrix is built once and kept in registers across the seed, which rotates
// a copy.
template <typename Arith, typename Eig>
struct NdltKeepCore {
  using T = Arith;
  using Base = NdltCore<Arith, Eig>;
  static constexpr int kSmemFloats = Eig::kSmemFloats;
  static constexpr bool kTakesLoader = true;

  template <typename Loader>
  static __device__ __forceinline__ void run(Loader& ld, T (&h)[9]) {
    T hn[9];
    typename Base::Frame f;
    T ltl[9][9], aj[9][9];
    Base::normal(ld, ltl, f);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int j = 0; j < 9; ++j) aj[i][j] = ltl[i][j];
    }
    Eig::seed(aj, hn);
    Eig::refine(ltl, hn);
    Base::denormalize(hn, f, h);
  }
};

template <int S, int L>
using Regs = NdltKeepCore<float, AblationInvitF32<VRegs, false, S, L>>;

// ------------------------------------------------------------------ HO ----
constexpr int kHoAblationThreads = 128;

// The rotation's cosine and sine in the forms that were tried, beside the
// shipped Rotation<DivIeee> and Rotation<DivTiny> (../baselines.cuh).
// AngleIeee is jacobi_smallest_col_core line for line; AngleAbs,
// Rotation<DivAlways64> and the shipped ones equal it for every input.
struct AngleIeee {
  static __device__ __forceinline__ void angle(float app, float aqq,
                                               float apq, float& c,
                                               float& sn) {
    const float tau = (aqq - app) * 0.5f;
    const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
    const float hyp = sqrtf(tau * tau + apq * apq + kTiny);
    const float tt = sgn * apq / (sgn * tau + hyp);
    c = 1.0f / sqrtf(tt * tt + 1.0f);
    sn = tt * c;
  }
};
struct AngleAbs {
  static __device__ __forceinline__ void angle(float app, float aqq,
                                               float apq, float& c,
                                               float& sn) {
    const float tau = (aqq - app) * 0.5f;
    const float hyp = sqrtf(tau * tau + apq * apq + kTiny);
    const float tt = (tau >= 0.0f ? apq : -apq) / (fabsf(tau) + hyp);
    c = 1.0f / sqrtf(tt * tt + 1.0f);
    sn = tt * c;
  }
};
// A numerator under 2^-100 through a float64 division rounded back to
// float32, and every division so, whatever the numerator.  The same value as
// the IEEE division for every input: a quotient of two 24-bit numbers that
// is not itself a midpoint of the float32 grid lies at least 2^-49 relative
// away from one, so rounding first to 53 bits never moves it across.  Both
// lost to DivTiny (../baselines.cuh): two conversions, a float64 division
// and a conversion back are ~70 instruction slots a warp.
struct DivTiny64 {
  static __device__ __forceinline__ float run(float num, float den) {
    if (fabsf(num) < 0x1p-100f) {
      return __double2float_rn(static_cast<double>(num) /
                               static_cast<double>(den));
    }
    return num / den;
  }
};
struct DivAlways64 {
  static __device__ __forceinline__ float run(float num, float den) {
    return __double2float_rn(static_cast<double>(num) /
                             static_cast<double>(den));
  }
};
// Not the function HO computes: approximate reciprocal and rsqrt (about 1
// ulp each) in place of the correctly rounded division, sqrt and reciprocal.
struct AngleApprox {
  static __device__ __forceinline__ void angle(float app, float aqq,
                                               float apq, float& c,
                                               float& sn) {
    const float tau = (aqq - app) * 0.5f;
    const float hyp = __fsqrt_rn(tau * tau + apq * apq + kTiny);
    float inv;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(fabsf(tau) + hyp));
    const float tt = (tau >= 0.0f ? apq : -apq) * inv;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(c) : "f"(tt * tt + 1.0f));
    sn = tt * c;
  }
};

// JacobiF32 (../baselines.cuh) with sweeps, rolling and rotation left open.
template <int SWEEPS, bool ROLL, typename Rot>
struct AblationJacobiF32 {
  using T = float;
  static __device__ __forceinline__ float floor(float v) {
    return clamp_min_nan(v, kTiny);
  }
  template <int N>
  static __device__ __forceinline__ void smallest(const float (&a)[N][N],
                                                  float (&x)[N]) {
    float aj[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) aj[i][j] = a[i][j];
    }
    VRegs<N> v;
    jacobi_smallest_col<N, SWEEPS, ROLL, Rot>(aj, x, v);
  }
};

// No eigensolver: the last column of the matrix stands in for its smallest
// eigenvector, so the rest of the core has something to work on.
struct NoEigF32 {
  using T = float;
  static __device__ __forceinline__ float floor(float v) {
    return clamp_min_nan(v, kTiny);
  }
  template <int N>
  static __device__ __forceinline__ void smallest(const float (&a)[N][N],
                                                  float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = a[i][N - 1];
  }
};

// Invit64 (../baselines.cuh) for HO with the seed's rolling and rotation left
// open, and either half removable: without SEED the solves start from the
// matrix's last column, without REFINE the widened seed is the answer.
template <bool ROLL, typename Rot, bool SEED = true, bool REFINE = true>
struct AblationInvit64 {
  using T = double;
  static __device__ __forceinline__ double floor(double v) {
    const double tiny = static_cast<double>(kTiny);
    return v > tiny ? v : v + tiny;
  }
  template <int N>
  static __device__ __forceinline__ void smallest(const double (&a)[N][N],
                                                  double (&x)[N]) {
    if constexpr (SEED) {
      float af[N][N], xf[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) af[i][j] = __double2float_rn(a[i][j]);
      }
      VRegs<N> v;
      jacobi_smallest_col<N, 4, ROLL, Rot>(af, xf, v);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = static_cast<double>(xf[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = a[i][N - 1];
    }
    if constexpr (REFINE) invit_solves<double, N, 2>(a, 0x1p-40, x);
  }
};

}  // namespace

// float32 storage and arithmetic (an instance of K4-HO).
#define SKS_EXPORT_HO_ABLATION(tag, Core, THREADS)                            \
  extern "C" int sks_ho_abl_##tag(const void* src, const void* tar,           \
                                  void* out, long long b, void* stream) {     \
    return launch_solve_soa<float, float, Core, THREADS, false>(              \
        src, tar, out, b, stream);                                            \
  }

// float64 storage and arithmetic, h22-normalized (an instance of K5-ho).
#define SKS_EXPORT_HO_ABLATION64(tag, Core, THREADS, MIN_BLOCKS)              \
  extern "C" int sks_ho_abl_##tag(const void* src, const void* tar,           \
                                  void* out, long long b, void* stream) {     \
    return launch_solve_soa<double, double, Core, THREADS, true, MIN_BLOCKS>( \
        src, tar, out, b, stream);                                            \
  }

// float32 storage and arithmetic (an instance of K4-NDLT).
#define SKS_EXPORT_ABLATION(tag, Core, MIN_BLOCKS)                            \
  extern "C" int sks_ndlt_abl_##tag(const void* src, const void* tar,         \
                                    void* out, long long b, void* stream) {   \
    return launch_solve_soa<float, float, Core, kAblationThreads, false,      \
                            MIN_BLOCKS>(src, tar, out, b, stream);            \
  }

// float64 storage and arithmetic, h22-normalized (an instance of K5-ndlt).
#define SKS_EXPORT_ABLATION64(tag, Core, MIN_BLOCKS)                          \
  extern "C" int sks_ndlt_abl_##tag(const void* src, const void* tar,         \
                                    void* out, long long b, void* stream) {   \
    return launch_solve_soa<double, double, Core, kAblationThreads, true,     \
                            MIN_BLOCKS>(src, tar, out, b, stream);            \
  }
