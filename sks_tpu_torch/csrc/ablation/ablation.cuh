// Timing instruments for K4-NDLT and K5-ndlt, not kernels of any path:
// instances of the NDLT solve that differ from the shipped ones
// (../baselines.cu, ../fp64.cu) in one thing each, so that a run on the card
// can say what sets their time.  bench/ndlt_ablation.py builds the sources
// of this directory into a library of their own, when it is asked to, and
// drives them; the package's kernel library does not hold them.
//
//   regs_s<S>_l<L>       (sweeps.cu, full.cu) the form K4-NDLT had before
//                        its redesign, with v and the normal matrix in
//                        registers, at S seed sweeps and L inverse-iteration
//                        solves.  regs_s3_l3 is that kernel itself; fewer
//                        sweeps or solves compute another function and are
//                        only timed.
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
//
// Each is sks_ndlt_abl_<tag>(src, tar, out, B, stream) on (8, B) minimal
// sets, as the solve kernels (../soa.cuh): float32 in and out, or, for the
// f64_ tags, float64 in and out with H over its h22.  All but the
// regs_s<S>_l<L> with S < 3 or L < 3 compute the shipped function and must
// equal its plain version.

#pragma once

#include "../baselines.cuh"

namespace {

constexpr int kAblationThreads = 64;

// InvitF32 (../baselines.cuh) with the sweeps, the solves and the rolling of
// the seed left open.
template <template <int> class VStore, bool ROLL, int SWEEPS = 3,
          int SOLVES = 3>
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
    jacobi_smallest_col<N, SWEEPS, ROLL>(a, x, v);
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

}  // namespace

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
