// HO timing instruments (ablation.cuh): K4-HO as it stood before its
// redesign (the rotation's IEEE sequences, 10 sweeps of straight-line code),
// the same at fewer sweeps, and the core without its eigensolver.  Only before
// computes HO.

#include "ablation.cuh"

template <int S>
using HoUnrolled = HoCore<float, AblationJacobiF32<S, false, AngleIeee>>;
using HoUnrolled0 = HoUnrolled<0>;
using HoUnrolled2 = HoUnrolled<2>;
using HoUnrolled5 = HoUnrolled<5>;
using HoUnrolled10 = HoUnrolled<10>;
using HoNoEig = HoCore<float, NoEigF32>;

SKS_EXPORT_HO_ABLATION(before, HoUnrolled10, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(unroll_s0, HoUnrolled0, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(unroll_s2, HoUnrolled2, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(unroll_s5, HoUnrolled5, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(noeig, HoNoEig, kHoAblationThreads)
