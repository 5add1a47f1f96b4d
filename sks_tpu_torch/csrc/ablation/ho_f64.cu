// HO timing instruments (ablation.cuh): K5-ho as it stood before its
// redesign, its float32 seed and its float64 solves apart, the seed as a
// loop, and the rotations that were tried under register caps.  f64_seed_only
// and f64_refine_only compute other functions; the rest compute K5-ho's.

#include "ablation.cuh"

using HoF64Before = HoCore<double, AblationInvit64<false, AngleIeee>>;
using HoF64SeedOnly =
    HoCore<double, AblationInvit64<false, AngleIeee, true, false>>;
using HoF64RefineOnly =
    HoCore<double, AblationInvit64<false, AngleIeee, false, true>>;
using HoF64Roll = HoCore<double, AblationInvit64<true, AngleIeee>>;
using HoF64Unit = HoCore<double, Invit64<4, VRegs, true, DivIeee>>;
using HoF64Tiny64 = HoCore<double, Invit64<4, VRegs, true, DivTiny64>>;
using HoF64Tiny = HoCore<double, Invit64<4, VRegs, true, DivTiny>>;

SKS_EXPORT_HO_ABLATION64(f64_before, HoF64Before, kHoAblationThreads, 0)
SKS_EXPORT_HO_ABLATION64(f64_seed_only, HoF64SeedOnly, kHoAblationThreads, 0)
SKS_EXPORT_HO_ABLATION64(f64_refine_only, HoF64RefineOnly, kHoAblationThreads,
                         0)
SKS_EXPORT_HO_ABLATION64(f64_roll, HoF64Roll, kHoAblationThreads, 0)
SKS_EXPORT_HO_ABLATION64(f64_unit, HoF64Unit, kHoAblationThreads, 0)
SKS_EXPORT_HO_ABLATION64(f64_unit_mb4, HoF64Unit, kHoAblationThreads, 4)
SKS_EXPORT_HO_ABLATION64(f64_unit_mb5, HoF64Unit, kHoAblationThreads, 5)
SKS_EXPORT_HO_ABLATION64(f64_tiny64_mb4, HoF64Tiny64, kHoAblationThreads, 4)
SKS_EXPORT_HO_ABLATION64(f64_tiny, HoF64Tiny, kHoAblationThreads, 0)
SKS_EXPORT_HO_ABLATION64(f64_tiny_mb3, HoF64Tiny, kHoAblationThreads, 3)
SKS_EXPORT_HO_ABLATION64(f64_tiny_mb4, HoF64Tiny, kHoAblationThreads, 4)
SKS_EXPORT_HO_ABLATION64(f64_tiny_mb5, HoF64Tiny, kHoAblationThreads, 5)
SKS_EXPORT_HO_ABLATION64(f64_tiny_t64_mb7, HoF64Tiny, 64, 7)
SKS_EXPORT_HO_ABLATION64(f64_tiny_t64_mb8, HoF64Tiny, 64, 8)
SKS_EXPORT_HO_ABLATION64(f64_tiny_t64_mb9, HoF64Tiny, 64, 9)
