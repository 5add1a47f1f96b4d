// HO timing instruments (ablation.cuh): the sweeps as a loop, with the
// rotation in each form that was tried, and the shipped form at other block
// sizes.  All but roll_s2, roll_s5 and roll_approx compute HO.

#include "ablation.cuh"

template <int S, typename Rot>
using HoRolled = HoCore<float, AblationJacobiF32<S, true, Rot>>;
using HoRolled2 = HoRolled<2, AngleIeee>;
using HoRolled5 = HoRolled<5, AngleIeee>;
using HoRolled10 = HoRolled<10, AngleIeee>;
using HoRolledAbs = HoRolled<10, AngleAbs>;
using HoRolledUnit = HoRolled<10, Rotation<DivIeee>>;
using HoRolledDiv64 = HoRolled<10, Rotation<DivAlways64>>;
using HoRolledTiny64 = HoRolled<10, Rotation<DivTiny64>>;
using HoRolledApprox = HoRolled<10, AngleApprox>;
using HoShipped = HoCore<float, JacobiF32>;

SKS_EXPORT_HO_ABLATION(roll_s2, HoRolled2, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_s5, HoRolled5, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_s10, HoRolled10, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_abs, HoRolledAbs, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_unit, HoRolledUnit, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_div64, HoRolledDiv64, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(roll_tiny64, HoRolledTiny64, kHoAblationThreads)
SKS_EXPORT_HO_ABLATION(tiny_t64, HoShipped, 64)
SKS_EXPORT_HO_ABLATION(tiny_t256, HoShipped, 256)
SKS_EXPORT_HO_ABLATION(roll_approx, HoRolledApprox, kHoAblationThreads)
