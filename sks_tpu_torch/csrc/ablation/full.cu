// NDLT timing instruments (ablation.cuh): the register form at 2 and at all
// 3 seed sweeps; regs_s3_l3 is K4-NDLT as it was before its redesign.

#include "ablation.cuh"

using Regs23 = Regs<2, 3>;
using Regs33 = Regs<3, 3>;

SKS_EXPORT_ABLATION(regs_s2_l3, Regs23, 0)
SKS_EXPORT_ABLATION(regs_s3_l3, Regs33, 0)
