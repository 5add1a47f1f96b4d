// NDLT timing instruments (ablation.cuh): the register form of K4-NDLT under
// a register cap (168 and 128 a thread), spills and all.

#include "ablation.cuh"

using Regs33 = Regs<3, 3>;

SKS_EXPORT_ABLATION(regs_s3_l3_mb6, Regs33, 6)
SKS_EXPORT_ABLATION(regs_s3_l3_mb8, Regs33, 8)
