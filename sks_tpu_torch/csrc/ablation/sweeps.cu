// NDLT timing instruments (ablation.cuh): the register form at fewer seed
// sweeps or solves than the kernel runs.  Timed only.

#include "ablation.cuh"

using Regs00 = Regs<0, 0>;
using Regs03 = Regs<0, 3>;
using Regs13 = Regs<1, 3>;
using Regs30 = Regs<3, 0>;

SKS_EXPORT_ABLATION(regs_s0_l0, Regs00, 0)
SKS_EXPORT_ABLATION(regs_s0_l3, Regs03, 0)
SKS_EXPORT_ABLATION(regs_s1_l3, Regs13, 0)
SKS_EXPORT_ABLATION(regs_s3_l0, Regs30, 0)
