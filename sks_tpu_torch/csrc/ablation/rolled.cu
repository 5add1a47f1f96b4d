// NDLT timing instruments (ablation.cuh): v in registers with the 3 seed
// sweeps a loop; alone, and with the normal matrix rebuilt after the seed
// under a 168-register cap (the form K5-ndlt ships, in float32).

#include "ablation.cuh"

using RegsRoll = NdltKeepCore<float, AblationInvitF32<VRegs, true>>;
using RegsRollReload = NdltCore<float, AblationInvitF32<VRegs, true>>;

SKS_EXPORT_ABLATION(regs_roll, RegsRoll, 0)
SKS_EXPORT_ABLATION(regs_roll_reload_mb6, RegsRollReload, 6)
