// NDLT timing instruments (ablation.cuh): K5-ndlt as it stood before its
// redesign, and in the form K4-NDLT ships (v in shared memory, unrolled
// sweeps, rebuilt normal matrix).

#include "ablation.cuh"

namespace {

template <int N>
using VSh = VShared<N, kAblationThreads>;

}  // namespace

using F64Regs = NdltKeepCore<double, Invit64<3, VRegs>>;
using F64SmemReload = NdltCore<double, Invit64<3, VSh>>;

SKS_EXPORT_ABLATION64(f64_regs, F64Regs, 0)
SKS_EXPORT_ABLATION64(f64_smem_reload, F64SmemReload, 0)
