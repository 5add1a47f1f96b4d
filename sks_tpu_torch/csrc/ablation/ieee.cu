// NDLT timing instruments (ablation.cuh): the shipped K4-NDLT (v in shared
// memory, unrolled sweeps, rebuilt normal matrix) and K5-ndlt (v in
// registers, rolled sweeps, rebuilt normal matrix, 168 registers) with the
// Jacobi rotation written as the plain version writes it (AngleIeee): what
// the rotation's shorter forms changed for the kernels that share it.

#include "ablation.cuh"

namespace {

template <int N>
using VSh = VShared<N, kAblationThreads>;

// Invit64 (../baselines.cuh) for NDLT with the seed's rotation left open.
struct IeeeInvit64 : Invit64<3, VRegs, true> {
  template <int N>
  static __device__ __forceinline__ void seed(const double (&a)[N][N],
                                              double (&x)[N]) {
    float af[N][N], xf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) af[i][j] = __double2float_rn(a[i][j]);
    }
    VRegs<N> v;
    jacobi_smallest_col<N, 3, true, AngleIeee>(af, xf, v);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = static_cast<double>(xf[i]);
  }
};

}  // namespace

using NdltIeee = NdltCore<float, AblationInvitF32<VSh, false, 3, 3, AngleIeee>>;
using NdltF64Ieee = NdltCore<double, IeeeInvit64>;

SKS_EXPORT_ABLATION(ieee, NdltIeee, 0)
SKS_EXPORT_ABLATION64(f64_ieee, NdltF64Ieee, 6)
