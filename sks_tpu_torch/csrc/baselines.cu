// K4  ge_solve, gpt_solve, ho_solve, ndlt_solve: hand-written Hopper (sm_90a)
// kernels for the batched minimal solve of the four baseline solvers.
//
// Replaces sks_tpu/kernels/baselines_pallas.py::_soa_solve (body
// _make_kernel), built there four times (ge_solve_soa, gpt_solve_soa,
// ho_solve_soa, ndlt_solve_soa).  Here it is one kernel template
// (soa.cuh::solve_soa_kernel) over four device cores (baselines.cuh), each
// following its PyTorch core op for op, in float32:
//   GeCore    sks_tpu_torch/ops/ge.py::ge_core                    ~250 flops
//   GptCore   sks_tpu_torch/ops/gpt.py::gpt_core                ~1,500 flops
//   HoCore    sks_tpu_torch/ops/ho.py::ho_core(eig_method='jacobi')  ~1,200
//   NdltCore  sks_tpu_torch/ops/ndlt.py::ndlt_core(eig='invit')    ~15,000
// The TPU kernels' sublane tiles (VMEM tuning) and their chain_ref timing
// nudge do not carry over.
//
// What is expected to bound each on an H100 (no profiler has confirmed it),
// and what the design does about it:
// - GE by device-memory bytes, like K1 and K3 (100 B per hypothesis in f32
//   for ~250 flops): 256 threads per block, coalesced (8, B) access.
// - GPT, HO and NDLT by float32 arithmetic and registers.  Every
//   static loop is unrolled (#pragma unroll), so GPT's 72-entry tableau and
//   the Jacobi state are indexed by constants and live in registers; a
//   dynamically indexed local array would go to local memory.  GPT and HO
//   keep 128 threads per block (77 and 72 registers).  NDLT's 9x9 Jacobi
//   seed carries 81 + 81 values beside the normal matrix (24 distinct sums
//   and zeros); ptxas fits it in 225 registers without spilling, so one SM
//   holds 4 blocks (8 warps) of it.  64 threads per block leaves the
//   compiler the full 255 registers and still puts 16,384 blocks on the
//   card at B = 2^20.
//   HO and NDLT run many IEEE sqrt and divisions (Jacobi takes two of each
//   per rotation), which no fast-math shortcut may replace: the plain
//   version rounds them exactly.

#include "baselines.cuh"

namespace {

constexpr int kGeThreads = 256;
constexpr int kGptThreads = 128;
constexpr int kHoThreads = 128;
constexpr int kNdltThreads = 64;

using HoF32 = HoCore<float, JacobiF32>;
using NdltF32 = NdltCore<float, InvitF32>;

}  // namespace

SKS_EXPORT_SOLVE(ge_solve, GeCore<float>, kGeThreads)
SKS_EXPORT_SOLVE(gpt_solve, GptCore<float>, kGptThreads)
SKS_EXPORT_SOLVE(ho_solve, HoF32, kHoThreads)
SKS_EXPORT_SOLVE(ndlt_solve, NdltF32, kNdltThreads)
