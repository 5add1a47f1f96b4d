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
//   NdltCore  sks_tpu_torch/ops/ndlt.py::ndlt_core(eig='invit')    ~18,500
// The TPU kernels' sublane tiles (VMEM tuning) and their chain_ref timing
// nudge do not carry over.
//
// What bounds each on an H100, and what the design does about it:
// - GE by device-memory bytes, like K1 and K3 (100 B per hypothesis in f32
//   for ~250 flops): 256 threads per block, coalesced (8, B) access.
// - GPT and HO by float32 arithmetic and registers (expected; not measured).
//   Every static loop is unrolled (#pragma unroll), so GPT's 72-entry
//   tableau and HO's Jacobi state are indexed by constants and live in
//   registers; a dynamically indexed local array would go to local memory.
//   128 threads per block (77 and 72 registers).
// - NDLT by instruction rate in its 9x9 Jacobi seed, and by the warps an SM
//   can hold to hide that seed's latency.  Measured (PERF.md, the ablation
//   of bench/ndlt_ablation.py): the 3 seed sweeps are ~95% of the time, the
//   3 LDL^T solves ~3%; each of the 108 rotations starts with a dependent
//   sqrt -> division -> sqrt -> division.  With the rotated matrix (81
//   values), the eigenvector matrix v (81) and the normal matrix (24
//   distinct sums) all in registers the kernel needed 225 registers: 4
//   blocks of 64 threads, 8 warps an SM, too few to hide the chain.  So:
//   v lives in shared memory, entry-major [entry][thread] (81 x 64 x 4 B =
//   20.7 KB a block, static indices, conflict-free, volatile so that the
//   compiler cannot forward it back into registers), and the normal matrix
//   is rebuilt after the seed from inputs read a second time.  That leaves
//   108 registers without a spill and 9 blocks = 18 warps an SM (registers
//   still set the limit; shared memory would allow 10 blocks), for half
//   again as many instructions (~30,000 a thread; the shared-memory traffic
//   and less reuse in registers).  A plain register cap on the old form
//   (168: faster, 128: slower than uncapped) did less.  The arithmetic is
//   untouched: the kernel equals its plain version bit for bit.
//   The price: one thread's seed is about a tenth longer through shared
//   memory, so a batch too small to fill the card with warps (B <= 10,000)
//   takes that much longer than in the register form (PERF.md has both).
//   HO and NDLT run many IEEE sqrt and divisions (Jacobi takes two of each
//   per rotation), which no fast-math shortcut may replace: the plain
//   version rounds them exactly.

#include "baselines.cuh"

namespace {

constexpr int kGeThreads = 256;
constexpr int kGptThreads = 128;
constexpr int kHoThreads = 128;
constexpr int kNdltThreads = 64;

template <int N>
using NdltV = VShared<N, kNdltThreads>;

using HoF32 = HoCore<float, JacobiF32>;
using NdltF32 = NdltCore<float, InvitF32<NdltV>>;

}  // namespace

SKS_EXPORT_SOLVE(ge_solve, GeCore<float>, kGeThreads)
SKS_EXPORT_SOLVE(gpt_solve, GptCore<float>, kGptThreads)
SKS_EXPORT_SOLVE(ho_solve, HoF32, kHoThreads)
SKS_EXPORT_SOLVE(ndlt_solve, NdltF32, kNdltThreads)
