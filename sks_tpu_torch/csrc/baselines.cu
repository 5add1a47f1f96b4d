// K4  ge_solve, gpt_solve, ho_solve, ndlt_solve: hand-written Hopper (sm_90a)
// kernels for the batched minimal solve of the four baseline solvers.
//
// Replaces sks_tpu/kernels/baselines_pallas.py::_soa_solve (body
// _make_kernel), built there four times (ge_solve_soa, gpt_solve_soa,
// ho_solve_soa, ndlt_solve_soa).  Here it is one kernel template
// (soa.cuh::solve_soa_kernel) over four device cores (baselines.cuh), each
// following its PyTorch core op for op, in float32:
//   GeCore    sks_tpu_torch/ops/ge.py::ge_core                       304 ops
//   GptCore   sks_tpu_torch/ops/gpt.py::gpt_core                     572 ops
//   HoCore    sks_tpu_torch/ops/ho.py::ho_core(eig_method='jacobi')  2,859
//   NdltCore  sks_tpu_torch/ops/ndlt.py::ndlt_core(eig='invit')     20,466
// (arithmetic operations of the plain version, bench/roofline.py).
// The TPU kernels' sublane tiles (VMEM tuning) and their chain_ref timing
// nudge do not carry over.
//
// What bounds each on an H100, and what the design does about it:
// - GE by device-memory bytes, like K1 and K3 (100 B per hypothesis in f32
//   for 304 operations): 256 threads per block, coalesced (8, B) access.
// - GPT by device-memory bytes too (572 operations for 100 B; it runs at
//   ~65% of the byte bound).  Every static loop is unrolled (#pragma
//   unroll), so its 72-entry tableau is indexed by constants and lives in
//   registers; a dynamically indexed local array would go to local memory.
//   128 threads per block, 77 registers.
// - HO by instruction rate in its 30 Jacobi rotations, and, as it first
//   stood, by the slow path of the IEEE division.  Measured on an NVIDIA H100
//   80GB HBM3 at 700 W (forms that differ in one thing each; PERF.md
//   section 6): the 3 x 3 Jacobi converges in 3-4 of its 10 sweeps; from then
//   on the off-diagonal entry that a rotation divides is zero in 70-92% of the
//   lanes and subnormal in the rest, the compiler's division fails its range
//   check in every warp, and ~120 instruction slots go where ~10 would do.  A
//   form with approximate reciprocals (not HO) ran at 98% of its
//   instruction-rate limit; the exact one at 58%.  Code size was not it: 10
//   unrolled sweeps (4,622 instructions a thread, 77 KB) ran 0.282 ms, a loop
//   of 377 0.265.
//   So the rotation (baselines.cuh::Rotation) keeps every rounding and drops
//   instructions: |tau| and a sign flip as operand modifiers; the second
//   sqrt and the reciprocal, whose argument lies in [1, 2], without range
//   check or branch (0.263 -> 0.246 ms); a numerator under 2^-100 divided by
//   an exact float32 sequence that stays off the slow path (DivTiny: 0.247
//   -> 0.197 ms; through a float64 division 0.215).  Sweeps are a loop (72
//   registers, no spills, every index static).  The kernel now runs at ~90%
//   of what its own ~4,700 instructions a thread allow; 64 or 256 threads a
//   block change nothing (0.196 / 0.207).  The NDLT seeds stop after 3
//   sweeps, long before they converge, and keep the plain IEEE division.
// - NDLT by instruction rate in its 9x9 Jacobi seed, and by the warps an SM
//   can hold to hide that seed's latency.  Measured (forms that differ in one
//   thing each; PERF.md section 6): the 3 seed sweeps are ~95% of the time,
//   the 3 LDL^T solves ~3%; each of the 108 rotations starts with a dependent
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
//   HO and NDLT run many square roots and divisions (Jacobi takes two of
//   each per rotation), which no fast-math shortcut may replace: the plain
//   version rounds them correctly, and so does every form here.

#include "baselines.cuh"

namespace {

constexpr int kGeThreads = 256;
constexpr int kGptThreads = 128;
constexpr int kHoThreads = 128;

using HoF32 = HoCore<float, JacobiF32>;
using NdltF32 = NdltCore<float, InvitF32>;

}  // namespace

SKS_EXPORT_SOLVE(ge_solve, GeCore<float>, kGeThreads)
SKS_EXPORT_SOLVE(gpt_solve, GptCore<float>, kGptThreads)
SKS_EXPORT_SOLVE(ho_solve, HoF32, kHoThreads)
SKS_EXPORT_SOLVE(ndlt_solve, NdltF32, kNdltF32Threads)
