// K5  fp64_<kind>: hand-written Hopper (sm_90a) kernels for the batched
// 4-point solve of all six solvers in native float64.
//
// Replaces sks_tpu/kernels/df64_pallas.py::df64_solve_soa (body
// _make_kernel over _CORES).  The TPU has no fp64, so the JAX kernel runs
// the solver cores on double-float (hi, lo) float32 pairs (~49 bits) and
// writes 18 words per hypothesis.  The H100 has fp64 units, so the port
// carries over the capability and not the emulation: the same cores
// (aca.cuh, sks.cuh, baselines.cuh) instantiated on double, 53 bits, one
// double per entry.  Each kind follows its PyTorch float64 core op for op
// (sks_tpu_torch/ops/fp64.py::FP64_CORES):
//   aca   AcaCore<double>                    ops/aca.py::aca_core
//   sks   SksCore<double>                    ops/sks.py::sks_core
//   ge    GeCore<double>                     ops/ge.py::ge_core
//   gpt   GptCore<double>                    ops/gpt.py::gpt_core
//   ho    HoCore<double, Invit64<4, ..>>     ho_core(eig_method='invit64')
//   ndlt  NdltCore<double, Invit64<3, ..>>   ndlt_core(eig='invit64')
// and every kind divides its 9 entries by h22 in float64, as the JAX kernel
// does (df64_pallas.py:103).  Inputs are float32 (widened exactly, as the
// JAX kernel lifts f32 to DF) or float64; the output is always float64.
// The TPU kernel's lane tiles, its hi/lo output and its chain_ref timing
// nudge do not carry over.
//
// What bounds each on an H100 (measured on an NVIDIA H100 80GB HBM3 at 700 W
// where it says so: PERF.md), and what the design does about it:
// - ACA, SKS and GE by device-memory bytes, as K1: 16 values in and 9
//   doubles out, 200 B per hypothesis from float64 storage (136 B from
//   float32) for a few hundred float64 ops; they run at ~84% of that bound.
//   256 threads per block, coalesced (8, B) access.
// - GPT by bytes too (70% of the bound): 581 float64 operations, 128 threads.
// - HO by latency: 793 float64 operations (22 divisions and 8 square roots
//   among them, each a sequence of a dozen dependent DFMAs; the compiler
//   shares no reciprocal between quotients of one divisor: 25 MUFU.RCP64H)
//   and a 4-sweep float32 Jacobi seed of 852, at 166 registers: 12 warps an
//   SM.  Measured (bench/ho_ablation.py): the seed alone 0.189 ms, the
//   float64 solves alone 0.111, both 0.203: they overlap, on different
//   pipes.  What paid: __launch_bounds__(128, 4), 128 registers with 40-48 B
//   of spills, 16 warps an SM (0.192 -> 0.166 ms; 96 registers and 250 B of
//   spills lose again, 0.167-0.179), and the rotation of K4-HO, whose seed
//   reaches zero and subnormal numerators in its last sweep too
//   (baselines.cuh::DivTiny: 0.166 -> 0.157).  The seed as a loop changed
//   nothing by itself (0.204).
// - NDLT by instruction rate and registers in its float32 Jacobi seed
//   (sweeps are ~95% of the time, as in K4-NDLT: see baselines.cu).  The
//   float64 LDL^T part needs ~190 registers whatever the seed does, so the
//   kernel cannot hold the warps that K4-NDLT's shared-memory seed feeds on,
//   and that form, with half again as many instructions, measured slower
//   here.  What measured best: v in registers, the 3 sweeps a loop (the
//   unrolled seed is ~19,000 instructions of straight-line code; the loop is
//   a third of it and measured a quarter faster in float32), the normal
//   matrix rebuilt after the seed from reloaded inputs, and
//   __launch_bounds__(64, 6): 168 registers, 12 warps an SM, ~430 B of
//   spills in the float64 part.  Times of the forms: PERF.md.
//
// Built, like every source here, with -fmad=false and IEEE division and
// sqrt (no fast math): every float64 and float32 op rounds as the eager
// op does, so each kind equals its plain version bit for bit.

#include "aca.cuh"
#include "baselines.cuh"
#include "sks.cuh"

namespace {

constexpr int kBytesThreads = 256;  // ACA, SKS, GE
constexpr int kGptThreads = 128;
constexpr int kHoThreads = 128;
constexpr int kNdltThreads = 64;
constexpr int kNdltMinBlocks = 6;  // 168 registers a thread
constexpr int kHoMinBlocks = 4;    // 128 registers a thread

using HoF64 = HoCore<double, Invit64<4, VRegs, true, DivTiny>>;
using NdltF64 = NdltCore<double, Invit64<3, VRegs, true>>;

}  // namespace

SKS_EXPORT_FP64(aca, AcaCore<double>, kBytesThreads)
SKS_EXPORT_FP64(sks, SksCore<double>, kBytesThreads)
SKS_EXPORT_FP64(ge, GeCore<double>, kBytesThreads)
SKS_EXPORT_FP64(gpt, GptCore<double>, kGptThreads)
SKS_EXPORT_FP64_BOUNDED(ho, HoF64, kHoThreads, kHoMinBlocks)
SKS_EXPORT_FP64_BOUNDED(ndlt, NdltF64, kNdltThreads, kNdltMinBlocks)
