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
//   ho    HoCore<double, Invit64<4>>         ho_core(eig_method='invit64')
//   ndlt  NdltCore<double, Invit64<3>>       ndlt_core(eig='invit64')
// and every kind divides its 9 entries by h22 in float64, as the JAX kernel
// does (df64_pallas.py:103).  Inputs are float32 (widened exactly, as the
// JAX kernel lifts f32 to DF) or float64; the output is always float64.
// The TPU kernel's lane tiles, its hi/lo output and its chain_ref timing
// nudge do not carry over.
//
// What is expected to bound each on an H100 (predictions; no profiler has
// confirmed them), and what the design does about it:
// - ACA, SKS and GE by device-memory bytes, as K1: 16 values in and 9
//   doubles out, 200 B per hypothesis from float64 storage (136 B from
//   float32) for a few hundred float64 ops.  256 threads per block,
//   coalesced (8, B) access.
// - GPT, HO and NDLT by float64 arithmetic and registers.  The card's
//   non-tensor float64 rate is half its float32 rate, IEEE float64
//   division and sqrt are multi-instruction sequences, and a double takes
//   two registers: GPT's 72-entry tableau and NDLT's float64 LDL^T (the
//   normal matrix, 36 L and 36 W entries, 9 pivots) beside its float32
//   Jacobi seed (81 + 81 values) probably spill past 255 registers.  Block
//   sizes as in K4 (GPT and HO 128, NDLT 64, which leaves each thread the
//   full 255 registers); the build log reports registers and spills, and
//   removing the spills is later work.
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

using HoF64 = HoCore<double, Invit64<4>>;
using NdltF64 = NdltCore<double, Invit64<3>>;

}  // namespace

SKS_EXPORT_FP64(aca, AcaCore<double>, kBytesThreads)
SKS_EXPORT_FP64(sks, SksCore<double>, kBytesThreads)
SKS_EXPORT_FP64(ge, GeCore<double>, kBytesThreads)
SKS_EXPORT_FP64(gpt, GptCore<double>, kGptThreads)
SKS_EXPORT_FP64(ho, HoF64, kHoThreads)
SKS_EXPORT_FP64(ndlt, NdltF64, kNdltThreads)
