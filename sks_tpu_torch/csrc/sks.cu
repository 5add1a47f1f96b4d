// K3  sks_solve: hand-written Hopper (sm_90a) kernel for the batched SKS solve.
//
// Replaces sks_tpu/kernels/sks_pallas.py::sks_solve_soa (body _solve_kernel):
// one hypothesis per lane, 16 values in, 9 out, f32 arithmetic whatever the
// storage dtype.  The TPU kernel's sublane tile and its chain_ref timing
// nudge do not carry over.
//
// Bound on an H100 by device-memory bytes: 100 B per hypothesis in f32 (50 B
// in bf16) for 169 flops and 5 IEEE reciprocals/divisions, far below the
// card's ~20 flops per byte.  Design: one thread per hypothesis on the (8, B)
// layout (soa.cuh), so all 25 accesses are coalesced; 256 threads per block,
// as K1, keeps enough loads in flight; bf16 storage halves the bytes.
//
// The core, SksCore, is in sks.cuh.

#include "sks.cuh"

namespace {

constexpr int kSksThreads = 256;

}  // namespace

SKS_EXPORT_SOLVE(sks_solve, SksCore<float>, kSksThreads)
