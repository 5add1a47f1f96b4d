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
// The core follows sks_tpu_torch/ops/sks.py::sks_core line by line: a * (1/d)
// and a / d are different roundings, and SKS uses both.

#include "soa.cuh"

namespace {

struct SksCore {
  static __device__ __forceinline__ void run(const float (&s)[8],
                                             const float (&t)[8],
                                             float (&h)[9]) {
    const float m1x = s[0], m1y = s[1], n1x = s[2], n1y = s[3];
    const float p1x = s[4], p1y = s[5], q1x = s[6], q1y = s[7];
    const float m2x = t[0], m2y = t[1], n2x = t[2], n2y = t[3];
    const float p2x = t[4], p2y = t[5], q2x = t[6], q2y = t[7];

    // Similarity-canonical coordinates of P, Q on each plane.
    const float w1x = 0.5f * (n1x - m1x);
    const float w1y = 0.5f * (n1y - m1y);
    const float o1x = 0.5f * (n1x + m1x);
    const float o1y = 0.5f * (n1y + m1y);
    const float inv1 = 1.0f / (w1x * w1x + w1y * w1y);
    const float p1dx = p1x - o1x;
    const float p1dy = p1y - o1y;
    const float q1dx = q1x - o1x;
    const float q1dy = q1y - o1y;
    const float p = (w1x * p1dx + w1y * p1dy) * inv1;
    const float q = ((-w1y) * p1dx + w1x * p1dy) * inv1;
    const float r = (w1x * q1dx + w1y * q1dy) * inv1;
    const float ss = ((-w1y) * q1dx + w1x * q1dy) * inv1;

    const float w2x = 0.5f * (n2x - m2x);
    const float w2y = 0.5f * (n2y - m2y);
    const float o2x = 0.5f * (n2x + m2x);
    const float o2y = 0.5f * (n2y + m2y);
    const float inv2 = 1.0f / (w2x * w2x + w2y * w2y);
    const float p2dx = p2x - o2x;
    const float p2dy = p2y - o2y;
    const float q2dx = q2x - o2x;
    const float q2dy = q2y - o2y;
    const float p2 = (w2x * p2dx + w2y * p2dy) * inv2;
    const float q2 = ((-w2y) * p2dx + w2x * p2dy) * inv2;
    const float r2 = (w2x * q2dx + w2y * q2dy) * inv2;
    const float s2 = ((-w2y) * q2dx + w2x * q2dy) * inv2;

    // 4-DOF kernel fixing (+-1, 0): symmetric 2x2 solve.
    const float k1 = q / q2;
    const float k3 = p2 * k1;
    const float k2 = ss / s2;
    const float k4 = r2 * k2;
    const float g = p * ss - r * q;
    const float h_ = ss - q;
    const float inv_det = 1.0f / (g * g - h_ * h_);
    const float rhs_a = k3 * ss - k4 * q;
    const float rhs_u = k1 * ss - k2 * q;
    const float a = (g * rhs_a - h_ * rhs_u) * inv_det;
    const float u = (g * rhs_u - h_ * rhs_a) * inv_det;
    const float inv_q = 1.0f / q;
    const float v = (k1 - a - u * p) * inv_q;
    const float b = (k3 - a * p - u) * inv_q;

    // H_L = H_S2^{-1} @ H_K.
    const float l00 = w2x * a + o2x * u;
    const float l01 = w2x * b - w2y + o2x * v;
    const float l02 = w2x * u + o2x * a;
    const float l10 = w2y * a + o2y * u;
    const float l11 = w2y * b + w2x + o2y * v;
    const float l12 = w2y * u + o2y * a;

    // H = H_L @ H_S1h (up to scale).
    const float t0 = -(w1x * o1x + w1y * o1y);
    const float t1 = w1y * o1x - w1x * o1y;
    const float wsq1 = w1x * w1x + w1y * w1y;

    h[0] = l00 * w1x - l01 * w1y;
    h[1] = l00 * w1y + l01 * w1x;
    h[2] = l00 * t0 + l01 * t1 + l02 * wsq1;
    h[3] = l10 * w1x - l11 * w1y;
    h[4] = l10 * w1y + l11 * w1x;
    h[5] = l10 * t0 + l11 * t1 + l12 * wsq1;
    h[6] = u * w1x - v * w1y;
    h[7] = u * w1y + v * w1x;
    h[8] = u * t0 + v * t1 + a * wsq1;
  }
};

constexpr int kSksThreads = 256;

}  // namespace

SKS_EXPORT_SOLVE(sks_solve, SksCore, kSksThreads)
