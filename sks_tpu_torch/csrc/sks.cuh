// The SKS core, a template on its arithmetic type: float32 in K3 (sks.cu),
// float64 in K5 (fp64.cu).  It follows sks_tpu_torch/ops/sks.py::sks_core
// line by line: a * (1/d) and a / d are different roundings, and SKS uses
// both.

#pragma once

#include "soa.cuh"

namespace {

template <typename Arith>
struct SksCore {
  using T = Arith;
  static __device__ __forceinline__ void run(const T (&s)[8], const T (&t)[8],
                                             T (&h)[9]) {
    const T m1x = s[0], m1y = s[1], n1x = s[2], n1y = s[3];
    const T p1x = s[4], p1y = s[5], q1x = s[6], q1y = s[7];
    const T m2x = t[0], m2y = t[1], n2x = t[2], n2y = t[3];
    const T p2x = t[4], p2y = t[5], q2x = t[6], q2y = t[7];

    // Similarity-canonical coordinates of P, Q on each plane.
    const T w1x = T(0.5) * (n1x - m1x);
    const T w1y = T(0.5) * (n1y - m1y);
    const T o1x = T(0.5) * (n1x + m1x);
    const T o1y = T(0.5) * (n1y + m1y);
    const T inv1 = T(1) / (w1x * w1x + w1y * w1y);
    const T p1dx = p1x - o1x;
    const T p1dy = p1y - o1y;
    const T q1dx = q1x - o1x;
    const T q1dy = q1y - o1y;
    const T p = (w1x * p1dx + w1y * p1dy) * inv1;
    const T q = ((-w1y) * p1dx + w1x * p1dy) * inv1;
    const T r = (w1x * q1dx + w1y * q1dy) * inv1;
    const T ss = ((-w1y) * q1dx + w1x * q1dy) * inv1;

    const T w2x = T(0.5) * (n2x - m2x);
    const T w2y = T(0.5) * (n2y - m2y);
    const T o2x = T(0.5) * (n2x + m2x);
    const T o2y = T(0.5) * (n2y + m2y);
    const T inv2 = T(1) / (w2x * w2x + w2y * w2y);
    const T p2dx = p2x - o2x;
    const T p2dy = p2y - o2y;
    const T q2dx = q2x - o2x;
    const T q2dy = q2y - o2y;
    const T p2 = (w2x * p2dx + w2y * p2dy) * inv2;
    const T q2 = ((-w2y) * p2dx + w2x * p2dy) * inv2;
    const T r2 = (w2x * q2dx + w2y * q2dy) * inv2;
    const T s2 = ((-w2y) * q2dx + w2x * q2dy) * inv2;

    // 4-DOF kernel fixing (+-1, 0): symmetric 2x2 solve.
    const T k1 = q / q2;
    const T k3 = p2 * k1;
    const T k2 = ss / s2;
    const T k4 = r2 * k2;
    const T g = p * ss - r * q;
    const T h_ = ss - q;
    const T inv_det = T(1) / (g * g - h_ * h_);
    const T rhs_a = k3 * ss - k4 * q;
    const T rhs_u = k1 * ss - k2 * q;
    const T a = (g * rhs_a - h_ * rhs_u) * inv_det;
    const T u = (g * rhs_u - h_ * rhs_a) * inv_det;
    const T inv_q = T(1) / q;
    const T v = (k1 - a - u * p) * inv_q;
    const T b = (k3 - a * p - u) * inv_q;

    // H_L = H_S2^{-1} @ H_K.
    const T l00 = w2x * a + o2x * u;
    const T l01 = w2x * b - w2y + o2x * v;
    const T l02 = w2x * u + o2x * a;
    const T l10 = w2y * a + o2y * u;
    const T l11 = w2y * b + w2x + o2y * v;
    const T l12 = w2y * u + o2y * a;

    // H = H_L @ H_S1h (up to scale).
    const T t0 = -(w1x * o1x + w1y * o1y);
    const T t1 = w1y * o1x - w1x * o1y;
    const T wsq1 = w1x * w1x + w1y * w1y;

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

}  // namespace
