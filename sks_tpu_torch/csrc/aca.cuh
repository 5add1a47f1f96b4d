// The ACA core, a template on its arithmetic type: float32 in K1 and K2
// (aca.cu), float64 in K5 (fp64.cu).

#pragma once

#include "soa.cuh"

namespace {

// sks_tpu_torch/ops/aca.py::aca_core, line by line, in the same order.
// s = (m1x, m1y, n1x, n1y, p1x, p1y, q1x, q1y); t likewise for plane 2.
template <typename T>
__device__ __forceinline__ void aca_core(const T* s, const T* t, T* h) {
  const T m1x = s[0], m1y = s[1], n1x = s[2], n1y = s[3];
  const T p1x = s[4], p1y = s[5], q1x = s[6], q1y = s[7];
  const T m2x = t[0], m2y = t[1], n2x = t[2], n2y = t[3];
  const T p2x = t[4], p2y = t[5], q2x = t[6], q2y = t[7];

  const T e1x = n1x - m1x;
  const T e1y = n1y - m1y;
  const T f1x = p1x - m1x;
  const T f1y = p1y - m1y;
  const T g1x = q1x - m1x;
  const T g1y = q1y - m1y;
  const T f1 = e1x * f1y - e1y * f1x;
  const T alpha = f1y * g1x - f1x * g1y;
  const T beta = e1x * g1y - e1y * g1x;

  const T e2x = n2x - m2x;
  const T e2y = n2y - m2y;
  const T f2x = p2x - m2x;
  const T f2y = p2y - m2y;
  const T g2x = q2x - m2x;
  const T g2y = q2y - m2y;
  const T f2 = e2x * f2y - e2y * f2x;
  const T gamma = f2y * g2x - f2x * g2y;
  const T delta = e2x * g2y - e2y * g2x;

  const T c = beta * (gamma * (f1 - beta) - alpha * (f2 - delta));
  const T d = alpha * (delta * (f1 - alpha) - beta * (f2 - gamma));
  const T e = alpha * beta * (f2 - gamma - delta);
  const T ce = c + e;
  const T de = d + e;

  const T t00 = e2x * ce + m2x * c;
  const T t01 = f2x * de + m2x * d;
  const T t02 = m2x * e;
  const T t10 = e2y * ce + m2y * c;
  const T t11 = f2y * de + m2y * d;
  const T t12 = m2y * e;

  const T a00 = f1y, a01 = -f1x;
  const T a10 = -e1y, a11 = e1x;
  const T a02 = -(a00 * m1x + a01 * m1y);
  const T a12 = -(a10 * m1x + a11 * m1y);

  h[0] = t00 * a00 + t01 * a10;
  h[1] = t00 * a01 + t01 * a11;
  h[2] = t00 * a02 + t01 * a12 + t02 * f1;
  h[3] = t10 * a00 + t11 * a10;
  h[4] = t10 * a01 + t11 * a11;
  h[5] = t10 * a02 + t11 * a12 + t12 * f1;
  h[6] = c * a00 + d * a10;
  h[7] = c * a01 + d * a11;
  h[8] = c * a02 + d * a12 + e * f1;
}

template <typename Arith>
struct AcaCore {
  using T = Arith;
  static __device__ __forceinline__ void run(const T (&s)[8], const T (&t)[8],
                                             T (&h)[9]) {
    aca_core(s, t, h);
  }
};

}  // namespace
