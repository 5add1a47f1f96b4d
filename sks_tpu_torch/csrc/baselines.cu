// K4  ge_solve, gpt_solve, ho_solve, ndlt_solve: hand-written Hopper (sm_90a)
// kernels for the batched minimal solve of the four baseline solvers.
//
// Replaces sks_tpu/kernels/baselines_pallas.py::_soa_solve (body
// _make_kernel), built there four times (ge_solve_soa, gpt_solve_soa,
// ho_solve_soa, ndlt_solve_soa).  Here it is one kernel template
// (soa.cuh::solve_soa_kernel) over four device cores, each following its
// PyTorch core op for op:
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
//
// Operation order is the contract (see soa.cuh): a Python sum(...) is a left
// fold from 0, every comparison keeps the eager op's strictness (NaN
// compares false), and max(v, tiny) keeps a NaN as torch.clamp does.

#include "soa.cuh"

namespace {

// ------------------------------------------------------------------ GE ----
struct GeCore {
  static __device__ __forceinline__ void solve3(
      float x0, float y0, float x1, float y1, float x2, float y2, float inv,
      float r0, float r1, float r2, float (&u)[3]) {
    u[0] = (r0 * (y1 - y2) - y0 * (r1 - r2) + (r1 * y2 - r2 * y1)) * inv;
    u[1] = (x0 * (r1 - r2) - r0 * (x1 - x2) + (x1 * r2 - x2 * r1)) * inv;
    u[2] = (x0 * (y1 * r2 - y2 * r1) - y0 * (x1 * r2 - x2 * r1) +
            r0 * (x1 * y2 - x2 * y1)) * inv;
  }

  static __device__ __forceinline__ float row(const float (&u)[3], float x3,
                                              float y3) {
    return u[0] * x3 + u[1] * y3 + u[2];
  }

  static __device__ __forceinline__ void run(const float (&s)[8],
                                             const float (&t)[8],
                                             float (&h)[9]) {
    const float x0 = s[0], y0 = s[1], x1 = s[2], y1 = s[3];
    const float x2 = s[4], y2 = s[5], x3 = s[6], y3 = s[7];
    const float X0 = t[0], Y0 = t[1], X1 = t[2], Y1 = t[3];
    const float X2 = t[4], Y2 = t[5], X3 = t[6], Y3 = t[7];

    const float det = x0 * (y1 - y2) - y0 * (x1 - x2) + (x1 * y2 - x2 * y1);
    const float inv = 1.0f / det;
    float u0[3], ux[3], uy[3], v0[3], vx[3], vy[3];
    solve3(x0, y0, x1, y1, x2, y2, inv, X0, X1, X2, u0);
    solve3(x0, y0, x1, y1, x2, y2, inv, x0 * X0, x1 * X1, x2 * X2, ux);
    solve3(x0, y0, x1, y1, x2, y2, inv, y0 * X0, y1 * X1, y2 * X2, uy);
    solve3(x0, y0, x1, y1, x2, y2, inv, Y0, Y1, Y2, v0);
    solve3(x0, y0, x1, y1, x2, y2, inv, x0 * Y0, x1 * Y1, x2 * Y2, vx);
    solve3(x0, y0, x1, y1, x2, y2, inv, y0 * Y0, y1 * Y1, y2 * Y2, vy);

    const float a11 = row(ux, x3, y3) - x3 * X3;
    const float a12 = row(uy, x3, y3) - y3 * X3;
    const float b1 = X3 - row(u0, x3, y3);
    const float a21 = row(vx, x3, y3) - x3 * Y3;
    const float a22 = row(vy, x3, y3) - y3 * Y3;
    const float b2 = Y3 - row(v0, x3, y3);

    const float det2 = a11 * a22 - a12 * a21;
    const float inv2 = 1.0f / det2;
    const float h7 = (b1 * a22 - b2 * a12) * inv2;
    const float h8 = (a11 * b2 - a21 * b1) * inv2;

#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[c] = u0[c] + h7 * ux[c] + h8 * uy[c];
      h[3 + c] = v0[c] + h7 * vx[c] + h8 * vy[c];
    }
    h[6] = h7;
    h[7] = h8;
    h[8] = 1.0f;
  }
};

// ----------------------------------------------------------------- GPT ----
struct GptCore {
  static __device__ __forceinline__ void run(const float (&s)[8],
                                             const float (&t)[8],
                                             float (&h)[9]) {
    // Tableau rows [A | b]: x-constraints then y-constraints.
    float m[8][9];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[2 * i], y = s[2 * i + 1];
      const float X = t[2 * i], Y = t[2 * i + 1];
      m[i][0] = x;    m[i][1] = y;    m[i][2] = 1.0f;
      m[i][3] = 0.0f; m[i][4] = 0.0f; m[i][5] = 0.0f;
      m[i][6] = (-x) * X; m[i][7] = (-y) * X; m[i][8] = X;
      m[4 + i][0] = 0.0f; m[4 + i][1] = 0.0f; m[4 + i][2] = 0.0f;
      m[4 + i][3] = x;    m[4 + i][4] = y;    m[4 + i][5] = 1.0f;
      m[4 + i][6] = (-x) * Y; m[4 + i][7] = (-y) * Y; m[4 + i][8] = Y;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // Bubble pass: swap rows k and r (columns k..8) where |m[r][k]| is
      // strictly larger, per lane and branch-free.
#pragma unroll
      for (int r = k + 1; r < 8; ++r) {
        const bool swap = fabsf(m[r][k]) > fabsf(m[k][k]);
#pragma unroll
        for (int c = k; c < 9; ++c) {
          const float a = m[k][c], b = m[r][c];
          m[k][c] = swap ? b : a;
          m[r][c] = swap ? a : b;
        }
      }
      const float inv = 1.0f / m[k][k];
#pragma unroll
      for (int c = k + 1; c < 9; ++c) m[k][c] = m[k][c] * inv;
      m[k][k] = 1.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r == k) continue;
        const float f = m[r][k];
#pragma unroll
        for (int c = k + 1; c < 9; ++c) m[r][c] = m[r][c] - f * m[k][c];
        m[r][k] = 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) h[r] = m[r][8];
    h[8] = 1.0f;
  }
};

// ------------------------------------------------- component eigensolvers ---
// sks_tpu_torch/ops/linalg.py::jacobi_smallest_col_core: SWEEPS cyclic sweeps
// over every (p, q), rows then columns of a, columns of v; returns the column
// of v at the smallest diagonal entry (strict <, NaN never taken).
// a is rotated in place.
template <int N, int SWEEPS>
__device__ __forceinline__ void jacobi_smallest_col(float (&a)[N][N],
                                                    float (&out)[N]) {
  float v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
#pragma unroll
    for (int p = 0; p < N; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
        const float tau = (aqq - app) * 0.5f;
        const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
        const float hyp = sqrtf(tau * tau + apq * apq + kTiny);
        const float tt = sgn * apq / (sgn * tau + hyp);
        const float c = 1.0f / sqrtf(tt * tt + 1.0f);
        const float sn = tt * c;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float rp = a[p][j], rq = a[q][j];
          a[p][j] = c * rp - sn * rq;
          a[q][j] = sn * rp + c * rq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float cp = a[i][p], cq = a[i][q];
          a[i][p] = c * cp - sn * cq;
          a[i][q] = sn * cp + c * cq;
          const float vp = v[i][p], vq = v[i][q];
          v[i][p] = c * vp - sn * vq;
          v[i][q] = sn * vp + c * vq;
        }
      }
    }
  }
  float best_w = a[0][0];
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = v[i][0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const bool take = a[j][j] < best_w;
    best_w = take ? a[j][j] : best_w;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = take ? v[i][j] : out[i];
  }
}

// sks_tpu_torch/ops/linalg.py::invit_smallest_col_core with its defaults:
// a 3-sweep Jacobi seed, LDL^T of A + 2^-22 trace(A) I, 3 solves, each
// rescaled by the exact power of two 2^-22.  a is left unchanged.
template <int N>
__device__ __forceinline__ void invit_smallest_col(const float (&a)[N][N],
                                                   float (&x)[N]) {
  constexpr float kShift = 2.384185791015625e-07f;  // 2^-22, exact
  {
    float aj[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) aj[i][j] = a[i][j];
    }
    jacobi_smallest_col<N, 3>(aj, x);
  }
  float tr = a[0][0];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + a[i][i];
  const float eps = tr * kShift;
  float l[N][N], w[N][N], d[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float sj = a[j][j] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) sj = sj - l[j][k] * w[j][k];
    d[j] = sj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float ti = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) ti = ti - l[i][k] * w[j][k];
      w[i][j] = ti;
      l[i][j] = ti / sj;
    }
  }
#pragma unroll
  for (int solve = 0; solve < 3; ++solve) {
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float yi = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) yi = yi - l[i][k] * y[k];
      y[i] = yi;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = y[i] / d[i];
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float xi = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) xi = xi - l[k][i] * x[k];
      x[i] = xi;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] * kShift;
  }
}

// ------------------------------------------------------------------ HO ----
struct HoCore {
  // Isotropic normalization of 4 points: zero centroid, mean distance sqrt 2.
  static __device__ __forceinline__ void iso(const float (&p)[8], float (&nx)[4],
                                             float (&ny)[4], float& cx,
                                             float& cy, float& sc) {
    constexpr float kSqrt2 = 1.41421356237309504880f;
    cx = (p[0] + p[2] + p[4] + p[6]) * 0.25f;
    cy = (p[1] + p[3] + p[5] + p[7]) * 0.25f;
    float dx[4], dy[4];
    float mean = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dx[i] = p[2 * i] - cx;
      dy[i] = p[2 * i + 1] - cy;
      mean = mean + sqrtf(dx[i] * dx[i] + dy[i] * dy[i]);
    }
    mean = mean * 0.25f;
    sc = kSqrt2 / clamp_min_nan(mean, kTiny);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nx[i] = dx[i] * sc;
      ny[i] = dy[i] * sc;
    }
  }

  // M = C^T diag(vals) C and the residual rows R = C G^{-1} M - diag(vals) C.
  static __device__ __forceinline__ void reduced(
      const float (&vals)[4], const float (&sx)[4], const float (&sy)[4],
      const float (&gi)[3][3], float (&m)[3][3], float (&rows)[4][3]) {
    float m00 = 0.0f, m01 = 0.0f, m02 = 0.0f, m11 = 0.0f, m12 = 0.0f;
    float m22 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m00 = m00 + vals[i] * sx[i] * sx[i];
      m01 = m01 + vals[i] * sx[i] * sy[i];
      m02 = m02 + vals[i] * sx[i];
      m11 = m11 + vals[i] * sy[i] * sy[i];
      m12 = m12 + vals[i] * sy[i];
      m22 = m22 + vals[i];
    }
    m[0][0] = m00; m[0][1] = m01; m[0][2] = m02;
    m[1][0] = m01; m[1][1] = m11; m[1][2] = m12;
    m[2][0] = m02; m[2][1] = m12; m[2][2] = m22;
    float k[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = acc + gi[r][j] * m[j][c];
        k[r][c] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float proj[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        proj[c] = sx[i] * k[0][c] + sy[i] * k[1][c] + k[2][c];
      rows[i][0] = proj[0] - vals[i] * sx[i];
      rows[i][1] = proj[1] - vals[i] * sy[i];
      rows[i][2] = proj[2] - vals[i];
    }
  }

  // G^{-1} M g: one row block (u or v) of the normalized H.
  static __device__ __forceinline__ void back(const float (&m)[3][3],
                                              const float (&gi)[3][3],
                                              const float (&g)[3], float* out) {
    float w[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) acc = acc + m[r][j] * g[j];
      w[r] = acc;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) acc = acc + gi[r][j] * w[j];
      out[r] = acc;
    }
  }

  static __device__ __forceinline__ void run(const float (&s)[8],
                                             const float (&t)[8],
                                             float (&h)[9]) {
    float sx[4], sy[4], tx[4], ty[4], cx1, cy1, s1, cx2, cy2, s2;
    iso(s, sx, sy, cx1, cy1, s1);
    iso(t, tx, ty, cx2, cy2, s2);

    // G = C^T C with C = [x y 1] (4x3).
    float g00 = 0.0f, g01 = 0.0f, g02 = 0.0f, g11 = 0.0f, g12 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g00 = g00 + sx[i] * sx[i];
      g01 = g01 + sx[i] * sy[i];
      g02 = g02 + sx[i];
      g11 = g11 + sy[i] * sy[i];
      g12 = g12 + sy[i];
    }
    const float g22 = 4.0f;
    // G^{-1} via adjugate.
    const float ca = g11 * g22 - g12 * g12;
    const float cb = g02 * g12 - g01 * g22;
    const float cc = g01 * g12 - g02 * g11;
    const float cd = g00 * g22 - g02 * g02;
    const float ce = g01 * g02 - g00 * g12;
    const float cf = g00 * g11 - g01 * g01;
    const float det = g00 * ca + g01 * cb + g02 * cc;
    const float dinv = 1.0f / det;
    const float gi[3][3] = {{ca * dinv, cb * dinv, cc * dinv},
                            {cb * dinv, cd * dinv, ce * dinv},
                            {cc * dinv, ce * dinv, cf * dinv}};

    float mx[3][3], my[3][3], rx[4][3], ry[4][3];
    reduced(tx, sx, sy, gi, mx, rx);
    reduced(ty, sx, sy, gi, my, ry);

    // D^T D over the 8 residual rows: the rx fold plus the ry fold.
    float dmat[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b) {
        float sxr = 0.0f, syr = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) sxr = sxr + rx[i][a] * rx[i][b];
#pragma unroll
        for (int i = 0; i < 4; ++i) syr = syr + ry[i][a] * ry[i][b];
        dmat[a][b] = sxr + syr;
        dmat[b][a] = dmat[a][b];
      }
    }
    float gvec[3];
    jacobi_smallest_col<3, 10>(dmat, gvec);

    float hn[9];
    back(mx, gi, gvec, hn);
    back(my, gi, gvec, hn + 3);
    hn[6] = gvec[0];
    hn[7] = gvec[1];
    hn[8] = gvec[2];

    // Denormalize: H = T2^{-1} Hn T1, isotropic T's.
    float rt[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float h0 = hn[3 * r], h1 = hn[3 * r + 1], h2 = hn[3 * r + 2];
      rt[r][0] = h0 * s1;
      rt[r][1] = h1 * s1;
      rt[r][2] = h2 - s1 * (h0 * cx1 + h1 * cy1);
    }
    const float inv_s2 = 1.0f / s2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[c] = rt[0][c] * inv_s2 + cx2 * rt[2][c];
      h[3 + c] = rt[1][c] * inv_s2 + cy2 * rt[2][c];
      h[6 + c] = rt[2][c];
    }
  }
};

// ---------------------------------------------------------------- NDLT ----
struct NdltCore {
  // Anisotropic Hartley normalization of 4 points.
  static __device__ __forceinline__ void hartley(const float (&p)[8],
                                                 float (&nx)[4], float (&ny)[4],
                                                 float& cx, float& cy,
                                                 float& sx, float& sy) {
    cx = (p[0] + p[2] + p[4] + p[6]) * 0.25f;
    cy = (p[1] + p[3] + p[5] + p[7]) * 0.25f;
    float dx[4], dy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dx[i] = p[2 * i] - cx;
      dy[i] = p[2 * i + 1] - cy;
    }
    const float devx =
        (fabsf(dx[0]) + fabsf(dx[1]) + fabsf(dx[2]) + fabsf(dx[3])) * 0.25f;
    const float devy =
        (fabsf(dy[0]) + fabsf(dy[1]) + fabsf(dy[2]) + fabsf(dy[3])) * 0.25f;
    sx = 1.0f / clamp_min_nan(devx, kTiny);
    sy = 1.0f / clamp_min_nan(devy, kTiny);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nx[i] = dx[i] * sx;
      ny[i] = dy[i] * sy;
    }
  }

  // Weighted sums of the 6 unique p p^T entries over the 4 points, as a 3x3
  // block [[xx, xy, x], [xy, yy, y], [x, y, 1]].
  static __device__ __forceinline__ void block(const float (&w)[4],
                                               const float (&nx)[4],
                                               const float (&ny)[4],
                                               float (&b)[3][3]) {
    float xx = 0.0f, xy = 0.0f, x = 0.0f, yy = 0.0f, y = 0.0f, o = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xx = xx + w[i] * nx[i] * nx[i];
      xy = xy + w[i] * nx[i] * ny[i];
      x = x + w[i] * nx[i];
      yy = yy + w[i] * ny[i] * ny[i];
      y = y + w[i] * ny[i];
      o = o + w[i];
    }
    b[0][0] = xx; b[0][1] = xy; b[0][2] = x;
    b[1][0] = xy; b[1][1] = yy; b[1][2] = y;
    b[2][0] = x;  b[2][1] = y;  b[2][2] = o;
  }

  static __device__ __forceinline__ void run(const float (&s)[8],
                                             const float (&t)[8],
                                             float (&h)[9]) {
    float nx[4], ny[4], tx[4], ty[4], cx1, cy1, sx1, sy1, cx2, cy2, sx2, sy2;
    hartley(s, nx, ny, cx1, cy1, sx1, sy1);
    hartley(t, tx, ty, cx2, cy2, sx2, sy2);

    float w1[4], wx[4], wy[4], wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w1[i] = 1.0f;
      wx[i] = -tx[i];
      wy[i] = -ty[i];
      wd[i] = tx[i] * tx[i] + ty[i] * ty[i];
    }
    float b1[3][3], bx[3][3], by[3][3], bd[3][3];
    block(w1, nx, ny, b1);
    block(wx, nx, ny, bx);
    block(wy, nx, ny, by);
    block(wd, nx, ny, bd);

    // LtL = [[S1, 0, Sx], [0, S1, Sy], [Sx, Sy, Sd]].
    float ltl[9][9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ltl[r][c] = b1[r][c];
        ltl[r][3 + c] = 0.0f;
        ltl[r][6 + c] = bx[r][c];
        ltl[3 + r][c] = 0.0f;
        ltl[3 + r][3 + c] = b1[r][c];
        ltl[3 + r][6 + c] = by[r][c];
        ltl[6 + r][c] = bx[r][c];
        ltl[6 + r][3 + c] = by[r][c];
        ltl[6 + r][6 + c] = bd[r][c];
      }
    }
    float hn[9];
    invit_smallest_col<9>(ltl, hn);

    // Denormalize: H = T2^{-1} Hn T1 (anisotropic Hartley T's).
    float rt[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float h0 = hn[3 * r], h1 = hn[3 * r + 1], h2 = hn[3 * r + 2];
      rt[r][0] = h0 * sx1;
      rt[r][1] = h1 * sy1;
      rt[r][2] = h2 - h0 * sx1 * cx1 - h1 * sy1 * cy1;
    }
    const float inv_sx2 = 1.0f / sx2;
    const float inv_sy2 = 1.0f / sy2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[c] = rt[0][c] * inv_sx2 + cx2 * rt[2][c];
      h[3 + c] = rt[1][c] * inv_sy2 + cy2 * rt[2][c];
      h[6 + c] = rt[2][c];
    }
  }
};

constexpr int kGeThreads = 256;
constexpr int kGptThreads = 128;
constexpr int kHoThreads = 128;
constexpr int kNdltThreads = 64;

}  // namespace

SKS_EXPORT_SOLVE(ge_solve, GeCore, kGeThreads)
SKS_EXPORT_SOLVE(gpt_solve, GptCore, kGptThreads)
SKS_EXPORT_SOLVE(ho_solve, HoCore, kHoThreads)
SKS_EXPORT_SOLVE(ndlt_solve, NdltCore, kNdltThreads)
