// Hand-written Hopper (sm_90a) kernel for the annealed Levenberg-Marquardt
// polish of a selected RANSAC model (sks_tpu_torch/robust/polish.py::
// anneal_polish).
//
// anneal_polish  replaces no TPU kernel: the JAX package leaves
//                sks_tpu/robust/polish.py::anneal_polish (its LM body
//                gn_refine_h) to XLA, which fuses it.  Eager PyTorch cannot:
//                3 levels of 8 LM steps, each two passes of normal equations
//                and an 8 x 8 LU solve, are ~4,400 launches of tiny
//                operations, the host's time of almost the whole tail while
//                the card idles.  This kernel is the whole polish in one
//                launch.
//
// What bounds it: neither bytes (16 B a point a pass, read from L1 / L2) nor
// operations (~110 flops a point a pass, ~6 MFLOP at N = 2,000), but a chain
// of dependent steps: per level a consensus pass, two Hartley passes, one
// pass of normal equations, then 8 steps of (solve, pass); in all at most
// 3 x (3 + 8) = 33 block reductions and 24 solves for the default levels,
// each waiting for the one before.  The design therefore gives the model one
// block of 256 threads that share every pass over the points, and keeps the
// LM's state in every thread's registers: each thread reads the reduced sums
// and runs the same solve on them, so a step needs no broadcast and no
// barrier besides the reduction's.
//
// Per level m (polish.py::anneal_polish, gn_refine_h):
//   1. pass 1: the consensus of the current model, r2 < 2 (m threshold)^2 on
//      the symmetric transfer error through the adjugate (ransac.py::
//      _residual2) and the point mask, kept a byte a point in scratch; its
//      mass and weighted centroids.  The first level's mass is n0.  A level
//      with mass < 8 or < 0.25 max(n0, 1) is skipped, as the eager where;
//   2. pass 2: the mean absolute deviations -> the Hartley scales
//      (ndlt.py::_hartley), so hn = T2 h T1^-1 / hn22;
//   3. pass 3: the LM system at hn, the 30 sums below;
//   4. 8 steps: solve (A + lam diag(A) + 1e-12 I) d = -g by LU with partial
//      pivoting (torch.linalg.solve_ex), h_new = hn + d, then one pass at
//      h_new that sums its system and its cost together.  The step is taken
//      where the new cost is finite and lower and h_new finite (lam x 0.3,
//      floor 1e-8), else lam x 10.  The eager loop recomputes the system at
//      hn in a second pass; here an accepted step's pass is the next step's
//      system, and a rejected step keeps the system it had, which is what a
//      pass at the unchanged hn would sum: the same arithmetic in half the
//      passes;
//   5. H = T2^-1 hn T1, kept where finite.
//
// The 30 sums of a pass at h (normalized points s -> t, weight w): the
// forward residual r = (px, py) / pz - t and its Jacobian rows (polish.py::
// _forward_normal_eqs) jx = (u, v, iz, 0, 0, 0, ex, fx), jy = (0, 0, 0, u, v,
// iz, ey, fy), u = x iz, v = y iz, ex = -px x iz iz, fx = -px y iz iz, ey and
// fy the same with py:
//   0-5    (w q_i) q_j over q = (u, v, iz), i <= j (uu, uv, u iz, vv, v iz,
//          iz iz): the blocks A[0:3, 0:3] and A[3:6, 3:6], which are equal;
//   6-11   (w q_i) (ex, fx)_j: A[0:3, 6:8];
//   12-17  (w q_i) (ey, fy)_j: A[3:6, 6:8];
//   18-20  (w ex) ex + (w ey) ey, (w ex) fx + (w ey) fy, (w fx) fx + (w fy) fy:
//          A[6:8, 6:8];
//   21-28  g: q_i (w rx), q_i (w ry), ex (w rx) + ey (w ry), fx (w rx) +
//          fy (w ry);
//   29     the cost, w (rx^2 + ry^2).
// A[0:3, 3:6] is zero: jx and jy share no support there.
//
// Sums run in a fixed order with no atomics (tail.cuh's block_sum), so one
// call gives the same bits every time.  Built with -fmad=false and without
// fast math, every product, sum, IEEE division and square root rounds on its
// own, as the plain version's operations (kernels/polish_cuda.py::
// anneal_polish_plain) do; the two differ in the order of the sums over the
// points only.  N has no cap: the points are read from global memory.
//
// The exported function launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include "tail.cuh"

namespace {

constexpr int kSys = 30;  // the sums of one LM pass
constexpr int kMaxLevels = 8;

struct Levels {
  float m[kMaxLevels];
  int n;
};

// c = a b for row-major 3 x 3 matrices, each entry a 3-term dot product
// summed left to right.
__device__ __forceinline__ void mul3(const float (&a)[9], const float (&b)[9],
                                     float (&c)[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[r * 3 + k] = a[r * 3] * b[k] + a[r * 3 + 1] * b[3 + k] +
                     a[r * 3 + 2] * b[6 + k];
  }
}

__device__ __forceinline__ bool all_finite(const float (&h)[9]) {
  bool f = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) f = f && isfinite(h[k]);
  return f;
}

// The Hartley normalisation of both point sets: x -> (x - cx) sx.
struct Hartley {
  float cx1, cy1, sx1, sy1, cx2, cy2, sx2, sy2;
};

// One point's terms of the 30 sums at h (see the note above).
__device__ __forceinline__ void add_terms(const float (&h)[9], float x,
                                          float y, float tx, float ty,
                                          float w, float (&s)[kSys]) {
  const float px = h[0] * x + h[1] * y + h[2];
  const float py = h[3] * x + h[4] * y + h[5];
  const float pz = h[6] * x + h[7] * y + h[8];
  const float iz = 1.0f / pz;
  const float rx = px * iz - tx;
  const float ry = py * iz - ty;
  const float q[3] = {x * iz, y * iz, iz};
  const float ex = -px * x * iz * iz, fx = -px * y * iz * iz;
  const float ey = -py * x * iz * iz, fy = -py * y * iz * iz;
  const float wq[3] = {w * q[0], w * q[1], w * q[2]};
  const float wex = w * ex, wfx = w * fx, wey = w * ey, wfy = w * fy;
  const float wrx = w * rx, wry = w * ry;
  s[0] = s[0] + wq[0] * q[0];
  s[1] = s[1] + wq[0] * q[1];
  s[2] = s[2] + wq[0] * q[2];
  s[3] = s[3] + wq[1] * q[1];
  s[4] = s[4] + wq[1] * q[2];
  s[5] = s[5] + wq[2] * q[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[6 + 2 * i] = s[6 + 2 * i] + wq[i] * ex;
    s[7 + 2 * i] = s[7 + 2 * i] + wq[i] * fx;
    s[12 + 2 * i] = s[12 + 2 * i] + wq[i] * ey;
    s[13 + 2 * i] = s[13 + 2 * i] + wq[i] * fy;
    s[21 + i] = s[21 + i] + q[i] * wrx;
    s[24 + i] = s[24 + i] + q[i] * wry;
  }
  s[18] = s[18] + (wex * ex + wey * ey);
  s[19] = s[19] + (wex * fx + wey * fy);
  s[20] = s[20] + (wfx * fx + wfy * fy);
  s[27] = s[27] + (ex * wrx + ey * wry);
  s[28] = s[28] + (fx * wrx + fy * wry);
  s[29] = s[29] + w * (rx * rx + ry * ry);
}

// The 30 sums at h over the normalized points of weight wbuf[i], into sums
// (shared).  Thread t visits the points t, t + 256, ... as pass 1 did, so it
// reads only the weights it wrote itself.
__device__ __forceinline__ void lm_pass(const float (&h)[9], const Hartley& nm,
                                        const float* __restrict__ src,
                                        const float* __restrict__ tar,
                                        const unsigned char* wbuf,
                                        long long n, float (*red)[kSys],
                                        float* sums) {
  float s[kSys];
#pragma unroll
  for (int k = 0; k < kSys; ++k) s[k] = 0.0f;
  for (long long i = threadIdx.x; i < n; i += kTailThreads) {
    const float w = wbuf[i];
    add_terms(h, (src[2 * i] - nm.cx1) * nm.sx1,
              (src[2 * i + 1] - nm.cy1) * nm.sy1,
              (tar[2 * i] - nm.cx2) * nm.sx2,
              (tar[2 * i + 1] - nm.cy2) * nm.sy2, w, s);
  }
  block_sum(s, red, sums);
}

// Index of (A)_ij, 0 <= i <= j < 3, among the sums 0-5.
__host__ __device__ constexpr int qq(int i, int j) {
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

// d = solve(A + lam diag(A) + 1e-12 I, -g), A and g from the 30 sums s:
// LU with partial pivoting, as torch.linalg.solve_ex (LAPACK getrf, getrs).
// The pivot of column k is the first row r >= k of largest |a_rk| (LAPACK's
// isamax: strict >, so a NaN past row k is never taken); rows k and p swap;
// each row below subtracts l = a_rk / a_kk times row k, the right-hand side
// with it; then back substitution, each row's sum left to right.  Every
// index is known at compile time (the swap is a select), so the 8 x 9 system
// stays in registers.
__device__ __forceinline__ void lm_solve(const float (&s)[kSys], float lam,
                                         float (&d)[8]) {
  float m[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i; j < 8; ++j) {
      float a;
      if (j < 3) a = s[qq(i, j)];
      else if (i < 3 && j < 6) a = 0.0f;
      else if (j < 6) a = s[qq(i - 3, j - 3)];
      else if (i < 3) a = s[6 + 2 * i + (j - 6)];
      else if (i < 6) a = s[12 + 2 * (i - 3) + (j - 6)];
      else a = s[18 + (i - 6) + (j - 6)];
      m[i][j] = a;
      m[j][i] = a;
    }
    m[i][i] = (m[i][i] + lam * m[i][i]) + 1e-12f;
    m[i][8] = -s[21 + i];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int p = k;
    float best = fabsf(m[k][k]);
#pragma unroll
    for (int r = k + 1; r < 8; ++r) {
      const float a = fabsf(m[r][k]);
      if (a > best) {
        best = a;
        p = r;
      }
    }
#pragma unroll
    for (int c = k; c < 9; ++c) {
      const float old_k = m[k][c];
      float new_k = old_k;
#pragma unroll
      for (int r = k + 1; r < 8; ++r) {
        new_k = p == r ? m[r][c] : new_k;
        m[r][c] = p == r ? old_k : m[r][c];
      }
      m[k][c] = new_k;
    }
#pragma unroll
    for (int r = k + 1; r < 8; ++r) {
      const float l = m[r][k] / m[k][k];
#pragma unroll
      for (int c = k + 1; c < 9; ++c) m[r][c] = m[r][c] - l * m[k][c];
    }
  }
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    float t = m[i][8];
#pragma unroll
    for (int j = i + 1; j < 8; ++j) t = t - m[i][j] * d[j];
    d[i] = t / m[i][i];
  }
}

// The polish of h0 (3 x 3) into out: one block.
__global__ void __launch_bounds__(kTailThreads)
anneal_polish_kernel(const float* __restrict__ h0,
                     const float* __restrict__ src,
                     const float* __restrict__ tar,
                     const unsigned char* __restrict__ mask,
                     unsigned char* wbuf, float* __restrict__ out,
                     long long n, float threshold, Levels levels, int iters) {
  __shared__ float red[kTailWarps][kSys];
  __shared__ float sums[kSys];
  const int tid = threadIdx.x;
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = h0[k];
  float n0 = 0.0f;

  for (int lv = 0; lv < levels.n; ++lv) {
    const float mt = levels.m[lv] * threshold;
    const float t2 = 2.0f * (mt * mt);
    float a[9];
    adjugate(h, a);

    // Pass 1: the consensus, its mass and its weighted centroids.
    float s1[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (long long i = tid; i < n; i += kTailThreads) {
      const float x = src[2 * i], y = src[2 * i + 1];
      const float xp = tar[2 * i], yp = tar[2 * i + 1];
      const bool in = residual2(h, a, x, y, xp, yp) < t2 &&
                      (mask == nullptr || mask[i] != 0);
      wbuf[i] = in;
      const float w = in ? 1.0f : 0.0f;
      s1[0] = s1[0] + w;
      s1[1] = s1[1] + x * w;
      s1[2] = s1[2] + y * w;
      s1[3] = s1[3] + xp * w;
      s1[4] = s1[4] + yp * w;
    }
    block_sum(s1, red, sums);
    const float mass = sums[0];
    if (lv == 0) n0 = clamp_min_nan(mass, 1.0f);
    if (!(mass >= 8.0f && mass >= 0.25f * n0)) continue;  // block-uniform
    Hartley nm;
    nm.cx1 = sums[1] / mass;
    nm.cy1 = sums[2] / mass;
    nm.cx2 = sums[3] / mass;
    nm.cy2 = sums[4] / mass;

    // Pass 2: the mean absolute deviations -> the Hartley scales.
    float s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long i = tid; i < n; i += kTailThreads) {
      const float w = wbuf[i];
      s2[0] = s2[0] + fabsf(src[2 * i] - nm.cx1) * w;
      s2[1] = s2[1] + fabsf(src[2 * i + 1] - nm.cy1) * w;
      s2[2] = s2[2] + fabsf(tar[2 * i] - nm.cx2) * w;
      s2[3] = s2[3] + fabsf(tar[2 * i + 1] - nm.cy2) * w;
    }
    block_sum(s2, red, sums);
    nm.sx1 = 1.0f / clamp_min_nan(sums[0] / mass, kTiny);
    nm.sy1 = 1.0f / clamp_min_nan(sums[1] / mass, kTiny);
    nm.sx2 = 1.0f / clamp_min_nan(sums[2] / mass, kTiny);
    nm.sy2 = 1.0f / clamp_min_nan(sums[3] / mass, kTiny);

    // hn = T2 h T1^-1 / hn22 (ndlt.py::_t_matrix, _t_inv_matrix).
    const float t2m[9] = {nm.sx2, 0.0f, -nm.sx2 * nm.cx2,
                          0.0f, nm.sy2, -nm.sy2 * nm.cy2,
                          0.0f, 0.0f, 1.0f};
    const float t1i[9] = {1.0f / nm.sx1, 0.0f, nm.cx1,
                          0.0f, 1.0f / nm.sy1, nm.cy1,
                          0.0f, 0.0f, 1.0f};
    float mid[9], hn[9];
    mul3(t2m, h, mid);
    mul3(mid, t1i, hn);
    const float h22 = hn[8];
#pragma unroll
    for (int k = 0; k < 9; ++k) hn[k] = hn[k] / h22;

    // Pass 3, then the LM steps, each a solve and one fused pass.
    float sys[kSys];
    lm_pass(hn, nm, src, tar, wbuf, n, red, sums);
#pragma unroll
    for (int k = 0; k < kSys; ++k) sys[k] = sums[k];
    float lam = 1e-3f;
    for (int it = 0; it < iters; ++it) {
      float d[8], hnew[9];
      lm_solve(sys, lam, d);
#pragma unroll
      for (int k = 0; k < 8; ++k) hnew[k] = hn[k] + d[k];
      hnew[8] = hn[8] + 0.0f;
      lm_pass(hnew, nm, src, tar, wbuf, n, red, sums);
      const float cost_new = sums[kSys - 1];
      if (isfinite(cost_new) && cost_new < sys[kSys - 1] &&
          all_finite(hnew)) {
#pragma unroll
        for (int k = 0; k < 9; ++k) hn[k] = hnew[k];
#pragma unroll
        for (int k = 0; k < kSys; ++k) sys[k] = sums[k];
        lam = clamp_min_nan(lam * 0.3f, 1e-8f);
      } else {
        lam = lam * 10.0f;
      }
    }

    // H = T2^-1 hn T1, kept where finite.
    const float t2i[9] = {1.0f / nm.sx2, 0.0f, nm.cx2,
                          0.0f, 1.0f / nm.sy2, nm.cy2,
                          0.0f, 0.0f, 1.0f};
    const float t1m[9] = {nm.sx1, 0.0f, -nm.sx1 * nm.cx1,
                          0.0f, nm.sy1, -nm.sy1 * nm.cy1,
                          0.0f, 0.0f, 1.0f};
    float h_out[9];
    mul3(t2i, hn, mid);
    mul3(mid, t1m, h_out);
    if (all_finite(h_out)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) h[k] = h_out[k];
    }
  }
  if (tid < 9) out[tid] = h[tid];
}

}  // namespace

extern "C" {

// h0, out (3, 3); src, tar (N, 2); mask (N,) bool or null; wbuf (N,) bytes
// of scratch; float32 and contiguous.  levels: n_levels threshold
// multipliers (host memory, at most 8), iters LM steps a level.
int sks_anneal_polish_f32(const void* h0, const void* src, const void* tar,
                          const void* mask, void* wbuf, void* out,
                          long long n, float threshold, const float* levels,
                          int n_levels, int iters, void* stream) {
  if (n < 0 || iters < 0 || n_levels < 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int i = 0; i < n_levels; ++i) lv.m[i] = levels[i];
  lv.n = n_levels;
  anneal_polish_kernel<<<1, kTailThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(src),
      static_cast<const float*>(tar), static_cast<const unsigned char*>(mask),
      static_cast<unsigned char*>(wbuf), static_cast<float*>(out), n,
      threshold, lv, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
