// Shared pieces of the per-pair tail's kernels: the IRLS refit (irls.cu) and
// the annealed LM polish (polish.cu).  Both run one block of kTailThreads per
// model, pass over the points from global memory, and reduce in a fixed order
// with no atomics, so that one call gives the same bits every time.
//
// Everything here has internal linkage, as in soa.cuh.

#pragma once

#include "soa.cuh"

namespace {

constexpr int kTailThreads = 256;
constexpr int kTailWarps = kTailThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The adjugate of h, geom/homography.py::inv_h: an up-to-scale inverse.
__device__ __forceinline__ void adjugate(const float (&h)[9],
                                         float (&a)[9]) {
  a[0] = h[4] * h[8] - h[5] * h[7];
  a[1] = h[2] * h[7] - h[1] * h[8];
  a[2] = h[1] * h[5] - h[2] * h[4];
  a[3] = h[5] * h[6] - h[3] * h[8];
  a[4] = h[0] * h[8] - h[2] * h[6];
  a[5] = h[2] * h[3] - h[0] * h[5];
  a[6] = h[3] * h[7] - h[4] * h[6];
  a[7] = h[1] * h[6] - h[0] * h[7];
  a[8] = h[0] * h[4] - h[1] * h[3];
}

// The squared symmetric transfer error of one point (ransac.py::_residual2:
// geom/homography.py::apply_homography of H and of its adjugate a).
__device__ __forceinline__ float residual2(const float (&h)[9],
                                           const float (&a)[9], float x,
                                           float y, float xp, float yp) {
  const float w = h[6] * x + h[7] * y + h[8];
  const float inv_w = 1.0f / w;
  const float dx = (h[0] * x + h[1] * y + h[2]) * inv_w - xp;
  const float dy = (h[3] * x + h[4] * y + h[5]) * inv_w - yp;
  const float wr = a[6] * xp + a[7] * yp + a[8];
  const float inv_wr = 1.0f / wr;
  const float ex = (a[0] * xp + a[1] * yp + a[2]) * inv_wr - x;
  const float ey = (a[3] * xp + a[4] * yp + a[5]) * inv_wr - y;
  return (dx * dx + dy * dy) + (ex * ex + ey * ey);
}

// Sums v over the block into out (shared, M floats), in a fixed order: a
// shuffle tree within each warp, then the warps in order.  red is shared
// scratch of W >= M floats a warp.  Every thread calls it; out is read after
// it returns, and stays valid until the next call's first barrier.
template <int M, int W>
__device__ __forceinline__ void block_sum(float (&v)[M], float (*red)[W],
                                          float* out) {
  static_assert(M <= W, "the scratch holds M sums a warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[m] = v[m] + __shfl_down_sync(kFull, v[m], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp][m] = v[m];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kTailWarps; ++w) s = s + red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace
