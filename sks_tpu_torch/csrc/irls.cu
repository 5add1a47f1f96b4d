// Hand-written Hopper (sm_90a) kernel for the IRLS refit of RANSAC's top-K
// candidates (sks_tpu_torch/robust/ransac.py::_irls_refine).
//
// irls_refine  replaces no TPU kernel: the JAX package leaves the refit to
//              XLA, which fuses it.  Eager PyTorch cannot: each round's
//              weighted NDLT and 9 x 9 Jacobi (8 sweeps of 36 rotations) is
//              ~12,100 launches of tiny operations, so the refit cost the host
//              ~80% of a fit while the card idled.  This kernel is that whole
//              refit, every round and every candidate, in one launch.
//
// What bounds it: neither bytes nor flops (K candidates x rounds x N points
// x ~110 flops, 4 x 2 x 2,000 x 110 = 1.8 MFLOP, and 16 B a point read once
// a pass), but a latency chain: each round's eigenvector is 288 dependent
// rotations of a 9 x 9 matrix, each an IEEE square root, a division and a
// correctly rounded reciprocal square root in a row, and the rounds follow
// one another.  The design therefore spends one block per candidate (the
// chains of the K candidates run side by side on K SMs), lets the block's
// warps share the passes over the points, and gives the rotations to one
// warp, which updates a rotation's rows and columns in parallel.
//
// Each round, per candidate (block):
//   1. the weights of the current model: the symmetric transfer error
//      through the adjugate (ransac.py::_residual2), then hard weights
//      r2 < (threshold * scale)^2 or MAGSAC++'s (1 - r / (k sigma))^2
//      (ransac.py::magsac_weights), times the point mask;
//   2. pass 1: sum w, w x, w y, w x', w y' -> the Hartley centroids;
//   3. pass 2: sum w |x - cx| and the like -> the Hartley scales
//      (ndlt.py::_hartley);
//   4. pass 3: the 24 sums of the normalized points that make the DLT normal
//      matrix, in ndlt.py::ndlt_core's block structure (S1, Sx, Sy, Sd:
//      weights w, -w x'n, -w y'n, w (x'n^2 + y'n^2) on the 6 unique entries
//      of p p^T), which equal ndlt_h's einsum over the 2N x 9 rows up to the
//      order of the sums;
//   5. the smallest eigenvector by linalg.py::jacobi_eigh (non-grad branch),
//      op for op: 8 cyclic sweeps over (p, q), rows, then columns, then the
//      eigenvector columns, the column of the smallest diagonal entry (strict
//      <, the lower index on ties);
//   6. denormalize, T2^-1 Hn T1 in ndlt_h's product order, and keep the
//      previous model where the refit is non-finite or sum w < 4.
// The weights are recomputed in each pass from the same model, so every pass
// sees the same bits; the points are read from global memory (L1 and L2 hold
// them at these sizes), so N has no cap.
//
// Sums run in a fixed order with no atomics (a thread's points in order,
// warps by a shuffle tree, then the warps in order through shared memory):
// one call gives the same bits every time.  Built with -fmad=false and
// without fast math (_build.NVCC_FLAGS), every product, sum, IEEE division
// and square root rounds on its own, as the eager operations do; the
// rotation's angle is baselines.cuh's Rotation<DivTiny>, the same values as
// the IEEE sequences without their slow path on converged (zero) numerators.
//
// The exported function launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include "baselines.cuh"
#include "tail.cuh"

namespace {

constexpr int kSweeps = 8;  // linalg.py::jacobi_eigh's default
constexpr int kSums = 24;   // S1, Sx, Sy, Sd: 6 entries each

// What one round needs of the current model and of the scoring.
struct Round {
  float h[9];  // the model, row-major
  float a[9];  // its adjugate (geom/homography.py::inv_h)
  float t2;    // hard weights: (threshold * scale)^2
  float ks;    // MAGSAC++: k * (sigma_max * scale)
  bool magsac;
  const float* mask;  // (N,) or null

  __device__ __forceinline__ void set(const float* hs) {
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = hs[k];
    adjugate(h, a);
  }

  // Point i's weight.  Every comparison keeps the eager op's strictness: a
  // NaN residual is never under the threshold, and clamps keep a NaN.
  __device__ __forceinline__ float weight(long long i, float x, float y,
                                          float xp, float yp) const {
    const float r2 = residual2(h, a, x, y, xp, yp);
    float w;
    if (magsac) {
      const float r = sqrtf(clamp_min_nan(r2, 0.0f));
      float g = 1.0f - r / ks;
      g = g < 0.0f ? 0.0f : (g > 1.0f ? 1.0f : g);
      w = isfinite(r2) ? g * g : 0.0f;
    } else {
      w = r2 < t2 ? 1.0f : 0.0f;
    }
    return mask ? w * mask[i] : w;
  }
};

// The weighted sums of the 6 unique entries of p p^T, p = (x, y, 1), under
// weight om: ndlt.py::ndlt_core's wsum_ppt, one point's terms.
__device__ __forceinline__ void add_ppt(float* s, float om, float nx,
                                        float ny) {
  const float wx = om * nx, wy = om * ny;
  s[0] = s[0] + wx * nx;  // xx
  s[1] = s[1] + wx * ny;  // xy
  s[2] = s[2] + wx;       // x
  s[3] = s[3] + wy * ny;  // yy
  s[4] = s[4] + wy;       // y
  s[5] = s[5] + om;       // 1
}

// Entry (r, c) of the 9 x 9 normal matrix from the 24 sums:
//   [[S1, 0, Sx], [0, S1, Sy], [Sx, Sy, Sd]], each block [[xx, xy, x],
//   [xy, yy, y], [x, y, 1]] (ndlt.py::ndlt_core's ltl).
__device__ __forceinline__ float normal_entry(const float* sums, int r,
                                              int c) {
  const int br = r / 3, bc = c / 3;
  // Block: S1 on the first two diagonal blocks, Sd on the last; Sx where
  // the block indices add to 2 off the diagonal, Sy to 3, zero to 1.
  const int b = br == bc ? (br == 2 ? 3 : 0) : br + bc - 1;
  if (b == 0 && br != bc) return 0.0f;
  // Entry of the symmetric 3 x 3 block: xx, xy, x, yy, y, 1.
  const int i = min(r % 3, c % 3), j = max(r % 3, c % 3);
  return sums[b * 6 + (i == 0 ? j : (i == 1 ? 2 + j : 5))];
}

// One candidate a block: `iters` rounds of the refit of h0[blockIdx.x] into
// out[blockIdx.x] (both (K, 3, 3)).
__global__ void __launch_bounds__(kTailThreads)
irls_refine_kernel(const float* __restrict__ h0,
                   const float* __restrict__ src,
                   const float* __restrict__ tar,
                   const float* __restrict__ mask, float* __restrict__ out,
                   long long n, int iters, float threshold, int magsac,
                   float sigma_max, float magsac_k) {
  __shared__ float red[kTailWarps][kSums];
  __shared__ float sums[kSums];
  __shared__ float hs[9];      // the current model
  __shared__ float am[9][9];   // the normal matrix, rotated in place
  __shared__ float vm[9][9];   // the eigenvectors (columns)
  const int tid = threadIdx.x;
  const long long cand = blockIdx.x;
  if (tid < 9) hs[tid] = h0[cand * 9 + tid];
  __syncthreads();

  for (int t = 0; t < iters; ++t) {
    // GNC schedule: 2^(iters-2-t) capped to [1, 4], an exact power of two.
    const float scale =
        fminf(fmaxf(ldexpf(1.0f, iters - 2 - t), 1.0f), 4.0f);
    Round m;
    m.set(hs);
    const float thr = threshold * scale;
    m.t2 = thr * thr;
    m.ks = magsac_k * (sigma_max * scale);
    m.magsac = magsac != 0;
    m.mask = mask;

    // Pass 1: the weight mass and the weighted centroids.
    float s1[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (long long i = tid; i < n; i += kTailThreads) {
      const float x = src[2 * i], y = src[2 * i + 1];
      const float xp = tar[2 * i], yp = tar[2 * i + 1];
      const float w = m.weight(i, x, y, xp, yp);
      s1[0] = s1[0] + w;
      s1[1] = s1[1] + x * w;
      s1[2] = s1[2] + y * w;
      s1[3] = s1[3] + xp * w;
      s1[4] = s1[4] + yp * w;
    }
    block_sum(s1, red, sums);
    const float wsum = sums[0];
    const float cx1 = sums[1] / wsum, cy1 = sums[2] / wsum;
    const float cx2 = sums[3] / wsum, cy2 = sums[4] / wsum;

    // Pass 2: the mean absolute deviations -> the Hartley scales.
    float s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long i = tid; i < n; i += kTailThreads) {
      const float x = src[2 * i], y = src[2 * i + 1];
      const float xp = tar[2 * i], yp = tar[2 * i + 1];
      const float w = m.weight(i, x, y, xp, yp);
      s2[0] = s2[0] + fabsf(x - cx1) * w;
      s2[1] = s2[1] + fabsf(y - cy1) * w;
      s2[2] = s2[2] + fabsf(xp - cx2) * w;
      s2[3] = s2[3] + fabsf(yp - cy2) * w;
    }
    block_sum(s2, red, sums);
    const float sx1 = 1.0f / clamp_min_nan(sums[0] / wsum, kTiny);
    const float sy1 = 1.0f / clamp_min_nan(sums[1] / wsum, kTiny);
    const float sx2 = 1.0f / clamp_min_nan(sums[2] / wsum, kTiny);
    const float sy2 = 1.0f / clamp_min_nan(sums[3] / wsum, kTiny);

    // Pass 3: the 24 sums of the normal matrix.
    float s3[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s3[k] = 0.0f;
    for (long long i = tid; i < n; i += kTailThreads) {
      const float x = src[2 * i], y = src[2 * i + 1];
      const float xp = tar[2 * i], yp = tar[2 * i + 1];
      const float w = m.weight(i, x, y, xp, yp);
      const float nx = (x - cx1) * sx1, ny = (y - cy1) * sy1;
      const float tx = (xp - cx2) * sx2, ty = (yp - cy2) * sy2;
      add_ppt(s3, w, nx, ny);
      add_ppt(s3 + 6, w * -tx, nx, ny);
      add_ppt(s3 + 12, w * -ty, nx, ny);
      add_ppt(s3 + 18, w * (tx * tx + ty * ty), nx, ny);
    }
    block_sum(s3, red, sums);
    if (tid < 81) {
      const int r = tid / 9, c = tid % 9;
      am[r][c] = normal_entry(sums, r, c);
      vm[r][c] = r == c ? 1.0f : 0.0f;
    }
    __syncthreads();

    // The Jacobi sweeps in warp 0: for each rotation, lane j < 9 updates
    // entries (p, j) and (q, j) of the rows, then (j, p) and (j, q) of the
    // columns of a and of v; lanes 9-31 compute the angle and idle.
    if (tid < 32) {
      const int lane = tid;
      for (int sweep = 0; sweep < kSweeps; ++sweep) {
        for (int p = 0; p < 8; ++p) {
          for (int q = p + 1; q < 9; ++q) {
            float c, sn;
            Rotation<DivTiny>::angle(am[p][p], am[q][q], am[p][q], c, sn);
            __syncwarp();
            if (lane < 9) {
              const float rp = am[p][lane], rq = am[q][lane];
              am[p][lane] = c * rp - sn * rq;
              am[q][lane] = sn * rp + c * rq;
            }
            __syncwarp();
            if (lane < 9) {
              const float cp = am[lane][p], cq = am[lane][q];
              am[lane][p] = c * cp - sn * cq;
              am[lane][q] = sn * cp + c * cq;
              const float vp = vm[lane][p], vq = vm[lane][q];
              vm[lane][p] = c * vp - sn * vq;
              vm[lane][q] = sn * vp + c * vq;
            }
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();

    if (tid == 0) {
      // The column of the smallest diagonal entry: strict <, so ties keep
      // the lower index and a NaN is never taken.
      int best = 0;
      float best_w = am[0][0];
      for (int j = 1; j < 9; ++j) {
        if (am[j][j] < best_w) {
          best_w = am[j][j];
          best = j;
        }
      }
      float hn[3][3];
#pragma unroll
      for (int k = 0; k < 9; ++k) hn[k / 3][k % 3] = vm[k][best];
      // H = T2^-1 Hn T1 (ndlt.py::_t_inv_matrix, _t_matrix), (T2^-1 Hn)
      // first, each entry a 3-term dot product summed left to right.
      const float t2inv[3][3] = {{1.0f / sx2, 0.0f, cx2},
                                 {0.0f, 1.0f / sy2, cy2},
                                 {0.0f, 0.0f, 1.0f}};
      const float t1[3][3] = {{sx1, 0.0f, -sx1 * cx1},
                              {0.0f, sy1, -sy1 * cy1},
                              {0.0f, 0.0f, 1.0f}};
      float mid[3][3], hnew[9];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          mid[r][c] = t2inv[r][0] * hn[0][c] + t2inv[r][1] * hn[1][c] +
                      t2inv[r][2] * hn[2][c];
      }
      bool finite = true;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float e = mid[r][0] * t1[0][c] + mid[r][1] * t1[1][c] +
                          mid[r][2] * t1[2][c];
          hnew[r * 3 + c] = e;
          finite = finite && isfinite(e);
        }
      }
      if (finite && wsum >= 4.0f) {
#pragma unroll
        for (int k = 0; k < 9; ++k) hs[k] = hnew[k];
      }
    }
    __syncthreads();
  }
  if (tid < 9) out[cand * 9 + tid] = hs[tid];
}

}  // namespace

extern "C" {

// h0, out (K, 3, 3); src, tar (N, 2); mask (N,) or null; all float32,
// contiguous.  magsac: 0 hard weights, 1 MAGSAC++ weights.
int sks_irls_refine_f32(const void* h0, const void* src, const void* tar,
                        const void* mask, void* out, long long k,
                        long long n, int iters, float threshold, int magsac,
                        float sigma_max, float magsac_k, void* stream) {
  if (k < 1 || k > 2147483647LL || n < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  irls_refine_kernel<<<static_cast<unsigned>(k), kTailThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(src),
      static_cast<const float*>(tar), static_cast<const float*>(mask),
      static_cast<float*>(out), n, iters, threshold, magsac, sigma_max,
      magsac_k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
