// Hand-written Hopper (sm_90a) kernel for the scoring of solved hypotheses
// (sks_tpu_torch/robust/ransac.py::_eval_chunk_eager, which the adaptive
// loop runs for every eager chunk).
//
// score_h  replaces no TPU kernel: the JAX package leaves
//          sks_tpu/robust/ransac.py::score_hypotheses to XLA, which fuses
//          its (B, N) passes.  Eager PyTorch cannot: at the adaptive loop's
//          131,072-hypothesis chunks against 2,000 points every one of its
//          ~25 operations writes or reads a (B, N) tensor (1.05 GB in
//          float32), so the scoring was most of a chunk's device time and
//          all of its memory.  This kernel scores every solved H of a chunk
//          in one launch; only the 4-byte score of a hypothesis (and of a
//          point chunk, below) reaches device memory.
//
// What bounds it: the float32 instruction rate, as K2's scoring (aca.cu):
// per (hypothesis, point) pair 2 IEEE divisions and ~40 separately rounded
// flops, against 20 B of point data that every hypothesis shares.  So the
// design is K2's, about warps in flight and independent work per warp:
// - A block is 32 hypotheses (one a lane: its H, its adjugate and whether H
//   is finite, in registers, computed once) by kSlices warps.  The block
//   stages its points in tiles of kTile in shared memory (x, y, x', y',
//   weight; zero-weight padding up to a multiple of kStep, which adds
//   exactly +0); each warp takes its own contiguous slice of a tile, and its
//   32 lanes read one shared address at a time (a broadcast), four points a
//   16-byte load.
// - The point loop takes kStep = 4 points a step: eight divisions of
//   independent work in a thread.
// - Grid (hypothesis blocks, point chunks): the point chunks go on grid.y
//   only where B alone does not put enough blocks on the 132 SMs
//   (kernels/aca_cuda.py::score_grid, the rule of K2, whose block this is).
// - Sums in a fixed order, no atomics: a step's four gains pairwise, the
//   steps of a tile in order, the tiles in order, the slices in order
//   through shared memory, the chunks in order through a scratch (chunks, B)
//   summed by score_sum_kernel.  The same call gives the same bits every
//   time.
//
// Each pair follows ransac.py::score_hypotheses op for op (built with
// -fmad=false and without fast math: every product, sum, IEEE division and
// square root rounds on its own, as the eager operation does):
// - the residual is tail.cuh's residual2, _residual2's order
//   (dx^2 + dy^2) + (ex^2 + ey^2) through the adjugate, so every r2 has the
//   eager bits and 'inliers' counts equal score_hypotheses' exactly;
// - a NaN or infinite r2 is no inlier and gains 0 (every gain is gated on a
//   comparison that NaN fails);
// - 'inliers' gains r2 < t2; 'msac' max(1 - r2 / t2, 0); 'magsac'
//   magsac_weights' clamp(1 - sqrt(r2) / (k sigma_max), 0, 1)^2, computed
//   only where r2 < gate (4 (k sigma_max)^2: beyond it the weight rounds to
//   0 in any order);
// - a gain is multiplied by the point's weight (the mask, 0 or 1);
// - a hypothesis with a non-finite entry scores -1 (K1's NaN for a
//   degenerate minimal set ends here, and so does a non-finite adjugate's
//   NaN residual).
// The scores differ from the eager sums only by the order of the sum over
// points: for 'inliers' (integer sums) not at all.
//
// The exported function launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include "tail.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kSlices = 8;
constexpr int kThreads = kLanes * kSlices;
constexpr int kTile = 512;
constexpr int kStep = 4;  // points a step, one float4 load a row
constexpr int kSumThreads = 256;

enum Scoring { kInliers = 0, kMsac = 1, kMagsac = 2 };

// The scoring's constants, each rounded to float32 as score_hypotheses'
// 0-d tensors are: t2 = threshold^2; ks = k * sigma_max; gate = 4 ks^2.
struct Gains {
  float t2, ks, gate;
};

template <int SCORING>
__device__ __forceinline__ float gain(float r2, const Gains& c) {
  if (SCORING == kInliers) return r2 < c.t2 ? 1.f : 0.f;
  if (SCORING == kMsac) {
    if (!(r2 < c.t2)) return 0.f;
    const float v = 1.f - r2 / c.t2;
    return v > 0.f ? v : 0.f;
  }
  if (!(r2 < c.gate)) return 0.f;
  // r2 >= 0 (a sum of squares), so clamp(r2, min=0) is r2, and 1 - r / ks
  // is at most 1: the clamp to [0, 1] is the one to 0.
  float v = 1.f - sqrtf(r2) / c.ks;
  v = v > 0.f ? v : 0.f;
  return v * v;
}

__device__ __forceinline__ bool finite9(const float (&h)[9]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) ok = ok && isfinite(h[k]);
  return ok;
}

// partial: (chunks, B); chunk c scores points
// [c * chunk_points, min(n, (c + 1) * chunk_points)).  With one chunk it is
// the output, and takes the final score (-1 where H is not finite).
template <int SCORING>
__global__ void __launch_bounds__(kThreads)
score_h_kernel(const float* __restrict__ hs, const float* __restrict__ src,
               const float* __restrict__ tar,
               const float* __restrict__ weights, Gains c,
               float* __restrict__ partial, long long b, long long n,
               long long chunk_points) {
  __shared__ __align__(16) float sh[5][kTile];  // x, y, x', y', weight
  __shared__ float red[kSlices][kLanes];

  const int lane = threadIdx.x, slice = threadIdx.y;
  const int tid = slice * kLanes + lane;
  const long long chunk = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kLanes + lane;
  // Lanes beyond B score the zero matrix (every gain is gated, so its NaN
  // residuals gain 0) and reach every barrier; they write nothing.
  const bool active = i < b;

  float h[9], a[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = active ? hs[i * 9 + k] : 0.f;
  const bool finite = finite9(h);
  adjugate(h, a);

  const long long chunk_begin = chunk * chunk_points;
  const long long chunk_end =
      chunk_begin + chunk_points < n ? chunk_begin + chunk_points : n;
  float acc = 0.f;
  for (long long base = chunk_begin; base < chunk_end; base += kTile) {
    const int cnt =
        static_cast<int>(chunk_end - base < kTile ? chunk_end - base : kTile);
    for (int j = tid; j < kTile; j += kThreads) {
      const bool valid = j < cnt;
      const long long p = base + j;
      sh[0][j] = valid ? src[2 * p] : 0.f;
      sh[1][j] = valid ? src[2 * p + 1] : 0.f;
      sh[2][j] = valid ? tar[2 * p] : 0.f;
      sh[3][j] = valid ? tar[2 * p + 1] : 0.f;
      sh[4][j] = valid ? (weights ? weights[p] : 1.f) : 0.f;
    }
    __syncthreads();
    // This warp's slice of the tile: the points dealt evenly over the warps
    // in contiguous runs, each a multiple of kStep (the padding weighs 0).
    const int run = ((cnt + kSlices - 1) / kSlices + kStep - 1) / kStep * kStep;
    const int padded = (cnt + kStep - 1) / kStep * kStep;
    const int j0 = slice * run;
    const int j1 = j0 + run < padded ? j0 + run : padded;
    float part = 0.f;
    for (int j = j0; j < j1; j += kStep) {
      const float4 x = *reinterpret_cast<const float4*>(&sh[0][j]);
      const float4 y = *reinterpret_cast<const float4*>(&sh[1][j]);
      const float4 xp = *reinterpret_cast<const float4*>(&sh[2][j]);
      const float4 yp = *reinterpret_cast<const float4*>(&sh[3][j]);
      const float4 w = *reinterpret_cast<const float4*>(&sh[4][j]);
      const float g0 =
          gain<SCORING>(residual2(h, a, x.x, y.x, xp.x, yp.x), c) * w.x;
      const float g1 =
          gain<SCORING>(residual2(h, a, x.y, y.y, xp.y, yp.y), c) * w.y;
      const float g2 =
          gain<SCORING>(residual2(h, a, x.z, y.z, xp.z, yp.z), c) * w.z;
      const float g3 =
          gain<SCORING>(residual2(h, a, x.w, y.w, xp.w, yp.w), c) * w.w;
      part = part + ((g0 + g1) + (g2 + g3));
    }
    acc = acc + part;
    __syncthreads();
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && active) {
    float sum = red[0][lane];
#pragma unroll
    for (int s = 1; s < kSlices; ++s) sum = sum + red[s][lane];
    if (gridDim.y == 1)
      partial[i] = finite ? sum : -1.f;
    else
      partial[chunk * b + i] = sum;
  }
}

// (chunks, B) -> (B,), chunks added in order; -1 where H is not finite.
__global__ void __launch_bounds__(kSumThreads)
score_sum_kernel(const float* __restrict__ hs,
                 const float* __restrict__ partial, float* __restrict__ out,
                 long long b, int chunks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= b) return;
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = hs[i * 9 + k];
  float sum = partial[i];
  for (int ch = 1; ch < chunks; ++ch) sum = sum + partial[ch * b + i];
  out[i] = finite9(h) ? sum : -1.f;
}

}  // namespace

extern "C" {

// h (B, 3, 3); src, tar (N, 2); weights (N,) or null (every point 1); out
// (B,); scratch (chunks, B), unused when chunks == 1; all float32,
// contiguous.  scoring: 0 inliers, 1 msac, 2 magsac.  A refused launch (a
// grid axis out of range) returns its error and launches nothing more.
int sks_score_h_f32(const void* h, const void* src, const void* tar,
                    const void* weights, void* out, void* scratch,
                    long long b, long long n, long long chunks,
                    long long chunk_points, int scoring, float t2, float ks,
                    float gate, void* stream) {
  if (b < 1 || n < 0 || chunks < 1 || chunks * chunk_points < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((b + kLanes - 1) / kLanes),
                  static_cast<unsigned>(chunks));
  const dim3 block(kLanes, kSlices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hs = static_cast<const float*>(h);
  const float* s = static_cast<const float*>(src);
  const float* t = static_cast<const float*>(tar);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  float* part = chunks == 1 ? o : static_cast<float*>(scratch);
  const Gains c{t2, ks, gate};
  switch (scoring) {
    case kInliers:
      score_h_kernel<kInliers>
          <<<grid, block, 0, st>>>(hs, s, t, w, c, part, b, n, chunk_points);
      break;
    case kMsac:
      score_h_kernel<kMsac>
          <<<grid, block, 0, st>>>(hs, s, t, w, c, part, b, n, chunk_points);
      break;
    case kMagsac:
      score_h_kernel<kMagsac>
          <<<grid, block, 0, st>>>(hs, s, t, w, c, part, b, n, chunk_points);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks == 1) return err;
  score_sum_kernel<<<static_cast<unsigned>((b + kSumThreads - 1) /
                                           kSumThreads),
                     kSumThreads, 0, st>>>(hs, part, o, b,
                                           static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
