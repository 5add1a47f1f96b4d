// Hand-written Hopper (sm_90a) kernels for the ACA hot path of sks_tpu_torch.
//
// K1  aca_solve      replaces sks_tpu/kernels/aca_pallas.py::aca_solve_soa
//                    (body _solve_kernel): batched division-free ACA.
// K2  aca_solve_score replaces sks_tpu/kernels/aca_pallas.py::aca_solve_score_soa
//                    (body _solve_score_kernel): ACA solve + adjugate +
//                    symmetric-transfer RANSAC scoring against all N points.
//
// The core: aca.cuh.  Layout and build flags: see soa.cuh.  -fmad=false
// makes every product and sum round on its own, exactly as the plain
// PyTorch version (one elementwise op at a time) does: K1 and its plain
// version agree bit for bit, and so does every per-point gain of K2, whose
// scores then differ from the plain version's by the order of the sum over
// points only ('inliers' counts not at all).  The scoring relies on IEEE
// division and on NaN < t2 being false, which fast math would break.
//
// Each exported function launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include "aca.cuh"

namespace {

// ---------------------------------------------------------------- K1 ------
// One thread per hypothesis (soa.cuh): 16 coalesced loads, 97 flops, 9
// coalesced stores.  Bound by device-memory bytes (100 B per hypothesis in
// f32, 50 B in bf16), so the design is only: full coalescing and enough
// blocks in flight.
constexpr int kSolveThreads = 256;

// ---------------------------------------------------------------- K2 ------
// Bound by float32 instruction rate, not by bytes: per (hypothesis, point)
// pair 2 IEEE divisions and ~38 separately rounded flops (-fmad=false), 74
// instructions as compiled, against 20 B of point data that every hypothesis
// shares and 68 B per hypothesis in and out.  The card reaches that rate only
// if every SM holds many warps and every warp has independent work, so the
// design is about warps in flight and instruction-level parallelism:
//
// - A launch covers (hypothesis block, point chunk, pair) = grid (x, y, z).
//   The TPU kernel's sequential point-block grid axis becomes parallel
//   chunks; its vmap over pairs becomes grid.z.  The wrapper picks the chunk
//   count from (pairs, B, N) (kernels/aca_cuda.py::score_grid): enough chunks
//   to put several warps on each SM when B is small, one when B alone fills
//   the card.
// - A block is 32 hypotheses (one per lane) x kScoreSlices warps.  The block
//   stages its chunk in tiles of kTile points in shared memory (x, y, x', y',
//   weight; zero-weight padding up to the tile, which adds exactly +0); each
//   warp takes its own contiguous slice of the tile, and its 32 lanes read
//   the same shared-memory address (a broadcast), four points per 16-byte
//   load.  Every thread recomputes the 97-flop solve and the adjugate for its
//   slice, as the TPU kernel does per point block: noise beside some tens of
//   points at ~70 instructions each.
// - The point loop takes four points a step (eight more measured slower: it
//   spills), so eight divisions are independent work in one thread; the four
//   gains are then added to the one accumulator in point order.
// - Sums have a fixed order and no atomics: points in order within a slice,
//   slices in order through shared memory, chunks in order through a scratch
//   tensor (pairs, chunks, B) summed by sum_chunks_kernel.  The same launch
//   gives the same bits every time; 'inliers' scores with 0/1 weights are
//   exact integers whatever the order.
// Global staging is scalar and coalesced: rows of a (4, N) tensor with a
// ragged N are not 16-byte aligned, and staging moves 20 B per point per
// block against ~70 instructions per point per thread.
constexpr int kScoreLanes = 32;
constexpr int kScoreSlices = 8;
constexpr int kScoreThreads = kScoreLanes * kScoreSlices;
constexpr int kTile = 512;
constexpr int kUnroll = 4;  // points per step, a multiple of 4 (float4 loads)

enum Scoring { kInliers = 0, kMsac = 1, kMagsac = 2 };

struct ScoreModel {
  float h[9];  // H, row-major
  float a[9];  // its adjugate, row-major
};

// One (hypothesis, point) pair: sks_tpu_torch/kernels/aca_cuda.py::
// aca_solve_score_soa_plain, op for op.
template <int SCORING>
__device__ __forceinline__ float pair_gain(const ScoreModel& m, float x,
                                           float y, float xp, float yp,
                                           float pw, float t2) {
  // Forward transfer.
  const float w = m.h[6] * x + m.h[7] * y + m.h[8];
  const float inv_w = 1.0f / w;
  const float dx = (m.h[0] * x + m.h[1] * y + m.h[2]) * inv_w - xp;
  const float dy = (m.h[3] * x + m.h[4] * y + m.h[5]) * inv_w - yp;
  float r2 = dx * dx + dy * dy;
  // Reverse transfer.
  const float wr = m.a[6] * xp + m.a[7] * yp + m.a[8];
  const float inv_wr = 1.0f / wr;
  const float dxr = (m.a[0] * xp + m.a[1] * yp + m.a[2]) * inv_wr - x;
  const float dyr = (m.a[3] * xp + m.a[4] * yp + m.a[5]) * inv_wr - y;
  r2 = r2 + dxr * dxr + dyr * dyr;
  const bool finite = (w != 0.f) && (wr != 0.f);
  // Every gain gates on r2 < t2: a NaN residual compares false and scores
  // 0, never propagates.
  const bool inl = r2 < t2;
  float gain;
  if (SCORING == kInliers) {
    gain = inl ? 1.f : 0.f;
  } else if (SCORING == kMsac) {
    gain = inl ? 1.f - r2 / t2 : 0.f;
  } else {
    // t2 carries (k * sigma_max)^2: weight (1 - r / (k sigma_max))^2.
    const float rr = sqrtf((r2 > 0.f ? r2 : 0.f) / t2);
    const float g = 1.f - rr;
    gain = inl ? g * g : 0.f;
  }
  return (finite ? gain : 0.f) * pw;
}

// partial: (pairs, chunks, B); chunk c of pair p scores points
// [c * chunk_points, min(n, (c + 1) * chunk_points)).
template <typename T, int SCORING>
__global__ void __launch_bounds__(kScoreThreads)
aca_solve_score_kernel(const T* __restrict__ src, const T* __restrict__ tar,
                       const float* __restrict__ pts,
                       const float* __restrict__ weights, float t2,
                       float* __restrict__ partial, long long b, long long n,
                       long long chunk_points) {
  __shared__ __align__(16) float sh[5][kTile];  // x, y, x', y', weight
  __shared__ float red[kScoreSlices][kScoreLanes];

  const int lane = threadIdx.x, slice = threadIdx.y;
  const int tid = slice * kScoreLanes + lane;
  const long long pair = blockIdx.z, chunk = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kScoreLanes + lane;
  // Lanes beyond B score the zero matrix (no hazard: every gain is gated)
  // and reach every barrier; they write nothing.
  const bool active = i < b;
  src += pair * 8 * b;
  tar += pair * 8 * b;
  pts += pair * 4 * n;
  weights += pair * n;

  ScoreModel m;
#pragma unroll
  for (int k = 0; k < 9; ++k) m.h[k] = 0.f;
  if (active) {
    float s[8], t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      load(src + k * b + i, s[k]);
      load(tar + k * b + i, t[k]);
    }
    aca_core(s, t, m.h);
  }
  // Adjugate for the reverse transfer (division-free up-to-scale inverse).
  m.a[0] = m.h[4] * m.h[8] - m.h[5] * m.h[7];
  m.a[1] = m.h[2] * m.h[7] - m.h[1] * m.h[8];
  m.a[2] = m.h[1] * m.h[5] - m.h[2] * m.h[4];
  m.a[3] = m.h[5] * m.h[6] - m.h[3] * m.h[8];
  m.a[4] = m.h[0] * m.h[8] - m.h[2] * m.h[6];
  m.a[5] = m.h[2] * m.h[3] - m.h[0] * m.h[5];
  m.a[6] = m.h[3] * m.h[7] - m.h[4] * m.h[6];
  m.a[7] = m.h[1] * m.h[6] - m.h[0] * m.h[7];
  m.a[8] = m.h[0] * m.h[4] - m.h[1] * m.h[3];

  const long long chunk_begin = chunk * chunk_points;
  const long long chunk_end =
      chunk_begin + chunk_points < n ? chunk_begin + chunk_points : n;
  float acc = 0.f;
  for (long long base = chunk_begin; base < chunk_end; base += kTile) {
    const int cnt =
        static_cast<int>(chunk_end - base < kTile ? chunk_end - base : kTile);
    for (int j = tid; j < kTile; j += kScoreThreads) {
      const bool valid = j < cnt;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sh[r][j] = valid ? pts[r * n + base + j] : 0.f;
      sh[4][j] = valid ? weights[base + j] : 0.f;
    }
    __syncthreads();
    // This warp's slice of the tile: the tile's points dealt evenly over the
    // warps in contiguous runs, each a multiple of kUnroll (the padding has
    // weight 0).
    const int run = ((cnt + kScoreSlices - 1) / kScoreSlices + kUnroll - 1) /
                    kUnroll * kUnroll;
    const int padded = (cnt + kUnroll - 1) / kUnroll * kUnroll;
    const int j0 = slice * run;
    const int j1 = j0 + run < padded ? j0 + run : padded;
    for (int j = j0; j < j1; j += kUnroll) {
      float g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; u += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&sh[0][j + u]);
        const float4 y = *reinterpret_cast<const float4*>(&sh[1][j + u]);
        const float4 xp = *reinterpret_cast<const float4*>(&sh[2][j + u]);
        const float4 yp = *reinterpret_cast<const float4*>(&sh[3][j + u]);
        const float4 pw = *reinterpret_cast<const float4*>(&sh[4][j + u]);
        g[u] = pair_gain<SCORING>(m, x.x, y.x, xp.x, yp.x, pw.x, t2);
        g[u + 1] = pair_gain<SCORING>(m, x.y, y.y, xp.y, yp.y, pw.y, t2);
        g[u + 2] = pair_gain<SCORING>(m, x.z, y.z, xp.z, yp.z, pw.z, t2);
        g[u + 3] = pair_gain<SCORING>(m, x.w, y.w, xp.w, yp.w, pw.w, t2);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = acc + g[u];
    }
    __syncthreads();
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && active) {
    float sum = red[0][lane];
#pragma unroll
    for (int w = 1; w < kScoreSlices; ++w) sum = sum + red[w][lane];
    partial[(pair * gridDim.y + chunk) * b + i] = sum;
  }
}

// (pairs, chunks, B) -> (pairs, B), chunks added in order.
__global__ void __launch_bounds__(kSolveThreads)
sum_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  long long b, int chunks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSolveThreads + threadIdx.x;
  if (i >= b) return;
  const long long pair = blockIdx.z;
  const float* p = partial + pair * chunks * b + i;
  float sum = p[0];
  for (int c = 1; c < chunks; ++c) sum = sum + p[c * b];
  out[pair * b + i] = sum;
}

// Scores (pairs, B) into out; scratch is (pairs, chunks, B) and is not
// touched when chunks == 1.  A refused launch (a grid axis out of range)
// returns its error and launches nothing more.
template <typename T>
int launch_solve_score(const void* src, const void* tar, const void* pts,
                       const void* weights, float t2, int scoring, void* out,
                       void* scratch, long long pairs, long long b,
                       long long n, long long chunks, long long chunk_points,
                       void* stream) {
  if (pairs < 1 || b < 1 || n < 0 || chunks < 1 ||
      chunks * chunk_points < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((b + kScoreLanes - 1) / kScoreLanes),
                  static_cast<unsigned>(chunks), static_cast<unsigned>(pairs));
  const dim3 block(kScoreLanes, kScoreSlices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* s = static_cast<const T*>(src);
  const T* t = static_cast<const T*>(tar);
  const float* p = static_cast<const float*>(pts);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  float* part = chunks == 1 ? o : static_cast<float*>(scratch);
  switch (scoring) {
    case kInliers:
      aca_solve_score_kernel<T, kInliers>
          <<<grid, block, 0, st>>>(s, t, p, w, t2, part, b, n, chunk_points);
      break;
    case kMsac:
      aca_solve_score_kernel<T, kMsac>
          <<<grid, block, 0, st>>>(s, t, p, w, t2, part, b, n, chunk_points);
      break;
    case kMagsac:
      aca_solve_score_kernel<T, kMagsac>
          <<<grid, block, 0, st>>>(s, t, p, w, t2, part, b, n, chunk_points);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || chunks == 1) return err;
  const dim3 sum_grid(
      static_cast<unsigned>((b + kSolveThreads - 1) / kSolveThreads), 1,
      static_cast<unsigned>(pairs));
  sum_chunks_kernel<<<sum_grid, kSolveThreads, 0, st>>>(
      part, o, b, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SKS_EXPORT_SOLVE(aca_solve, AcaCore<float>, kSolveThreads)

extern "C" {

// src, tar (pairs, 8, B); pts (pairs, 4, N); weights (pairs, N); out
// (pairs, B); scratch (pairs, chunks, B) float32, unused when chunks == 1.
#define SKS_EXPORT_SCORE(suffix, T)                                           \
  int sks_aca_solve_score_##suffix(                                           \
      const void* src, const void* tar, const void* pts, const void* weights, \
      float t2, int scoring, void* out, void* scratch, long long pairs,       \
      long long b, long long n, long long chunks, long long chunk_points,     \
      void* stream) {                                                         \
    return launch_solve_score<T>(src, tar, pts, weights, t2, scoring, out,    \
                                 scratch, pairs, b, n, chunks, chunk_points,  \
                                 stream);                                     \
  }

SKS_EXPORT_SCORE(f32, float)
SKS_EXPORT_SCORE(bf16, __nv_bfloat16)

}  // extern "C"
