// Hand-written Hopper (sm_90a) kernels for the ACA hot path of sks_tpu_torch.
//
// K1  aca_solve      replaces sks_tpu/kernels/aca_pallas.py::aca_solve_soa
//                    (body _solve_kernel): batched division-free ACA.
// K2  aca_solve_score replaces sks_tpu/kernels/aca_pallas.py::aca_solve_score_soa
//                    (body _solve_score_kernel): ACA solve + adjugate +
//                    symmetric-transfer RANSAC scoring against all N points.
//
// Layout: plain component-major SoA.  A batch of B minimal sets is (8, B):
// component k of hypothesis i at ptr[k * B + i]; the output of K1 is (9, B).
// There is no 128-lane padding: every kernel masks the ragged edge itself.
// Storage is float32 or bfloat16; arithmetic is always float32.
//
// Build flags (sks_tpu_torch/kernels/_build.py): -O3 -fmad=false, and no
// --use_fast_math.  -fmad=false makes every product and sum round on its own,
// exactly as the plain PyTorch version (one elementwise op at a time) does, so
// the kernels and their plain versions agree bit for bit.  The scoring relies
// on IEEE division and on NaN < t2 being false, which fast math would break.
//
// Each exported function launches on the given stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as Tensor.to(bfloat16)
}

// sks_tpu_torch/ops/aca.py::aca_core, line by line, in the same order.
// s = (m1x, m1y, n1x, n1y, p1x, p1y, q1x, q1y); t likewise for plane 2.
__device__ __forceinline__ void aca_core(const float* s, const float* t,
                                         float* h) {
  const float m1x = s[0], m1y = s[1], n1x = s[2], n1y = s[3];
  const float p1x = s[4], p1y = s[5], q1x = s[6], q1y = s[7];
  const float m2x = t[0], m2y = t[1], n2x = t[2], n2y = t[3];
  const float p2x = t[4], p2y = t[5], q2x = t[6], q2y = t[7];

  const float e1x = n1x - m1x;
  const float e1y = n1y - m1y;
  const float f1x = p1x - m1x;
  const float f1y = p1y - m1y;
  const float g1x = q1x - m1x;
  const float g1y = q1y - m1y;
  const float f1 = e1x * f1y - e1y * f1x;
  const float alpha = f1y * g1x - f1x * g1y;
  const float beta = e1x * g1y - e1y * g1x;

  const float e2x = n2x - m2x;
  const float e2y = n2y - m2y;
  const float f2x = p2x - m2x;
  const float f2y = p2y - m2y;
  const float g2x = q2x - m2x;
  const float g2y = q2y - m2y;
  const float f2 = e2x * f2y - e2y * f2x;
  const float gamma = f2y * g2x - f2x * g2y;
  const float delta = e2x * g2y - e2y * g2x;

  const float c = beta * (gamma * (f1 - beta) - alpha * (f2 - delta));
  const float d = alpha * (delta * (f1 - alpha) - beta * (f2 - gamma));
  const float e = alpha * beta * (f2 - gamma - delta);
  const float ce = c + e;
  const float de = d + e;

  const float t00 = e2x * ce + m2x * c;
  const float t01 = f2x * de + m2x * d;
  const float t02 = m2x * e;
  const float t10 = e2y * ce + m2y * c;
  const float t11 = f2y * de + m2y * d;
  const float t12 = m2y * e;

  const float a00 = f1y, a01 = -f1x;
  const float a10 = -e1y, a11 = e1x;
  const float a02 = -(a00 * m1x + a01 * m1y);
  const float a12 = -(a10 * m1x + a11 * m1y);

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

// ---------------------------------------------------------------- K1 ------
// One thread per hypothesis: 16 coalesced loads, 97 flops, 9 coalesced
// stores.  Bound by device-memory bytes (100 B per hypothesis in f32, 50 B in
// bf16), so the design is only: full coalescing and enough blocks in flight.
constexpr int kSolveThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
aca_solve_kernel(const T* __restrict__ src, const T* __restrict__ tar,
                 T* __restrict__ out, long long b) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b) return;
  float s[8], t[8], h[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = load_f32(src + k * b + i);
    t[k] = load_f32(tar + k * b + i);
  }
  aca_core(s, t, h);
#pragma unroll
  for (int k = 0; k < 9; ++k) store_f32(out + k * b + i, h[k]);
}

// ---------------------------------------------------------------- K2 ------
// One thread per hypothesis keeps its 9 H entries and 9 adjugate entries in
// registers.  The block walks the N points in tiles staged in shared memory
// (x, y, x', y', weight: 5 floats x kTile = 20 KB); every thread reads the
// same address at each step, which shared memory broadcasts.  The score
// accumulates in a register and one float per hypothesis is written, so no
// reduction across blocks is needed.  Bound by float32 arithmetic: per pair, 2
// IEEE divisions and ~38 flops; the design keeps everything else (hypothesis
// state, point loads) off that path.
constexpr int kScoreThreads = 128;
constexpr int kTile = 1024;

enum Scoring { kInliers = 0, kMsac = 1, kMagsac = 2 };

template <typename T, int SCORING>
__global__ void __launch_bounds__(kScoreThreads)
aca_solve_score_kernel(const T* __restrict__ src, const T* __restrict__ tar,
                       const float* __restrict__ pts,
                       const float* __restrict__ weights, float t2,
                       float* __restrict__ score, long long b, long long n) {
  __shared__ float sh_x[kTile];
  __shared__ float sh_y[kTile];
  __shared__ float sh_xp[kTile];
  __shared__ float sh_yp[kTile];
  __shared__ float sh_w[kTile];

  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Threads beyond B still stage tiles and reach every barrier.
  const bool active = i < b;

  float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    float s[8], t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] = load_f32(src + k * b + i);
      t[k] = load_f32(tar + k * b + i);
    }
    aca_core(s, t, h);
  }
  const float h00 = h[0], h01 = h[1], h02 = h[2];
  const float h10 = h[3], h11 = h[4], h12 = h[5];
  const float h20 = h[6], h21 = h[7], h22 = h[8];

  // Adjugate for the reverse transfer (division-free up-to-scale inverse).
  const float i00 = h11 * h22 - h12 * h21;
  const float i01 = h02 * h21 - h01 * h22;
  const float i02 = h01 * h12 - h02 * h11;
  const float i10 = h12 * h20 - h10 * h22;
  const float i11 = h00 * h22 - h02 * h20;
  const float i12 = h02 * h10 - h00 * h12;
  const float i20 = h10 * h21 - h11 * h20;
  const float i21 = h01 * h20 - h00 * h21;
  const float i22 = h00 * h11 - h01 * h10;

  float acc = 0.f;
  for (long long base = 0; base < n; base += kTile) {
    const int cnt = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      sh_x[j] = pts[base + j];
      sh_y[j] = pts[n + base + j];
      sh_xp[j] = pts[2 * n + base + j];
      sh_yp[j] = pts[3 * n + base + j];
      sh_w[j] = weights[base + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        const float x = sh_x[j], y = sh_y[j];
        const float xp = sh_xp[j], yp = sh_yp[j];
        const float pw = sh_w[j];
        // Forward transfer.
        const float w = h20 * x + h21 * y + h22;
        const float inv_w = 1.0f / w;
        const float dx = (h00 * x + h01 * y + h02) * inv_w - xp;
        const float dy = (h10 * x + h11 * y + h12) * inv_w - yp;
        float r2 = dx * dx + dy * dy;
        // Reverse transfer.
        const float wr = i20 * xp + i21 * yp + i22;
        const float inv_wr = 1.0f / wr;
        const float dxr = (i00 * xp + i01 * yp + i02) * inv_wr - x;
        const float dyr = (i10 * xp + i11 * yp + i12) * inv_wr - y;
        r2 = r2 + dxr * dxr + dyr * dyr;
        const bool finite = (w != 0.f) && (wr != 0.f);
        // Every gain gates on r2 < t2: a NaN residual compares false and
        // scores 0, never propagates.
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
        acc = acc + (finite ? gain : 0.f) * pw;
      }
    }
    __syncthreads();
  }
  if (active) score[i] = acc;
}

template <typename T>
int launch_solve(const void* src, const void* tar, void* out, long long b,
                 void* stream) {
  const long long blocks = (b + kSolveThreads - 1) / kSolveThreads;
  aca_solve_kernel<T><<<static_cast<unsigned>(blocks), kSolveThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const T*>(tar),
      static_cast<T*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_score(const void* src, const void* tar, const void* pts,
                       const void* weights, float t2, int scoring, void* out,
                       long long b, long long n, void* stream) {
  const long long blocks = (b + kScoreThreads - 1) / kScoreThreads;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* s = static_cast<const T*>(src);
  const T* t = static_cast<const T*>(tar);
  const float* p = static_cast<const float*>(pts);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  switch (scoring) {
    case kInliers:
      aca_solve_score_kernel<T, kInliers>
          <<<grid, kScoreThreads, 0, st>>>(s, t, p, w, t2, o, b, n);
      break;
    case kMsac:
      aca_solve_score_kernel<T, kMsac>
          <<<grid, kScoreThreads, 0, st>>>(s, t, p, w, t2, o, b, n);
      break;
    case kMagsac:
      aca_solve_score_kernel<T, kMagsac>
          <<<grid, kScoreThreads, 0, st>>>(s, t, p, w, t2, o, b, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sks_aca_solve_f32(const void* src, const void* tar, void* out, long long b,
                      void* stream) {
  return launch_solve<float>(src, tar, out, b, stream);
}

int sks_aca_solve_bf16(const void* src, const void* tar, void* out,
                       long long b, void* stream) {
  return launch_solve<__nv_bfloat16>(src, tar, out, b, stream);
}

int sks_aca_solve_score_f32(const void* src, const void* tar, const void* pts,
                            const void* weights, float t2, int scoring,
                            void* out, long long b, long long n,
                            void* stream) {
  return launch_solve_score<float>(src, tar, pts, weights, t2, scoring, out, b,
                                   n, stream);
}

int sks_aca_solve_score_bf16(const void* src, const void* tar, const void* pts,
                             const void* weights, float t2, int scoring,
                             void* out, long long b, long long n,
                             void* stream) {
  return launch_solve_score<__nv_bfloat16>(src, tar, pts, weights, t2, scoring,
                                           out, b, n, stream);
}

}  // extern "C"
