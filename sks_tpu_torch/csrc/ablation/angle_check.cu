// The check that lets the Jacobi rotation (../baselines.cuh::Rotation)
// replace the compiler's IEEE sequences by shorter forms, bit for bit (any
// NaN equals any NaN):
// - sqrt_1to2 and rcp_1to2 against sqrtf and 1.0f / x on every float32 of
//   [1, 2] (2^23 + 1 values) and on NaN;
// - DivTiny, DivTiny64 and DivAlways64 against num / den on 2^28 pairs made from a
//   counter: a quarter each of arbitrary bit patterns, a numerator under
//   2^-100 (subnormals included) over an arbitrary positive denominator, the
//   same over a power of two (quotients on the ties of the subnormal grid),
//   and two arbitrary normal numbers of moderate size;
// - Rotation<DivIeee>, Rotation<DivTiny> and Rotation<DivAlways64> against
//   the rotation written as the plain version writes it (AngleIeee) on every
//   triple of a list of special values.
// No solve; bench/ho_ablation.py::angle_check launches it.

#include "ablation.cuh"

namespace {

constexpr unsigned kOneBits = 0x3f800000u;       // 1.0f
constexpr unsigned kUnitCount = (1u << 23) + 2;  // [1, 2] and one NaN
constexpr unsigned kPairCount = 1u << 28;

__device__ __forceinline__ bool same_bits(float a, float b) {
  return (a != a && b != b) || __float_as_uint(a) == __float_as_uint(b);
}

// A 32-bit mix of a counter (the finalizer of MurmurHash3).
__device__ __forceinline__ unsigned mix(unsigned h) {
  h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// counts[0]: arguments where sqrt_1to2 differs from sqrtf; counts[1]: where
// rcp_1to2 differs from 1.0f / x.
__global__ void unit_range_kernel(unsigned long long* counts) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kUnitCount) return;
  const float x = i == kUnitCount - 1 ? __uint_as_float(0x7fc00000u)
                                      : __uint_as_float(kOneBits + i);
  if (!same_bits(sqrt_1to2(x), sqrtf(x))) atomicAdd(&counts[0], 1ull);
  if (!same_bits(rcp_1to2(x), 1.0f / x)) atomicAdd(&counts[1], 1ull);
}

// counts[2]: pairs where DivTiny, DivTiny64 or DivAlways64 differs from
// num / den;
// counts[4]: pairs whose quotient is subnormal and not zero (how many of
// them reach the rounding that the float64 detour has to get right).
__global__ void division_kernel(unsigned long long* counts) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned a = mix(2u * i), b = mix(2u * i + 1u);
  float num, den;
  switch (i >> 26) {
    case 0:  // any two bit patterns
      num = __uint_as_float(a);
      den = __uint_as_float(b);
      break;
    case 1:  // exponent field 0..26: subnormal up to 2^-100; any positive den
      num = __uint_as_float((a & 0x807fffffu) | ((a >> 23) % 27u) << 23);
      den = __uint_as_float(b & 0x7fffffffu);
      break;
    case 2:  // the same numerators over 2^k, k = 0..47
      num = __uint_as_float((a & 0x807fffffu) | ((a >> 23) % 27u) << 23);
      den = __uint_as_float((127u + b % 48u) << 23);
      break;
    default:  // normal numbers of 2^-32 .. 2^31
      num = __uint_as_float((a & 0x807fffffu) | (95u + (a >> 23) % 64u) << 23);
      den = __uint_as_float((b & 0x807fffffu) | (95u + (b >> 23) % 64u) << 23);
  }
  const float q = num / den;
  if (!same_bits(DivTiny::run(num, den), q) ||
      !same_bits(DivTiny64::run(num, den), q) ||
      !same_bits(DivAlways64::run(num, den), q))
    atomicAdd(&counts[2], 1ull);
  if (q != 0.0f && fabsf(q) < kTiny) atomicAdd(&counts[4], 1ull);
}

// counts[3]: triples (app, aqq, apq) of the n values where a shipped
// rotation's cosine or sine differs from AngleIeee's.
__global__ void angle_kernel(const float* values, int n,
                             unsigned long long* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * n * n) return;
  const float app = values[i / (n * n)], aqq = values[i / n % n];
  const float apq = values[i % n];
  float c0, s0, c1, s1, c2, s2, c3, s3;
  AngleIeee::angle(app, aqq, apq, c0, s0);
  Rotation<DivIeee>::angle(app, aqq, apq, c1, s1);
  Rotation<DivTiny>::angle(app, aqq, apq, c2, s2);
  Rotation<DivAlways64>::angle(app, aqq, apq, c3, s3);
  if (!same_bits(c0, c1) || !same_bits(s0, s1) || !same_bits(c0, c2) ||
      !same_bits(s0, s2) || !same_bits(c0, c3) || !same_bits(s0, s3))
    atomicAdd(&counts[3], 1ull);
}

}  // namespace

// counts: 5 zeroed uint64 on the device; values: n float32 on the device.
extern "C" int sks_ho_abl_angle_check(const void* values, int n, void* counts,
                                      void* stream) {
  auto* out = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  unit_range_kernel<<<(kUnitCount + 255) / 256, 256, 0, s>>>(out);
  division_kernel<<<kPairCount / 256, 256, 0, s>>>(out);
  const int triples = n * n * n;
  angle_kernel<<<(triples + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(values), n, out);
  return static_cast<int>(cudaGetLastError());
}
