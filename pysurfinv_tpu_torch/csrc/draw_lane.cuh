// Per-lane arithmetic of the sampler's random streams, shared by the CUDA
// kernels of draw_lanes.cu (and by any host build of this header).
//
// The counter-based streams of inversion/random.py, one lane at a time:
// the Threefry-2x32 hash (20 rounds) on 32-bit words, fold_in / split of
// a key, random bits, and the candidates of a retry round of
// inversion/mcmc.py (a truncated-normal perturbation, or a uniform reset).
// Each function performs the IEEE operations of the plain torch ops in
// their order, so a lane's bits are those of the plain path on the same
// device:
//   * every product, sum and quotient is one correctly rounded operation
//     (__dmul_rn and friends on the card: never contracted into an FMA);
//   * the uniform's mantissa is (hi << 20) | (lo >> 12) times 2^-52
//     (float64), or (hi ^ lo) >> 9 times 2^-23 (float32);
//   * erf, erfinv and nextafter are the CUDA math library's, which ATen's
//     CUDA unary kernels call; maximum and clamp propagate NaN as ATen's
//     CUDA kernels do.
// On the host, erf and nextafter are the C library's and erfinv is the
// formula of ATen's CPU kernel (calc_erfinv); the plain CPU path may take
// a vectorised erf, and its build may contract erfinv's polynomials, so
// host floats can differ from it in the last bits (tests/test_torch_draws.py).
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define DL_HD __host__ __device__ __forceinline__
#else
#define DL_HD inline
#endif

namespace dl {

struct Key {
  uint32_t k0, k1;
};

DL_HD uint32_t rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// threefry2x32 of counters (x0, x1) under key k (random.py threefry2x32)
DL_HD void threefry(Key k, uint32_t x0, uint32_t x1, uint32_t* y0,
                    uint32_t* y1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// fold_in(key, data): the hash of the counter (0, data); split's key i is
// fold_in(key, i)
DL_HD Key fold_in(Key k, uint32_t data) {
  Key out;
  threefry(k, 0u, data, &out.k0, &out.k1);
  return out;
}

DL_HD Key load_key(const int64_t* keys, int64_t i) {
  return Key{static_cast<uint32_t>(keys[2 * i]),
             static_cast<uint32_t>(keys[2 * i + 1])};
}

DL_HD void store_key(int64_t* keys, int64_t i, Key k) {
  keys[2 * i] = static_cast<int64_t>(k.k0);
  keys[2 * i + 1] = static_cast<int64_t>(k.k1);
}

// ---------------------------------------------------------------------------
// Correctly rounded arithmetic and the math library, per scalar type
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
DL_HD double add(double a, double b) { return __dadd_rn(a, b); }
DL_HD double sub(double a, double b) { return __dsub_rn(a, b); }
DL_HD double mul(double a, double b) { return __dmul_rn(a, b); }
DL_HD double div(double a, double b) { return __ddiv_rn(a, b); }
DL_HD float add(float a, float b) { return __fadd_rn(a, b); }
DL_HD float sub(float a, float b) { return __fsub_rn(a, b); }
DL_HD float mul(float a, float b) { return __fmul_rn(a, b); }
DL_HD float div(float a, float b) { return __fdiv_rn(a, b); }
DL_HD double erfinv_(double x) { return ::erfinv(x); }
DL_HD float erfinv_(float x) { return ::erfinvf(x); }
#else
template <typename T>
inline T add(T a, T b) { return a + b; }
template <typename T>
inline T sub(T a, T b) { return a - b; }
template <typename T>
inline T mul(T a, T b) { return a * b; }
template <typename T>
inline T div(T a, T b) { return a / b; }

// ATen's CPU erfinv (ATen/native/Math.h calc_erfinv): a rational first
// guess, then two Newton steps on the C library's erf
template <typename T>
inline T erfinv_(T y) {
  const T a[4] = {T(0.886226899), T(-1.645349621), T(0.914624893),
                  T(-0.140543331)};
  const T b[4] = {T(-2.118377725), T(1.442710462), T(-0.329097515),
                  T(0.012229801)};
  const T c[4] = {T(-1.970840454), T(-1.624906493), T(3.429567803),
                  T(1.641345311)};
  const T d[2] = {T(3.543889200), T(1.637067800)};
  const T y_abs = fabs(y);
  if (y_abs > T(1)) return T(NAN);
  if (y_abs == T(1)) return copysign(T(INFINITY), y);
  T x, z, num, dem;
  if (y_abs <= T(0.7)) {
    z = y * y;
    num = (((a[3] * z + a[2]) * z + a[1]) * z + a[0]);
    dem = ((((b[3] * z + b[2]) * z + b[1]) * z + b[0]) * z + T(1));
    x = y * num / dem;
  } else {
    z = sqrt(-log((T(1) - y_abs) / T(2)));
    num = ((c[3] * z + c[2]) * z + c[1]) * z + c[0];
    dem = (d[1] * z + d[0]) * z + T(1);
    x = copysign(num, y) / dem;
  }
  const T two_over_sqrt_pi = T(2) * T(0.564189583547756286948079451560772586);
  x = x - (erf(x) - y) / (two_over_sqrt_pi * exp(-x * x));
  x = x - (erf(x) - y) / (two_over_sqrt_pi * exp(-x * x));
  return x;
}
#endif

DL_HD double erf_(double x) { return ::erf(x); }
DL_HD float erf_(float x) { return ::erff(x); }
DL_HD double next_(double x, double to) { return ::nextafter(x, to); }
DL_HD float next_(float x, float to) { return ::nextafterf(x, to); }

// torch.maximum: NaN from either side, else the larger
template <typename T>
DL_HD T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmax(a, b);
}

// torch.clamp with tensor bounds: NaN from the value or a bound
template <typename T>
DL_HD T clamp(T v, T lo, T hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fmin(fmax(v, lo), hi);
}

// ---------------------------------------------------------------------------
// Uniform draws and a retry round's candidates
// ---------------------------------------------------------------------------

// the p-th uniform [0, 1) draw of key k (random.py _unit)
template <typename T>
DL_HD T unit(Key k, uint32_t p);

template <>
DL_HD double unit<double>(Key k, uint32_t p) {
  uint32_t hi, lo;
  threefry(k, 0u, p, &hi, &lo);
  const uint64_t mant = (static_cast<uint64_t>(hi) << 20) | (lo >> 12);
  return mul(static_cast<double>(mant), 0x1p-52);
}

template <>
DL_HD float unit<float>(Key k, uint32_t p) {
  uint32_t hi, lo;
  threefry(k, 0u, p, &hi, &lo);
  return mul(static_cast<float>((hi ^ lo) >> 9), 0x1p-23f);
}

// random.uniform's affine map: maximum(minval, f * (maxval - minval) +
// minval)
template <typename T>
DL_HD T uniform(T f, T minval, T maxval) {
  return maximum(minval, add(mul(f, sub(maxval, minval)), minval));
}

// mcmc.truncated_step of one parameter from its uniform draw f: the
// truncated normal on ((vmin - theta) / step, (vmax - theta) / step)
// (random.truncated_normal), then theta + z * step
template <typename T>
DL_HD T perturb(T f, T theta, T step, T vmin, T vmax) {
  const T sqrt2 = static_cast<T>(1.4142135623730951);
  const T lower = div(sub(vmin, theta), step);
  const T upper = div(sub(vmax, theta), step);
  const T a = erf_(div(lower, sqrt2));
  const T b = erf_(div(upper, sqrt2));
  const T z = mul(sqrt2, erfinv_(uniform(f, a, b)));
  const T zc = clamp(z, next_(lower, static_cast<T>(INFINITY)),
                     next_(upper, -static_cast<T>(INFINITY)));
  return add(theta, mul(zc, step));
}

// mcmc.uniform_reset of one parameter: vmin + u * (vmax - vmin), u the
// standard uniform
template <typename T>
DL_HD T reset(T f, T vmin, T vmax) {
  const T u = uniform(f, static_cast<T>(0), static_cast<T>(1));
  return add(vmin, mul(u, sub(vmax, vmin)));
}

// parameter p of the candidate drawn from subkey k
template <typename T>
DL_HD T candidate(Key k, uint32_t p, bool perturbing, T theta, T step, T vmin,
                  T vmax) {
  const T f = unit<T>(k, p);
  return perturbing ? perturb(f, theta, step, vmin, vmax)
                    : reset(f, vmin, vmax);
}

}  // namespace dl
