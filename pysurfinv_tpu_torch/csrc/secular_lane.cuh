// Per-lane secular-function arithmetic shared by the CUDA kernels of
// secular_lanes.cu (and by any host build of this header).
//
// One lane is one (trial phase velocity c, period T, model b) triple.
// Everything here is written once, templated on a scalar type S:
//   S = float  : the value kernels (secular_lanes, secular_lanes_frozen,
//                the Illinois phase of refine_lanes);
//   S = Dual2  : a float with two tangent slots, d/dc and d/dT, for the
//                gradient kernel (secular_lanes_grad) and the Newton phase
//                of refine_lanes.  The JAX package
//                got these tangents from jax.linearize of _ray_prop,
//                _ray_closure, _love_prop and _love_init
//                (pysurfinv_tpu/ops/pallas_secular.py:122-239); here the
//                same per-layer code runs on Dual2.
// The layer material (a, b, rho, d) is always a plain float: the tangent
// in T runs through the wavenumbers only (the fixed-material group
// convention), and the per-layer renormalisation factor is taken from
// the primal values, so it carries no tangent.
//
// Accurate libm functions (expf, sincosf, sqrtf, logf, IEEE division):
// build without --use_fast_math, whose approximations move the sign of F
// near a root.  Each regime computes only its own side (expf for an
// evanescent wavenumber, sincosf for an oscillatory one): the selected
// value is the same expression on the same inputs as the plain
// version's select, so the bits do not change.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define SL_HD __host__ __device__ __forceinline__
#else
#define SL_HD inline
#endif

namespace sl {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kAccur = 1e-8f;  // regime-switch tolerance, surfa.f:191-192

// ---------------------------------------------------------------------------
// Scalar types
// ---------------------------------------------------------------------------

struct Dual2 {
  float v, dc, dt;  // value, d/dc, d/dT
  SL_HD Dual2(float x = 0.f) : v(x), dc(0.f), dt(0.f) {}
  SL_HD Dual2(float x, float c, float t) : v(x), dc(c), dt(t) {}
};

SL_HD float val(float x) { return x; }
SL_HD float val(const Dual2& x) { return x.v; }

SL_HD Dual2 operator-(const Dual2& a) { return Dual2(-a.v, -a.dc, -a.dt); }
SL_HD Dual2 operator+(const Dual2& a, const Dual2& b) {
  return Dual2(a.v + b.v, a.dc + b.dc, a.dt + b.dt);
}
SL_HD Dual2 operator-(const Dual2& a, const Dual2& b) {
  return Dual2(a.v - b.v, a.dc - b.dc, a.dt - b.dt);
}
SL_HD Dual2 operator*(const Dual2& a, const Dual2& b) {
  return Dual2(a.v * b.v, a.dc * b.v + a.v * b.dc, a.dt * b.v + a.v * b.dt);
}
SL_HD Dual2 operator/(const Dual2& a, const Dual2& b) {
  const float q = a.v / b.v;
  return Dual2(q, (a.dc - q * b.dc) / b.v, (a.dt - q * b.dt) / b.v);
}
SL_HD Dual2 operator+(const Dual2& a, float b) {
  return Dual2(a.v + b, a.dc, a.dt);
}
SL_HD Dual2 operator+(float a, const Dual2& b) { return b + a; }
SL_HD Dual2 operator-(const Dual2& a, float b) {
  return Dual2(a.v - b, a.dc, a.dt);
}
SL_HD Dual2 operator-(float a, const Dual2& b) {
  return Dual2(a - b.v, -b.dc, -b.dt);
}
SL_HD Dual2 operator*(const Dual2& a, float b) {
  return Dual2(a.v * b, a.dc * b, a.dt * b);
}
SL_HD Dual2 operator*(float a, const Dual2& b) { return b * a; }
SL_HD Dual2 operator/(const Dual2& a, float b) {
  return Dual2(a.v / b, a.dc / b, a.dt / b);
}
SL_HD Dual2 operator/(float a, const Dual2& b) {
  const float q = a / b.v;
  return Dual2(q, -q * b.dc / b.v, -q * b.dt / b.v);
}

// The plain versions evaluate ``scalar / x`` as PyTorch does,
// reciprocal(x) * scalar, and take PyTorch's forward-mode derivative
// formulas (reciprocal: -t * r * r, sqrt: t / (2 r)); the kernels use
// the same operations so that both round alike.
SL_HD float rcp(float x) { return 1.f / x; }
SL_HD Dual2 rcp(const Dual2& x) {
  const float r = 1.f / x.v, rr = r * r;
  return Dual2(r, -x.dc * rr, -x.dt * rr);
}

SL_HD float s_exp(float x) { return expf(x); }
SL_HD float s_sqrt(float x) { return sqrtf(x); }
SL_HD float s_abs(float x) { return fabsf(x); }
SL_HD void s_sincos(float x, float* s, float* c) { sincosf(x, s, c); }

SL_HD Dual2 s_exp(const Dual2& x) {
  const float e = expf(x.v);
  return Dual2(e, e * x.dc, e * x.dt);
}
SL_HD Dual2 s_sqrt(const Dual2& x) {
  const float r = sqrtf(x.v), r2 = 2.f * r;
  return Dual2(r, x.dc / r2, x.dt / r2);
}
SL_HD Dual2 s_abs(const Dual2& x) { return x.v >= 0.f ? x : -x; }
SL_HD void s_sincos(const Dual2& x, Dual2* s, Dual2* c) {
  float sn, cs;
  sincosf(x.v, &sn, &cs);
  *s = Dual2(sn, cs * x.dc, cs * x.dt);
  *c = Dual2(cs, -sn * x.dc, -sn * x.dt);
}

// ---------------------------------------------------------------------------
// One layer's material, attenuated and flattened (pallas_secular.py:269-287)
// ---------------------------------------------------------------------------

struct Model {
  const float *vp, *vs, *rho, *qsi, *hf, *vf, *rf;  // (L, B) row-major
  int B, L;
};

struct Layer {
  float a, b, rho, d;
};

SL_HD Layer layer_at(const Model& m, int l, int col, float lnt, bool atten) {
  const int i = l * m.B + col;
  const float vp = m.vp[i], vs = m.vs[i], vf = m.vf[i];
  Layer y;
  if (atten) {
    const float qsq = m.qsi[i] * lnt;
    const float vp_s = fabsf(vp) > 0.f ? vp : 1.f;
    const float r = vs / vp_s;
    const float qpq = qsq * 1.33333333f * (r * r);
    y.a = vp * (1.f + qpq) * vf;
    y.b = vs * (1.f + qsq) * vf;
  } else {
    y.a = vp * vf;
    y.b = vs * vf;
  }
  y.rho = m.rho[i] * m.rf[i];
  y.d = m.hf[i];
  return y;
}

// ---------------------------------------------------------------------------
// Per-layer updates (pallas_secular.py:86-239)
// ---------------------------------------------------------------------------

// (r*sin, sin/r, cos) for one signed wavenumber regime: sinh/cosh for an
// evanescent r, sin/cos for an oscillatory one, the limit otherwise.
template <class S>
SL_HD void pq(const S& r, const S& wd, S* rsin, S* sinr, S* cosx) {
  const S pm = wd * r;
  if (val(r) < -kAccur) {
    const S e = s_exp(pm);
    const S einv = rcp(e);
    const S sh = 0.5f * (e - einv);
    *rsin = (-r) * sh;
    *sinr = sh / r;
    *cosx = 0.5f * (e + einv);
  } else if (val(r) > kAccur) {
    S sn, cs;
    s_sincos(pm, &sn, &cs);
    *rsin = r * sn;
    *sinr = sn / r;
    *cosx = cs;
  } else {
    *rsin = S(0.f);
    *sinr = wd;
    *cosx = S(1.f);
  }
}

// Signed ra, rb and g, g1 (surfa.f:211-258); liquid-safe.
template <class S>
SL_HD void wavenumbers(const S& c, float a, float b, S* ra, S* rb, S* g,
                       S* g1, bool* liquid) {
  const S csq = c * c;
  const S arga = 1.f - csq / (a * a);
  const S ra_abs = s_sqrt(s_abs(arga));
  *ra = val(arga) > 0.f ? -ra_abs : ra_abs;
  *liquid = fabsf(b) <= kAccur;
  const float b_safe = *liquid ? 1.f : b;
  const S argb = 1.f - csq / (b_safe * b_safe);
  const S rb_abs = s_sqrt(s_abs(argb));
  *rb = val(argb) > 0.f ? -rb_abs : rb_abs;
  *g = (2.f * b_safe * b_safe) / csq;
  *g1 = *g - 1.f;
}

// The Dunkin matrix of one layer applied to the 5-vector (surfa.f:259-335),
// from the layer's (r*sin, sin/r, cos) pairs.  Each entry is formed where
// the rows that use it need it and added to them at once, every row
// summed in the plain version's order, so that few entries are live at a
// time (the Dual2 body's registers).  kLiquid: the liquid-surface-layer
// override (surfa.f:216-251), e11 = cosp, e21 = rhoc * sinpr and every
// other entry times 0, the TPU kernel's multiplicative mask (liquid
// layers are shallow: entries are finite); a solid layer's factor of 1
// changes no bits and is left out.
template <bool kLiquid, class S>
SL_HD void dunkin_update(S bv[5], const S& rhoc, const S& g, const S& g1,
                         const S& rsinp, const S& sinpr, const S& cosp,
                         const S& rsinq, const S& sinqr, const S& cosq) {
  auto mask = [](const S& e) {
    if constexpr (kLiquid) {
      return e * 0.f;
    } else {
      return e;
    }
  };
  const S e42 = mask(rsinp * sinqr);
  const S e24 = mask(sinpr * rsinq);
  const S rr = rsinp * rsinq;
  const S ss = sinpr * sinqr;
  const S rs1 = rsinp * cosq;
  const S rs2 = sinqr * cosp;
  const S rs3 = sinpr * cosq;
  const S rs4 = rsinq * cosp;
  const S cc = cosp * cosq;
  const S b1 = bv[0], b2 = bv[1], b3 = bv[2], b4 = bv[3], b5 = bv[4];
  const S gs = g * g;
  const S g1s = g1 * g1;
  const S ccm = 1.f - cc;
  const S e51 = mask((rhoc * rhoc) *
                     (2.f * gs * g1s * ccm + gs * gs * rr + g1s * g1s * ss));
  S n4 = e51 * b1;
  const S e41 = mask(-rhoc * (g1s * rs2 + gs * rs1));
  n4 = n4 - e41 * b2;
  S n3 = e41 * b1;
  const S gm = 2.f * g - 1.f;
  const S gg1 = g * g1;
  const S e31 = mask(rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr));
  n4 = n4 + 2.f * e31 * b3;
  S n2 = e31 * b1;
  const S e21 = kLiquid ? rhoc * sinpr : rhoc * (g1s * rs3 + gs * rs4);
  n4 = n4 - e21 * b4;
  S n1 = e21 * b1;
  const S suu = gs * rr + g1s * ss;
  const S e11 = kLiquid ? cosp : (2.f * gs - gm) * cc - suu - 2.f * gg1;
  bv[4] = n4 + e11 * b5;
  S n0 = e11 * b1;
  n3 = n3 + e42 * b2;
  const S e32 = mask(g1 * rs2 + g * rs1);
  n3 = n3 - 2.f * e32 * b3;
  n2 = n2 + e32 * b2;
  const S e22 = mask(cc);
  n3 = n3 + e22 * b4;
  n1 = n1 + e22 * b2;
  const S inv_rhoc = rcp(rhoc);
  const S e12 = mask(-(rs1 + rs2) * inv_rhoc);
  bv[3] = n3 - e12 * b5;
  n0 = n0 + e12 * b2;
  const S e33 = mask(1.f + 2.f * (2.f * gg1 * ccm + suu));
  n2 = n2 + e33 * b3;
  const S e23 = mask(2.f * (g * rs4 + g1 * rs3));
  n2 = n2 - 0.5f * e23 * b4;
  n1 = n1 + e23 * b3;
  const S e13 = mask(-2.f * (gm * ccm + g1 * ss + g * rr) * inv_rhoc);
  bv[2] = n2 + 0.5f * e13 * b5;
  n0 = n0 + e13 * b3;
  n1 = n1 + e24 * b4;
  const S e14 = mask((rs3 + rs4) * inv_rhoc);
  bv[1] = n1 - e14 * b5;
  n0 = n0 + e14 * b4;
  const S e15 = mask((2.f * ccm + rr + ss) * inv_rhoc * inv_rhoc);
  bv[0] = n0 + e15 * b5;
}

// Unscaled Dunkin 5-vector update through one layer (surfa.f:259-335).
template <class S>
SL_HD void ray_prop(const S& c, const S& t, S bv[5], const Layer& y) {
  const S csq = c * c;
  const S wvno = rcp(c * t) * kTwoPi;
  S ra, rb, g, g1;
  bool liquid;
  wavenumbers(c, y.a, y.b, &ra, &rb, &g, &g1, &liquid);
  const S wd = wvno * y.d;
  S rsinp, sinpr, cosp, rsinq, sinqr, cosq;
  pq(ra, wd, &rsinp, &sinpr, &cosp);
  pq(rb, wd, &rsinq, &sinqr, &cosq);
  const S rhoc = y.rho * csq;
  if (liquid) {
    dunkin_update<true>(bv, rhoc, g, g1, rsinp, sinpr, cosp, rsinq, sinqr,
                        cosq);
  } else {
    dunkin_update<false>(bv, rhoc, g, g1, rsinp, sinpr, cosp, rsinq, sinqr,
                         cosq);
  }
}

// Halfspace closure -> secular value (surfa.f:340-354).
template <class S>
SL_HD S ray_closure(const S& c, const S bv[5], float a_h, float b_h,
                    float rho_h) {
  const S csq = c * c;
  S ra_h, rb_h, g_h, g1_h;
  bool liquid;
  wavenumbers(c, a_h, b_h, &ra_h, &rb_h, &g_h, &g1_h, &liquid);
  if (!(fabsf(val(ra_h)) > kAccur)) ra_h = S(-kAccur);
  const float den = rho_h * a_h * a_h;
  const S gra = g_h * ra_h;
  const S rba = rb_h - rcp(ra_h);
  const float aa = a_h * a_h;
  const S A11 = -2.f * rb_h * (b_h * b_h) / aa + csq * (g1_h * g1_h) / (aa * gra);
  const S A12 = rcp(g_h * den) * -1.f;
  const S A13 = -rb_h / den + g1_h / (den * gra);
  const S A14 = rb_h / (den * gra);
  const float ra2 = (rho_h * a_h) * (rho_h * a_h);
  const S A15 = rba / (ra2 * csq * g_h);
  return -(A11 * bv[0] + A12 * bv[1] + 2.f * A13 * bv[2] + A14 * bv[3] +
           A15 * bv[4]);
}

// Unscaled Haskell (u, stress) update through one layer (surfa.f:156-172);
// water layers are the caller's mask.
template <class S>
SL_HD void love_prop(const S& c, const S& t, S* ut, S* tt, const Layer& y) {
  const S wvno = rcp(c * t) * kTwoPi;
  const bool water = fabsf(y.b) <= kAccur;
  const float b_safe = water ? 1.f : y.b;
  const S cb = c / b_safe;
  const S rb = s_sqrt(s_abs(cb * cb - 1.f));
  const float hmu = y.rho * b_safe * b_safe;
  const S q = (-wvno) * y.d * rb;
  const bool big = val(rb) >= 1e-20f;
  S yv, z, cosq;
  if (val(c) > b_safe && big) {  // oscillatory
    S sn;
    s_sincos(q, &sn, &cosq);
    yv = sn / rb;
    z = rb * sn;
  } else if (val(c) < b_safe && big) {  // evanescent, q <= 0
    const S eq = s_exp(q);
    const S shq = 0.5f * (eq - rcp(eq));
    yv = shq / rb;
    z = (-rb) * shq;
    cosq = 0.5f * (eq + rcp(eq));
  } else {
    yv = (-wvno) * y.d;
    z = S(0.f);
    cosq = S(1.f);
  }
  const S u0 = *ut, t0 = *tt;
  *ut = cosq * u0 - yv * t0 / hmu;
  *tt = hmu * z * u0 + cosq * t0;
}

// Halfspace initial (u, stress) for Love (surfa.f:143-148).
template <class S>
SL_HD void love_init(const S& c, float b_h, float rho_h, S* ut, S* tt) {
  const float b_hs = fabsf(b_h) > kAccur ? b_h : 1.f;
  const S cb = c / b_hs;
  const S rb_h = s_sqrt(s_abs(cb * cb - 1.f));
  *ut = S(1.f);
  *tt = rho_h * b_hs * b_hs * rb_h;
}

// Divide n values by their max-abs (primal values only: the factor
// carries no tangent).  Returns true when the factor is 1, i.e. the
// values came back unchanged.
template <class S>
SL_HD bool renorm(S* x, int n) {
  float scale = 0.f;
  for (int i = 0; i < n; ++i) scale = fmaxf(scale, fabsf(val(x[i])));
  const float inv = 1.f / (scale > 0.f ? scale : 1.f);
  for (int i = 0; i < n; ++i) x[i] = x[i] * inv;
  return inv == 1.f;
}

// ``count`` renormalisations of values no layer updates in between (the
// masked layers, which on the TPU only renormalise).  Once one leaves
// the values unchanged, so does every later one: stop there.
template <class S>
SL_HD void renorm_steps(S* x, int n, int count) {
  for (int i = 0; i < count; ++i) {
    if (renorm(x, n)) break;
  }
}

// ---------------------------------------------------------------------------
// Whole-lane evaluations
// ---------------------------------------------------------------------------

struct Truncation {
  Layer hs;  // closure halfspace material
  int mm;    // 1-based closure layer
};

// log(t_base / tm) / pi as the plain version rounds it: PyTorch computes
// scalar / x as reciprocal(x) * scalar and, on the GPU, x / scalar as
// x * (1 / scalar).
SL_HD float lnt_of(float t_base, float tm, bool atten) {
  return atten ? logf(rcp(tm) * t_base) * (1.f / kPi) : 0.f;
}

// The inline 4-wavelength truncation walk of _rayleigh_kernel /
// _love_kernel (pallas_secular.py:296-311, 386-395).  ``mmf`` > 0 pins
// the closure at layer mmf-1.  Returns the closure; lanes that never
// close in 0..L-2 take the padded row L-1 and mm = nlay.  For Rayleigh
// the 5-vector is propagated through every layer above the closure.  A
// lane leaves the walk once closed; the TPU kernel's remaining, masked
// iterations only renormalise the vector, and so does this code (F near
// the f32 noise floor moves with every rounding of that vector).
template <bool kRayleigh>
SL_HD Truncation walk(const Model& m, int col, float c, float t, float lnt,
                      bool atten, int mmf, int nlay, float fact, float bv[5]) {
  const bool frozen = mmf > 0;
  const float dmax = fact * c * t;
  float csum = 0.f;
  bool pending = false;
  int l = 0;
  Truncation tr{Layer{}, nlay};
  bool closed = false;
  for (; l < m.L - 1; ++l) {
    const Layer y = layer_at(m, l, col, lnt, atten);
    const bool cond = c < y.b && l < nlay;
    csum = csum + (cond ? y.d : 0.f);
    const bool exceed = cond && csum > dmax;
    const bool close_dyn = pending || exceed || l == nlay - 1;
    const bool close_sel = frozen ? (l == mmf - 1) : close_dyn;
    if (l >= 1 && close_sel) {
      tr = Truncation{y, l + 1};
      closed = true;
      break;
    }
    pending = pending || (exceed && l == 0);
    if constexpr (kRayleigh) {
      ray_prop(c, t, bv, y);
      renorm(bv, 5);
    }
  }
  if constexpr (kRayleigh) renorm_steps(bv, 5, m.L - 1 - l);
  if (!closed) tr.hs = layer_at(m, m.L - 1, col, lnt, atten);
  return tr;
}

// Frozen closure row mmf-1, or the padded row L-1 when mmf-1 lies outside
// 0..L-2 (_capture_halfspace, pallas_secular.py:579-593).
SL_HD Layer frozen_halfspace(const Model& m, int col, float lnt, bool atten,
                             int mmf) {
  const int l = (mmf - 1 >= 0 && mmf - 1 <= m.L - 2) ? mmf - 1 : m.L - 1;
  return layer_at(m, l, col, lnt, atten);
}

// Rayleigh at frozen truncation: layers l < mmf-1 (_ray_secular_tile and
// _ray_secular_grad_tile, pallas_secular.py:596-655), closing with the
// halfspace ``hs_of()``; the masked layers below renormalise too, as on
// the TPU.
template <class S, class Hs>
SL_HD S rayleigh_frozen(const Model& m, int col, const S& c, const S& t,
                        float lnt, bool atten, int mmf, const Hs& hs_of) {
  S bv[5] = {S(1.f), S(0.f), S(0.f), S(0.f), S(0.f)};
  const int n = mmf - 1 < m.L - 1 ? mmf - 1 : m.L - 1;
  int l = 0;
  for (; l < n; ++l) {
    ray_prop(c, t, bv, layer_at(m, l, col, lnt, atten));
    renorm(bv, 5);
  }
  renorm_steps(bv, 5, m.L - 1 - l);
  const Layer hs = hs_of();
  return ray_closure(c, bv, hs.a, hs.b, hs.rho);
}

// Love upward pass from the halfspace through layers l <= mm-2 that are
// not water (_love_kernel pass 2, _love_secular_tile,
// _love_secular_grad_tile).  The halfspace vector and the masked layers
// below the closure only renormalise, as on the TPU.  Returns F = -stress.
template <class S>
SL_HD S love_upward(const Model& m, int col, const S& c, const S& t,
                    float lnt, bool atten, int mm, const Layer& hs) {
  S x[2];
  love_init(c, hs.b, hs.rho, &x[0], &x[1]);
  int top = mm - 2 < m.L - 2 ? mm - 2 : m.L - 2;  // first applied layer
  top = top < -1 ? -1 : top;
  renorm_steps(x, 2, 1 + (m.L - 2 - top));
  for (int l = top; l >= 0; --l) {
    const Layer y = layer_at(m, l, col, lnt, atten);
    if (!(fabsf(y.b) <= kAccur)) love_prop(c, t, &x[0], &x[1], y);
    renorm(x, 2);
  }
  return -x[1];
}

// ---------------------------------------------------------------------------
// The kernels' per-lane bodies
// ---------------------------------------------------------------------------

// secular_lanes: F with the dynamic truncation walk (or a pinned closure
// for mmf > 0); ``t`` drives the wavenumbers, ``tm`` the attenuation.
template <bool kRayleigh>
SL_HD void lane_dynamic(const Model& m, int col, float c, float t, float tm,
                        int mmf, int nlay, float fact, float t_base,
                        bool atten, float* F, float* bhs, int* mm) {
  const float lnt = lnt_of(t_base, tm, atten);
  float bv[5] = {1.f, 0.f, 0.f, 0.f, 0.f};
  const Truncation tr =
      walk<kRayleigh>(m, col, c, t, lnt, atten, mmf, nlay, fact, bv);
  if constexpr (kRayleigh) {
    *F = ray_closure(c, bv, tr.hs.a, tr.hs.b, tr.hs.rho);
  } else {
    *F = love_upward(m, col, c, t, lnt, atten, tr.mm, tr.hs);
  }
  *bhs = tr.hs.b;
  *mm = tr.mm;
}

// F at the pinned closure layer mmf (>= 2) with the halfspace ``hs_of()``,
// read where the closure needs it (Rayleigh: after the propagation, so
// that it holds no registers through it).
template <bool kRayleigh, class S, class Hs>
SL_HD S frozen_at(const Model& m, int col, const S& c, const S& t, float lnt,
                  bool atten, int mmf, const Hs& hs_of) {
  if constexpr (kRayleigh) {
    return rayleigh_frozen(m, col, c, t, lnt, atten, mmf, hs_of);
  } else {
    return love_upward(m, col, c, t, lnt, atten, mmf, hs_of());
  }
}

// secular_lanes_frozen: F at the pinned closure layer mmf (>= 2),
// material at the lane's t.
template <bool kRayleigh>
SL_HD float lane_frozen(const Model& m, int col, float c, float t, int mmf,
                        float t_base, bool atten) {
  const float lnt = lnt_of(t_base, t, atten);
  return frozen_at<kRayleigh>(m, col, c, t, lnt, atten, mmf, [&] {
    return frozen_halfspace(m, col, lnt, atten, mmf);
  });
}

// (F, dF/dc, dF/dT) at c.
template <bool kRayleigh, class Hs>
SL_HD Dual2 grad_at(const Model& m, int col, float c, float t, float lnt,
                    bool atten, int mmf, const Hs& hs_of) {
  return frozen_at<kRayleigh>(m, col, Dual2(c, 1.f, 0.f), Dual2(t, 0.f, 1.f),
                              lnt, atten, mmf, hs_of);
}

// secular_lanes_grad.
template <bool kRayleigh>
SL_HD void lane_grad(const Model& m, int col, float c, float t, int mmf,
                     float t_base, bool atten, float* F, float* Fc,
                     float* Ft) {
  const float lnt = lnt_of(t_base, t, atten);
  const Dual2 f = grad_at<kRayleigh>(m, col, c, t, lnt, atten, mmf, [&] {
    return frozen_halfspace(m, col, lnt, atten, mmf);
  });
  *F = f.v;
  *Fc = f.dc;
  *Ft = f.dt;
}

// ---------------------------------------------------------------------------
// refine_lanes: bracket -> root -> group velocity per lane, in two phases
// (_refine_kernel, pallas_secular.py:906-1024)
// ---------------------------------------------------------------------------

SL_HD float sgn(float x) { return x >= 0.f ? 1.f : -1.f; }

// NaN-propagating max/min: torch.maximum/minimum (and jnp.clip) return
// NaN when either side is NaN, where fmaxf/fminf would drop it.
SL_HD float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
SL_HD float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// What the Illinois phase hands to the Newton phase: the live bracket,
// the clipped estimate and sgn(F(lo)), which are all the Newton steps
// read of the Illinois state (16 bytes a lane).
struct RefineState {
  float lo, hi, x, slo;
};

// The state each phase carries from one evaluation to the next, kept in
// memory the caller gives (the kernels: volatile shared memory, which the
// compiler neither caches in registers nor forwards) and read back only
// after the evaluation, so that it holds no registers through the
// evaluation's layer loop.  The closure layer is read back before each
// evaluation: what follows from it alone (the halfspace and its part of
// the closure) is then computed inside the evaluation, as in the frozen
// and gradient kernels, and not hoisted out of the phase's loop to hold
// registers through every evaluation.
struct IllinoisKeep {
  float lo, hi, flo, fhi, side;
  int mmf;
};
struct NewtonKeep {
  float lo, hi, slo, u;
  int mmf;
};

// The Illinois phase: ``n_ill + 2`` iterations on [lo, hi] (the first two
// evaluate the ends), then the clipped regula-falsi estimate, with one
// evaluation site.  Every state update is the plain version's select, in
// its order (refine_lanes_plain in ops/secular_lanes.py).  The halfspace
// is read where each evaluation's closure needs it, as in
// secular_lanes_frozen.
template <bool kRayleigh, class Keep>
SL_HD RefineState lane_refine_illinois(const Model& m, int col, float lo,
                                       float hi, float t, int mmf,
                                       float t_base, bool atten, int n_ill,
                                       Keep* keep) {
  const float lnt = lnt_of(t_base, t, atten);
  keep->mmf = mmf;
  keep->lo = lo;
  keep->hi = hi;
  keep->flo = 0.f;
  keep->fhi = 0.f;
  keep->side = 0.f;
  for (int j = 0; j < n_ill + 2; ++j) {
    float x;
    if (j < 2) {
      x = j == 0 ? keep->lo : keep->hi;
    } else {
      const float lo = keep->lo, hi = keep->hi;
      const float flo = keep->flo, fhi = keep->fhi;
      float denom = fhi - flo;
      denom = fabsf(denom) > 0.f ? denom : 1.f;
      const float x_int = (lo * fhi - hi * flo) / denom;
      const bool bad = !(x_int > lo && x_int < hi);
      x = bad ? 0.5f * (lo + hi) : x_int;
    }
    const int mm = keep->mmf;
    const float fx = frozen_at<kRayleigh>(m, col, x, t, lnt, atten, mm, [&] {
      return frozen_halfspace(m, col, lnt, atten, mm);
    });
    if (j == 0) {
      keep->flo = fx;
      continue;
    }
    if (j == 1) {
      keep->fhi = fx;
      continue;
    }
    const float flo = keep->flo, fhi = keep->fhi, side = keep->side;
    const bool same_lo = sgn(fx) == sgn(flo);
    float nflo = same_lo ? fx : flo;
    float nfhi = same_lo ? fhi : fx;
    if (same_lo && side == -1.f) nfhi = 0.5f * nfhi;
    if (!same_lo && side == 1.f) nflo = 0.5f * nflo;
    keep->side = same_lo ? -1.f : 1.f;
    if (same_lo) {
      keep->lo = x;
    } else {
      keep->hi = x;
    }
    keep->flo = nflo;
    keep->fhi = nfhi;
  }
  const float lo_f = keep->lo, hi_f = keep->hi;
  const float flo = keep->flo, fhi = keep->fhi;
  float denom = fhi - flo;
  denom = fabsf(denom) > 0.f ? denom : 1.f;
  const float x =
      nan_min(nan_max((lo_f * fhi - hi_f * flo) / denom, lo_f), hi_f);
  return RefineState{lo_f, hi_f, x, sgn(flo)};
}

// The Newton phase: ``n_newton`` bracket-clamped Newton steps from the
// Illinois estimate, the last of which only evaluates; u = c / (1 - (T/c)
// F_T/F_c) from that evaluation's tangents (0 without ``compute_group``
// or Newton steps).
template <bool kRayleigh, class Keep>
SL_HD void lane_refine_newton(const Model& m, int col, RefineState s,
                              float t, int mmf, float t_base, bool atten,
                              int n_newton, bool compute_group, Keep* keep,
                              float* root, float* u) {
  const float lnt = lnt_of(t_base, t, atten);
  keep->mmf = mmf;
  keep->lo = s.lo;
  keep->hi = s.hi;
  keep->slo = s.slo;
  keep->u = 0.f;
  float x = s.x;
  for (int j = 0; j < n_newton; ++j) {
    const int mm = keep->mmf;
    const Dual2 g = grad_at<kRayleigh>(m, col, x, t, lnt, atten, mm, [&] {
      return frozen_halfspace(m, col, lnt, atten, mm);
    });
    const bool same_lo = sgn(g.v) == keep->slo;
    const float lo = same_lo ? x : keep->lo;
    const float hi = same_lo ? keep->hi : x;
    keep->lo = lo;
    keep->hi = hi;
    const float fc_safe = fabsf(g.dc) > 0.f ? g.dc : 1.f;
    float xn = x - g.v / fc_safe;
    const bool bad = !(xn > lo && xn < hi);
    xn = bad ? 0.5f * (lo + hi) : xn;
    if (compute_group) keep->u = x / (1.f - (t / x) * (g.dt / fc_safe));
    x = j < n_newton - 1 ? xn : x;
  }
  *root = x;
  *u = keep->u;
}

// The whole refinement of one lane: the two phases in a row (the host
// build's reference for the two-kernel launch).
template <bool kRayleigh>
SL_HD void lane_refine(const Model& m, int col, float lo, float hi, float t,
                       int mmf, float t_base, bool atten, int n_ill,
                       int n_newton, bool compute_group, float* root,
                       float* u) {
  IllinoisKeep ik;
  NewtonKeep nk;
  lane_refine_newton<kRayleigh>(
      m, col,
      lane_refine_illinois<kRayleigh>(m, col, lo, hi, t, mmf, t_base, atten,
                                      n_ill, &ik),
      t, mmf, t_base, atten, n_newton, compute_group, &nk, root, u);
}

}  // namespace sl
