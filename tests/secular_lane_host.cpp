// Host build of the CUDA kernels' per-lane arithmetic
// (pysurfinv_tpu_torch/csrc/secular_lane.cuh), for tests/test_torch_kernels.py:
// each entry point runs one kernel's lane body over every (k, b) lane on
// the CPU, with the CUDA launch functions' signatures minus the stream.
// The port itself never uses this library.

#include "secular_lane.cuh"

namespace {

sl::Model model(const float* vp, const float* vs, const float* rho,
                const float* qsi, const float* hf, const float* vf,
                const float* rf, int B, int L) {
  return sl::Model{vp, vs, rho, qsi, hf, vf, rf, B, L};
}

}  // namespace

extern "C" {

void secular_lanes_host(const float* c, const float* t, const float* tm,
                        const int* mmf, const float* vp, const float* vs,
                        const float* rho, const float* qsi, const float* hf,
                        const float* vf, const float* rf, const int* nlay,
                        float* F, float* bhs, int* mm, int K, int B, int L,
                        int rayleigh, float fact, float t_base, int atten) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int k = 0; k < K; ++k) {
    for (int b = 0; b < B; ++b) {
      const int i = k * B + b;
      if (rayleigh) {
        sl::lane_dynamic<true>(m, b, c[i], t[i], tm[i], mmf[i], nlay[b], fact,
                               t_base, atten != 0, &F[i], &bhs[i], &mm[i]);
      } else {
        sl::lane_dynamic<false>(m, b, c[i], t[i], tm[i], mmf[i], nlay[b],
                                fact, t_base, atten != 0, &F[i], &bhs[i],
                                &mm[i]);
      }
    }
  }
}

void secular_lanes_frozen_host(const float* c, const float* t, const int* mmf,
                               const float* vp, const float* vs,
                               const float* rho, const float* qsi,
                               const float* hf, const float* vf,
                               const float* rf, float* F, int K, int B, int L,
                               int rayleigh, float t_base, int atten) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int i = 0; i < K * B; ++i) {
    const int b = i % B;
    F[i] = rayleigh ? sl::lane_frozen<true>(m, b, c[i], t[i], mmf[i], t_base,
                                            atten != 0)
                    : sl::lane_frozen<false>(m, b, c[i], t[i], mmf[i],
                                             t_base, atten != 0);
  }
}

void secular_lanes_grad_host(const float* c, const float* t, const int* mmf,
                             const float* vp, const float* vs,
                             const float* rho, const float* qsi,
                             const float* hf, const float* vf, const float* rf,
                             float* F, float* Fc, float* Ft, int K, int B,
                             int L, int rayleigh, float t_base, int atten) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int i = 0; i < K * B; ++i) {
    const int b = i % B;
    if (rayleigh) {
      sl::lane_grad<true>(m, b, c[i], t[i], mmf[i], t_base, atten != 0, &F[i],
                          &Fc[i], &Ft[i]);
    } else {
      sl::lane_grad<false>(m, b, c[i], t[i], mmf[i], t_base, atten != 0,
                           &F[i], &Fc[i], &Ft[i]);
    }
  }
}

void refine_lanes_host(const float* lo, const float* hi, const float* t,
                       const int* mmf, const float* vp, const float* vs,
                       const float* rho, const float* qsi, const float* hf,
                       const float* vf, const float* rf, float* root, float* u,
                       int K, int B, int L, int rayleigh, float t_base,
                       int atten, int n_ill, int n_newton, int compute_group) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int i = 0; i < K * B; ++i) {
    const int b = i % B;
    if (rayleigh) {
      sl::lane_refine<true>(m, b, lo[i], hi[i], t[i], mmf[i], t_base,
                            atten != 0, n_ill, n_newton, compute_group != 0,
                            &root[i], &u[i]);
    } else {
      sl::lane_refine<false>(m, b, lo[i], hi[i], t[i], mmf[i], t_base,
                             atten != 0, n_ill, n_newton, compute_group != 0,
                             &root[i], &u[i]);
    }
  }
}

// The two phases of refine_lanes' launch, the hand-over going through
// memory as on the card: ``state`` is (K, B, 4) float (lo, hi, x, slo).
void refine_illinois_host(const float* lo, const float* hi, const float* t,
                          const int* mmf, const float* vp, const float* vs,
                          const float* rho, const float* qsi, const float* hf,
                          const float* vf, const float* rf, float* state,
                          int K, int B, int L, int rayleigh, float t_base,
                          int atten, int n_ill) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int i = 0; i < K * B; ++i) {
    const int b = i % B;
    sl::IllinoisKeep keep;
    const sl::RefineState s =
        rayleigh ? sl::lane_refine_illinois<true>(m, b, lo[i], hi[i], t[i],
                                                  mmf[i], t_base, atten != 0,
                                                  n_ill, &keep)
                 : sl::lane_refine_illinois<false>(m, b, lo[i], hi[i], t[i],
                                                   mmf[i], t_base, atten != 0,
                                                   n_ill, &keep);
    float* out = state + 4 * i;
    out[0] = s.lo;
    out[1] = s.hi;
    out[2] = s.x;
    out[3] = s.slo;
  }
}

void refine_newton_host(const float* state, const float* t, const int* mmf,
                        const float* vp, const float* vs, const float* rho,
                        const float* qsi, const float* hf, const float* vf,
                        const float* rf, float* root, float* u, int K, int B,
                        int L, int rayleigh, float t_base, int atten,
                        int n_newton, int compute_group) {
  const sl::Model m = model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  for (int i = 0; i < K * B; ++i) {
    const int b = i % B;
    const float* in = state + 4 * i;
    const sl::RefineState s{in[0], in[1], in[2], in[3]};
    sl::NewtonKeep keep;
    if (rayleigh) {
      sl::lane_refine_newton<true>(m, b, s, t[i], mmf[i], t_base, atten != 0,
                                   n_newton, compute_group != 0, &keep,
                                   &root[i], &u[i]);
    } else {
      sl::lane_refine_newton<false>(m, b, s, t[i], mmf[i], t_base, atten != 0,
                                    n_newton, compute_group != 0, &keep,
                                    &root[i], &u[i]);
    }
  }
}

}  // extern "C"
