// CUDA kernels of the batched dispersion solve, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pysurfinv_tpu/ops/pallas_secular.py:
//   secular_lanes_kernel  <- secular_lanes        (_rayleigh_kernel,
//                            _love_kernel): F with the dynamic
//                            4-wavelength truncation walk
//   secular_frozen_kernel <- secular_lanes_frozen (_frozen_kernel): F at a
//                            pinned closure layer
//   secular_grad_kernel   <- secular_lanes_grad   (_rayleigh_grad_kernel,
//                            _love_grad_kernel): (F, dF/dc, dF/dT)
//   refine_kernel         <- refine_lanes         (_refine_kernel): Illinois
//                            + clamped Newton + group velocity in one pass
//
// Design.  One thread per (k, b) lane; blocks of 128 threads run along the
// model axis b, the grid is (ceil(B/128), K).  Each lane is a sequential
// recursion of up to L-1 (~90) layer steps, with the state (the Dunkin
// 5-vector or the Haskell pair, plus the truncation walk) in registers.
// What bounds it on this card is FP32 and SFU throughput — per layer and
// lane one expf, one sinf/cosf pair per wavenumber, two sqrtf and a dozen
// IEEE divisions, ~150 flops — not memory: a layer reads 28 bytes of
// model per lane (7 floats at l*B + b, coalesced across a warp without
// shared memory) and the K rows of one model share them through L1/L2.
// The simple design does nothing more about that bound than to skip the
// arithmetic of the layers a lane does not apply (the TPU kernel computed
// and discarded them); those steps only renormalise, as on the TPU.  The
// ragged edge of B is masked, not padded.  The per-lane arithmetic lives
// in secular_lane.cuh, shared by the four kernels; the gradient kernel
// and the refinement's Newton tail run it on a dual number carrying d/dc
// and d/dT.  Built without FMA contraction (see NVCC_FLAGS in
// ops/secular_lanes.py), each kernel is bitwise equal to its plain
// PyTorch version on the card.
//
// C interface for ctypes: pointers and the stream are void*, each entry
// point launches on the given stream, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "secular_lane.cuh"

namespace {

constexpr int kBlock = 128;

struct Lanes {
  const float* c;
  const float* t;
  const float* tm;
  const int* mmf;
  int K, B;
};

sl::Model make_model(const void* vp, const void* vs, const void* rho,
                     const void* qsi, const void* hf, const void* vf,
                     const void* rf, int B, int L) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return sl::Model{f(vp), f(vs), f(rho), f(qsi), f(hf), f(vf), f(rf), B, L};
}

template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
secular_lanes_kernel(Lanes in, sl::Model m, const int* __restrict__ nlay,
                     float fact, float t_base, bool atten,
                     float* __restrict__ F, float* __restrict__ bhs,
                     int* __restrict__ mm) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  sl::lane_dynamic<kRayleigh>(m, b, in.c[i], in.t[i], in.tm[i], in.mmf[i],
                              nlay[b], fact, t_base, atten, &F[i], &bhs[i],
                              &mm[i]);
}

template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
secular_frozen_kernel(Lanes in, sl::Model m, float t_base, bool atten,
                      float* __restrict__ F) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  F[i] = sl::lane_frozen<kRayleigh>(m, b, in.c[i], in.t[i], in.mmf[i],
                                    t_base, atten);
}

template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
secular_grad_kernel(Lanes in, sl::Model m, float t_base, bool atten,
                    float* __restrict__ F, float* __restrict__ Fc,
                    float* __restrict__ Ft) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  sl::lane_grad<kRayleigh>(m, b, in.c[i], in.t[i], in.mmf[i], t_base, atten,
                           &F[i], &Fc[i], &Ft[i]);
}

// refine_lanes: the whole refinement of one (k, b) lane in one thread —
// (n_ill + 2) frozen evaluations, then n_newton tangent evaluations, with
// the halfspace row captured once.  Replaces the separate frozen (Illinois)
// and gradient launches of the solver's refinement phase: the model column
// is read from L2 by one launch instead of n_ill + 2 + n_newton.  Bound:
// FP32/SFU throughput, as the kernels above (the extra state is a dozen
// registers).
template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
refine_kernel(Lanes in, const float* __restrict__ hi, sl::Model m,
              float t_base, bool atten, int n_ill, int n_newton,
              bool compute_group, float* __restrict__ root,
              float* __restrict__ u) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  sl::lane_refine<kRayleigh>(m, b, in.c[i], hi[i], in.t[i], in.mmf[i], t_base,
                             atten, n_ill, n_newton, compute_group, &root[i],
                             &u[i]);
}

dim3 grid_of(int K, int B) { return dim3((B + kBlock - 1) / kBlock, K); }

}  // namespace

extern "C" {

int secular_lanes_launch(const void* c, const void* t, const void* tm,
                         const void* mmf, const void* vp, const void* vs,
                         const void* rho, const void* qsi, const void* hf,
                         const void* vf, const void* rf, const void* nlay,
                         void* F, void* bhs, void* mm, int K, int B, int L,
                         int rayleigh, float fact, float t_base, int atten,
                         void* stream) {
  const Lanes in{static_cast<const float*>(c), static_cast<const float*>(t),
                 static_cast<const float*>(tm), static_cast<const int*>(mmf),
                 K, B};
  const sl::Model m = make_model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0 && B > 0) {
    if (rayleigh) {
      secular_lanes_kernel<true><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, static_cast<const int*>(nlay), fact, t_base, atten != 0,
          static_cast<float*>(F), static_cast<float*>(bhs),
          static_cast<int*>(mm));
    } else {
      secular_lanes_kernel<false><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, static_cast<const int*>(nlay), fact, t_base, atten != 0,
          static_cast<float*>(F), static_cast<float*>(bhs),
          static_cast<int*>(mm));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int secular_lanes_frozen_launch(const void* c, const void* t, const void* mmf,
                                const void* vp, const void* vs,
                                const void* rho, const void* qsi,
                                const void* hf, const void* vf,
                                const void* rf, void* F, int K, int B,
                                int L, int rayleigh, float t_base, int atten,
                                void* stream) {
  const Lanes in{static_cast<const float*>(c), static_cast<const float*>(t),
                 nullptr, static_cast<const int*>(mmf), K, B};
  const sl::Model m = make_model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0 && B > 0) {
    if (rayleigh) {
      secular_frozen_kernel<true><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F));
    } else {
      secular_frozen_kernel<false><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int secular_lanes_grad_launch(const void* c, const void* t, const void* mmf,
                              const void* vp, const void* vs, const void* rho,
                              const void* qsi, const void* hf, const void* vf,
                              const void* rf, void* F, void* Fc, void* Ft,
                              int K, int B, int L, int rayleigh,
                              float t_base, int atten, void* stream) {
  const Lanes in{static_cast<const float*>(c), static_cast<const float*>(t),
                 nullptr, static_cast<const int*>(mmf), K, B};
  const sl::Model m = make_model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 0 && B > 0) {
    if (rayleigh) {
      secular_grad_kernel<true><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F),
          static_cast<float*>(Fc), static_cast<float*>(Ft));
    } else {
      secular_grad_kernel<false><<<grid_of(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F),
          static_cast<float*>(Fc), static_cast<float*>(Ft));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int refine_lanes_launch(const void* lo, const void* hi, const void* t,
                        const void* mmf, const void* vp, const void* vs,
                        const void* rho, const void* qsi, const void* hf,
                        const void* vf, const void* rf, void* root, void* u,
                        int K, int B, int L, int rayleigh, float t_base,
                        int atten, int n_ill, int n_newton, int compute_group,
                        void* stream) {
  const Lanes in{static_cast<const float*>(lo), static_cast<const float*>(t),
                 nullptr, static_cast<const int*>(mmf), K, B};
  const sl::Model m = make_model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  if (K > 0 && B > 0) {
    if (rayleigh) {
      refine_kernel<true><<<grid_of(K, B), kBlock, 0, s>>>(
          in, h, m, t_base, atten != 0, n_ill, n_newton, compute_group != 0,
          static_cast<float*>(root), static_cast<float*>(u));
    } else {
      refine_kernel<false><<<grid_of(K, B), kBlock, 0, s>>>(
          in, h, m, t_base, atten != 0, n_ill, n_newton, compute_group != 0,
          static_cast<float*>(root), static_cast<float*>(u));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
