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
//   refine_illinois_kernel, refine_newton_kernel
//                         <- refine_lanes         (_refine_kernel): Illinois,
//                            then clamped Newton + group velocity, two
//                            kernels of one launch entry point
//
// Design.  One thread a (k, b) lane: a lane is a sequential recursion of
// up to L-1 (~90) layer steps with its state (the Dunkin 5-vector or the
// Haskell pair, and the truncation walk) in registers.  What bounds the
// kernels on this card, measured on the H100 (PERF.md), is instruction
// issue, not memory: a Rayleigh layer step is ~400-550 SASS instructions
// (a dozen IEEE divisions, expf or sincosf, two sqrtf and the ~130 FP32
// operations of the Dunkin matrix) against 28 bytes of model, and a
// lane-layer costs no more when the model streams from HBM than when it
// sits in L2.  The per-lane code (secular_lane.cuh, shared by the
// kernels) therefore spends fewer instructions: each regime computes only
// its own side, a solid layer skips the liquid mask, the layers a lane
// does not apply renormalise only until the vector stops changing, and
// the dual-number body forms each Dunkin entry where its rows need it
// (96 registers for the Rayleigh gradient kernel instead of 128: 5
// blocks an SM instead of 4).  Every kernel runs the K rows of a
// 128-model tile next to each other in the grid (blockIdx.x = k), so the
// rows read the tile's model columns from L2 and each SM mixes rows of
// short and long period (shallow and deep closures): Love, whose layer
// step costs a quarter of Rayleigh's, is the kernel that shows it.  A
// block that staged its tile's columns in shared memory (cp.async, an
// mbarrier) for a group of rows measured slower at the solve's shapes and
// far slower at few rows (79 KB of slab cap an SM at 2 blocks); it won
// only Love's K=90 sweep at 1,920 models.  refine_lanes runs its float
// Illinois phase and its dual-number Newton phase as two kernels, each at
// its own register count, handing 16 bytes a lane over in device memory.
// The ragged edge of B is masked, not padded.  The gradient kernel and
// the refinement's Newton phase run the lane code on a dual number
// carrying d/dc and d/dT.  Built without FMA contraction
// (see NVCC_FLAGS in ops/secular_lanes.py), each kernel is bitwise equal
// to its plain PyTorch version on the card.
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

// One thread a (k, b) lane, in the grid rows_first(K, B) (below).
template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
secular_lanes_kernel(Lanes in, sl::Model m, const int* __restrict__ nlay,
                     float fact, float t_base, bool atten,
                     float* __restrict__ F, float* __restrict__ bhs,
                     int* __restrict__ mm) {
  const int b = blockIdx.y * kBlock + threadIdx.x;
  const int k = blockIdx.x;
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
  const int b = blockIdx.y * kBlock + threadIdx.x;
  const int k = blockIdx.x;
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
  const int b = blockIdx.y * kBlock + threadIdx.x;
  const int k = blockIdx.x;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  sl::lane_grad<kRayleigh>(m, b, in.c[i], in.t[i], in.mmf[i], t_base, atten,
                           &F[i], &Fc[i], &Ft[i]);
}

// refine_lanes, in two kernels launched back to back, so that each phase
// runs at its own register count: a thread that runs both holds the
// dual-number body's registers (127, Rayleigh) through the float
// Illinois evaluations, ten of the twelve at n_ill 8, and runs them at a
// quarter of the warps.  Each phase keeps the state it carries between
// evaluations in shared memory (sl::IllinoisKeep, sl::NewtonKeep), so
// that it runs at its one-evaluation kernel's registers: the Illinois
// phase at about secular_frozen_kernel's, the Newton phase at
// secular_grad_kernel's.
//
// Phase 1, float only: the n_ill + 2 Illinois evaluations of a (k, b)
// lane and the clipped estimate.  With a state buffer it hands the live
// bracket, the estimate and sgn(F(lo)) to phase 2 (a float4 a lane);
// without one (n_newton = 0) it writes the root and u = 0 itself.
template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
refine_illinois_kernel(Lanes in, const float* __restrict__ hi, sl::Model m,
                       float t_base, bool atten, int n_ill,
                       float4* __restrict__ state, float* __restrict__ root,
                       float* __restrict__ u) {
  const int b = blockIdx.y * kBlock + threadIdx.x;
  const int k = blockIdx.x;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  __shared__ sl::IllinoisKeep keep[kBlock];
  volatile sl::IllinoisKeep* kp = &keep[threadIdx.x];
  const sl::RefineState s = sl::lane_refine_illinois<kRayleigh>(
      m, b, in.c[i], hi[i], in.t[i], in.mmf[i], t_base, atten, n_ill, kp);
  if (state != nullptr) {
    state[i] = make_float4(s.lo, s.hi, s.x, s.slo);
  } else {
    root[i] = s.x;
    u[i] = 0.f;
  }
}

// Phase 2, on the dual number: the n_newton clamped Newton steps and u.
template <bool kRayleigh>
__global__ void __launch_bounds__(kBlock)
refine_newton_kernel(Lanes in, sl::Model m, float t_base, bool atten,
                     int n_newton, bool compute_group,
                     const float4* __restrict__ state,
                     float* __restrict__ root, float* __restrict__ u) {
  const int b = blockIdx.y * kBlock + threadIdx.x;
  const int k = blockIdx.x;
  if (b >= in.B) return;
  const int i = k * in.B + b;
  const float4 s = state[i];
  __shared__ sl::NewtonKeep keep[kBlock];
  volatile sl::NewtonKeep* kp = &keep[threadIdx.x];
  sl::lane_refine_newton<kRayleigh>(m, b, sl::RefineState{s.x, s.y, s.z, s.w},
                                    in.t[i], in.mmf[i], t_base, atten,
                                    n_newton, compute_group, kp, &root[i],
                                    &u[i]);
}

// Every kernel: block (k, y) takes row k of models y*kBlock ..
// y*kBlock + kBlock - 1, so the K rows of a model tile run next to each
// other (B <= 65,535 * kBlock).
dim3 rows_first(int K, int B) { return dim3(K, (B + kBlock - 1) / kBlock); }

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
      secular_lanes_kernel<true><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, static_cast<const int*>(nlay), fact, t_base, atten != 0,
          static_cast<float*>(F), static_cast<float*>(bhs),
          static_cast<int*>(mm));
    } else {
      secular_lanes_kernel<false><<<rows_first(K, B), kBlock, 0, s>>>(
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
      secular_frozen_kernel<true><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F));
    } else {
      secular_frozen_kernel<false><<<rows_first(K, B), kBlock, 0, s>>>(
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
      secular_grad_kernel<true><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F),
          static_cast<float*>(Fc), static_cast<float*>(Ft));
    } else {
      secular_grad_kernel<false><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, static_cast<float*>(F),
          static_cast<float*>(Fc), static_cast<float*>(Ft));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ``state``: a (K, B, 4) float32 scratch buffer for the phases' hand-over,
// needed when n_newton > 0 and not read otherwise.
int refine_lanes_launch(const void* lo, const void* hi, const void* t,
                        const void* mmf, const void* vp, const void* vs,
                        const void* rho, const void* qsi, const void* hf,
                        const void* vf, const void* rf, void* root, void* u,
                        void* state, int K, int B, int L, int rayleigh,
                        float t_base, int atten, int n_ill, int n_newton,
                        int compute_group, void* stream) {
  const Lanes in{static_cast<const float*>(lo), static_cast<const float*>(t),
                 nullptr, static_cast<const int*>(mmf), K, B};
  const sl::Model m = make_model(vp, vs, rho, qsi, hf, vf, rf, B, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  float4* st = n_newton > 0 ? static_cast<float4*>(state) : nullptr;
  float* r = static_cast<float*>(root);
  float* uu = static_cast<float*>(u);
  if (n_newton > 0 && st == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K > 0 && B > 0) {
    if (rayleigh) {
      refine_illinois_kernel<true><<<rows_first(K, B), kBlock, 0, s>>>(
          in, h, m, t_base, atten != 0, n_ill, st, r, uu);
    } else {
      refine_illinois_kernel<false><<<rows_first(K, B), kBlock, 0, s>>>(
          in, h, m, t_base, atten != 0, n_ill, st, r, uu);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || st == nullptr) return static_cast<int>(err);
    if (rayleigh) {
      refine_newton_kernel<true><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, n_newton, compute_group != 0, st, r, uu);
    } else {
      refine_newton_kernel<false><<<rows_first(K, B), kBlock, 0, s>>>(
          in, m, t_base, atten != 0, n_newton, compute_group != 0, st, r, uu);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
