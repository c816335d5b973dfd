// CUDA kernels of the sampler's random streams, for Hopper (sm_90a).
//
// They replace no TPU kernel: the JAX package draws with jax.random inside
// its jitted sampler, where XLA fuses the Threefry hash into the
// surrounding computation.  The port's plain version (inversion/random.py
// and mcmc._draw) builds the same hash from torch integer ops, ~170 of
// them a hash, one kernel launch each on the card; a retry round of the
// survey sampler (a W-long walk of each lane's key chain and the W x M x P
// candidates drawn from it) took ~1,750 launches of a few microseconds'
// work each, and the host's time to launch them, not the card, bounded it.
//   draw_round_kernel <- a retry round of mcmc._propose_batched /
//                        mcmc._propose: the key walk and the candidates
//   fold_in_kernel    <- random.fold_in, and random.split (key i / num
//                        folded in with i % num)
//   bits_kernel       <- random.random_bits (32 or 64 bits)
//
// Design.  What bounds a round is its one launch: ~2,048 candidates x
// (P + 1) hashes is ~10^7 integer operations, microseconds of the card.
// A block takes 32 lanes.  A lane's key chain is sequential (key w + 1 is
// a hash of key w), so one thread a lane walks it, up to 64 keys a pass,
// into shared memory; the block's 256 threads then hash the subkeys and
// draw the candidates' parameters, neighbouring threads writing
// neighbouring parameters.  Rounds wider than 64 draws a lane take
// further passes.  The per-lane arithmetic (draw_lane.cuh) performs the
// plain version's IEEE operations in its order, so every kernel is
// bitwise equal to its plain version on the card.
//
// C interface for ctypes: pointers and the stream are void*, each entry
// point launches on the given stream, does not synchronise and returns
// cudaGetLastError().  Keys are int64 (n, 2) arrays of 32-bit words.

#include <cuda_runtime.h>

#include "draw_lane.cuh"

namespace {

constexpr int kLanes = 32;    // lanes a block of draw_round_kernel
constexpr int kThreads = 256;
constexpr int kChunk = 64;    // draws a lane a pass (the sampler's widest)

unsigned blocks(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    draw_round_kernel(const int64_t* keys, const T* theta, const T* step,
                      const T* vmin, const T* vmax, int64_t* keys_out,
                      T* cand, int M, int P, int W, int n_pert) {
  __shared__ dl::Key walk[kChunk][kLanes];  // key before split w
  __shared__ dl::Key sub[kChunk][kLanes];   // its subkey: draw w's key
  const int m0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, M - m0);
  const int t = threadIdx.x;
  dl::Key k{0u, 0u};
  if (t < nl) k = dl::load_key(keys, m0 + t);
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    const int nw = min(kChunk, W - w0);
    if (t < nl) {
      for (int w = 0; w < nw; ++w) {
        walk[w][t] = k;
        k = dl::fold_in(k, 0u);
      }
    }
    __syncthreads();
    for (int i = t; i < nw * nl; i += kThreads) {
      sub[i / nl][i % nl] = dl::fold_in(walk[i / nl][i % nl], 1u);
    }
    __syncthreads();
    for (int i = t; i < nw * nl * P; i += kThreads) {
      const int p = i % P;
      const int l = (i / P) % nl;
      const int w = i / (P * nl);
      const int64_t e = static_cast<int64_t>(m0 + l) * P + p;
      cand[(static_cast<int64_t>(w0 + w) * M + m0 + l) * P + p] =
          dl::candidate<T>(sub[w][l], static_cast<uint32_t>(p),
                           w0 + w < n_pert, theta[e], step[e], vmin[e],
                           vmax[e]);
    }
    __syncthreads();
  }
  if (t < nl) dl::store_key(keys_out, m0 + t, k);
}

// out[i] = fold_in(keys[i * key_step], data ? data[i] : data0), or, when
// num > 0 (a split), fold_in(keys[i / num], i % num)
__global__ void fold_in_kernel(const int64_t* keys, int key_step,
                               const int64_t* data, uint32_t data0, int num,
                               int64_t* out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t k = num > 0 ? i / num : i * key_step;
  const uint32_t d = num > 0 ? static_cast<uint32_t>(i % num)
                     : data  ? static_cast<uint32_t>(data[i])
                             : data0;
  dl::store_key(out, i, dl::fold_in(dl::load_key(keys, k), d));
}

// the hash of counter c < per under keys[i / per]: (hi, lo) into hi[i] and
// lo[i], or hi ^ lo into hi[i] when lo is null (32-bit draws)
__global__ void bits_kernel(const int64_t* keys, int64_t per, int64_t* hi,
                            int64_t* lo, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t c = i % per;
  uint32_t y0, y1;
  dl::threefry(dl::load_key(keys, i / per), static_cast<uint32_t>(c >> 32),
               static_cast<uint32_t>(c), &y0, &y1);
  if (lo) {
    hi[i] = static_cast<int64_t>(y0);
    lo[i] = static_cast<int64_t>(y1);
  } else {
    hi[i] = static_cast<int64_t>(y0 ^ y1);
  }
}

}  // namespace

extern "C" {

// A retry round: keys (M, 2) -> keys_out (M, 2) advanced W splits, cand
// (W, M, P) the candidates (draw w perturbs while w < n_pert, resets
// after); theta, step, vmin, vmax (M, P) of float64 (is_double) or
// float32.
int draw_round_launch(const void* keys, const void* theta, const void* step,
                      const void* vmin, const void* vmax, void* keys_out,
                      void* cand, int M, int P, int W, int n_pert,
                      int is_double, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(keys);
  int64_t* ko = static_cast<int64_t*>(keys_out);
  if (M > 0) {
    const unsigned g = blocks(M, kLanes);
    if (is_double) {
      draw_round_kernel<double><<<g, kThreads, 0, s>>>(
          k, static_cast<const double*>(theta),
          static_cast<const double*>(step), static_cast<const double*>(vmin),
          static_cast<const double*>(vmax), ko, static_cast<double*>(cand), M,
          P, W, n_pert);
    } else {
      draw_round_kernel<float><<<g, kThreads, 0, s>>>(
          k, static_cast<const float*>(theta), static_cast<const float*>(step),
          static_cast<const float*>(vmin), static_cast<const float*>(vmax), ko,
          static_cast<float*>(cand), M, P, W, n_pert);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// fold_in (num 0) or split (num > 0, data unused) of n output keys
int fold_in_launch(const void* keys, int key_step, const void* data,
                   unsigned data0, int num, void* out, long long n,
                   void* stream) {
  if (n > 0) {
    fold_in_kernel<<<blocks(n, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), key_step,
        static_cast<const int64_t*>(data), data0, num,
        static_cast<int64_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

int bits_launch(const void* keys, long long per, void* hi, void* lo,
                long long n, void* stream) {
  if (n > 0) {
    bits_kernel<<<blocks(n, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), per, static_cast<int64_t*>(hi),
        static_cast<int64_t*>(lo), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
