// Host build of the draw kernels' per-lane arithmetic
// (pysurfinv_tpu_torch/csrc/draw_lane.cuh), for tests/test_torch_draws.py:
// each entry point runs one kernel's lane body over every lane on the CPU,
// with the CUDA launch functions' signatures minus the stream; erf_host and
// erfinv_host expose the header's host special functions.  The port itself
// never uses this library.

#include <stdint.h>

#include <vector>

#include "draw_lane.cuh"

namespace {

template <typename T>
void round_lanes(const int64_t* keys, const T* theta, const T* step,
                 const T* vmin, const T* vmax, int64_t* keys_out, T* cand,
                 int M, int P, int W, int n_pert) {
  std::vector<dl::Key> sub(W);
  for (int m = 0; m < M; ++m) {
    dl::Key k = dl::load_key(keys, m);
    for (int w = 0; w < W; ++w) {
      sub[w] = dl::fold_in(k, 1u);
      k = dl::fold_in(k, 0u);
    }
    dl::store_key(keys_out, m, k);
    for (int w = 0; w < W; ++w) {
      for (int p = 0; p < P; ++p) {
        const int64_t e = static_cast<int64_t>(m) * P + p;
        cand[(static_cast<int64_t>(w) * M + m) * P + p] = dl::candidate<T>(
            sub[w], static_cast<uint32_t>(p), w < n_pert, theta[e], step[e],
            vmin[e], vmax[e]);
      }
    }
  }
}

}  // namespace

extern "C" {

void draw_round_host(const void* keys, const void* theta, const void* step,
                     const void* vmin, const void* vmax, void* keys_out,
                     void* cand, int M, int P, int W, int n_pert,
                     int is_double) {
  const int64_t* k = static_cast<const int64_t*>(keys);
  int64_t* ko = static_cast<int64_t*>(keys_out);
  if (is_double) {
    round_lanes(k, static_cast<const double*>(theta),
                static_cast<const double*>(step),
                static_cast<const double*>(vmin),
                static_cast<const double*>(vmax), ko,
                static_cast<double*>(cand), M, P, W, n_pert);
  } else {
    round_lanes(k, static_cast<const float*>(theta),
                static_cast<const float*>(step),
                static_cast<const float*>(vmin),
                static_cast<const float*>(vmax), ko,
                static_cast<float*>(cand), M, P, W, n_pert);
  }
}

void fold_in_host(const int64_t* keys, int key_step, const int64_t* data,
                  uint32_t data0, int num, int64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = num > 0 ? i / num : i * key_step;
    const uint32_t d = num > 0 ? static_cast<uint32_t>(i % num)
                       : data  ? static_cast<uint32_t>(data[i])
                               : data0;
    dl::store_key(out, i, dl::fold_in(dl::load_key(keys, k), d));
  }
}

void bits_host(const int64_t* keys, int64_t per, int64_t* hi, int64_t* lo,
               int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
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
}

void erf_host(const double* x, double* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = dl::erf_(x[i]);
}

void erfinv_host(const double* x, double* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = dl::erfinv_(x[i]);
}

}  // extern "C"
