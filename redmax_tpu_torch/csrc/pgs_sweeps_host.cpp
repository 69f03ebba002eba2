// The CPU build of K3 (pgs_sweeps_lane.cuh): g++ -O2 into a shared library
// with a plain C interface, loaded with ctypes (pgs_kernel.py) for CPU
// tensors. Lanes run one after another on the calling thread.
//
// Layouts (row-major, batch-first, as the callers hold them): D [B, m, m],
// r, lo, hi [B, m], active [B] (bytes, 0 = frozen; null = every lane), lam
// [B, m] out. A frozen lane is not swept and comes out 0.
#include <vector>

#include "pgs_sweeps_lane.cuh"

namespace {

template <typename T>
void run(int m, int B, const T* D, const T* r, const T* lo, const T* hi,
         const unsigned char* active, int iters, T reg, T* lam) {
  std::vector<T> Dt(static_cast<long>(m) * m + 1), rho(m + 1);
  for (int b = 0; b < B; ++b) {
    const long off = static_cast<long>(b) * m;
    if (active && !active[b]) {
      for (int i = 0; i < m; ++i) lam[off + i] = T(0);
      continue;
    }
    pgs::sweeps_lane<T>(m, D + off * m, r + off, lo + off, hi + off, iters, reg, lam + off,
                        Dt.data(), rho.data());
  }
}

}  // namespace

extern "C" int pgs_sweeps_host_f32(int m, int B, const float* D, const float* r,
                                   const float* lo, const float* hi,
                                   const unsigned char* active, int iters, float reg,
                                   float* lam) {
  run<float>(m, B, D, r, lo, hi, active, iters, reg, lam);
  return 0;
}

extern "C" int pgs_sweeps_host_f64(int m, int B, const double* D, const double* r,
                                   const double* lo, const double* hi,
                                   const unsigned char* active, int iters, double reg,
                                   double* lam) {
  run<double>(m, B, D, r, lo, hi, active, iters, reg, lam);
  return 0;
}
