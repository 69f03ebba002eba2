// The CPU build of K3 (pgs_sweeps_lane.cuh, lane_sweeps): g++ -O2 into a
// shared library with a plain C interface, loaded with ctypes
// (pgs_kernel.py) for CPU tensors. Lanes run one after another on the
// calling thread. It computes the card designs' arithmetic in the same
// order, so it gives their results bit for bit.
//
// Layouts (row-major, batch-first, as the callers hold them): D [B, m, m],
// r, lo, hi [B, m], active [B] (bytes, 0 = frozen; null = every lane), lam
// [B, m] out. A frozen lane is not swept and comes out 0.
#include <vector>

#include "pgs_sweeps_lane.cuh"

namespace {

// The lane header's fma() is one instruction on x86-64 (the header's target
// pragma): a CPU without it cannot run this build.
bool cpu_has_fma() {
#if defined(__x86_64__)
  return __builtin_cpu_supports("fma");
#else
  return true;
#endif
}

template <typename T>
int run(int m, int B, const T* D, const T* r, const T* lo, const T* hi,
        const unsigned char* active, int iters, T reg, T* lam) {
  if (!cpu_has_fma()) return -2;
  const long mm = static_cast<long>(m) * m;
  std::vector<T> Doff(mm + 1), Dcol(mm + 1), sig(m + 1), inv(m + 1), safe(m + 1);
  for (int b = 0; b < B; ++b) {
    const long off = static_cast<long>(b) * m;
    if (active && !active[b]) {
      for (int i = 0; i < m; ++i) lam[off + i] = T(0);
      continue;
    }
    pgs::lane_sweeps<T>(m, D + off * m, r + off, lo + off, hi + off, iters, reg, lam + off,
                        Doff.data(), Dcol.data(), sig.data(), inv.data(), safe.data());
  }
  return 0;
}

}  // namespace

// Each returns 0, or -2 where the CPU has no FMA instruction.
extern "C" int pgs_sweeps_host_f32(int m, int B, const float* D, const float* r,
                                   const float* lo, const float* hi,
                                   const unsigned char* active, int iters, float reg,
                                   float* lam) {
  return run<float>(m, B, D, r, lo, hi, active, iters, reg, lam);
}

extern "C" int pgs_sweeps_host_f64(int m, int B, const double* D, const double* r,
                                   const double* lo, const double* hi,
                                   const unsigned char* active, int iters, double reg,
                                   double* lam) {
  return run<double>(m, B, D, r, lo, hi, active, iters, reg, lam);
}
