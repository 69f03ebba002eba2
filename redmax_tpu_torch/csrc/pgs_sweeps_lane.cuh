// Per-lane body of the batched projected Gauss-Seidel sweeps (K3), in float
// and double.
//
// It replaces no Pallas kernel: it is the op-level lax.scan of
// redmax_tpu/friction.py:633-642 (the friction pass's box sweeps) and
// redmax_tpu/qp.py:77-86 (qp_pgs's sweeps on a given dual). For one lane, on
// D [m, m] row-major and r, lo, hi [m]: lambda = 0, then `iters` sweeps over
// the rows in order, each row reading the freshest lambda (Gauss-Seidel, not
// Jacobi):
//   resid    = r_i - sum_j D_ij lambda_j + D_ii lambda_i
//   lambda_i = clip(resid / safe_i, lo_i, hi_i),   safe_i = |D_ii| < reg ? 1 : D_ii
// lo/hi may hold -inf/+inf. The clip keeps a NaN (of the update or of a
// bound) as torch.maximum/minimum do in qp.pgs_sweeps, so a diverged lane
// comes out NaN instead of sitting on a bound.
//
// The sweep keeps the residual rho = r - D lambda instead of taking a dot
// product a row (the same iterates in exact arithmetic): at each sweep's
// start rho_j = r_j - sum_c D_jc lambda_c (refresh_row, in column order), so
// rounding cannot drift past one sweep; within the sweep row i takes
// resid = rho_i + D_ii lambda_i, and its change delta = lambda_i' - lambda_i
// updates every rho_j -= D_ji delta (update_row). A row's dependent chain is
// then one division, a clip and one delta, not a dot product of m.
//
// The functions are __host__ __device__: g++ builds sweeps_lane for CPU
// tensors (pgs_sweeps_host.cpp), nvcc builds the card's kernel
// (pgs_sweeps.cu), which runs the same steps a warp a lane (thread j % 32
// holds rho_j and lambda_j). The macros are defined empty when __CUDACC__ is
// absent.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace pgs {

#define PGS_HD __host__ __device__ __forceinline__

// min(max(v, lo), hi) that keeps a NaN of v, lo or hi.
template <typename T>
PGS_HD T clip_keep_nan(T v, T lo, T hi) {
  v = (v < lo || lo != lo) ? lo : v;
  return (v > hi || hi != hi) ? hi : v;
}

// The guarded diagonal: 1 where |d| < reg (a masked or degenerate row).
template <typename T>
PGS_HD T safe_diag(T d, T reg) {
  return (d < T(0) ? -d : d) < reg ? T(1) : d;
}

// Row i's new lambda from rho_i = r_i - sum_j D_ij lambda_j.
template <typename T>
PGS_HD T row_update(T rho_i, T d_ii, T lam_i, T safe_i, T lo_i, T hi_i) {
  return clip_keep_nan((rho_i + d_ii * lam_i) / safe_i, lo_i, hi_i);
}

// rho_j = r_j - sum_c D_jc lambda_c over the columns in order; Dj is row j
// of D, read at Dj[c * stride] (stride 1: row-major D; m: its transpose).
template <typename T>
PGS_HD T refresh_row(int m, const T* Dj, int stride, T r_j, const T* lam) {
  T acc = T(0);
  for (int c = 0; c < m; ++c) acc += Dj[c * stride] * lam[c];
  return r_j - acc;
}

// One lane on one thread: lam [m] out; Dt [m, m] scratch (D transposed,
// so that each column of D is contiguous) and rho [m] scratch. The refresh
// runs four interleaved partial sums (the CPU's add latency, not its rate,
// bounds a single chain); the card's refresh_row keeps one.
template <typename T>
PGS_HD void sweeps_lane(int m, const T* D, const T* r, const T* lo, const T* hi, int iters,
                        T reg, T* lam, T* Dt, T* rho) {
  for (int j = 0; j < m; ++j)
    for (int c = 0; c < m; ++c) Dt[static_cast<long>(c) * m + j] = D[static_cast<long>(j) * m + c];
  for (int i = 0; i < m; ++i) lam[i] = T(0);
  for (int it = 0; it < iters; ++it) {
    for (int j = 0; j < m; ++j) {
      const T* Dj = D + static_cast<long>(j) * m;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
      int c = 0;
      for (; c + 4 <= m; c += 4) {
        s0 += Dj[c] * lam[c];
        s1 += Dj[c + 1] * lam[c + 1];
        s2 += Dj[c + 2] * lam[c + 2];
        s3 += Dj[c + 3] * lam[c + 3];
      }
      for (; c < m; ++c) s0 += Dj[c] * lam[c];
      rho[j] = r[j] - ((s0 + s1) + (s2 + s3));
    }
    for (int i = 0; i < m; ++i) {
      const T d_ii = D[static_cast<long>(i) * m + i];
      const T lam_i = row_update(rho[i], d_ii, lam[i], safe_diag(d_ii, reg), lo[i], hi[i]);
      const T delta = lam_i - lam[i];
      lam[i] = lam_i;
      const T* col = Dt + static_cast<long>(i) * m;
      for (int j = 0; j < m; ++j) rho[j] -= col[j] * delta;
    }
  }
}

}  // namespace pgs
