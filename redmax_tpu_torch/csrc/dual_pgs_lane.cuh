// Per-lane body of the fused dual projected Gauss-Seidel QP solve.
//
// Replaces the lane arithmetic of redmax_tpu/pallas_qp.py::_build_kernel, one
// lane at a time and in its order: unpivoted Gauss-Jordan H^-1; H^-1 f,
// H^-1 A^T, D = A H^-1 A^T, r = A H^-1 f - b; the reg-guarded diagonal;
// `iters` sweeps over the M rows in order, each row reading the freshest
// lambda (Gauss-Seidel, not Jacobi) and clipped to [lo, hi]; then
// x = H^-1 f - H^-1 A^T lambda. The function is __host__ __device__ so g++ can
// compile the same body for a CPU check; the macros are defined empty when
// __CUDACC__ is absent.
//
// Layouts (all float32, struct-of-arrays: element p of lane b at p*B + b):
//   H [N*N, B] row-major, f [N, B], A [M*N, B] row-major, b, lo, hi [M, B]
//   outputs x [N, B], lam [M, B]
// lo/hi may hold -inf/+inf (equality and active inequality rows). A NaN in a
// row's update stays NaN through the clip, so a lane whose H is not positive
// definite comes out NaN instead of sitting on a bound.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#include <math.h>

namespace qp {

#define QP_HD __host__ __device__ __forceinline__

// min(max(v, lo), hi) that keeps a NaN v (fminf/fmaxf would return the bound).
QP_HD float clip_keep_nan(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <int N, int M>
QP_HD void dual_pgs_lane(int lane, int B, const float* H, const float* f, const float* A,
                         const float* b, const float* lo, const float* hi, int iters, float reg,
                         float* x_out, float* lam_out) {
  // H^-1 by branch-free Gauss-Jordan on [H | I] (H is SPD at physical steps).
  float G[N][2 * N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      G[i][j] = H[(i * N + j) * B + lane];
      G[i][N + j] = i == j ? 1.0f : 0.0f;
    }
  for (int k = 0; k < N; ++k) {
    const float inv_p = 1.0f / G[k][k];
    for (int j = 0; j < 2 * N; ++j) G[k][j] *= inv_p;
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const float fac = G[i][k];
      for (int j = 0; j < 2 * N; ++j) G[i][j] -= fac * G[k][j];
    }
  }

  float fv[N], Hf[N];
  for (int i = 0; i < N; ++i) fv[i] = f[i * B + lane];
  for (int i = 0; i < N; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc += G[i][N + k] * fv[k];
    Hf[i] = acc;
  }

  // HAT[:, r] = H^-1 A[r, :]^T, D = A HAT, r = A Hf - b, row by row of A.
  float HAT[N][M], D[M][M], rv[M];
  {
    float Am[M][N];
    for (int r = 0; r < M; ++r)
      for (int k = 0; k < N; ++k) Am[r][k] = A[(r * N + k) * B + lane];
    for (int i = 0; i < N; ++i)
      for (int r = 0; r < M; ++r) {
        float acc = 0.0f;
        for (int k = 0; k < N; ++k) acc += G[i][N + k] * Am[r][k];
        HAT[i][r] = acc;
      }
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < N; ++k) acc += Am[i][k] * HAT[k][j];
        D[i][j] = acc;
      }
      float acc = 0.0f;
      for (int k = 0; k < N; ++k) acc += Am[i][k] * Hf[k];
      rv[i] = acc - b[i * B + lane];
    }
  }

  float safe[M], lov[M], hiv[M], lam[M];
  for (int i = 0; i < M; ++i) {
    safe[i] = fabsf(D[i][i]) < reg ? 1.0f : D[i][i];
    lov[i] = lo[i * B + lane];
    hiv[i] = hi[i * B + lane];
    lam[i] = 0.0f;
  }

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) acc += D[i][j] * lam[j];
      const float resid = rv[i] - acc + D[i][i] * lam[i];
      lam[i] = clip_keep_nan(resid / safe[i], lov[i], hiv[i]);
    }
  }

  for (int i = 0; i < N; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += HAT[i][j] * lam[j];
    x_out[i * B + lane] = Hf[i] - acc;
  }
  for (int i = 0; i < M; ++i) lam_out[i * B + lane] = lam[i];
}

}  // namespace qp
