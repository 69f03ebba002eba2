// Per-lane body of the fused BDF2 chord-Newton solve (K1a + K1c: constant-S
// joints, penalty ground contact on cuboid corners as the only force closure,
// unguarded chord, lane-shared physical params).
//
// Replaces the lane arithmetic of redmax_tpu/pallas_step.py::_build_kernel
// (its fk_and_J / joint_forces / maximal_forces / _ground_contact / residual /
// hessian / gj_inverse / chord loop), one lane at a time. Functions are
// __host__ __device__ so g++ can compile the same body for a CPU check; the
// macros are defined empty when __CUDACC__ is absent.
//
// Layouts (all float32):
//   per-lane state  [NR, B] struct-of-arrays: element r of lane b at r*B + b
//   topo_i (int32)  parent[N] jtype[N] doffs[N+1] dofj[NR] anc[N*N] C cbody[C]
//   stat_f          E0_pj[16N] E0_ji[16N] I_i[6N] axes[9N] jsf[7*NR] bd[N] g[3] h
//                   cp[13*C]: per contact sides[3] kn kt kd mu xg[3] ng[3]
//   outputs         x [NR, B] (NaN on rejected lanes), Hinv [NR*NR, B]
// C ground contacts (C = 0: none), contact c on body cbody[c] against the
// plane through xg with normal ng. The template flag CONTACTS = false compiles
// the contact code out (for scenes with C = 0: the contact loops, even when
// they run no iteration, cost the constant-S solve registers and time).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#include <math.h>

namespace chord {

#define CHORD_HD __host__ __device__ __forceinline__

enum JointKind { FIXED = 0, REVOLUTE = 1, PRISMATIC = 2, PLANAR = 3, TRANSLATIONAL = 4 };

struct Frame {
  float R[3][3];
  float p[3];
};

CHORD_HD bool finitef(float v) { return fabsf(v) <= 3.402823466e38f; }

CHORD_HD void frame_from_E(const float* E, Frame& F) {
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) F.R[a][b] = E[a * 4 + b];
    F.p[a] = E[a * 4 + 3];
  }
}

// C = A * B (compose (R, p) pairs)
CHORD_HD void frame_mul(const Frame& A, const Frame& B, Frame& C) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      C.R[i][j] = A.R[i][0] * B.R[0][j] + A.R[i][1] * B.R[1][j] + A.R[i][2] * B.R[2][j];
    C.p[i] = A.p[i] + (A.R[i][0] * B.p[0] + A.R[i][1] * B.p[1] + A.R[i][2] * B.p[2]);
  }
}

CHORD_HD void frame_inv(const Frame& A, Frame& C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C.R[i][j] = A.R[j][i];
  for (int i = 0; i < 3; ++i)
    C.p[i] = -(C.R[i][0] * A.p[0] + C.R[i][1] * A.p[1] + C.R[i][2] * A.p[2]);
}

// 6x6 spatial adjoint [[R, 0], [hat(p) R, R]]
CHORD_HD void adjoint(const Frame& F, float A[6][6]) {
  const float(*R)[3] = F.R;
  const float* p = F.p;
  for (int j = 0; j < 3; ++j) {
    A[3][j] = p[1] * R[2][j] - p[2] * R[1][j];
    A[4][j] = p[2] * R[0][j] - p[0] * R[2][j];
    A[5][j] = p[0] * R[1][j] - p[1] * R[0][j];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i][j] = R[i][j];
      A[i][3 + j] = 0.0f;
      A[3 + i][3 + j] = R[i][j];
    }
}

CHORD_HD void mat6_vec(const float A[6][6], const float* v, float* out) {
  for (int i = 0; i < 6; ++i) {
    float acc = A[i][0] * v[0];
    for (int k = 1; k < 6; ++k) acc = acc + A[i][k] * v[k];
    out[i] = acc;
  }
}

CHORD_HD void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// ad(phi) y = (w x yw, v x yw + w x yv)
CHORD_HD void ad_vec(const float* phi, const float* y, float* out) {
  float t1[3], t2[3];
  cross3(phi, y, out);
  cross3(phi + 3, y, t1);
  cross3(phi, y + 3, t2);
  for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
}

// ad(phi)^T y = (yw x w + yv x v, yv x w)
CHORD_HD void adT_vec(const float* phi, const float* y, float* out) {
  float t1[3], t2[3];
  cross3(y, phi, t1);
  cross3(y + 3, phi + 3, t2);
  for (int k = 0; k < 3; ++k) out[k] = t1[k] + t2[k];
  cross3(y + 3, phi, out + 3);
}

CHORD_HD void hat(const float* a, float H[3][3]) {
  H[0][0] = 0.0f;  H[0][1] = -a[2]; H[0][2] = a[1];
  H[1][0] = a[2];  H[1][1] = 0.0f;  H[1][2] = -a[0];
  H[2][0] = -a[1]; H[2][1] = a[0];  H[2][2] = 0.0f;
}

// R^T g
CHORD_HD void rt_vec(const float R[3][3], const float* g, float* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[0][i] * g[0] + R[1][i] * g[1] + R[2][i] * g[2];
}

// Closed-form K/D blocks of Coriolis + gravity + body damping
// (pallas_step.local_force_blocks_closed).
CHORD_HD void local_force_blocks(const float* Ii, const float R[3][3], const float* phi,
                                 float bd, const float* g, float K[6][6], float D[6][6]) {
  const float m = Ii[3];
  float Rtg[3], Iw[3], hRtg[3][3], hIw[3][3], hw[3][3], hv[3][3];
  rt_vec(R, g, Rtg);
  for (int k = 0; k < 3; ++k) Iw[k] = Ii[k] * phi[k];
  hat(Rtg, hRtg);
  hat(Iw, hIw);
  hat(phi, hw);
  hat(phi + 3, hv);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) K[i][j] = D[i][j] = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      K[3 + i][j] = m * hRtg[i][j];
      D[i][j] = hIw[i][j] - hw[i][j] * Ii[j];
      D[3 + i][j] = m * hv[i][j];
      D[3 + i][3 + j] = -m * hw[i][j];
    }
  for (int i = 0; i < 6; ++i) D[i][i] = D[i][i] - bd;
}

// Penalty ground contact on the 8 corners of one cuboid body
// (pallas_step._ground_contact; force law of ForceGroundCuboid.m:54-153).
// Per corner r, with depth d = n.(x_c - xg), corner velocity u = w x r + v
// (body frame), normal speed vn and tangential velocity a (world frame):
//   active = d <= 0,  static = mu |kn d| > kt |a|
//   fW = active (-(kn d + kd vn) n) + sta (-kt a) + dyn (-mu kn d a/|a|)
// and the body wrench gains [r x fb; fb], fb = R^T fW. The regimes are 0/1
// masks that multiply, never branches, so a NaN state gives a NaN wrench;
// |a|^2 is clamped at 1e-24 by a compare that keeps NaN.
//
// BLOCKS also adds the closed-form K = d(wrench)/d(xi) (E <- E exp(xi^)) and
// D = d(wrench)/d(phi) to Kb, Db. World-frame A = dfW/dx_c = alpha n^T and
// B = dfW/dv_c = ct I + cn n n^T + ca a a^T, so in the body frame
//   P = R^T A R = pa nb^T,   Q = R^T B R = ct I + cn nb nb^T + ca ab ab^T
//   K = Gamma^T [hat(fb) - P hat(r) - Q hat(u) | P],   D = Gamma^T [-Q hat(r) | Q]
// with Gamma^T = [hat(r); I]. The normal spring and damper count in K, D for
// a corner that can reach the floor within one step, d <= h |vn| + h^2 |g|
// (the Newton matrix only: the residual keeps the exact force).
template <bool BLOCKS>
CHORD_HD void ground_contact(const Frame& E, const float* phi, const float* cp, float h,
                             float gmag, float* wrench, float Kb[6][6], float Db[6][6]) {
  const float kn = cp[3], kt = cp[4], kd = cp[5], mu = cp[6];
  const float* xg = cp + 7;
  const float* ng = cp + 10;
  const float hf = mu > 0.0f ? 1.0f : 0.0f;
  const float* w = phi;
  const float* v = phi + 3;
  float nb[3];
  rt_vec(E.R, ng, nb);
  for (int c = 0; c < 8; ++c) {
    const float r[3] = {(c & 4 ? 0.5f : -0.5f) * cp[0], (c & 2 ? 0.5f : -0.5f) * cp[1],
                        (c & 1 ? 0.5f : -0.5f) * cp[2]};
    float d = 0.0f, u[3], vw[3], a[3], fW[3], fb[3], rxf[3];
    for (int i = 0; i < 3; ++i) {
      const float xc = E.p[i] + (E.R[i][0] * r[0] + E.R[i][1] * r[1] + E.R[i][2] * r[2]);
      d = d + ng[i] * (xc - xg[i]);
    }
    const float active = d <= 0.0f ? 1.0f : 0.0f;
    cross3(w, r, u);
    for (int i = 0; i < 3; ++i) u[i] = u[i] + v[i];
    for (int i = 0; i < 3; ++i) vw[i] = E.R[i][0] * u[0] + E.R[i][1] * u[1] + E.R[i][2] * u[2];
    const float vn = ng[0] * vw[0] + ng[1] * vw[1] + ng[2] * vw[2];
    for (int i = 0; i < 3; ++i) a[i] = vw[i] - vn * ng[i];
    const float a2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
    const float flow = a2 >= 1e-24f ? 1.0f : 0.0f;
    const float anorm = sqrtf(a2 < 1e-24f ? 1e-24f : a2);
    const float ainv = 1.0f / anorm;
    const float st = mu * fabsf(kn * d) > kt * anorm ? 1.0f : 0.0f;
    const float dyn = hf * (1.0f - st) * active;
    const float sta = hf * st * active;
    for (int i = 0; i < 3; ++i)
      fW[i] = active * (-kn * d * ng[i] - kd * vn * ng[i]) + sta * (-kt * a[i]) +
              dyn * (-mu * kn * d * a[i] * ainv);
    rt_vec(E.R, fW, fb);
    cross3(r, fb, rxf);
    for (int i = 0; i < 3; ++i) {
      wrench[i] = wrench[i] + rxf[i];
      wrench[3 + i] = wrench[3 + i] + fb[i];
    }
    if constexpr (BLOCKS) {
      const float margin = h * fabsf(vn) + h * h * gmag;
      const float reach = (d - margin) <= 0.0f ? 1.0f : 0.0f;
      const float act_h = active + (1.0f - active) * reach;
      float alpha[3], pa[3], ab[3];
      for (int i = 0; i < 3; ++i)
        alpha[i] = act_h * (-kn) * ng[i] + dyn * (-mu * kn) * (a[i] * ainv);
      rt_vec(E.R, alpha, pa);
      rt_vec(E.R, a, ab);
      const float cdyn = dyn * (-mu * kn) * d * ainv;
      const float ct = sta * (-kt) + cdyn;
      const float cn = act_h * (-kd) - ct;
      const float ca = -(cdyn * flow) * (ainv * ainv);
      // LK = [hat(fb) - P hat(r) - Q hat(u) | P], LD = [-Q hat(r) | Q], row by
      // row: row i of M hat(x) is M_i x x.
      float nbxr[3], LK[3][6], LD[3][6];
      cross3(nb, r, nbxr);
      for (int i = 0; i < 3; ++i) {
        float Qi[3], Qixu[3], Qixr[3];
        for (int j = 0; j < 3; ++j)
          Qi[j] = (i == j ? ct : 0.0f) + cn * nb[i] * nb[j] + ca * ab[i] * ab[j];
        cross3(Qi, u, Qixu);
        cross3(Qi, r, Qixr);
        for (int j = 0; j < 3; ++j) {
          LK[i][j] = -pa[i] * nbxr[j] - Qixu[j];
          LK[i][3 + j] = pa[i] * nb[j];
          LD[i][j] = -Qixr[j];
          LD[i][3 + j] = Qi[j];
        }
      }
      LK[0][1] = LK[0][1] - fb[2];  // + hat(fb)
      LK[0][2] = LK[0][2] + fb[1];
      LK[1][0] = LK[1][0] + fb[2];
      LK[1][2] = LK[1][2] - fb[0];
      LK[2][0] = LK[2][0] - fb[1];
      LK[2][1] = LK[2][1] + fb[0];
      // Gamma^T L = [hat(r) L; L]: column j of hat(r) L is r x L[:, j]
      for (int j = 0; j < 6; ++j) {
        const float lk[3] = {LK[0][j], LK[1][j], LK[2][j]};
        const float ld[3] = {LD[0][j], LD[1][j], LD[2][j]};
        float rk[3], rd[3];
        cross3(r, lk, rk);
        cross3(r, ld, rd);
        for (int i = 0; i < 3; ++i) {
          Kb[i][j] = Kb[i][j] + rk[i];
          Kb[3 + i][j] = Kb[3 + i][j] + lk[i];
          Db[i][j] = Db[i][j] + rd[i];
          Db[3 + i][j] = Db[3 + i][j] + ld[i];
        }
      }
    }
  }
}

// Lane-shared inputs, unpacked from topo_i / stat_f.
template <int N, int NR>
struct Shared {
  const int* parent;
  const int* jtype;
  const int* doffs;
  const int* dofj;
  const int* anc;
  const float* E0pj;
  const float* E0ji;
  const float* Ii;
  const float* axes;
  const float* jsf;  // stiffness, damping, qrest, qlimL, qlimU, qlimK, qlimD (each [NR])
  const float* bd;
  const float* g;
  float h;
  int ncontacts;
  const int* cbody;  // [ncontacts] body of each ground contact
  const float* cp;   // [ncontacts][13]

  CHORD_HD Shared(const int* topo_i, const float* stat_f) {
    parent = topo_i;
    jtype = parent + N;
    doffs = jtype + N;
    dofj = doffs + N + 1;
    anc = dofj + NR;
    E0pj = stat_f;
    E0ji = E0pj + 16 * N;
    Ii = E0ji + 16 * N;
    axes = Ii + 6 * N;
    jsf = axes + 9 * N;
    bd = jsf + 7 * NR;
    g = bd + N;
    h = g[3];
    ncontacts = anc[N * N];
    cbody = anc + N * N + 1;
    cp = g + 4;
  }
  CHORD_HD float axis(int j, int a, int d) const { return axes[j * 9 + a * 3 + d]; }
  CHORD_HD bool is_anc(int i, int a) const { return anc[i * N + a] != 0; }
};

// Per-lane kinematics at one iterate: FK, world-column J and Jdot, twists.
template <int N, int NR>
struct Kin {
  Frame Ew[N];           // world body frames
  float J[N][NR][6];     // valid where anc(i, dofj[r])
  float Jd[N][NR][6];
  float phi[N][6];
};

// Body-frame motion subspace columns Sb[r] = Ad(inv(E0_ji)) S_j[:, d]
// (constant for these joint types).
template <int N, int NR>
CHORD_HD void static_subspace(const Shared<N, NR>& sh, float Sb[NR][6]) {
  for (int j = 0; j < N; ++j) {
    Frame E0, E0inv;
    float A0[6][6];
    frame_from_E(sh.E0ji + 16 * j, E0);
    frame_inv(E0, E0inv);
    adjoint(E0inv, A0);
    const int nd = sh.doffs[j + 1] - sh.doffs[j];
    for (int d = 0; d < nd; ++d) {
      float Sj[6];
      const bool rot = sh.jtype[j] == REVOLUTE;
      for (int a = 0; a < 3; ++a) {
        Sj[a] = rot ? sh.axis(j, a, d) : 0.0f;
        Sj[3 + a] = rot ? 0.0f : sh.axis(j, a, d);
      }
      mat6_vec(A0, Sj, Sb[sh.doffs[j] + d]);
    }
  }
}

template <int N, int NR>
CHORD_HD void fk_and_J(const Shared<N, NR>& sh, const float Sb[NR][6], const float* x,
                       const float* qd, Kin<N, NR>& K) {
  Frame Ewj[N];
  for (int j = 0; j < N; ++j) {
    Frame Q, E0, Epj;
    const int o = sh.doffs[j];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) Q.R[a][b] = a == b ? 1.0f : 0.0f;
      Q.p[a] = 0.0f;
    }
    const int jt = sh.jtype[j];
    if (jt == REVOLUTE) {
      const float c = cosf(x[o]), s = sinf(x[o]);
      const float a0 = sh.axis(j, 0, 0), a1 = sh.axis(j, 1, 0), a2 = sh.axis(j, 2, 0);
      const float omc = 1.0f - c;
      Q.R[0][0] = c + omc * a0 * a0;
      Q.R[0][1] = omc * a0 * a1 - s * a2;
      Q.R[0][2] = omc * a0 * a2 + s * a1;
      Q.R[1][0] = omc * a1 * a0 + s * a2;
      Q.R[1][1] = c + omc * a1 * a1;
      Q.R[1][2] = omc * a1 * a2 - s * a0;
      Q.R[2][0] = omc * a2 * a0 - s * a1;
      Q.R[2][1] = omc * a2 * a1 + s * a0;
      Q.R[2][2] = c + omc * a2 * a2;
    } else if (jt == PRISMATIC || jt == PLANAR || jt == TRANSLATIONAL) {
      const int nd = sh.doffs[j + 1] - o;
      for (int k = 0; k < 3; ++k) {
        float acc = sh.axis(j, k, 0) * x[o];
        for (int d = 1; d < nd; ++d) acc = acc + sh.axis(j, k, d) * x[o + d];
        Q.p[k] = acc;
      }
    }
    frame_from_E(sh.E0pj + 16 * j, E0);
    frame_mul(E0, Q, Epj);
    if (sh.parent[j] < 0)
      Ewj[j] = Epj;
    else
      frame_mul(Ewj[sh.parent[j]], Epj, Ewj[j]);
    frame_from_E(sh.E0ji + 16 * j, E0);
    frame_mul(Ewj[j], E0, K.Ew[j]);
  }

  // W[r] = Ad(E_wi[dofj[r]]) Sb[r];  J[i][r] = Ad(inv(E_wi[i])) W[r]
  float W[NR][6];
  for (int r = 0; r < NR; ++r) {
    float Awb[6][6];
    adjoint(K.Ew[sh.dofj[r]], Awb);
    mat6_vec(Awb, Sb[r], W[r]);
  }
  for (int i = 0; i < N; ++i) {
    Frame Einv;
    float Abw[6][6];
    frame_inv(K.Ew[i], Einv);
    adjoint(Einv, Abw);
    for (int r = 0; r < NR; ++r)
      if (sh.is_anc(i, sh.dofj[r])) mat6_vec(Abw, W[r], K.J[i][r]);
    for (int k = 0; k < 6; ++k) {
      float acc = 0.0f;
      for (int r = 0; r < NR; ++r)
        if (sh.is_anc(i, sh.dofj[r])) acc = acc + K.J[i][r][k] * qd[r];
      K.phi[i][k] = acc;
    }
  }
  // Wdot[r] = Ad(E_wi[a]) ad(phi_a) Sb[r]  (Sbdot = 0 for these types)
  float Wd[NR][6];
  for (int r = 0; r < NR; ++r) {
    float Awb[6][6], inner[6];
    adjoint(K.Ew[sh.dofj[r]], Awb);
    ad_vec(K.phi[sh.dofj[r]], Sb[r], inner);
    mat6_vec(Awb, inner, Wd[r]);
  }
  // Jdot[i][r] = Ad(inv(E_wi[i])) Wdot[r] - ad(phi_i) J[i][r]
  for (int i = 0; i < N; ++i) {
    Frame Einv;
    float Abw[6][6];
    frame_inv(K.Ew[i], Einv);
    adjoint(Einv, Abw);
    for (int r = 0; r < NR; ++r) {
      if (!sh.is_anc(i, sh.dofj[r])) continue;
      float t1[6], t2[6];
      mat6_vec(Abw, Wd[r], t1);
      ad_vec(K.phi[i], K.J[i][r], t2);
      for (int k = 0; k < 6; ++k) K.Jd[i][r][k] = t1[k] - t2[k];
    }
  }
}

// BDF2 inner-step history and the lane's torques.
template <int NR>
struct History {
  float q0[NR], qd0[NR], q1[NR], qd1[NR], tau[NR];
};

template <int NR>
CHORD_HD void qdot_of(const History<NR>& hs, float h, const float* x, float* qd) {
  for (int r = 0; r < NR; ++r)
    qd[r] = (1.5f / h) * (x[r] - (4.0f / 3.0f) * hs.q1[r] + (1.0f / 3.0f) * hs.q0[r]);
}

// g(x) = J^T Mm J dqtmp - ch2 (fr + J^T (fm - Mm Jdot qd)), at x with
// kinematics K (already evaluated at x).
template <int N, int NR, bool CONTACTS>
CHORD_HD void residual(const Shared<N, NR>& sh, const History<NR>& hs, const float* x,
                       const float* qd, const Kin<N, NR>& K, float* g) {
  const float h = sh.h;
  const float ch2 = (4.0f / 9.0f) * h * h;
  float dqt[NR], fr[NR];
  for (int r = 0; r < NR; ++r) {
    dqt[r] = x[r] - (4.0f / 3.0f) * hs.q1[r] + (1.0f / 3.0f) * hs.q0[r] -
             (8.0f / 9.0f) * h * hs.qd1[r] + (2.0f / 9.0f) * h * hs.qd0[r];
    const float* jsf = sh.jsf;
    float f = hs.tau[r] + jsf[r] * (jsf[2 * NR + r] - x[r]) - jsf[NR + r] * qd[r];
    const float hl = x[r] < jsf[3 * NR + r] ? 1.0f : 0.0f;
    const float hu = x[r] > jsf[4 * NR + r] ? 1.0f : 0.0f;
    f = f + hl * (jsf[5 * NR + r] * (jsf[3 * NR + r] - x[r]) - jsf[6 * NR + r] * qd[r]);
    f = f + hu * (jsf[5 * NR + r] * (jsf[4 * NR + r] - x[r]) - jsf[6 * NR + r] * qd[r]);
    fr[r] = f;
  }
  for (int r = 0; r < NR; ++r) g[r] = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float* Ii = sh.Ii + 6 * i;
    // maximal forces: ad(phi)^T (I phi) + [0; m R^T g] - bd phi
    float Iphi[6], fm[6], Rtg[3];
    for (int k = 0; k < 6; ++k) Iphi[k] = Ii[k] * K.phi[i][k];
    adT_vec(K.phi[i], Iphi, fm);
    rt_vec(K.Ew[i].R, sh.g, Rtg);
    for (int k = 0; k < 3; ++k) fm[3 + k] = fm[3 + k] + Ii[3] * Rtg[k];
    for (int k = 0; k < 6; ++k) fm[k] = fm[k] - sh.bd[i] * K.phi[i][k];
    if constexpr (CONTACTS)
      for (int c = 0; c < sh.ncontacts; ++c)
        if (sh.cbody[c] == i)
          ground_contact<false>(K.Ew[i], K.phi[i], sh.cp + 13 * c, sh.h, 0.0f, fm, nullptr,
                                nullptr);
    float Jdq[6] = {0, 0, 0, 0, 0, 0}, Jd_qd[6] = {0, 0, 0, 0, 0, 0};
    for (int r = 0; r < NR; ++r) {
      if (!sh.is_anc(i, sh.dofj[r])) continue;
      for (int k = 0; k < 6; ++k) {
        Jdq[k] = Jdq[k] + K.J[i][r][k] * dqt[r];
        Jd_qd[k] = Jd_qd[k] + K.Jd[i][r][k] * qd[r];
      }
    }
    float w[6];
    for (int k = 0; k < 6; ++k) w[k] = Ii[k] * Jdq[k] - ch2 * (fm[k] - Ii[k] * Jd_qd[k]);
    for (int r = 0; r < NR; ++r) {
      if (!sh.is_anc(i, sh.dofj[r])) continue;
      float acc = g[r];
      for (int k = 0; k < 6; ++k) acc = acc + K.J[i][r][k] * w[k];
      g[r] = acc;
    }
  }
  for (int r = 0; r < NR; ++r) g[r] = g[r] - ch2 * fr[r];
}

// Structured H = M + cK Kt + cD Dt at the iterate whose kinematics K holds.
template <int N, int NR, bool CONTACTS>
CHORD_HD void hessian(const Shared<N, NR>& sh, const float* x, const Kin<N, NR>& K,
                      float H[NR][NR]) {
  const float h = sh.h;
  const float cK = -(4.0f / 9.0f) * h * h;
  const float cD = -(2.0f / 3.0f) * h;
  for (int r = 0; r < NR; ++r)
    for (int s = 0; s < NR; ++s) H[r][s] = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float* Ii = sh.Ii + 6 * i;
    float Kb[6][6], Db[6][6];
    local_force_blocks(Ii, K.Ew[i].R, K.phi[i], sh.bd[i], sh.g, Kb, Db);
    if constexpr (CONTACTS) {
      const float gmag = sqrtf(sh.g[0] * sh.g[0] + sh.g[1] * sh.g[1] + sh.g[2] * sh.g[2]);
      for (int c = 0; c < sh.ncontacts; ++c) {
        if (sh.cbody[c] != i) continue;
        float wrench[6] = {0, 0, 0, 0, 0, 0};
        ground_contact<true>(K.Ew[i], K.phi[i], sh.cp + 13 * c, h, gmag, wrench, Kb, Db);
      }
    }
    // Column s outer, so K J_s and D J_s are 6-vectors rather than [NR][6]
    // arrays (nvcc -O3 for sm_90a computed NaN from the [NR][6] form at
    // N = NR = 12; the order of the sums into each H[r][s] is unchanged).
    for (int s = 0; s < NR; ++s) {
      if (!sh.is_anc(i, sh.dofj[s])) continue;
      const float* Js = K.J[i][s];
      const float* Jds = K.Jd[i][s];
      float KJs[6], DJs[6];
      mat6_vec(Kb, Js, KJs);
      mat6_vec(Db, Js, DJs);
      for (int r = 0; r < NR; ++r) {
        if (!sh.is_anc(i, sh.dofj[r])) continue;
        const float* Jr = K.J[i][r];
        float m_rs = 0.0f, kd = 0.0f, qvv = 0.0f;
        for (int k = 0; k < 6; ++k) {
          m_rs = m_rs + Jr[k] * Ii[k] * Js[k];
          kd = kd + Jr[k] * (cK * KJs[k] + cD * DJs[k]);
          qvv = qvv + Ii[k] * Jr[k] * Jds[k];
        }
        H[r][s] = H[r][s] + m_rs + kd + cD * (-2.0f) * qvv;
      }
    }
  }
  const float* jsf = sh.jsf;
  for (int r = 0; r < NR; ++r) {
    const float hit = (x[r] < jsf[3 * NR + r] ? 1.0f : 0.0f) + (x[r] > jsf[4 * NR + r] ? 1.0f : 0.0f);
    const float Krd = -jsf[r] - hit * jsf[5 * NR + r];
    const float Drd = -jsf[NR + r] - hit * jsf[6 * NR + r];
    H[r][r] = H[r][r] + cK * Krd + cD * Drd;
  }
}

// Unpivoted Gauss-Jordan inverse (linalg.gj_inverse, pivot=False).
template <int NR>
CHORD_HD void gj_inverse(const float H[NR][NR], float Hinv[NR][NR]) {
  float M[NR][2 * NR];
  for (int i = 0; i < NR; ++i)
    for (int j = 0; j < NR; ++j) {
      M[i][j] = H[i][j];
      M[i][NR + j] = i == j ? 1.0f : 0.0f;
    }
  for (int k = 0; k < NR; ++k) {
    const float inv_p = 1.0f / M[k][k];
    for (int j = 0; j < 2 * NR; ++j) M[k][j] = M[k][j] * inv_p;
    for (int i = 0; i < NR; ++i) {
      if (i == k) continue;
      const float fac = M[i][k];
      for (int j = 0; j < 2 * NR; ++j) M[i][j] = M[i][j] - fac * M[k][j];
    }
  }
  for (int i = 0; i < NR; ++i)
    for (int j = 0; j < NR; ++j) Hinv[i][j] = M[i][NR + j];
}

struct ChordConfig {
  int fixed_iters;
  float growth_reject;  // 0 disables
  float tol_reject;     // 0 disables
  float dx_clamp;       // 0 disables
};

// One lane's fixed-iteration chord solve (integrators.newton semantics):
// H and H^-1 at the predictor x0, then fixed_iters steps x -= H^-1 g(x),
// rejection on a non-finite result or a residual that grew.
template <int N, int NR, bool CONTACTS = true>
CHORD_HD void chord_bdf2_lane(int lane, int B, const float* x0s, const float* q0s,
                              const float* qd0s, const float* q1s, const float* qd1s,
                              const float* taus, const int* topo_i, const float* stat_f,
                              ChordConfig cfg, float* x_out, float* hinv_out) {
  const Shared<N, NR> sh(topo_i, stat_f);
  History<NR> hs;
  float x[NR], qd[NR], g[NR];
  for (int r = 0; r < NR; ++r) {
    x[r] = x0s[r * B + lane];
    hs.q0[r] = q0s[r * B + lane];
    hs.qd0[r] = qd0s[r * B + lane];
    hs.q1[r] = q1s[r * B + lane];
    hs.qd1[r] = qd1s[r * B + lane];
    hs.tau[r] = taus[r * B + lane];
  }
  float Sb[NR][6];
  static_subspace<N, NR>(sh, Sb);

  Kin<N, NR> K;
  float Hinv[NR][NR];
  {
    float H[NR][NR];
    qdot_of<NR>(hs, sh.h, x, qd);
    fk_and_J<N, NR>(sh, Sb, x, qd, K);
    hessian<N, NR, CONTACTS>(sh, x, K, H);
    gj_inverse<NR>(H, Hinv);
  }
  float g0n = 0.0f, gln = 0.0f;
  for (int it = 0; it < cfg.fixed_iters; ++it) {
    qdot_of<NR>(hs, sh.h, x, qd);
    if (it > 0) fk_and_J<N, NR>(sh, Sb, x, qd, K);  // iteration 0 reuses the predictor's
    residual<N, NR, CONTACTS>(sh, hs, x, qd, K, g);
    float gg = 0.0f;
    for (int r = 0; r < NR; ++r) gg = gg + g[r] * g[r];
    const float gn = sqrtf(gg);
    if (it == 0) g0n = gn;
    gln = gn;  // residual at the pre-update iterate
    float dx[NR];
    for (int r = 0; r < NR; ++r) {
      float acc = 0.0f;
      for (int s = 0; s < NR; ++s) acc = acc + Hinv[r][s] * g[s];
      dx[r] = acc;
    }
    if (cfg.dx_clamp != 0.0f) {
      float dd = 0.0f;
      for (int r = 0; r < NR; ++r) dd = dd + dx[r] * dx[r];
      const float scale = fminf(1.0f, cfg.dx_clamp / fmaxf(sqrtf(dd), 1e-30f));
      for (int r = 0; r < NR; ++r) dx[r] = dx[r] * scale;
    }
    for (int r = 0; r < NR; ++r) x[r] = x[r] - dx[r];
  }
  bool finite = finitef(gln);
  for (int r = 0; r < NR; ++r) finite = finite && finitef(x[r]);
  bool diverged = !finite;
  if (cfg.growth_reject != 0.0f) diverged = diverged || (gln > cfg.growth_reject * g0n);
  if (cfg.tol_reject != 0.0f) diverged = diverged || (gln > cfg.tol_reject);
  for (int r = 0; r < NR; ++r) x_out[r * B + lane] = diverged ? NAN : x[r];
  for (int r = 0; r < NR; ++r)
    for (int s = 0; s < NR; ++s) hinv_out[(r * NR + s) * B + lane] = Hinv[r][s];
}

}  // namespace chord
