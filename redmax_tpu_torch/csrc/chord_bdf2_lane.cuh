// Per-lane body of the fused BDF2 chord-Newton solve (K1a + K1b + K1c + K1d +
// K1e + K1f + K1g: constant-S joints and the q-dependent UNIVERSAL, exp-map
// SPHERICAL and FREE3D joints; penalty ground contact on cuboid corners,
// two-point springs and multi-point tension-only cables as force closures;
// unguarded chord, and the robust modes: H re-built at every iterate, the
// full / half / stay-put guard at every iteration or on the last one only;
// physical params lane-shared or per lane).
//
// Replaces the lane arithmetic of redmax_tpu/pallas_step.py::_build_kernel
// (its fk_and_J / _so3_exp_S / joint_forces / maximal_forces / _ground_contact
// / _spring_force / _point_pair_blocks / _cable_force / residual / hessian /
// add_pair / gj_inverse / fixed-iteration loop), one lane at a time. Functions are
// __host__ __device__ so g++ can compile the same body for a CPU check; the
// macros are defined empty when __CUDACC__ is absent.
//
// Layouts (all float32):
//   per-lane state  [NR, B] struct-of-arrays: element r of lane b at r*B + b
//   topo_i (int32)  parent[N] jtype[N] doffs[N+1] dofj[NR] anc[N*N]
//                   C S NCAB NPTS cbody[C] spring[4*S] cable[NCAB + NPTS]
//                   spring: kind (0 point-point, 1 spring-damper) b1 b2 tension
//                   cable: P bodies[P]
//   stat_f          E0_pj[16N] E0_ji[16N] I_i[6N] axes[9N] jsf[7*NR] bd[N] g[3] h
//                   (axes rows are zero for the q-dependent joints)
//                   cp[13*C]: per contact sides[3] kn kt kd mu xg[3] ng[3]
//                   sp[9*S]: per spring xl1[3] xl2[3] k d L (L = 0 for point-point)
//                   cb: per cable xls[3P] k d L
//   lane_f          (kPerlane builds) the per-lane record [P, B], lane-major:
//                   I_i[6N] bd[N] g[3] h cp[13*C] sp[9*S] cb[3*NPTS + 3*NCAB],
//                   P = 7N + 4 + 13C + 9S + 3 NPTS + 3 NCAB <= kMaxLaneRecord,
//                   each field in the layout of stat_f; these builds read
//                   these fields from lane_f and ignore them in stat_f
//   outputs         x [NR, B] (NaN on rejected lanes), Hinv [NR*NR, B]
// C ground contacts, contact c on body cbody[c] against the plane through xg
// with normal ng; S springs and NCAB cables of NPTS points in all (body -1: a
// world point, its xl in world coordinates). The template bitmask FEAT
// compiles in the code of each closure kind (kContacts, kSprings, kCables), of
// the q-dependent joints (kQdep), of the per-lane record (kPerlane) and of
// the robust solve modes (kRobust) only where a scene or config has it:
// closure loops that run no iteration still cost the constant-S solve
// registers and time.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#include <math.h>

namespace chord {

#define CHORD_HD __host__ __device__ __forceinline__
#ifdef __CUDACC__
#define CHORD_NO_UNROLL _Pragma("unroll 1")
#else
#define CHORD_NO_UNROLL
#endif

enum JointKind {
  FIXED = 0, REVOLUTE = 1, PRISMATIC = 2, PLANAR = 3, TRANSLATIONAL = 4,
  UNIVERSAL = 5, SPHERICAL = 6, FREE3D = 8
};

// Closure kinds, the q-dependent joints (kQdep), the per-lane physical
// params (kPerlane) and the robust solve modes (kRobust) of the FEAT bitmask;
// the longest cable a lane holds and the longest per-lane record (floats):
// 8 and 512 in the fixed builds, sized from the scene in a build made for
// one scene (-DCHORD_MAX_CABLE_POINTS, -DCHORD_MAX_RECORD).
constexpr int kContacts = 1, kSprings = 2, kCables = 4, kAllClosures = 7, kQdep = 8,
              kPerlane = 16, kRobust = 32;
#ifdef CHORD_MAX_CABLE_POINTS
constexpr int kMaxCablePoints = CHORD_MAX_CABLE_POINTS;
#else
constexpr int kMaxCablePoints = 8;
#endif
#ifdef CHORD_MAX_RECORD
constexpr int kMaxLaneRecord = CHORD_MAX_RECORD;
#else
constexpr int kMaxLaneRecord = 512;
#endif

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

// Lane-shared inputs, unpacked from topo_i / stat_f; read_lane points the
// physical params at one lane's own record instead (kPerlane builds).
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
  int ncontacts, nsprings, ncables;
  const int* cbody;  // [ncontacts] body of each ground contact
  const int* sspec;  // [nsprings][4] kind, b1, b2, tension
  const int* cspec;  // per cable P, bodies[P]
  const float* cp;   // [ncontacts][13]
  const float* sp;   // [nsprings][9]
  const float* cb;   // per cable xls[3P], k, d, L

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
    nsprings = anc[N * N + 1];
    ncables = anc[N * N + 2];
    cbody = anc + N * N + 4;
    sspec = cbody + ncontacts;
    cspec = sspec + 4 * nsprings;
    cp = g + 4;
    sp = cp + 13 * ncontacts;
    cb = sp + 9 * nsprings;
  }
  // Floats in one lane's record of lane_f (the layout above).
  CHORD_HD int lane_record_size() const {
    return 7 * N + 4 + 13 * ncontacts + 9 * nsprings + 3 * anc[N * N + 3] + 3 * ncables;
  }
  // Copy lane `lane` of the [P, B] record into rec and read Ii, bd, g, h,
  // cp, sp and cb from there: the lane arithmetic stays as it is.
  CHORD_HD void read_lane(const float* lane_f, int lane, int B, float* rec) {
    const int P = lane_record_size();
    for (int k = 0; k < P; ++k) rec[k] = lane_f[k * B + lane];
    use_record(rec);
  }
  // Read Ii, bd, g, h, cp, sp and cb from rec, one lane's record (the
  // layout of lane_f above).
  CHORD_HD void use_record(const float* rec) {
    Ii = rec;
    bd = Ii + 6 * N;
    g = bd + N;
    h = g[3];
    cp = g + 4;
    sp = cp + 13 * ncontacts;
    cb = sp + 9 * nsprings;
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

CHORD_HD bool is_qdep(int jt) { return jt == UNIVERSAL || jt == SPHERICAL || jt == FREE3D; }

// Body-frame motion subspace columns Sb[r] = Ad(inv(E0_ji)) S_j[:, d]
// (constant for these joint types). The QDEP build leaves the q-dependent
// joints' columns zero: fk_and_J fills them per iterate.
template <int N, int NR, bool QDEP = false>
CHORD_HD void static_subspace(const Shared<N, NR>& sh, float Sb[NR][6]) {
  for (int j = 0; j < N; ++j) {
    if constexpr (QDEP) {
      if (is_qdep(sh.jtype[j])) {
        for (int r = sh.doffs[j]; r < sh.doffs[j + 1]; ++r)
          for (int k = 0; k < 6; ++k) Sb[r][k] = 0.0f;
        continue;
      }
    }
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

// R = exp(hat(w)), the exp-map subspace S = Jr(w) (the SO(3) right Jacobian)
// and Sd = (dS/dw) wd, per lane (pallas_step._so3_exp_S; JointSphericalExp.m
// :49-91). With s = |w|^2, W = hat(w), t = sqrt(s):
//   R = I + c1 W + a W^2,   S = I - a W + b W^2,
//   Sd = -a' sd W - a Wd + b' sd W^2 + b (Wd W + W Wd),   sd = 2 w.wd,
// c1 = sin t / t, a = (1 - cos t)/s, b = (t - sin t)/(s t), a' = da/ds,
// b' = db/ds: even in t, each with its Taylor branch below s = 0.04. s is
// clamped at 1e-12 by a compare that keeps NaN (fmaxf would not).
CHORD_HD void so3_exp_S(const float* w, const float* wd, float R[3][3], float S[3][3],
                        float Sd[3][3]) {
  const float s = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float sg = s < 1e-12f ? 1e-12f : s;
  const float th = sqrtf(sg);
  const float sn = sinf(th), cs = cosf(th);
  const bool small = s < 0.04f;
  const float c1 = small ? 1.0f - s / 6.0f + s * s / 120.0f : sn / th;
  const float a = small ? 0.5f - s / 24.0f + s * s / 720.0f : (1.0f - cs) / sg;
  const float b = small ? 1.0f / 6.0f - s / 120.0f + s * s / 5040.0f : (th - sn) / (sg * th);
  const float ap = small ? -1.0f / 24.0f + s / 360.0f - s * s / 13440.0f
                         : (th * sn * 0.5f - (1.0f - cs)) / (sg * sg);
  const float bp = small ? -1.0f / 120.0f + s / 2520.0f - s * s / 120960.0f
                         : ((1.0f - cs) * th - 3.0f * (th - sn)) / (2.0f * sg * sg * th);
  const float sd = 2.0f * (w[0] * wd[0] + w[1] * wd[1] + w[2] * wd[2]);
  float W[3][3], Wd[3][3];
  hat(w, W);
  hat(wd, Wd);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float W2 = w[i] * w[j] - (i == j ? s : 0.0f);
      float WdW = 0.0f, WWd = 0.0f;
      for (int k = 0; k < 3; ++k) {
        WdW = WdW + Wd[i][k] * W[k][j];
        WWd = WWd + W[i][k] * Wd[k][j];
      }
      R[i][j] = eye + c1 * W[i][j] + a * W2;
      S[i][j] = eye - a * W[i][j] + b * W2;
      Sd[i][j] = -ap * sd * W[i][j] - a * Wd[i][j] + bp * sd * W2 + b * (WdW + WWd);
    }
}

// One body-frame column and its time derivative: Sb = A0 col, Sbd = A0 dcol.
CHORD_HD void put_column(const float A0[6][6], const float* col, const float* dcol, float* Sb,
                         float* Sbd) {
  mat6_vec(A0, col, Sb);
  mat6_vec(A0, dcol, Sbd);
}

// Q and the per-lane columns Sb, Sbd of a q-dependent joint j at (x, qd)
// (pallas_step fk_and_J, :907-967):
//   UNIVERSAL  R = Rx(q0) Ry(q1); S = [c1, 0, s1; 0], [ey; 0]; only column 0
//              moves, Sdot = [-s1, 0, c1; 0] qd1;
//   SPHERICAL  R, S, Sdot of so3_exp_S;
//   FREE3D     p = q[0:3], R of r = q[3:6]; translation columns [0; R^T e_d]
//              with Sdot = [0; -hat(omega_b) R^T e_d], omega_b = Jr rdot;
//              rotation columns those of SPHERICAL.
template <int N, int NR>
CHORD_HD void qdep_joint(const Shared<N, NR>& sh, int j, const float* x, const float* qd,
                         Frame& Q, float Sb[NR][6], float Sbd[NR][6]) {
  const int o = sh.doffs[j];
  const int jt = sh.jtype[j];
  Frame E0, E0inv;
  float A0[6][6];
  frame_from_E(sh.E0ji + 16 * j, E0);
  frame_inv(E0, E0inv);
  adjoint(E0inv, A0);
  if (jt == UNIVERSAL) {
    const float c0 = cosf(x[o]), s0 = sinf(x[o]);
    const float c1 = cosf(x[o + 1]), s1 = sinf(x[o + 1]);
    const float R[3][3] = {{c1, 0.0f, s1}, {s0 * s1, c0, -s0 * c1}, {-c0 * s1, s0, c0 * c1}};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) Q.R[a][b] = R[a][b];
    const float qd1 = qd[o + 1];
    const float col0[6] = {c1, 0.0f, s1, 0.0f, 0.0f, 0.0f};
    const float dcol0[6] = {-s1 * qd1, 0.0f, c1 * qd1, 0.0f, 0.0f, 0.0f};
    const float col1[6] = {0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float zero[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    put_column(A0, col0, dcol0, Sb[o], Sbd[o]);
    put_column(A0, col1, zero, Sb[o + 1], Sbd[o + 1]);
    return;
  }
  const int ro = jt == FREE3D ? o + 3 : o;  // the rotation's DOFs
  float S3[3][3], S3d[3][3];
  so3_exp_S(x + ro, qd + ro, Q.R, S3, S3d);
  for (int d = 0; d < 3; ++d) {
    const float col[6] = {S3[0][d], S3[1][d], S3[2][d], 0.0f, 0.0f, 0.0f};
    const float dcol[6] = {S3d[0][d], S3d[1][d], S3d[2][d], 0.0f, 0.0f, 0.0f};
    put_column(A0, col, dcol, Sb[ro + d], Sbd[ro + d]);
  }
  if (jt == FREE3D) {
    float om[3], Rte[3], omxR[3];
    for (int i = 0; i < 3; ++i)
      om[i] = S3[i][0] * qd[ro] + S3[i][1] * qd[ro + 1] + S3[i][2] * qd[ro + 2];
    for (int d = 0; d < 3; ++d) {
      for (int i = 0; i < 3; ++i) Rte[i] = Q.R[d][i];  // R^T e_d
      cross3(om, Rte, omxR);
      const float col[6] = {0.0f, 0.0f, 0.0f, Rte[0], Rte[1], Rte[2]};
      const float dcol[6] = {0.0f, 0.0f, 0.0f, -omxR[0], -omxR[1], -omxR[2]};
      put_column(A0, col, dcol, Sb[o + d], Sbd[o + d]);
      Q.p[d] = x[o + d];
    }
  }
}

// FK, the world-column J and Jdot and the body twists at (x, qd). The QDEP
// build fills the q-dependent joints' columns Sb and their derivatives Sbd
// per iterate (Sbd is zero on the constant-S columns and unused elsewhere).
template <int N, int NR, bool QDEP = false>
CHORD_HD void fk_and_J(const Shared<N, NR>& sh, float Sb[NR][6], float (*Sbd)[6],
                       const float* x, const float* qd, Kin<N, NR>& K) {
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
    if constexpr (QDEP) {
      if (is_qdep(jt)) qdep_joint<N, NR>(sh, j, x, qd, Q, Sb, Sbd);
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
  // Wdot[r] = Ad(E_wi[a]) (ad(phi_a) Sb[r] + Sbd[r])  (Sbd = 0 without QDEP)
  float Wd[NR][6];
  for (int r = 0; r < NR; ++r) {
    float Awb[6][6], inner[6];
    adjoint(K.Ew[sh.dofj[r]], Awb);
    ad_vec(K.phi[sh.dofj[r]], Sb[r], inner);
    if constexpr (QDEP)
      for (int k = 0; k < 6; ++k) inner[k] = inner[k] + Sbd[r][k];
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

// A point of a spring or cable closure at one iterate: body b (-1: a world
// point, r then in world coordinates), body-frame point r, world position x
// and velocity v, body-frame velocity u = w x r + v (pallas_step's
// point_state). A world point has v = u = 0 and takes no wrench and no block.
struct Point {
  int b;
  float r[3], x[3], v[3], u[3];
};

template <int N, int NR>
CHORD_HD void point_state(const Kin<N, NR>& K, int b, const float* r, Point& P) {
  P.b = b;
  for (int i = 0; i < 3; ++i) {
    P.r[i] = r[i];
    P.x[i] = r[i];
    P.v[i] = 0.0f;
    P.u[i] = 0.0f;
  }
  if (b < 0) return;
  const Frame& E = K.Ew[b];
  const float* phi = K.phi[b];
  cross3(phi, r, P.u);
  for (int i = 0; i < 3; ++i) P.u[i] = P.u[i] + phi[3 + i];
  for (int i = 0; i < 3; ++i) {
    P.x[i] = E.p[i] + (E.R[i][0] * r[0] + E.R[i][1] * r[1] + E.R[i][2] * r[2]);
    P.v[i] = E.R[i][0] * P.u[0] + E.R[i][1] * P.u[1] + E.R[i][2] * P.u[2];
  }
}

// wrench[6] += [r x fb; fb] of the world force F at body point r, fb = R^T F.
CHORD_HD void add_point_wrench(const Frame& E, const float* r, const float* F, float* wrench) {
  float fb[3], rxf[3];
  rt_vec(E.R, F, fb);
  cross3(r, fb, rxf);
  for (int i = 0; i < 3; ++i) {
    wrench[i] = wrench[i] + rxf[i];
    wrench[3 + i] = wrench[3 + i] + fb[i];
  }
}

// Two-point spring (pallas_step._spring_force; ForcePointPoint.m:48-141,
// ForceSpringGeneric.m:37-83 + ForceSpringDamper.m:62-72): the world force
// fW on point 1 (-fW on point 2) from dx = x2 - x1, dv = v2 - v1,
//   point-point (kind 0):   fW = k dx + d dv
//   spring-damper (kind 1): l = |dx|, ldot = dx.dv / l,
//                           fW = gate (k (l - L)/L + d ldot/L) dx / l
// with gate = (l > L) when tension-only, else 1: a 0/1 mask that multiplies,
// so a NaN length gives a NaN force. l = sqrt(max(l^2, 1e-24)) by a compare
// that keeps NaN. BLOCKS also gives A = dfW/d(dx), Bm = dfW/d(dv) (world 3x3).
template <bool BLOCKS>
CHORD_HD void spring_force(const Point& p1, const Point& p2, const float* sp, int kind,
                           int tension, float* fW, float A[3][3], float Bm[3][3]) {
  const float k = sp[6], d = sp[7], L = sp[8];
  float dx[3], dv[3];
  for (int i = 0; i < 3; ++i) {
    dx[i] = p2.x[i] - p1.x[i];
    dv[i] = p2.v[i] - p1.v[i];
  }
  if (kind == 0) {
    for (int i = 0; i < 3; ++i) fW[i] = k * dx[i] + d * dv[i];
    if constexpr (BLOCKS)
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          A[i][j] = i == j ? k : 0.0f;
          Bm[i][j] = i == j ? d : 0.0f;
        }
    return;
  }
  const float l2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
  const float l = sqrtf(l2 < 1e-24f ? 1e-24f : l2);
  const float linv = 1.0f / l;
  float e[3];
  for (int i = 0; i < 3; ++i) e[i] = dx[i] * linv;
  const float ldot = (dx[0] * dv[0] + dx[1] * dv[1] + dx[2] * dv[2]) * linv;
  const float fs = k * (l - L) / L + d * ldot / L;
  const float gate = tension ? (l > L ? 1.0f : 0.0f) : 1.0f;
  for (int i = 0; i < 3; ++i) fW[i] = gate * fs * linv * dx[i];
  if constexpr (BLOCKS) {
    float dfs[3];
    for (int i = 0; i < 3; ++i) dfs[i] = (k / L) * e[i] + (d / L) * (dv[i] - ldot * e[i]) * linv;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        A[i][j] = gate * (fs * linv * ((i == j ? 1.0f : 0.0f) - e[i] * e[j]) + e[i] * dfs[j]);
        Bm[i][j] = gate * (d / L) * e[i] * e[j];
      }
  }
}

// G = cK K + cD D for the wrench of body point j against the perturbation
// of body point i (pallas_step._point_pair_blocks): with P = coef Rj^T A Ri,
// Q = coef Rj^T Bm Ri (A = dF_j/dx_i, Bm = dF_j/dv_i, world 3x3),
//   K = Gamma_j^T [same hat(fbj) - P hat(ri) - Q hat(ui) | P]
//   D = Gamma_j^T [-Q hat(ri) | Q],   Gamma_j^T = [hat(rj); I],
// built as Gamma_j^T [cK ML + cD DL | cK P + cD Q] one 3x6 row block at a
// time (row a of M hat(x) is M_a x x).
CHORD_HD void pair_block(const Frame& Ej, const Point& pj, const float* fbj, const Frame& Ei,
                         const Point& pi, const float A[3][3], const float Bm[3][3], float coef,
                         bool same, float cK, float cD, float G[6][6]) {
  float L[3][6];
  for (int a = 0; a < 3; ++a) {
    // row a of P and Q: coef (Rj^T)_a A Ri = coef (sum_k Rj[k][a] A[k]) Ri
    float ra[3], rb[3], P[3], Q[3], Pxr[3], Qxr[3], Qxu[3];
    for (int m = 0; m < 3; ++m) {
      ra[m] = coef * (Ej.R[0][a] * A[0][m] + Ej.R[1][a] * A[1][m] + Ej.R[2][a] * A[2][m]);
      rb[m] = coef * (Ej.R[0][a] * Bm[0][m] + Ej.R[1][a] * Bm[1][m] + Ej.R[2][a] * Bm[2][m]);
    }
    for (int m = 0; m < 3; ++m) {
      P[m] = ra[0] * Ei.R[0][m] + ra[1] * Ei.R[1][m] + ra[2] * Ei.R[2][m];
      Q[m] = rb[0] * Ei.R[0][m] + rb[1] * Ei.R[1][m] + rb[2] * Ei.R[2][m];
    }
    cross3(P, pi.r, Pxr);
    cross3(Q, pi.r, Qxr);
    cross3(Q, pi.u, Qxu);
    for (int m = 0; m < 3; ++m) {
      L[a][m] = cK * (-Pxr[m] - Qxu[m]) + cD * (-Qxr[m]);
      L[a][3 + m] = cK * P[m] + cD * Q[m];
    }
  }
  if (same) {  // + cK hat(fbj)
    L[0][1] = L[0][1] - cK * fbj[2];
    L[0][2] = L[0][2] + cK * fbj[1];
    L[1][0] = L[1][0] + cK * fbj[2];
    L[1][2] = L[1][2] - cK * fbj[0];
    L[2][0] = L[2][0] - cK * fbj[1];
    L[2][1] = L[2][1] + cK * fbj[0];
  }
  for (int m = 0; m < 6; ++m) {
    const float col[3] = {L[0][m], L[1][m], L[2][m]};
    float rc[3];
    cross3(pj.r, col, rc);
    for (int a = 0; a < 3; ++a) {
      G[a][m] = rc[a];
      G[3 + a][m] = col[a];
    }
  }
}

// H[r][s] += J_b[r] . (G J_c[s]) over the columns of bodies b and c
// (pallas_step's add_pair), column s outermost with 6-vector temporaries, as
// in hessian().
template <int N, int NR>
CHORD_HD void add_pair(const Shared<N, NR>& sh, const Kin<N, NR>& K, int b, int c,
                       const float G[6][6], float H[NR][NR]) {
  for (int s = 0; s < NR; ++s) {
    if (!sh.is_anc(c, sh.dofj[s])) continue;
    float GJs[6];
    mat6_vec(G, K.J[c][s], GJs);
    for (int r = 0; r < NR; ++r) {
      if (!sh.is_anc(b, sh.dofj[r])) continue;
      float acc = 0.0f;
      for (int k = 0; k < 6; ++k) acc = acc + K.J[b][r][k] * GJs[k];
      H[r][s] = H[r][s] + acc;
    }
  }
}

// Every spring's wrenches into fcl (residual) or its pairwise blocks into H
// (hessian): for endpoints e, f on bodies, dF_e/dx_f = s_e sig_f A with the
// application signs s = (+1, -1) and the dx signs sig = (-1, +1).
template <int N, int NR, bool BLOCKS>
CHORD_HD void springs(const Shared<N, NR>& sh, const Kin<N, NR>& K, float fcl[N][6],
                      float cK, float cD, float H[NR][NR]) {
  for (int s = 0; s < sh.nsprings; ++s) {
    const int* spec = sh.sspec + 4 * s;
    const float* sp = sh.sp + 9 * s;
    Point p[2];
    point_state<N, NR>(K, spec[1], sp, p[0]);
    point_state<N, NR>(K, spec[2], sp + 3, p[1]);
    float fW[3], A[3][3], Bm[3][3];
    spring_force<BLOCKS>(p[0], p[1], sp, spec[0], spec[3], fW, A, Bm);
    for (int e = 0; e < 2; ++e) {
      if (p[e].b < 0) continue;
      const float se = e == 0 ? 1.0f : -1.0f;
      const float F[3] = {se * fW[0], se * fW[1], se * fW[2]};
      if constexpr (!BLOCKS) {
        add_point_wrench(K.Ew[p[e].b], p[e].r, F, fcl[p[e].b]);
      } else {
        float fb[3];
        rt_vec(K.Ew[p[e].b].R, F, fb);
        for (int f = 0; f < 2; ++f) {
          if (p[f].b < 0) continue;
          float G[6][6];
          pair_block(K.Ew[p[e].b], p[e], fb, K.Ew[p[f].b], p[f], A, Bm,
                     se * (f == 0 ? -1.0f : 1.0f), e == f, cK, cD, G);
          add_pair<N, NR>(sh, K, p[e].b, p[f].b, G, H);
        }
      }
    }
  }
}

// Every cable (pallas_step._cable_force; ForceCable.m:66-84,
// ForceSpringMultiPointGeneric.m:28-95): segments s with u_s = dx_s / l_s,
// l = sum l_s, ldot = sum u_s . dv_s, one tension
// fs = gate (k (l - L)/L + d ldot/L), gate = (l > L), and point j takes
// F_j = fs c_j, c_j = u_j [j < P-1] - u_{j-1} [j > 0]. BLOCKS adds, for every
// pair of points (j, i) on bodies,
//   A = dF_j/dx_i = c_j a_i^T + fs D_ji,   Bm = dF_j/dv_i = -gate (d/L) c_j c_i^T,
//   a_i = gate (-(k/L) c_i + (d/L) (Pm_{i-1} dv_{i-1}/l_{i-1} - Pm_i dv_i/l_i)),
//   D_ji = (Pm_j/l_j)(d_{i,j+1} - d_{i,j}) - (Pm_{j-1}/l_{j-1})(d_{i,j} - d_{i,j-1}),
// Pm_s = I - u_s u_s^T (terms with a segment index outside 0..P-2 drop out).
template <int N, int NR, bool BLOCKS>
CHORD_HD void cables(const Shared<N, NR>& sh, const Kin<N, NR>& K, float fcl[N][6],
                     float cK, float cD, float H[NR][NR]) {
  const int* spec = sh.cspec;
  const float* cb = sh.cb;
  for (int ci = 0; ci < sh.ncables; ++ci) {
    const int P = spec[0];
    const int* bodies = spec + 1;
    const float k = cb[3 * P], d = cb[3 * P + 1], L = cb[3 * P + 2];
    Point pt[kMaxCablePoints];
    for (int j = 0; j < P; ++j) point_state<N, NR>(K, bodies[j], cb + 3 * j, pt[j]);
    float u[kMaxCablePoints][3], dv[kMaxCablePoints][3], linv[kMaxCablePoints];
    float l = 0.0f, ldot = 0.0f;
    for (int s = 0; s + 1 < P; ++s) {
      float dx[3];
      for (int i = 0; i < 3; ++i) {
        dx[i] = pt[s + 1].x[i] - pt[s].x[i];
        dv[s][i] = pt[s + 1].v[i] - pt[s].v[i];
      }
      const float l2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
      const float ls = sqrtf(l2 < 1e-24f ? 1e-24f : l2);
      linv[s] = 1.0f / ls;
      for (int i = 0; i < 3; ++i) u[s][i] = dx[i] * linv[s];
      l = l + ls;
      ldot = ldot + (u[s][0] * dv[s][0] + u[s][1] * dv[s][1] + u[s][2] * dv[s][2]);
    }
    const float gate = l > L ? 1.0f : 0.0f;
    const float fs = gate * (k * (l - L) / L + d * ldot / L);
    float c[kMaxCablePoints][3];
    for (int j = 0; j < P; ++j)
      for (int i = 0; i < 3; ++i)
        c[j][i] = (j < P - 1 ? u[j][i] : 0.0f) - (j > 0 ? u[j - 1][i] : 0.0f);
    if constexpr (!BLOCKS) {
      for (int j = 0; j < P; ++j) {
        if (pt[j].b < 0) continue;
        const float F[3] = {fs * c[j][0], fs * c[j][1], fs * c[j][2]};
        add_point_wrench(K.Ew[pt[j].b], pt[j].r, F, fcl[pt[j].b]);
      }
    } else {
      // w_s = Pm_s dv_s / l_s, then a_i
      float w[kMaxCablePoints][3], a[kMaxCablePoints][3];
      for (int s = 0; s + 1 < P; ++s) {
        const float ud = u[s][0] * dv[s][0] + u[s][1] * dv[s][1] + u[s][2] * dv[s][2];
        for (int i = 0; i < 3; ++i) w[s][i] = (dv[s][i] - u[s][i] * ud) * linv[s];
      }
      for (int j = 0; j < P; ++j)
        for (int i = 0; i < 3; ++i) {
          float ai = -gate * (k / L) * c[j][i];
          if (j > 0) ai = ai + gate * (d / L) * w[j - 1][i];
          if (j < P - 1) ai = ai - gate * (d / L) * w[j][i];
          a[j][i] = ai;
        }
      for (int j = 0; j < P; ++j) {
        if (pt[j].b < 0) continue;
        const float F[3] = {fs * c[j][0], fs * c[j][1], fs * c[j][2]};
        float fb[3];
        rt_vec(K.Ew[pt[j].b].R, F, fb);
        for (int i = 0; i < P; ++i) {
          if (pt[i].b < 0) continue;
          // D_ji = t1 Pm_j - t2 Pm_{j-1}
          const float t1 = j < P - 1 ? ((i == j + 1 ? 1.0f : 0.0f) - (i == j ? 1.0f : 0.0f)) * linv[j]
                                     : 0.0f;
          const float t2 = j > 0 ? ((i == j ? 1.0f : 0.0f) - (i == j - 1 ? 1.0f : 0.0f)) * linv[j - 1]
                                 : 0.0f;
          float A[3][3], Bm[3][3];
          for (int m = 0; m < 3; ++m)
            for (int n = 0; n < 3; ++n) {
              const float I = m == n ? 1.0f : 0.0f;
              float Dmn = 0.0f;
              if (j < P - 1) Dmn = Dmn + t1 * (I - u[j][m] * u[j][n]);
              if (j > 0) Dmn = Dmn - t2 * (I - u[j - 1][m] * u[j - 1][n]);
              A[m][n] = c[j][m] * a[i][n] + fs * Dmn;
              Bm[m][n] = -gate * (d / L) * c[j][m] * c[i][n];
            }
          float G[6][6];
          pair_block(K.Ew[pt[j].b], pt[j], fb, K.Ew[pt[i].b], pt[i], A, Bm, 1.0f, i == j, cK,
                     cD, G);
          add_pair<N, NR>(sh, K, pt[j].b, pt[i].b, G, H);
        }
      }
    }
    spec = spec + 1 + P;
    cb = cb + 3 * P + 3;
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
// kinematics K (already evaluated at x). The springs' and cables' wrenches are
// gathered per body in fcl once, before the body loop.
template <int N, int NR, int FEAT>
CHORD_HD void residual(const Shared<N, NR>& sh, const History<NR>& hs, const float* x,
                       const float* qd, const Kin<N, NR>& K, float* g) {
  constexpr bool CONTACTS = (FEAT & kContacts) != 0;
  constexpr bool PAIRS = (FEAT & (kSprings | kCables)) != 0;
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
  float fcl[PAIRS ? N : 1][6];
  if constexpr (PAIRS) {
    for (int i = 0; i < N; ++i)
      for (int k = 0; k < 6; ++k) fcl[i][k] = 0.0f;
    if constexpr ((FEAT & kSprings) != 0) springs<N, NR, false>(sh, K, fcl, 0.0f, 0.0f, nullptr);
    if constexpr ((FEAT & kCables) != 0) cables<N, NR, false>(sh, K, fcl, 0.0f, 0.0f, nullptr);
  }
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
    if constexpr (PAIRS)
      for (int k = 0; k < 6; ++k) fm[k] = fm[k] + fcl[i][k];
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

// Structured H = M + cK Kt + cD Dt at the iterate whose kinematics K holds;
// the springs' and cables' pairwise blocks after the per-body loop, one
// (b, c) block at a time.
template <int N, int NR, int FEAT>
CHORD_HD void hessian(const Shared<N, NR>& sh, const float* x, const Kin<N, NR>& K,
                      float H[NR][NR]) {
  constexpr bool CONTACTS = (FEAT & kContacts) != 0;
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
  if constexpr ((FEAT & kSprings) != 0) springs<N, NR, true>(sh, K, nullptr, cK, cD, H);
  if constexpr ((FEAT & kCables) != 0) cables<N, NR, true>(sh, K, nullptr, cK, cD, H);
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

// The solve mode a kRobust build reads (integrators.NewtonConfig's flags):
// guarded, guard_last (chord only, unguarded otherwise), chord (0: H re-built
// at every iterate). Builds without kRobust run unguarded chord and ignore it.
struct RobustConfig {
  int guarded;
  int guard_last;
  int chord;
};

template <int NR>
CHORD_HD float norm_of(const float* v) {
  float vv = 0.0f;
  for (int r = 0; r < NR; ++r) vv = vv + v[r] * v[r];
  return sqrtf(vv);
}

// dx = Hinv g, scaled to |dx| <= dx_clamp where the clamp is on.
template <int NR>
CHORD_HD void newton_step(const float Hinv[NR][NR], const float* g, float dx_clamp, float* dx) {
  for (int r = 0; r < NR; ++r) {
    float acc = 0.0f;
    for (int s = 0; s < NR; ++s) acc = acc + Hinv[r][s] * g[s];
    dx[r] = acc;
  }
  if (dx_clamp != 0.0f) {
    float dd = 0.0f;
    for (int r = 0; r < NR; ++r) dd = dd + dx[r] * dx[r];
    const float scale = fminf(1.0f, dx_clamp / fmaxf(sqrtf(dd), 1e-30f));
    for (int r = 0; r < NR; ++r) dx[r] = dx[r] * scale;
  }
}

// The joints' static motion subspaces Sb, and Sbd (d/dt of the q-dependent
// ones, which fk_and_J fills) zeroed.
template <int N, int NR, bool QDEP>
CHORD_HD void subspaces(const Shared<N, NR>& sh, float Sb[NR][6], float (*Sbd)[6]) {
  static_subspace<N, NR, QDEP>(sh, Sb);
  if constexpr (QDEP)
    for (int r = 0; r < NR; ++r)
      for (int k = 0; k < 6; ++k) Sbd[r][k] = 0.0f;
}

// One lane's fixed-iteration chord solve (integrators.newton semantics):
// H and H^-1 at the predictor x0, then fixed_iters steps x -= H^-1 g(x),
// rejection on a non-finite result or a residual that grew. A kPerlane build
// reads the lane's physical params from lane_f (unused otherwise).
template <int N, int NR, int FEAT = kAllClosures>
CHORD_HD void chord_bdf2_lane(int lane, int B, const float* x0s, const float* q0s,
                              const float* qd0s, const float* q1s, const float* qd1s,
                              const float* taus, const int* topo_i, const float* stat_f,
                              ChordConfig cfg, float* x_out, float* hinv_out,
                              const float* lane_f = nullptr) {
  constexpr bool QDEP = (FEAT & kQdep) != 0;
  constexpr bool PERLANE = (FEAT & kPerlane) != 0;
  Shared<N, NR> sh(topo_i, stat_f);
  float rec[PERLANE ? kMaxLaneRecord : 1];
  if constexpr (PERLANE)
    sh.read_lane(lane_f, lane, B, rec);
  else
    (void)rec;
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
  float Sbd[QDEP ? NR : 1][6];
  subspaces<N, NR, QDEP>(sh, Sb, Sbd);

  Kin<N, NR> K;
  float Hinv[NR][NR];
  {
    float H[NR][NR];
    qdot_of<NR>(hs, sh.h, x, qd);
    fk_and_J<N, NR, QDEP>(sh, Sb, Sbd, x, qd, K);
    hessian<N, NR, FEAT>(sh, x, K, H);
    gj_inverse<NR>(H, Hinv);
  }
  float g0n = 0.0f, gln = 0.0f;
  for (int it = 0; it < cfg.fixed_iters; ++it) {
    qdot_of<NR>(hs, sh.h, x, qd);
    if (it > 0) fk_and_J<N, NR, QDEP>(sh, Sb, Sbd, x, qd, K);  // iteration 0: the predictor's
    residual<N, NR, FEAT>(sh, hs, x, qd, K, g);
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

// The same solve in the mode rc names (the kRobust builds; integrators.newton
// semantics; a kPerlane build reads the lane's physical params from lane_f,
// as chord_bdf2_lane does): chord=False re-builds H and H^-1 at every iterate; a guarded
// iteration (every one, or with guard_last the last one only) takes the full
// step if |g| did not grow there, else the half step if it did not grow
// there, else stays put (a non-finite trial compares false, so it counts as
// grown), and carries the accepted iterate's g and |g|. A lane that stayed
// put is rejected when its solve never halved |g|. The loops are written so
// that FK, the residual, H and GJ each have one call site: nvcc inlines every
// site, and the sites of a loop over the trials would otherwise multiply the
// build's code and compile time. The lane load and the rejection repeat
// chord_bdf2_lane's: as helpers of both, any one of them moved the
// <4,4,contacts> build from 242 to 240 registers under nvcc -O3.
template <int N, int NR, int FEAT>
CHORD_HD void chord_bdf2_lane_robust(int lane, int B, const float* x0s, const float* q0s,
                                     const float* qd0s, const float* q1s, const float* qd1s,
                                     const float* taus, const int* topo_i, const float* stat_f,
                                     ChordConfig cfg, RobustConfig rc, float* x_out,
                                     float* hinv_out, const float* lane_f = nullptr) {
  constexpr bool QDEP = (FEAT & kQdep) != 0;
  constexpr bool PERLANE = (FEAT & kPerlane) != 0;
  static_assert((FEAT & kRobust) != 0, "the robust solve runs in the kRobust builds");
  Shared<N, NR> sh(topo_i, stat_f);
  float rec[PERLANE ? kMaxLaneRecord : 1];
  if constexpr (PERLANE)
    sh.read_lane(lane_f, lane, B, rec);
  else
    (void)rec, (void)lane_f;
  History<NR> hs;
  float x[NR], g[NR];
  for (int r = 0; r < NR; ++r) {
    x[r] = x0s[r * B + lane];
    hs.q0[r] = q0s[r * B + lane];
    hs.qd0[r] = qd0s[r * B + lane];
    hs.q1[r] = q1s[r * B + lane];
    hs.qd1[r] = qd1s[r * B + lane];
    hs.tau[r] = taus[r * B + lane];
  }
  float Sb[NR][6];
  float Sbd[QDEP ? NR : 1][6];
  subspaces<N, NR, QDEP>(sh, Sb, Sbd);

  Kin<N, NR> K;
  float Hinv[NR][NR], dx[NR], xt[2][NR], gt[2][NR], gtn[2];
  float g0n = 0.0f, gln = 0.0f, gn = 0.0f;
  bool have_g = false, stayput = false;
  CHORD_NO_UNROLL
  for (int it = 0; it < cfg.fixed_iters; ++it) {
    const bool guard = rc.guarded != 0 || (rc.guard_last != 0 && it == cfg.fixed_iters - 1);
    const bool rebuild = it == 0 || rc.chord == 0;  // H at the predictor, or at every iterate
    // e = 0: the kinematics at x, g there unless an accepted trial carried
    // it, and H^-1 there where it is rebuilt; e = 1, 2: the full and the
    // half trial of a guarded iteration
    CHORD_NO_UNROLL
    for (int e = have_g && !rebuild ? 1 : 0; e < (guard ? 3 : 1); ++e) {
      if (e == 1) newton_step<NR>(Hinv, g, cfg.dx_clamp, dx);
      float* xe = e == 0 ? x : xt[e - 1];
      float* ge = e == 0 ? g : gt[e - 1];
      if (e > 0)
        for (int r = 0; r < NR; ++r) xe[r] = x[r] - (e == 1 ? dx[r] : 0.5f * dx[r]);
      float qd[NR];
      qdot_of<NR>(hs, sh.h, xe, qd);
      fk_and_J<N, NR, QDEP>(sh, Sb, Sbd, xe, qd, K);
      if (e > 0 || !have_g) {
        residual<N, NR, FEAT>(sh, hs, xe, qd, K, ge);
        const float n = norm_of<NR>(ge);
        if (e > 0) {
          gtn[e - 1] = n;
          continue;
        }
        gn = n;
      }
      if (rebuild) {
        float H[NR][NR];
        hessian<N, NR, FEAT>(sh, x, K, H);
        gj_inverse<NR>(H, Hinv);
      }
    }
    if (it == 0) g0n = gn;
    if (!guard) {
      newton_step<NR>(Hinv, g, cfg.dx_clamp, dx);
      gln = gn;  // residual at the pre-update iterate
      for (int r = 0; r < NR; ++r) x[r] = x[r] - dx[r];
      have_g = false;
      continue;
    }
    const int pick = gtn[0] <= gn ? 0 : (gtn[1] <= gn ? 1 : -1);
    if (pick >= 0) {
      for (int r = 0; r < NR; ++r) {
        x[r] = xt[pick][r];
        g[r] = gt[pick][r];
      }
      gn = gtn[pick];
    } else {
      stayput = true;
    }
    gln = gn;  // g tracks the accepted iterate
    have_g = true;
  }
  bool finite = finitef(gln);
  for (int r = 0; r < NR; ++r) finite = finite && finitef(x[r]);
  bool diverged = !finite || (stayput && gln > 0.5f * g0n);
  if (cfg.growth_reject != 0.0f) diverged = diverged || (gln > cfg.growth_reject * g0n);
  if (cfg.tol_reject != 0.0f) diverged = diverged || (gln > cfg.tol_reject);
  for (int r = 0; r < NR; ++r) x_out[r * B + lane] = diverged ? NAN : x[r];
  for (int r = 0; r < NR; ++r)
    for (int s = 0; s < NR; ++s) hinv_out[(r * NR + s) * B + lane] = Hinv[r][s];
}

}  // namespace chord
