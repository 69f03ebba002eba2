// Cooperative body of the residual VJP of the chord route's adjoint backward:
// one warp per lane, the lane's record in shared memory, as in
// chord_bdf2_coop.cuh, whose phases (setup, setup_pairs, the kinematics:
// joints, FK, J, the twists, Wdot; not Jdot, which the VJP does not read) and
// helpers (local_force_blocks, ground_contact, nth_contact, adT_vec) it calls
// as they are.
//
// Replaces no TPU kernel: the JAX package takes this VJP with jax.vjp of the
// op-level residual (redmax_tpu/integrators.py:867-868), and the port took it
// with torch.autograd.grad through residual_bdf2 (model.assemble at 32768
// lanes: small batched GEMMs). For the BDF2 residual
//   g(q2) = M(q2) dq - c f(q2, v),  v = (3/(2h)) (q2 - 4/3 q1 + 1/3 q0),
//   dq = q2 - 4/3 q1 + 1/3 q0 - 8/9 h qd1 + 2/9 h qd0,  c = 4/9 h^2,
// taken at the fixed solution q2 with the cotangent w = -z, z = H^-T xbar,
// no cotangent reaches the kinematics (they read q2 alone), so the VJP is two
// products a lane, a = M(q2) w and b = (df/dv)^T w at (q2, v), and
//   tau_bar = -c w,  q0_bar = a/3 - 2/9 h b,  qd0_bar = 2/9 h a,
//   q1_bar = -4/3 a + 8/9 h b,  qd1_bar = -8/9 h a.
// With u_i = J_i w, y_i = I_i u_i and Dm_i the exact per-body derivative of
// the Coriolis, body-damping and ground-contact wrench by phi_i:
//   a_r = sum_i J_ir . y_i,
//   b_r = Dr_r w_r + sum_i J_ir . Dm_i^T u_i - d/dv_r [sum_i y_i . Jdot_i(v) v].
// The last term, in world-frame columns (Jdot_i v = Ad(inv E_wi) sum_r v_r
// Wdot_r, Wdot_r = ad(Phi_a) W_r, Phi_a = sum over the columns s that move
// body a of v_s W_s, a = dofj[r]), with z_r = sum over the bodies i that
// column r moves of Ad(inv E_wi)^T y_i:
//   d/dv_r = z_r . Wdot_r - W_r . sum over the columns r' whose body column
//            r moves of v_r' ad(W_r')^T z_r'
// (both slots of the bilinear Jdot(v) v differentiated). The masks are frozen
// where autograd freezes them: the joint-limit hit, the contacts' active,
// static, dynamic and flow; the contact's D block has no proximity margin
// (ground_contact with h = 0: the exact D, where the Newton matrix's adds the
// normal terms of corners within a step's reach). The Newton matrix's D~
// approximates the quadratic-velocity term by -2 J^T Mm Jdot, which is not
// the derivative, so the chord kernel's H cannot stand in for it.
//
// What bounds it on an H100: per-lane f32 arithmetic, the kinematics of one
// iterate (as one of the chord solve's) plus the per-body D blocks, about
// 5e4 flops a lane (1e5 with a contact on every link), against about 1.1 KB
// in and out (the five [B, NR] states, xbar, the forward's H^-1 on the
// "reuse" backward, the five cotangents). The phases, each split over the
// warp's 32 threads with __syncwarp() between them:
//   gather     per (input, column): the lane's q2, q0, qd0, q1, qd1 and xbar,
//              each read with its own strides (the tensors autograd holds)
//   setup      setup's (the column masks, contacts, Sb, the history from the
//              gathered rows); per column: w = -z, z = H^-T xbar from the
//              forward's H^-1, or xbar itself where it is z already
//   pairs      setup_pairs's
//   kinematics at q2 with v: joints, FK, J, the twists, Wdot
//   bodies     per body: u = J w, y = I u, Dm^T u (local_force_blocks and the
//              body's ground contacts with h = 0), Ad(inv E_wi)^T y
//   columns    per column: a, J^T Dm^T u, z_r . Wdot_r, v_r ad(W_r)^T z_r
//   out        per column: b, then the five cotangents into [5, B, NR].
// Each phase reads only what earlier phases wrote, so g++ runs them on the CPU
// one tid after another, in either order (tests/test_torch_residual_vjp.py).
#pragma once

#include "chord_bdf2_coop.cuh"

namespace chord {
namespace vjp {

using coop::kWarp;

// One lane's record: the chord solve's (its kinematics' fields) and the
// VJP's own.
template <int N, int NR, int FEAT>
struct alignas(16) VjpLane : coop::LaneOf<N, NR, FEAT> {
  alignas(16) float in[5][NR];  // q2, q0, qd0, q1, qd1 (setup's rows)
  alignas(16) float y[N][6];    // I_i u_i
  alignas(16) float dm[N][6];   // Dm_i^T u_i
  alignas(16) float yw[N][6];   // Ad(inv E_wi)^T y_i
  alignas(16) float xi[NR][6];  // v_r ad(W_r)^T z_r
  float xb[NR];                 // xbar (z where no H^-1 is given)
  float wv[NR];                 // w = -z
  float a[NR], bdu[NR], s1[NR];
};

// The lane's inputs: q2, q0, qd0, q1, qd1, xbar, element (lane, r) of input k
// at p[k][lane * sl[k] + r * sc[k]]; and the forward's H^-1, element (lane,
// s, r) at hinv[lane * hl + s * hs + r * hc] (null: xbar holds z).
struct Inputs {
  const float* p[6];
  long long sl[6], sc[6];
  const float* hinv;
  long long hl, hs, hc;
};

// Each (input, column) a thread: the lane's rows of q2 ... qd1 into in, of
// xbar into xb.
template <int N, int NR, int FEAT>
CHORD_HD void gather(int t, const Inputs& x, VjpLane<N, NR, FEAT>& L, long long lane) {
  for (int e = t; e < 6 * NR; e += kWarp) {
    const int k = e / NR, r = e % NR;
    const float v = x.p[k][lane * x.sl[k] + r * x.sc[k]];
    if (k < 5)
      L.in[k][r] = v;
    else
      L.xb[r] = v;
  }
}

// w_r = -z_r, z = H^-T xbar (sum over s of H^-1[s][r] xbar[s]), or z = xbar
// where no H^-1 is given; a column a thread.
template <int N, int NR, int FEAT>
CHORD_HD void cotangent(int t, const Inputs& x, VjpLane<N, NR, FEAT>& L, long long lane) {
  if (t >= NR) return;
  const int r = t;
  float z = L.xb[r];
  if (x.hinv != nullptr) {
    const float* H = x.hinv + lane * x.hl + r * x.hc;
    z = 0.0f;
    for (int s = 0; s < NR; ++s) z = z + H[s * x.hs] * L.xb[s];
  }
  L.wv[r] = -z;
}

// Body i = t: u = sum_r J[i][r] w_r, y = I u, Dm^T u with Dm the exact
// derivative of the body's Coriolis, damping and ground-contact wrench by
// phi (local_force_blocks' D and each contact's, ground_contact at h = 0 and
// |g| = 0: no proximity margin), and Ad(inv E_wi)^T y.
template <int N, int NR, int FEAT>
CHORD_HD void bodies(int t, const Shared<N, NR>& sh, VjpLane<N, NR, FEAT>& L) {
  if (t >= N) return;
  const int i = t;
  const float* Ii = sh.Ii + 6 * i;
  alignas(16) Frame E;
  alignas(16) float phi[6], Jr[6], A[6][6], y[6], dm[6], yw[6];
  float u[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < NR; ++r) {
    if (!L.moves(i, r)) continue;
    coop::copy_f<6>(Jr, L.J[i][r]);
    const float w = L.wv[r];
    for (int k = 0; k < 6; ++k) u[k] = u[k] + Jr[k] * w;
  }
  for (int k = 0; k < 6; ++k) y[k] = Ii[k] * u[k];
  coop::copy_frame(E, L.Ew[i]);
  coop::copy_f<6>(phi, L.phi[i]);
  float Kb[6][6], Db[6][6];
  local_force_blocks(Ii, E.R, phi, sh.bd[i], sh.g, Kb, Db);
  if constexpr ((FEAT & kContacts) != 0) {
    float wrench[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < L.ncontacts[i]; ++k)
      ground_contact<true>(E, phi, sh.cp + 13 * coop::nth_contact(sh, i, k), 0.0f, 0.0f, wrench,
                           Kb, Db);
  }
  coop::copy_f<36>(&A[0][0], &L.Abw[i][0][0]);
  for (int l = 0; l < 6; ++l) {
    float d = 0.0f, s = 0.0f;
    for (int k = 0; k < 6; ++k) {
      d = d + Db[k][l] * u[k];
      s = s + A[k][l] * y[k];
    }
    dm[l] = d;
    yw[l] = s;
  }
  coop::copy_f<6>(L.y[i], y);
  coop::copy_f<6>(L.dm[i], dm);
  coop::copy_f<6>(L.yw[i], yw);
}

// Column r = t, over the bodies it moves: a_r = J_ir . y_i, J_ir . Dm_i^T
// u_i, z_r = sum of Ad(inv E_wi)^T y_i; then z_r . Wdot_r and
// v_r ad(W_r)^T z_r.
template <int N, int NR, int FEAT>
CHORD_HD void columns(int t, VjpLane<N, NR, FEAT>& L) {
  if (t >= NR) return;
  const int r = t;
  alignas(16) float Jr[6], y[6], dm[6], yw[6], W[6], Wd[6], xi[6];
  float z[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, a = 0.0f, bdu = 0.0f;
  for (int i = 0; i < N; ++i) {
    if (!L.moves(i, r)) continue;
    coop::copy_f<6>(Jr, L.J[i][r]);
    coop::copy_f<6>(y, L.y[i]);
    coop::copy_f<6>(dm, L.dm[i]);
    coop::copy_f<6>(yw, L.yw[i]);
    for (int k = 0; k < 6; ++k) {
      a = a + Jr[k] * y[k];
      bdu = bdu + Jr[k] * dm[k];
      z[k] = z[k] + yw[k];
    }
  }
  coop::copy_f<6>(W, L.W[r]);
  coop::copy_f<6>(Wd, L.Wd[r]);
  float s1 = 0.0f;
  for (int k = 0; k < 6; ++k) s1 = s1 + z[k] * Wd[k];
  adT_vec(W, z, xi);
  const float v = L.qd[r];
  for (int k = 0; k < 6; ++k) xi[k] = v * xi[k];
  L.a[r] = a;
  L.bdu[r] = bdu;
  L.s1[r] = s1;
  coop::copy_f<6>(L.xi[r], xi);
}

// Column r = t: b_r = Dr_r w_r + (J^T Dm^T u)_r - z_r . Wdot_r + W_r . (sum
// of xi_r' over the columns r' whose body column r moves), Dr the joint
// damping and the limit's (hit at q2); then the five cotangents, output k of
// (lane, r) at out[(k B + lane) NR + r]: tau, q0, qd0, q1, qd1.
template <int N, int NR, int FEAT>
CHORD_HD void out(int t, const Shared<N, NR>& sh, const VjpLane<N, NR, FEAT>& L, long long lane,
                  int B, float* out_) {
  if (t >= NR) return;
  const int r = t;
  const float* jsf = sh.jsf;
  alignas(16) float W[6], xi[6];
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = 0; p < NR; ++p) {
    if (!L.moves(L.dofj[p], r)) continue;
    coop::copy_f<6>(xi, L.xi[p]);
    for (int k = 0; k < 6; ++k) acc[k] = acc[k] + xi[k];
  }
  coop::copy_f<6>(W, L.W[r]);
  float s2 = 0.0f;
  for (int k = 0; k < 6; ++k) s2 = s2 + W[k] * acc[k];
  const float x = L.x[r];
  const float hit = (x < jsf[3 * NR + r] ? 1.0f : 0.0f) + (x > jsf[4 * NR + r] ? 1.0f : 0.0f);
  const float Dr = -jsf[NR + r] - hit * jsf[6 * NR + r];
  const float w = L.wv[r], a = L.a[r], h = sh.h;
  const float b = Dr * w + L.bdu[r] - L.s1[r] + s2;
  const float c = (4.0f / 9.0f) * h * h;
  const long long row = lane * NR + r, plane = static_cast<long long>(B) * NR;
  out_[row] = -c * w;
  out_[plane + row] = a * (1.0f / 3.0f) - (2.0f / 9.0f) * h * b;
  out_[2 * plane + row] = (2.0f / 9.0f) * h * a;
  out_[3 * plane + row] = -(4.0f / 3.0f) * a + (8.0f / 9.0f) * h * b;
  out_[4 * plane + row] = -(8.0f / 9.0f) * h * a;
}

// One lane's VJP: the record from the inputs, the kinematics at q2 with the
// BDF2 velocity v (the joints phase's qdot), the reverse pass, the
// write-out. run(phase, f) runs f(tid) on every thread of the lane and waits
// for all of them (on the card f(lane id) and __syncwarp(); on the CPU every
// tid in turn).
template <int N, int NR, int FEAT, class Run>
CHORD_HD void residual_vjp(const Run& run, VjpLane<N, NR, FEAT>& L, long long lane, int B,
                           const Inputs& x, const int* topo_i, const float* stat_f, float* out_) {
  static_assert((FEAT & ~kContacts) == 0, "the VJP body holds ground contacts only");
  const Shared<N, NR> sh(topo_i, stat_f);
  run(coop::kLaneRecord, [&](int t) { gather<N, NR, FEAT>(t, x, L, lane); });
  // setup reads the gathered rows as lane 0 of 1; tau, which the VJP does not
  // read (only the joint forces fr, unused here, do), is given q2's row.
  run(coop::kSetup, [&](int t) {
    coop::setup<N, NR>(t, sh, L, 0, 1, L.in[0], L.in[1], L.in[2], L.in[3], L.in[4], L.in[0]);
    cotangent<N, NR, FEAT>(t, x, L, lane);
  });
  run(coop::kPairs, [&](int t) { coop::setup_pairs<N, NR>(t, L); });
  // the kinematic phases of coop::kinematics but Jdot
  run(coop::kJoints, [&](int t) { coop::joints<N, NR>(t, sh, L, L.x); });
  run(coop::kTree, [&](int t) { coop::fk_tree<N, NR>(t, L); });
  run(coop::kFrames, [&](int t) { coop::body_frames<N, NR>(t, sh, L); });
  run(coop::kJacobian, [&](int t) { coop::jacobian<N, NR>(t, L); });
  run(coop::kTwists, [&](int t) { coop::twists<N, NR>(t, L); });
  run(coop::kWdot, [&](int t) { coop::world_columns_dot<N, NR, FEAT>(t, L); });
  run(coop::kForcesBlocks, [&](int t) { bodies<N, NR, FEAT>(t, sh, L); });
  run(coop::kResidual, [&](int t) { columns<N, NR, FEAT>(t, L); });
  run(coop::kWriteOut, [&](int t) { out<N, NR, FEAT>(t, sh, L, lane, B, out_); });
}

// The most of 8, 4, 2, 1 lanes whose records fit a block's dynamic shared
// memory on sm_90 (0: not even one).
template <int N, int NR, int FEAT>
constexpr int lanes_per_block() {
  constexpr long long size = sizeof(VjpLane<N, NR, FEAT>);
  for (int n = 8; n >= 1; n /= 2)
    if (n * size <= 232448) return n;
  return 0;
}

}  // namespace vjp
}  // namespace chord
