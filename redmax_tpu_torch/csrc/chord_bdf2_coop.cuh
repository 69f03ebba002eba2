// Cooperative body of the fused BDF2 chord-Newton solve: one warp per lane,
// every value that crosses a phase in the lane's record in shared memory.
//
// Replaces the lane arithmetic of redmax_tpu/pallas_step.py::_build_kernel
// (:689-1320) on its constant-S branches (K1a), with penalty ground contact
// (K1c, _ground_contact :237-345), with two-point springs (K1d,
// _spring_force :401, _point_pair_blocks :516 and their terms of residual
// and hessian) and with multi-point cables (K1e, _cable_force :561 and its
// terms of residual and hessian), in any mix of them; in the unguarded
// chord mode with lane-shared params, with per-lane params (K1f, the
// perlane reads :706-712, :767-841: kPerlane) and in the robust modes (K1g,
// :1220-1313: kRobust), with or without per-lane params; and on its
// q-dependent branch (K1b: S(q) and Sdot of the UNIVERSAL, exp-map SPHERICAL
// and FREE3D joints, FK :907-967, _so3_exp_S :348-398: kQdep), with or
// without closures: every kind mix in one solve loop, each kind's phases
// and record fields compiled in where its bit is set (LaneOf). The
// thread-per-lane body of chord_bdf2_lane.cuh keeps the shapes past this
// design's width or room, and its helpers (Frame, frame_mul, frame_inv,
// adjoint, mat6_vec, ad_vec, adT_vec, rt_vec, local_force_blocks,
// ground_contact, Point, add_point_wrench, spring_force, pair_block,
// qdep_joint, Shared, ChordConfig, RobustConfig) this file calls as they
// are; the cables' per-point and per-pair arithmetic is written here again
// term for term (cable_points ... cable_blocks), as phases. Every sum runs in the
// thread-per-lane body's order, so the two give the same result bit for
// bit wherever the compiler contracts the same multiply-adds (always under
// g++, which contracts none).
//
// What bounds it on an H100: per-lane f32 arithmetic, about 1.4e5 flops a
// lane at N = nr = 12 (2.4e5 with a contact on every link, 1.6e5 with the
// spring chain's three springs, 4.0e5 guarded; 1.9e4 on scene 13's (4, 3)
// with its 3-point cable), against 0.9 KB of state in
// and out (0.5-1 KB more with per-lane params). The
// thread-per-lane body issues those flops one after another on one thread,
// with J, H and the Gauss-Jordan rows in local memory. Here the 32 threads
// of a warp split each phase of the solve over its parallel width, with
// __syncwarp() between phases:
//   record     (kPerlane) per float of the lane's record of lane_f: copied
//              into the lane record, which the params are then read from
//   setup      per body: parent, column mask, ground contacts; per column:
//              the lane's history and the body-frame subspace column Sb[r];
//              then per body: its (body, column) pairs
//   joints     per column: qdot, the BDF2 increment, the joint forces; on
//              the next threads, per joint: E_pj = E0_pj Q(q) (a root's is
//              its world frame), at the iterate the solve names
//   qdep joints (kQdep) per q-dependent joint: Q(q), E_pj and its columns
//              Sb[r] and their time derivatives Sbd[r] at the iterate's qdot
//   FK         down the tree, E_wj = E_wj[parent] E_pj, a row of every
//              frame a thread (a chain's row kept in registers); per body:
//              E_wi and Ad(inv(E_wi)), and on the next threads per column:
//              W[r]
//   J, Jdot    per (body, column) pair that moves: J; per body: phi; per
//              column: Wdot[r] (with Sbd[r] under kQdep); per pair: Jdot
//   springs    (kSprings) per (spring, endpoint): the endpoint's state; per
//              spring: its world force fW (and, where H is built, A =
//              dfW/d(dx) and Bm = dfW/d(dv)), the force on each endpoint
//   cables     (kCables) per cable point: its state; per segment: u_s, dv_s,
//              l_s, 1 / l_s (and, where H is built, w_s); per point: its
//              cable's l, ldot, gate and tension fs (summed in segment
//              order), c_j, F_j = fs c_j (and a_j)
//   forces     per body: the maximal force with the body's own ground
//              contacts and, where H is built, its closed-form K/D blocks
//              (the contact force and its blocks in one ground_contact
//              call), then the wrenches of the spring endpoints and cable
//              points on it; then
//              the body's w = I J dq - ch2 (f - I Jdot qdot)
//   residual   per column: g[r] = sum over bodies of J_r . w
//   H          per pair: cK K J_s + cD D J_s and J_s I; (kSprings) per pair
//              block (spring, e, f) with both endpoints on bodies, or
//              (kCables) per pair block (cable point j, point i) with both
//              points on bodies: G, then per (block, column s): G J_s; per
//              (r, s): H[r][s], summed over the bodies, then over the
//              blocks, in hessian's order, plus the joint terms on the
//              diagonal
//   GJ         one pivot at a time, each row of the elimination a thread,
//              from one [NR][2NR] buffer into the other
//   step       per column: dx = H^-1 g (thread 0: |g|); x -= dx, clamped
//   trials     (kRobust) per column: the full or the half trial iterate;
//              thread 0: both trials' |g| and the guard's pick; per column:
//              the accepted trial's x and g
//   write-out  per column x (NaN on a rejected lane), per (r, s) H^-1.
// The warps of an SM share its shared-memory pipe, which counts accesses,
// not bytes: so a phase reads its operands into registers as 16- or 8-byte
// accesses (copy_f) where the layout allows, and stores its results last
// (nvcc cannot tell the record's arrays apart, so a store between two loads
// would order them). Each phase is a function of (tid, the lane's record)
// that reads only what earlier phases wrote, so g++ runs the same phases on
// the CPU one tid after another, in either order
// (tests/test_torch_coop_*.py). The
// loops and every decision of the solve (the guard's pick included) are
// uniform across the warp (one lane): each thread reads them from the
// record after the barrier. Tensor cores have no place here: their only
// f32 type, TF32, keeps about three digits, and H^-1 is held at 2e-5 of
// scale.
#pragma once

#include <type_traits>

#include "chord_bdf2_lane.cuh"

namespace chord {
namespace coop {

constexpr int kWarp = 32;  // threads a lane

// The phases of a solve, for run(phase, f): the probe build of
// chord_bdf2_coop.cu adds each phase's cycles to its slot (kPhaseNames).
enum Phase {
  kLaneRecord, kSetup, kPairs, kJoints, kTree, kFrames, kJacobian, kTwists, kWdot, kJdot,
  kSpringPoints, kSpringForces, kForcesBlocks, kForces, kNewtonTerms, kSpringBlocks,
  kSpringColumns, kNewtonMatrix, kGaussJordan, kResidual, kStepDx, kStepUpdate, kTrial,
  kGuardPick, kGuardAccept, kWriteOut, kQdepJoints, kCablePoints, kCableSegments, kCableForces,
  kCableBlocks, kCableColumns, kPhases
};
constexpr const char* kPhaseNames[kPhases] = {
    "lane_record", "setup", "pairs", "joints", "fk_tree", "body_frames", "jacobian", "twists",
    "world_columns_dot", "jacobian_dot", "spring_points", "spring_forces",
    "body_forces_blocks", "body_forces", "newton_terms", "spring_blocks", "spring_columns",
    "newton_matrix", "gj_pivot", "residual_columns", "step_dx", "step_update", "trial",
    "guard_pick", "guard_accept", "write_out", "qdep_joints", "cable_points", "cable_segments",
    "cable_forces", "cable_blocks", "cable_columns"};

// NF floats from src to dst: on the card as 16-byte accesses where NF is a
// multiple of 4, else 8-byte ones where it is even, so both sides must be
// aligned to that (the lane record's arrays are 16-byte aligned, and the
// rows read here start at multiples of their access; registers are
// declared alignas(16)).
template <int NF>
CHORD_HD void copy_f(float* __restrict__ dst, const float* __restrict__ src) {
#ifdef __CUDA_ARCH__
  if constexpr (NF % 4 == 0) {
    for (int k = 0; k < NF / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(src)[k];
  } else if constexpr (NF % 2 == 0) {
    for (int k = 0; k < NF / 2; ++k)
      reinterpret_cast<float2*>(dst)[k] = reinterpret_cast<const float2*>(src)[k];
  } else {
    for (int k = 0; k < NF; ++k) dst[k] = src[k];
  }
#else
  for (int k = 0; k < NF; ++k) dst[k] = src[k];
#endif
}

CHORD_HD void copy_frame(Frame& dst, const Frame& src) { copy_f<12>(&dst.R[0][0], &src.R[0][0]); }

// One lane's record: the topology it reads in inner loops, the iterate and
// its history, the kinematics, the residual's and Newton matrix's terms.
template <int N, int NR>
struct alignas(16) Lane {
  static_assert(NR <= 32, "a column mask is one 32-bit word");
  alignas(16) Frame Epj[N];  // joint frames in their parent
  alignas(16) Frame Ewj[N];  // joint frames in the world
  alignas(16) Frame Ew[N];   // body frames in the world
  alignas(16) float Abw[N][6][6];  // Ad(inv(E_wi))
  // Each body's closed-form K/D blocks (KDb[0] K, KDb[1] D), from
  // body_forces to newton_terms; a kSprings build whose pair blocks' G J_s
  // fit here keeps them here after that (GJ, from spring_columns to
  // newton_matrix: spring_gj).
  union {
    alignas(16) float KDb[2][N][6][6];
    alignas(16) float GJ[2 * N * 6 / NR][NR][6];
  };
  alignas(16) float M[2][NR][2 * NR];  // Gauss-Jordan [H | I], pivot k reads M[k & 1]
  alignas(16) float J[N][NR][6];
  alignas(16) float Jd[N][NR][6];
  alignas(16) float KD[N][NR][6];  // cK K J_s + cD D J_s
  alignas(16) float IJ[N][NR][6];  // J_s I
  alignas(16) float Sb[NR][6];
  alignas(16) float W[NR][6];
  alignas(16) float Wd[NR][6];
  alignas(16) float phi[N][6];
  alignas(16) float w[N][6];
  alignas(16) float g[NR];
  float x[NR], q0[NR], qd0[NR], q1[NR], qd1[NR], tau[NR];
  float qd[NR], dqt[NR], fr[NR], dx[NR];
  float g0n, gln;  // |g| at the predictor, at the last pre-update iterate
  int parent[N], dofj[NR];
  int ncontacts[N];   // ground contacts on each body
  unsigned cols[N];   // bit r set: column r moves body i (anc(i, dofj[r]))
  int pairs[N * NR];  // i * NR + r of each (body, column) that moves, by i, r
  int npairs;

  CHORD_HD bool moves(int i, int r) const { return ((cols[i] >> r) & 1u) != 0; }
  CHORD_HD float hinv(int r, int s) const { return M[NR & 1][r][NR + s]; }
};

// Each kind of the FEAT bitmask adds its own fields to the record, after
// those of the kinds before it (in this order: kQdep, kSprings, kCables,
// kRobust, kPerlane), so a build holds exactly the fields of its kinds and
// a build of one kind keeps the layout it had alone.

// kQdep: the time derivative Sbd[r] of each body-frame column (zero on the
// constant-S ones), and Sb[r] per iterate on the q-dependent joints'
// columns.
template <class Base, int NR>
struct alignas(16) WithQdep : Base {
  alignas(16) float Sbd[NR][6];
};

// The springs, cables and cable points a build's record holds: 3, 2 and
// kMaxCablePoints (8) in the fixed library; a build made for one scene
// sizes each from the scene (-DCHORD_MAX_SPRINGS, -DCHORD_MAX_CABLES,
// -DCHORD_MAX_CABLE_POINTS), so it holds the scene's closures however
// they split. Pair blocks: one for each ordered pair of endpoints on
// bodies, four a spring at most; one for each ordered pair of a cable's
// points on bodies, at most the square of the points.
#ifdef CHORD_MAX_SPRINGS
constexpr int kCoopSprings = CHORD_MAX_SPRINGS;
#else
constexpr int kCoopSprings = 3;
#endif
#ifdef CHORD_MAX_CABLES
constexpr int kCoopCables = CHORD_MAX_CABLES;
#else
constexpr int kCoopCables = 2;
#endif
constexpr int kCoopBlocks = 4 * kCoopSprings;
constexpr int kCoopCablePoints = kMaxCablePoints;
constexpr int kCoopCableBlocks = kCoopCablePoints * kCoopCablePoints;

// True where the springs' G J_s of every pair block fit the storage of the
// K/D blocks (the union GJ), which newton_terms has read by then: the
// spring chain's 12 blocks at (12, 12) fill it. Elsewhere (more springs, or
// nr above N) they have a store of their own (WithSpringColumns).
template <int N, int NR>
constexpr bool springs_in_kd() {
  return kCoopBlocks * NR <= 2 * N * 6;
}

// kSprings: each endpoint's state at the iterate and the world force on it,
// each spring's A = dfW/d(dx) and Bm = dfW/d(dv) where H is built, and each
// pair block (spring, e, f) with both endpoints on bodies, in hessian's
// order: its bodies and G = cK K + cD D.
template <class Base>
struct alignas(16) WithSprings : Base {
  alignas(16) float G[kCoopBlocks][6][6];
  float F[kCoopSprings][2][3];  // the world force on endpoint e, +fW on 0, -fW on 1
  float A[kCoopSprings][3][3];
  float Bm[kCoopSprings][3][3];
  Point pt[kCoopSprings][2];
  int blk[kCoopBlocks];       // 4 s + 2 e + f
  int blkb[kCoopBlocks][2];   // the bodies of endpoints e and f
  int nblocks;
};

// The store of the springs' G J_s where the K/D blocks' does not hold them.
template <class Base, int NR>
struct alignas(16) WithSpringColumns : Base {
  alignas(16) float SGJ[kCoopBlocks][NR][6];
};

// kCables, every point and segment by its index g in the cables' points in
// order (segment g runs from point g to point g + 1 of the same cable):
// each point's state at the iterate, each segment's u_s, dv_s, l_s, 1 / l_s,
// u_s . dv_s and (where H is built) w_s = Pm_s dv_s / l_s, each point's
// c_j, the world force F_j = fs c_j on it and (where H is built) a_j, each
// cable's tension fs and gate; the static map of points to cables, bodies
// and params, and each pair block (j, i) with both points on bodies, in
// hessian's order: its points, its bodies, G = cK K + cD D and G J_s (a
// store of its own: a cable of P points has P^2 blocks).
template <class Base, int NR>
struct alignas(16) WithCables : Base {
  alignas(16) float CG[kCoopCableBlocks][6][6];
  alignas(16) float CGJ[kCoopCableBlocks][NR][6];
  float cu[kCoopCablePoints][3];
  float cdv[kCoopCablePoints][3];
  float cw[kCoopCablePoints][3];
  float cc[kCoopCablePoints][3];
  float ca[kCoopCablePoints][3];
  float cF[kCoopCablePoints][3];
  float cls[kCoopCablePoints], clinv[kCoopCablePoints], cud[kCoopCablePoints];
  float cfs[kCoopCables], cgate[kCoopCables];
  Point cpt[kCoopCablePoints];
  int cpc[kCoopCablePoints];  // the cable of point g
  int cpj[kCoopCablePoints];  // its index j in that cable
  int cpb[kCoopCablePoints];  // its body (-1: a world point)
  int coff[kCoopCables];      // each cable's first point g
  int cnpts[kCoopCables];     // and its points P
  int cbo[kCoopCables];       // the offset of its xls, k, d, L in the closure params
  int cblk[kCoopCableBlocks][2];   // the points (g_j, g_i) of pair block k
  int cblkb[kCoopCableBlocks][2];  // and their bodies
  int cnpoints, cnblocks;
};

// kRobust: the full and the half trial iterate, their residuals and |g|,
// and the guard's pick (0 full, 1 half, -1 stay put).
template <class Base, int NR>
struct alignas(16) WithTrials : Base {
  alignas(16) float xt[2][NR];
  alignas(16) float gt[2][NR];
  float gtn[2];
  int pick;
};

// Floats of the per-lane record a kPerlane build holds, the fields of
// lane_f its kinds have (chord_bdf2_lane.cuh: P = 7N + 4 + 13C + 9S +
// 3 NPTS + 3 NCAB) for the closures its record holds, to a multiple of 4:
// with ground contacts, whose count no build fixes, kMaxLaneRecord (512 in
// the fixed library, the scene's record in a build made for one scene).
template <int N, int FEAT>
constexpr int coop_record_floats() {
  if constexpr ((FEAT & kContacts) != 0) return kMaxLaneRecord;
  int p = 7 * N + 4;
  if constexpr ((FEAT & kSprings) != 0) p += 9 * kCoopSprings;
  if constexpr ((FEAT & kCables) != 0) p += 3 * kCoopCablePoints + 3 * kCoopCables;
  return (p + 3) / 4 * 4;
}

// kPerlane: the lane's record of lane_f (P floats at most), which its
// Shared reads the physical params from.
template <class Base, int P>
struct alignas(16) LanePerlane : Base {
  alignas(16) float rec[P];
};

// The record of a build of kinds FEAT but its per-lane params, each kind's
// fields after those of the kinds before it, and the whole record.
template <int N, int NR, int FEAT>
struct LaneKinds {
  using Q = std::conditional_t<(FEAT & kQdep) != 0, WithQdep<Lane<N, NR>, NR>, Lane<N, NR>>;
  using S = std::conditional_t<(FEAT & kSprings) != 0, WithSprings<Q>, Q>;
  using SC = std::conditional_t<(FEAT & kSprings) != 0 && !springs_in_kd<N, NR>(),
                                WithSpringColumns<S, NR>, S>;
  using C = std::conditional_t<(FEAT & kCables) != 0, WithCables<SC, NR>, SC>;
  using type = std::conditional_t<(FEAT & kRobust) != 0, WithTrials<C, NR>, C>;
};
template <int N, int NR, int FEAT>
using LaneBase = typename LaneKinds<N, NR, FEAT>::type;
template <int N, int NR, int FEAT>
using LaneOf = std::conditional_t<(FEAT & kPerlane) != 0,
                                  LanePerlane<LaneBase<N, NR, FEAT>, coop_record_floats<N, FEAT>()>,
                                  LaneBase<N, NR, FEAT>>;

// G J_s of the springs' pair blocks, [block][column][6]: in the K/D blocks'
// storage or in a store of its own (springs_in_kd).
template <int N, int NR, class Rec>
CHORD_HD float (*spring_gj(Rec& L))[NR][6] {
  if constexpr (springs_in_kd<N, NR>())
    return L.GJ;
  else
    return L.SGJ;
}

// Lane `lane` of the [P, B] per-lane buffer into the record, a float a
// thread.
template <int N, int NR, class Rec>
CHORD_HD void lane_record(int t, const Shared<N, NR>& sh, Rec& L, const float* lane_f, int lane,
                          int B) {
  const int P = sh.lane_record_size();
  for (int k = t; k < P; k += kWarp) L.rec[k] = lane_f[k * B + lane];
}

// Each body's parent, column mask and ground contacts, the lane's history,
// and the body-frame subspace columns Sb[r] = Ad(inv(E0_ji)) S_j[:, d]
// (static_subspace, a column a thread).
template <int N, int NR>
CHORD_HD void setup(int t, const Shared<N, NR>& sh, Lane<N, NR>& L, int lane, int B,
                    const float* x0s, const float* q0s, const float* qd0s, const float* q1s,
                    const float* qd1s, const float* taus) {
  if (t < N) {
    L.parent[t] = sh.parent[t];
    unsigned m = 0u;
    for (int r = 0; r < NR; ++r)
      if (sh.is_anc(t, sh.dofj[r])) m |= 1u << r;
    L.cols[t] = m;
    int n = 0;
    for (int c = 0; c < sh.ncontacts; ++c) n += sh.cbody[c] == t ? 1 : 0;
    L.ncontacts[t] = n;
  }
  if (t < NR) {
    const int r = t;
    L.dofj[r] = sh.dofj[r];
    L.x[r] = x0s[r * B + lane];
    L.q0[r] = q0s[r * B + lane];
    L.qd0[r] = qd0s[r * B + lane];
    L.q1[r] = q1s[r * B + lane];
    L.qd1[r] = qd1s[r * B + lane];
    L.tau[r] = taus[r * B + lane];
    const int j = sh.dofj[r];
    const int d = r - sh.doffs[j];
    Frame E0, E0inv;
    float A0[6][6], Sj[6];
    frame_from_E(sh.E0ji + 16 * j, E0);
    frame_inv(E0, E0inv);
    adjoint(E0inv, A0);
    const bool rot = sh.jtype[j] == REVOLUTE;
    for (int a = 0; a < 3; ++a) {
      Sj[a] = rot ? sh.axis(j, a, d) : 0.0f;
      Sj[3 + a] = rot ? 0.0f : sh.axis(j, a, d);
    }
    mat6_vec(A0, Sj, L.Sb[r]);
  }
}

// Sbd[r] = 0 of every column, a column a thread (kQdep): qdep_joints
// overwrites the q-dependent joints' at every iterate.
template <int N, int NR, class Rec>
CHORD_HD void setup_qdep(int t, Rec& L) {
  if (t >= NR) return;
  for (int k = 0; k < 6; ++k) L.Sbd[t][k] = 0.0f;
}

// The (body, column) pairs that move, body by body: each body's thread
// writes its own after the columns of the bodies before it.
template <int N, int NR>
CHORD_HD void setup_pairs(int t, Lane<N, NR>& L) {
  if (t >= N) return;
  int at = 0;
  for (int i = 0; i < t; ++i)
    for (int r = 0; r < NR; ++r) at += L.moves(i, r) ? 1 : 0;
  for (int r = 0; r < NR; ++r)
    if (L.moves(t, r)) L.pairs[at++] = t * NR + r;
  if (t == N - 1) L.npairs = at;
}

// The pair blocks of each spring, spring by spring: each spring's thread
// writes its own, (e, f) over its endpoints on bodies, after the blocks of
// the springs before it.
template <int N, int NR, class Rec>
CHORD_HD void setup_springs(int t, const Shared<N, NR>& sh, Rec& L) {
  if (t == 0 && sh.nsprings == 0) L.nblocks = 0;
  for (int u = t; u < sh.nsprings; u += kWarp) {
    int at = 0;
    for (int s = 0; s < u; ++s) {
      const int n = (sh.sspec[4 * s + 1] >= 0 ? 1 : 0) + (sh.sspec[4 * s + 2] >= 0 ? 1 : 0);
      at += n * n;
    }
    for (int e = 0; e < 2; ++e) {
      const int b = sh.sspec[4 * u + 1 + e];
      for (int f = 0; f < 2 && b >= 0; ++f) {
        const int c = sh.sspec[4 * u + 1 + f];
        if (c < 0) continue;
        L.blk[at] = 4 * u + 2 * e + f;
        L.blkb[at][0] = b;
        L.blkb[at][1] = c;
        ++at;
      }
    }
    if (u == sh.nsprings - 1) L.nblocks = at;
  }
}

// Each cable's points, their params and its pair blocks, cable by cable:
// each cable's thread writes its own, (j, i) over its points on bodies,
// after the points and blocks of the cables before it.
template <int N, int NR, class Rec>
CHORD_HD void setup_cables(int t, const Shared<N, NR>& sh, Rec& L) {
  if (t == 0 && sh.ncables == 0) L.cnpoints = L.cnblocks = 0;
  for (int u = t; u < sh.ncables; u += kWarp) {
    int spec = 0, g = 0, cbo = 0, at = 0;
    for (int c = 0; c < u; ++c) {
      const int P = sh.cspec[spec];
      int on = 0;
      for (int j = 0; j < P; ++j) on += sh.cspec[spec + 1 + j] >= 0 ? 1 : 0;
      at += on * on;
      g += P;
      cbo += 3 * P + 3;
      spec += 1 + P;
    }
    const int P = sh.cspec[spec];
    const int* bodies = sh.cspec + spec + 1;
    L.coff[u] = g;
    L.cnpts[u] = P;
    L.cbo[u] = cbo;
    for (int j = 0; j < P; ++j) {
      L.cpc[g + j] = u;
      L.cpj[g + j] = j;
      L.cpb[g + j] = bodies[j];
    }
    for (int j = 0; j < P; ++j) {
      if (bodies[j] < 0) continue;
      for (int i = 0; i < P; ++i) {
        if (bodies[i] < 0) continue;
        L.cblk[at][0] = g + j;
        L.cblk[at][1] = g + i;
        L.cblkb[at][0] = bodies[j];
        L.cblkb[at][1] = bodies[i];
        ++at;
      }
    }
    if (u == sh.ncables - 1) {
      L.cnpoints = g + P;
      L.cnblocks = at;
    }
  }
}

// qdot at the iterate xe, the BDF2 increment dq and the joint forces
// (spring, damper, penalty limits) of column r (residual's first loop).
template <int N, int NR>
CHORD_HD void joint_terms(int r, const Shared<N, NR>& sh, Lane<N, NR>& L, const float* xe) {
  const float h = sh.h;
  const float* jsf = sh.jsf;
  const float x = xe[r];
  const float qd = (1.5f / h) * (x - (4.0f / 3.0f) * L.q1[r] + (1.0f / 3.0f) * L.q0[r]);
  L.qd[r] = qd;
  L.dqt[r] = x - (4.0f / 3.0f) * L.q1[r] + (1.0f / 3.0f) * L.q0[r] -
             (8.0f / 9.0f) * h * L.qd1[r] + (2.0f / 9.0f) * h * L.qd0[r];
  float f = L.tau[r] + jsf[r] * (jsf[2 * NR + r] - x) - jsf[NR + r] * qd;
  const float hl = x < jsf[3 * NR + r] ? 1.0f : 0.0f;
  const float hu = x > jsf[4 * NR + r] ? 1.0f : 0.0f;
  f = f + hl * (jsf[5 * NR + r] * (jsf[3 * NR + r] - x) - jsf[6 * NR + r] * qd);
  f = f + hu * (jsf[5 * NR + r] * (jsf[4 * NR + r] - x) - jsf[6 * NR + r] * qd);
  L.fr[r] = f;
}

// E_pj = E0_pj Q(q) of constant-S joint j at the iterate xe (fk_and_J's
// joint loop); a root joint's is its world frame E_wj.
template <int N, int NR>
CHORD_HD void fk_local(int j, const Shared<N, NR>& sh, Lane<N, NR>& L, const float* xe) {
  const int o = sh.doffs[j];
  const int jt = sh.jtype[j];
  Frame Q, E0;
  alignas(16) Frame Epj;
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) Q.R[a][b] = a == b ? 1.0f : 0.0f;
    Q.p[a] = 0.0f;
  }
  if (jt == REVOLUTE) {
    const float c = cosf(xe[o]), s = sinf(xe[o]);
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
      float acc = sh.axis(j, k, 0) * xe[o];
      for (int d = 1; d < nd; ++d) acc = acc + sh.axis(j, k, d) * xe[o + d];
      Q.p[k] = acc;
    }
  }
  frame_from_E(sh.E0pj + 16 * j, E0);
  frame_mul(E0, Q, Epj);
  copy_frame(L.parent[j] < 0 ? L.Ewj[j] : L.Epj[j], Epj);
}

// Each column's terms (a column a thread) and each joint's E_pj (a joint a
// thread, on the threads after the columns'), at the iterate xe (the
// record's x, or a trial): one phase, as neither reads the other. With
// QDEP the q-dependent joints are left to qdep_joints, which reads qdot.
template <int N, int NR, bool QDEP = false>
CHORD_HD void joints(int t, const Shared<N, NR>& sh, Lane<N, NR>& L, const float* xe) {
  for (int e = t; e < NR + N; e += kWarp) {
    if (e < NR)
      joint_terms<N, NR>(e, sh, L, xe);
    else if (!QDEP || !is_qdep(sh.jtype[e - NR]))
      fk_local<N, NR>(e - NR, sh, L, xe);
  }
}

// Q(q) of q-dependent joint j = t at the iterate xe, with its columns Sb[r]
// and their time derivatives Sbd[r] at the record's qdot (qdep_joint, as
// fk_and_J calls it), and E_pj = E0_pj Q (a root joint's is its world
// frame); a joint a thread.
template <int N, int NR, class Rec>
CHORD_HD void qdep_joints(int t, const Shared<N, NR>& sh, Rec& L, const float* xe) {
  if (t >= N || !is_qdep(sh.jtype[t])) return;
  const int j = t;
  Frame Q, E0;
  alignas(16) Frame Epj;
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) Q.R[a][b] = a == b ? 1.0f : 0.0f;
    Q.p[a] = 0.0f;
  }
  qdep_joint<N, NR>(sh, j, xe, L.qd, Q, L.Sb, L.Sbd);
  frame_from_E(sh.E0pj + 16 * j, E0);
  frame_mul(E0, Q, Epj);
  copy_frame(L.parent[j] < 0 ? L.Ewj[j] : L.Epj[j], Epj);
}

// E_wj = E_wj[parent] E_pj down the tree in joint order (parents precede
// children; joint 0 is a root), row a of every frame on thread a < 3: row a
// of a product needs row a of its left factor only (frame_mul's sums), so
// each thread walks the tree alone, a chain's row staying in registers from
// one joint to the next, and the next E_pj is read before this one's row is
// stored.
template <int N, int NR>
CHORD_HD void fk_tree(int t, Lane<N, NR>& L) {
  if (t >= 3) return;
  const int a = t;
  alignas(16) Frame P, next;
  float A[4], row[4] = {L.Ewj[0].R[a][0], L.Ewj[0].R[a][1], L.Ewj[0].R[a][2], L.Ewj[0].p[a]};
  copy_frame(next, L.Epj[N > 1 ? 1 : 0]);
  for (int j = 1; j < N; ++j) {
    P = next;
    if (j + 1 < N) copy_frame(next, L.Epj[j + 1]);
    const int p = L.parent[j];
    const Frame& F = L.Ewj[p < 0 ? j : p];
    for (int b = 0; b < 3; ++b) A[b] = p == j - 1 ? row[b] : F.R[a][b];
    A[3] = p == j - 1 ? row[3] : F.p[a];
    if (p < 0) {
      for (int b = 0; b < 4; ++b) row[b] = A[b];
      continue;
    }
    for (int b = 0; b < 3; ++b)
      row[b] = A[0] * P.R[0][b] + A[1] * P.R[1][b] + A[2] * P.R[2][b];
    row[3] = A[3] + (A[0] * P.p[0] + A[1] * P.p[1] + A[2] * P.p[2]);
    for (int b = 0; b < 3; ++b) L.Ewj[j].R[a][b] = row[b];
    L.Ewj[j].p[a] = row[3];
  }
}

// Body frames E_wi = E_wj E0_ji and Ad(inv(E_wi)), a body a thread; on the
// threads after the bodies', W[r] = Ad(E_wi[dofj[r]]) Sb[r], each with its
// own product E_wj E0_ji of that body (the same arithmetic).
template <int N, int NR>
CHORD_HD void body_frames(int t, const Shared<N, NR>& sh, Lane<N, NR>& L) {
  for (int e = t; e < N + NR; e += kWarp) {
    const int i = e < N ? e : L.dofj[e - N];
    alignas(16) Frame Ewj, Ew;
    alignas(16) float A[6][6];
    Frame E0, Einv;
    copy_frame(Ewj, L.Ewj[i]);
    frame_from_E(sh.E0ji + 16 * i, E0);
    frame_mul(Ewj, E0, Ew);
    if (e < N) {
      frame_inv(Ew, Einv);
      adjoint(Einv, A);
      copy_frame(L.Ew[i], Ew);
      copy_f<36>(&L.Abw[i][0][0], &A[0][0]);
    } else {
      alignas(16) float Sb[6], W[6];
      copy_f<6>(Sb, L.Sb[e - N]);
      adjoint(Ew, A);
      mat6_vec(A, Sb, W);
      copy_f<6>(L.W[e - N], W);
    }
  }
}

// J[i][r] = Ad(inv(E_wi)) W[r] where column r moves body i
template <int N, int NR>
CHORD_HD void jacobian(int t, Lane<N, NR>& L) {
  for (int e = t; e < L.npairs; e += kWarp) {
    const int i = L.pairs[e] / NR, r = L.pairs[e] % NR;
    alignas(16) float A[6][6], W[6], J[6];
    copy_f<36>(&A[0][0], &L.Abw[i][0][0]);
    copy_f<6>(W, L.W[r]);
    mat6_vec(A, W, J);
    copy_f<6>(L.J[i][r], J);
  }
}

// phi_i = sum_r J[i][r] qdot[r], a body a thread
template <int N, int NR>
CHORD_HD void twists(int t, Lane<N, NR>& L) {
  if (t >= N) return;
  alignas(16) float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, Jr[6];
  for (int r = 0; r < NR; ++r) {
    if (!L.moves(t, r)) continue;
    copy_f<6>(Jr, L.J[t][r]);
    const float qd = L.qd[r];
    for (int k = 0; k < 6; ++k) acc[k] = acc[k] + Jr[k] * qd;
  }
  copy_f<6>(L.phi[t], acc);
}

// Wdot[r] = Ad(E_wi[a]) (ad(phi_a) Sb[r] + Sbd[r]), a = dofj[r] (the Sbd
// term under kQdep only)
template <int N, int NR, int FEAT = 0>
CHORD_HD void world_columns_dot(int t, LaneOf<N, NR, FEAT>& L) {
  if (t >= NR) return;
  const int a = L.dofj[t];
  alignas(16) Frame Ew;
  alignas(16) float phi[6], Sb[6], Wd[6];
  float A[6][6], inner[6];
  copy_frame(Ew, L.Ew[a]);
  copy_f<6>(phi, L.phi[a]);
  copy_f<6>(Sb, L.Sb[t]);
  adjoint(Ew, A);
  ad_vec(phi, Sb, inner);
  if constexpr ((FEAT & kQdep) != 0) {
    alignas(16) float Sbd[6];
    copy_f<6>(Sbd, L.Sbd[t]);
    for (int k = 0; k < 6; ++k) inner[k] = inner[k] + Sbd[k];
  }
  mat6_vec(A, inner, Wd);
  copy_f<6>(L.Wd[t], Wd);
}

// Jdot[i][r] = Ad(inv(E_wi)) Wdot[r] - ad(phi_i) J[i][r]
template <int N, int NR>
CHORD_HD void jacobian_dot(int t, Lane<N, NR>& L) {
  for (int e = t; e < L.npairs; e += kWarp) {
    const int i = L.pairs[e] / NR, r = L.pairs[e] % NR;
    alignas(16) float A[6][6], Wd[6], phi[6], J[6], Jd[6];
    float t1[6], t2[6];
    copy_f<36>(&A[0][0], &L.Abw[i][0][0]);
    copy_f<6>(Wd, L.Wd[r]);
    copy_f<6>(phi, L.phi[i]);
    copy_f<6>(J, L.J[i][r]);
    mat6_vec(A, Wd, t1);
    ad_vec(phi, J, t2);
    for (int k = 0; k < 6; ++k) Jd[k] = t1[k] - t2[k];
    copy_f<6>(L.Jd[i][r], Jd);
  }
}

// The state of endpoint e of spring s at the record's Ew and phi
// (point_state's arithmetic), a (spring, endpoint) a thread.
template <int N, int NR, class Rec>
CHORD_HD void spring_points(int t, const Shared<N, NR>& sh, Rec& L) {
  for (int q = t; q < 2 * sh.nsprings; q += kWarp) {
    const int s = q / 2, e = q % 2;
    const int b = sh.sspec[4 * s + 1 + e];
    const float* sp = sh.sp + 9 * s + 3 * e;
    const float r[3] = {sp[0], sp[1], sp[2]};
    Point P;
    P.b = b;
    for (int i = 0; i < 3; ++i) {
      P.r[i] = r[i];
      P.x[i] = r[i];
      P.v[i] = 0.0f;
      P.u[i] = 0.0f;
    }
    if (b >= 0) {
      alignas(16) Frame E;
      alignas(16) float phi[6];
      copy_frame(E, L.Ew[b]);
      copy_f<6>(phi, L.phi[b]);
      cross3(phi, r, P.u);
      for (int i = 0; i < 3; ++i) P.u[i] = P.u[i] + phi[3 + i];
      for (int i = 0; i < 3; ++i) {
        P.x[i] = E.p[i] + (E.R[i][0] * r[0] + E.R[i][1] * r[1] + E.R[i][2] * r[2]);
        P.v[i] = E.R[i][0] * P.u[0] + E.R[i][1] * P.u[1] + E.R[i][2] * P.u[2];
      }
    }
    L.pt[s][e] = P;
  }
}

// Spring s's world force fW (spring_force), the force on each endpoint
// (+fW on 0, -fW on 1) and, where H is built (blocks), A and Bm; a spring a
// thread.
template <int N, int NR, class Rec>
CHORD_HD void spring_forces(int t, const Shared<N, NR>& sh, Rec& L, bool blocks) {
  for (int s = t; s < sh.nsprings; s += kWarp) {
    const int* spec = sh.sspec + 4 * s;
    const Point p1 = L.pt[s][0], p2 = L.pt[s][1];
    float fW[3], A[3][3], Bm[3][3];
    if (blocks)
      spring_force<true>(p1, p2, sh.sp + 9 * s, spec[0], spec[3], fW, A, Bm);
    else
      spring_force<false>(p1, p2, sh.sp + 9 * s, spec[0], spec[3], fW, A, Bm);
    for (int e = 0; e < 2; ++e) {
      const float se = e == 0 ? 1.0f : -1.0f;
      for (int i = 0; i < 3; ++i) L.F[s][e][i] = se * fW[i];
    }
    if (!blocks) continue;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        L.A[s][i][j] = A[i][j];
        L.Bm[s][i][j] = Bm[i][j];
      }
  }
}

// G of pair block k (spring s, endpoint e's wrench against endpoint f's
// perturbation, pair_block with dF_e/dx_f = s_e sig_f A: the application
// signs s = (+1, -1), the dx signs sig = (-1, +1)), a block a thread.
template <int N, int NR, class Rec>
CHORD_HD void spring_blocks(int t, const Shared<N, NR>& sh, Rec& L) {
  const float h = sh.h;
  const float cK = -(4.0f / 9.0f) * h * h;
  const float cD = -(2.0f / 3.0f) * h;
  for (int k = t; k < L.nblocks; k += kWarp) {
    const int code = L.blk[k];
    const int s = code / 4, e = (code / 2) % 2, f = code % 2;
    const float se = e == 0 ? 1.0f : -1.0f;
    alignas(16) Frame Eb, Ec;
    alignas(16) float G[6][6];
    copy_frame(Eb, L.Ew[L.blkb[k][0]]);
    copy_frame(Ec, L.Ew[L.blkb[k][1]]);
    const Point pe = L.pt[s][e], pf = L.pt[s][f];
    float A[3][3], Bm[3][3], F[3], fb[3];
    for (int i = 0; i < 3; ++i) {
      F[i] = L.F[s][e][i];
      for (int j = 0; j < 3; ++j) {
        A[i][j] = L.A[s][i][j];
        Bm[i][j] = L.Bm[s][i][j];
      }
    }
    rt_vec(Eb.R, F, fb);
    pair_block(Eb, pe, fb, Ec, pf, A, Bm, se * (f == 0 ? -1.0f : 1.0f), e == f, cK, cD, G);
    copy_f<36>(&L.G[k][0][0], &G[0][0]);
  }
}

// G J_s of each pair block k (bodies b, c) and column s that moves body c
// (add_pair's), a (block, column) a thread, into spring_gj's store.
template <int N, int NR, class Rec>
CHORD_HD void spring_columns(int t, Rec& L) {
  float(*GJ)[NR][6] = spring_gj<N, NR>(L);
  for (int q = t; q < L.nblocks * NR; q += kWarp) {
    const int k = q / NR, s = q % NR, c = L.blkb[k][1];
    if (!L.moves(c, s)) continue;
    alignas(16) float G[6][6], Js[6], GJs[6];
    copy_f<36>(&G[0][0], &L.G[k][0][0]);
    copy_f<6>(Js, L.J[c][s]);
    mat6_vec(G, Js, GJs);
    copy_f<6>(GJ[k][s], GJs);
  }
}

// The state of cable point g at the record's Ew and phi (point_state's
// arithmetic, as the cables loop of chord_bdf2_lane.cuh calls it), a point
// a thread.
template <int N, int NR, class Rec>
CHORD_HD void cable_points(int t, const Shared<N, NR>& sh, Rec& L) {
  for (int g = t; g < L.cnpoints; g += kWarp) {
    const int b = L.cpb[g];
    const float* r = sh.cb + L.cbo[L.cpc[g]] + 3 * L.cpj[g];
    Point P;
    P.b = b;
    for (int i = 0; i < 3; ++i) {
      P.r[i] = r[i];
      P.x[i] = r[i];
      P.v[i] = 0.0f;
      P.u[i] = 0.0f;
    }
    if (b >= 0) {
      alignas(16) Frame E;
      alignas(16) float phi[6];
      copy_frame(E, L.Ew[b]);
      copy_f<6>(phi, L.phi[b]);
      cross3(phi, P.r, P.u);
      for (int i = 0; i < 3; ++i) P.u[i] = P.u[i] + phi[3 + i];
      for (int i = 0; i < 3; ++i) {
        P.x[i] = E.p[i] + (E.R[i][0] * P.r[0] + E.R[i][1] * P.r[1] + E.R[i][2] * P.r[2]);
        P.v[i] = E.R[i][0] * P.u[0] + E.R[i][1] * P.u[1] + E.R[i][2] * P.u[2];
      }
    }
    L.cpt[g] = P;
  }
}

// Segment g (point g to point g + 1 of one cable), a segment a thread: dv,
// l_s, 1 / l_s, u_s and u_s . dv_s (the cables loop's segment arithmetic)
// and, where H is built (blocks), w_s = (dv_s - u_s (u_s . dv_s)) / l_s.
template <int N, int NR, class Rec>
CHORD_HD void cable_segments(int t, Rec& L, bool blocks) {
  for (int g = t; g < L.cnpoints; g += kWarp) {
    if (L.cpj[g] + 1 >= L.cnpts[L.cpc[g]]) continue;
    const Point p0 = L.cpt[g], p1 = L.cpt[g + 1];
    float dx[3], dv[3], u[3];
    for (int i = 0; i < 3; ++i) {
      dx[i] = p1.x[i] - p0.x[i];
      dv[i] = p1.v[i] - p0.v[i];
    }
    const float l2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
    const float ls = sqrtf(l2 < 1e-24f ? 1e-24f : l2);
    const float linv = 1.0f / ls;
    for (int i = 0; i < 3; ++i) u[i] = dx[i] * linv;
    const float ud = u[0] * dv[0] + u[1] * dv[1] + u[2] * dv[2];
    for (int i = 0; i < 3; ++i) {
      L.cu[g][i] = u[i];
      L.cdv[g][i] = dv[i];
    }
    L.cls[g] = ls;
    L.clinv[g] = linv;
    L.cud[g] = ud;
    if (blocks)
      for (int i = 0; i < 3; ++i) L.cw[g][i] = (dv[i] - u[i] * ud) * linv;
  }
}

// Point g of a cable, a point a thread: the cable's l = sum l_s and ldot =
// sum u_s . dv_s in segment order, its gate (l > L) and tension fs (each
// point's thread sums them alike; the cable's first point records them),
// then c_j = u_j [j < P-1] - u_{j-1} [j > 0], F_j = fs c_j and, where H is
// built, a_j (the cables loop's arithmetic, term for term).
template <int N, int NR, class Rec>
CHORD_HD void cable_forces(int t, const Shared<N, NR>& sh, Rec& L, bool blocks) {
  for (int g = t; g < L.cnpoints; g += kWarp) {
    const int c = L.cpc[g], j = L.cpj[g], P = L.cnpts[c], g0 = L.coff[c];
    const float* cb = sh.cb + L.cbo[c];
    const float k = cb[3 * P], d = cb[3 * P + 1], Lr = cb[3 * P + 2];
    float l = 0.0f, ldot = 0.0f;
    for (int s = 0; s + 1 < P; ++s) {
      l = l + L.cls[g0 + s];
      ldot = ldot + L.cud[g0 + s];
    }
    const float gate = l > Lr ? 1.0f : 0.0f;
    const float fs = gate * (k * (l - Lr) / Lr + d * ldot / Lr);
    float cj[3];
    for (int i = 0; i < 3; ++i) {
      cj[i] = (j < P - 1 ? L.cu[g][i] : 0.0f) - (j > 0 ? L.cu[g - 1][i] : 0.0f);
      L.cc[g][i] = cj[i];
      L.cF[g][i] = fs * cj[i];
    }
    if (j == 0) {
      L.cfs[c] = fs;
      L.cgate[c] = gate;
    }
    if (!blocks) continue;
    for (int i = 0; i < 3; ++i) {
      float ai = -gate * (k / Lr) * cj[i];
      if (j > 0) ai = ai + gate * (d / Lr) * L.cw[g - 1][i];
      if (j < P - 1) ai = ai - gate * (d / Lr) * L.cw[g][i];
      L.ca[g][i] = ai;
    }
  }
}

// G of cable pair block k (point j's wrench against point i's perturbation:
// A = c_j a_i^T + fs D_ji, Bm = -gate (d/L) c_j c_i^T, pair_block with
// coefficient 1, the cables loop's arithmetic), a block a thread.
template <int N, int NR, class Rec>
CHORD_HD void cable_blocks(int t, const Shared<N, NR>& sh, Rec& L) {
  const float h = sh.h;
  const float cK = -(4.0f / 9.0f) * h * h;
  const float cD = -(2.0f / 3.0f) * h;
  for (int q = t; q < L.cnblocks; q += kWarp) {
    const int gj = L.cblk[q][0], gi = L.cblk[q][1];
    const int c = L.cpc[gj], P = L.cnpts[c], g0 = L.coff[c];
    const int j = gj - g0, i = gi - g0;
    const float* cb = sh.cb + L.cbo[c];
    const float d = cb[3 * P + 1], Lr = cb[3 * P + 2];
    const float fs = L.cfs[c], gate = L.cgate[c];
    alignas(16) Frame Ej, Ei;
    alignas(16) float G[6][6];
    copy_frame(Ej, L.Ew[L.cblkb[q][0]]);
    copy_frame(Ei, L.Ew[L.cblkb[q][1]]);
    const Point pj = L.cpt[gj], pi = L.cpt[gi];
    float fb[3];
    const float F[3] = {L.cF[gj][0], L.cF[gj][1], L.cF[gj][2]};
    rt_vec(Ej.R, F, fb);
    const float t1 = j < P - 1 ? ((i == j + 1 ? 1.0f : 0.0f) - (i == j ? 1.0f : 0.0f)) * L.clinv[gj]
                               : 0.0f;
    const float t2 = j > 0 ? ((i == j ? 1.0f : 0.0f) - (i == j - 1 ? 1.0f : 0.0f)) * L.clinv[gj - 1]
                           : 0.0f;
    float A[3][3], Bm[3][3];
    for (int m = 0; m < 3; ++m)
      for (int n = 0; n < 3; ++n) {
        const float I = m == n ? 1.0f : 0.0f;
        float Dmn = 0.0f;
        if (j < P - 1) Dmn = Dmn + t1 * (I - L.cu[gj][m] * L.cu[gj][n]);
        if (j > 0) Dmn = Dmn - t2 * (I - L.cu[gj - 1][m] * L.cu[gj - 1][n]);
        A[m][n] = L.cc[gj][m] * L.ca[gi][n] + fs * Dmn;
        Bm[m][n] = -gate * (d / Lr) * L.cc[gj][m] * L.cc[gi][n];
      }
    pair_block(Ej, pj, fb, Ei, pi, A, Bm, 1.0f, i == j, cK, cD, G);
    copy_f<36>(&L.CG[q][0][0], &G[0][0]);
  }
}

// CGJ[k][s] = G_k J_c[s] of each cable pair block k (bodies b, c) and column
// s that moves body c (add_pair's), a (block, column) a thread.
template <int N, int NR, class Rec>
CHORD_HD void cable_columns(int t, Rec& L) {
  for (int q = t; q < L.cnblocks * NR; q += kWarp) {
    const int k = q / NR, s = q % NR, c = L.cblkb[k][1];
    if (!L.moves(c, s)) continue;
    alignas(16) float G[6][6], Js[6], GJs[6];
    copy_f<36>(&G[0][0], &L.CG[k][0][0]);
    copy_f<6>(Js, L.J[c][s]);
    mat6_vec(G, Js, GJs);
    copy_f<6>(L.CGJ[k][s], GJs);
  }
}

// The index of body i's k-th ground contact (k < its count).
template <int N, int NR>
CHORD_HD int nth_contact(const Shared<N, NR>& sh, int i, int k) {
  for (int c = 0; c < sh.ncontacts; ++c)
    if (sh.cbody[c] == i && k-- == 0) return c;
  return -1;
}

// Each body's maximal force f = ad(phi)^T (I phi) + [0; m R^T g] - bd phi
// with its own ground contacts and (kSprings) the wrenches of the spring
// endpoints on it, summed from zero in (spring, endpoint) order as the
// residual gathers them, and its residual term
// w = I (J dq) - ch2 (f - I (Jdot qdot)); BLOCKS also writes its
// closed-form K/D blocks (local_force_blocks and the contacts' blocks, the
// contact force and its blocks from one ground_contact call). Every body's
// thread takes its k-th contact at the same call site, so the warp runs
// them side by side rather than one body after another (a loop over the
// scene's contacts with a test for the body would diverge there).
template <int N, int NR, int FEAT, bool BLOCKS>
CHORD_HD void body_forces(int t, const Shared<N, NR>& sh, LaneOf<N, NR, FEAT>& L) {
  constexpr bool CONTACTS = (FEAT & kContacts) != 0;
  if (t >= N) return;
  const int i = t;
  const float* Ii = sh.Ii + 6 * i;
  alignas(16) Frame E;
  alignas(16) float phi[6];
  float Iphi[6], fm[6], Rtg[3];
  copy_frame(E, L.Ew[i]);
  copy_f<6>(phi, L.phi[i]);
  for (int k = 0; k < 6; ++k) Iphi[k] = Ii[k] * phi[k];
  adT_vec(phi, Iphi, fm);
  rt_vec(E.R, sh.g, Rtg);
  for (int k = 0; k < 3; ++k) fm[3 + k] = fm[3 + k] + Ii[3] * Rtg[k];
  for (int k = 0; k < 6; ++k) fm[k] = fm[k] - sh.bd[i] * phi[k];
  if constexpr (BLOCKS) {
    alignas(16) float Kb[6][6], Db[6][6];
    local_force_blocks(Ii, E.R, phi, sh.bd[i], sh.g, Kb, Db);
    if constexpr (CONTACTS) {
      const float gmag = sqrtf(sh.g[0] * sh.g[0] + sh.g[1] * sh.g[1] + sh.g[2] * sh.g[2]);
      for (int k = 0; k < L.ncontacts[i]; ++k)
        ground_contact<true>(E, phi, sh.cp + 13 * nth_contact(sh, i, k), sh.h, gmag, fm, Kb, Db);
    }
    copy_f<36>(&L.KDb[0][i][0][0], &Kb[0][0]);
    copy_f<36>(&L.KDb[1][i][0][0], &Db[0][0]);
  } else if constexpr (CONTACTS) {
    for (int k = 0; k < L.ncontacts[i]; ++k)
      ground_contact<false>(E, phi, sh.cp + 13 * nth_contact(sh, i, k), sh.h, 0.0f, fm, nullptr,
                            nullptr);
  }
  if constexpr ((FEAT & (kSprings | kCables)) != 0) {
    float fcl[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr ((FEAT & kSprings) != 0)
      for (int s = 0; s < sh.nsprings; ++s)
        for (int e = 0; e < 2; ++e)
          if (sh.sspec[4 * s + 1 + e] == i)
            add_point_wrench(E, sh.sp + 9 * s + 3 * e, L.F[s][e], fcl);
    if constexpr ((FEAT & kCables) != 0)
      for (int g = 0; g < L.cnpoints; ++g)
        if (L.cpb[g] == i)
          add_point_wrench(E, sh.cb + L.cbo[L.cpc[g]] + 3 * L.cpj[g], L.cF[g], fcl);
    for (int k = 0; k < 6; ++k) fm[k] = fm[k] + fcl[k];
  }
  const float ch2 = (4.0f / 9.0f) * sh.h * sh.h;
  alignas(16) float Jr[6], Jdr[6], w[6];
  float Jdq[6] = {0, 0, 0, 0, 0, 0}, Jd_qd[6] = {0, 0, 0, 0, 0, 0};
  for (int r = 0; r < NR; ++r) {
    if (!L.moves(i, r)) continue;
    copy_f<6>(Jr, L.J[i][r]);
    copy_f<6>(Jdr, L.Jd[i][r]);
    const float dq = L.dqt[r], qd = L.qd[r];
    for (int k = 0; k < 6; ++k) {
      Jdq[k] = Jdq[k] + Jr[k] * dq;
      Jd_qd[k] = Jd_qd[k] + Jdr[k] * qd;
    }
  }
  for (int k = 0; k < 6; ++k) w[k] = Ii[k] * Jdq[k] - ch2 * (fm[k] - Ii[k] * Jd_qd[k]);
  copy_f<6>(L.w[i], w);
}

// g[r] = sum_i J[i][r] . w[i] - ch2 fr[r], into g (the record's g, or a
// trial's)
template <int N, int NR>
CHORD_HD void residual_columns(int t, const Shared<N, NR>& sh, Lane<N, NR>& L, float* g) {
  if (t >= NR) return;
  const int r = t;
  const float ch2 = (4.0f / 9.0f) * sh.h * sh.h;
  alignas(16) float Jr[6], w[6];
  float acc = 0.0f;
  for (int i = 0; i < N; ++i) {
    if (!L.moves(i, r)) continue;
    copy_f<6>(Jr, L.J[i][r]);
    copy_f<6>(w, L.w[i]);
    for (int k = 0; k < 6; ++k) acc = acc + Jr[k] * w[k];
  }
  g[r] = acc - ch2 * L.fr[r];
}

// KD[i][s] = cK K J_s + cD D J_s and IJ[i][s] = J_s I of body i: the
// factors of hessian's kd, m_rs and qvv.
template <int N, int NR>
CHORD_HD void newton_terms(int t, const Shared<N, NR>& sh, Lane<N, NR>& L) {
  const float h = sh.h;
  const float cK = -(4.0f / 9.0f) * h * h;
  const float cD = -(2.0f / 3.0f) * h;
  for (int e = t; e < L.npairs; e += kWarp) {
    const int i = L.pairs[e] / NR, s = L.pairs[e] % NR;
    const float* Ii = sh.Ii + 6 * i;
    alignas(16) float Kb[6][6], Db[6][6], Js[6], KD[6], IJ[6];
    float KJs[6], DJs[6];
    copy_f<36>(&Kb[0][0], &L.KDb[0][i][0][0]);
    copy_f<36>(&Db[0][0], &L.KDb[1][i][0][0]);
    copy_f<6>(Js, L.J[i][s]);
    mat6_vec(Kb, Js, KJs);
    mat6_vec(Db, Js, DJs);
    for (int k = 0; k < 6; ++k) {
      KD[k] = cK * KJs[k] + cD * DJs[k];
      IJ[k] = Js[k] * Ii[k];
    }
    copy_f<6>(L.KD[i][s], KD);
    copy_f<6>(L.IJ[i][s], IJ);
  }
}

// H[r][s] = sum over bodies of m_rs + kd + cD (-2) qvv (hessian's terms:
// J_r I . J_s, J_r . KD_s, J_r I . Jdot_s, in its order), then (kSprings)
// over the pair blocks k (bodies b, c) of J_b[r] . GJ[k][s] where r moves b
// and s moves c (add_pair's), plus the joint
// terms on the diagonal, into the left half of M[0], the identity into its
// right half. The (r, s) go to the threads by m = max(r, s) (item q of
// m^2 <= q < (m + 1)^2), so the threads of one pass share most of their
// bodies (in a chain, the bodies from m's on): the warp runs a body's sums
// where any of its threads needs them.
template <int N, int NR, int FEAT>
CHORD_HD void newton_matrix(int t, const Shared<N, NR>& sh, LaneOf<N, NR, FEAT>& L) {
  const float h = sh.h;
  const float cK = -(4.0f / 9.0f) * h * h;
  const float cD = -(2.0f / 3.0f) * h;
  const float* jsf = sh.jsf;
  for (int q = t; q < NR * NR; q += kWarp) {
    int m = static_cast<int>(sqrtf(static_cast<float>(q)));
    m = (m + 1) * (m + 1) <= q ? m + 1 : (m * m > q ? m - 1 : m);
    const int o = q - m * m;
    const int r = o <= m ? m : o - m - 1, s = o <= m ? o : m;
    float acc = 0.0f;
    for (int i = 0; i < N; ++i) {
      if (!L.moves(i, r) || !L.moves(i, s)) continue;
      alignas(16) float Jr[6], IJr[6], Js[6], KDs[6], Jds[6];
      copy_f<6>(Jr, L.J[i][r]);
      copy_f<6>(IJr, L.IJ[i][r]);
      copy_f<6>(Js, L.J[i][s]);
      copy_f<6>(KDs, L.KD[i][s]);
      copy_f<6>(Jds, L.Jd[i][s]);
      float m_rs = 0.0f, kd = 0.0f, qvv = 0.0f;
      for (int k = 0; k < 6; ++k) {
        m_rs = m_rs + IJr[k] * Js[k];
        kd = kd + Jr[k] * KDs[k];
        qvv = qvv + IJr[k] * Jds[k];
      }
      acc = acc + m_rs + kd + cD * (-2.0f) * qvv;
    }
    if constexpr ((FEAT & kSprings) != 0) {
      float(*GJ)[NR][6] = spring_gj<N, NR>(L);
      for (int k = 0; k < L.nblocks; ++k) {
        const int b = L.blkb[k][0], c = L.blkb[k][1];
        if (!L.moves(b, r) || !L.moves(c, s)) continue;
        alignas(16) float Jr[6], GJs[6];
        copy_f<6>(Jr, L.J[b][r]);
        copy_f<6>(GJs, GJ[k][s]);
        float a = 0.0f;
        for (int m = 0; m < 6; ++m) a = a + Jr[m] * GJs[m];
        acc = acc + a;
      }
    }
    if constexpr ((FEAT & kCables) != 0) {
      for (int k = 0; k < L.cnblocks; ++k) {
        const int b = L.cblkb[k][0], c = L.cblkb[k][1];
        if (!L.moves(b, r) || !L.moves(c, s)) continue;
        alignas(16) float Jr[6], GJs[6];
        copy_f<6>(Jr, L.J[b][r]);
        copy_f<6>(GJs, L.CGJ[k][s]);
        float a = 0.0f;
        for (int m = 0; m < 6; ++m) a = a + Jr[m] * GJs[m];
        acc = acc + a;
      }
    }
    if (r == s) {
      const float x = L.x[r];
      const float hit = (x < jsf[3 * NR + r] ? 1.0f : 0.0f) + (x > jsf[4 * NR + r] ? 1.0f : 0.0f);
      const float Krd = -jsf[r] - hit * jsf[5 * NR + r];
      const float Drd = -jsf[NR + r] - hit * jsf[6 * NR + r];
      acc = acc + cK * Krd + cD * Drd;
    }
    L.M[0][r][s] = acc;
    L.M[0][r][NR + s] = r == s ? 1.0f : 0.0f;
  }
}

// Pivot k of the unpivoted Gauss-Jordan inverse (gj_inverse), from M[k & 1]
// into M[(k + 1) & 1], a row a thread: the pivot row scaled by 1 / M[k][k],
// every other row less M[i][k] times it. Columns at or left of k are never
// read again, so what lands there is of no account; each row goes whole, as
// wide accesses.
template <int N, int NR>
CHORD_HD void gj_pivot(int t, Lane<N, NR>& L, int k) {
  if (t >= NR) return;
  const float(*src)[2 * NR] = L.M[k & 1];
  alignas(16) float row[2 * NR], prow[2 * NR];
  copy_f<2 * NR>(row, src[t]);
  copy_f<2 * NR>(prow, src[k]);
  const float inv_p = 1.0f / src[k][k];
  const float fac = src[t][k];
  for (int j = 0; j < 2 * NR; ++j) {
    const float pk = prow[j] * inv_p;
    row[j] = t == k ? pk : row[j] - fac * pk;
  }
  copy_f<2 * NR>(L.M[(k + 1) & 1][t], row);
}

// dx = H^-1 g; thread 0 records |g| (g0n at the predictor).
template <int N, int NR>
CHORD_HD void step_dx(int t, Lane<N, NR>& L, int it) {
  alignas(16) float g[NR];
  copy_f<NR>(g, L.g);
  if (t < NR) {
    alignas(16) float hrow[NR];
    copy_f<NR>(hrow, &L.M[NR & 1][t][NR]);
    float acc = 0.0f;
    for (int s = 0; s < NR; ++s) acc = acc + hrow[s] * g[s];
    L.dx[t] = acc;
  }
  if (t == 0) {
    float gg = 0.0f;
    for (int r = 0; r < NR; ++r) gg = gg + g[r] * g[r];
    const float gn = sqrtf(gg);
    if (it == 0) L.g0n = gn;
    L.gln = gn;  // residual at the pre-update iterate
  }
}

// dx[t] scaled to |dx| <= dx_clamp where the clamp is on (newton_step's).
template <int N, int NR>
CHORD_HD float clamped_dx(int t, const Lane<N, NR>& L, float dx_clamp) {
  float d = L.dx[t];
  if (dx_clamp != 0.0f) {
    float dd = 0.0f;
    for (int r = 0; r < NR; ++r) dd = dd + L.dx[r] * L.dx[r];
    const float scale = fminf(1.0f, dx_clamp / fmaxf(sqrtf(dd), 1e-30f));
    d = d * scale;
  }
  return d;
}

// x -= dx, dx scaled to |dx| <= dx_clamp where the clamp is on.
template <int N, int NR>
CHORD_HD void step_update(int t, Lane<N, NR>& L, float dx_clamp) {
  if (t >= NR) return;
  L.x[t] = L.x[t] - clamped_dx<N, NR>(t, L, dx_clamp);
}

// Trial e of a guarded iteration (1 the full step, 2 the half step) from
// the dx of step_dx: xt[e - 1] = x - dx or x - dx / 2, dx clamped as in
// step_update.
template <int N, int NR, class Rec>
CHORD_HD void trial(int t, Rec& L, int e, float dx_clamp) {
  if (t >= NR) return;
  const float d = clamped_dx<N, NR>(t, L, dx_clamp);
  L.xt[e - 1][t] = L.x[t] - (e == 1 ? d : 0.5f * d);
}

// Thread 0: |g| of both trials and the guard's pick, the full step if |g|
// did not grow there, else the half step if it did not grow there, else
// stay put (a non-finite |g| compares false: grown). gln is |g| at the
// iterate (step_dx's).
template <int N, int NR, class Rec>
CHORD_HD void guard_pick(int t, Rec& L) {
  if (t != 0) return;
  float n[2];
  for (int e = 0; e < 2; ++e) {
    float vv = 0.0f;
    for (int r = 0; r < NR; ++r) vv = vv + L.gt[e][r] * L.gt[e][r];
    n[e] = sqrtf(vv);
  }
  const float gn = L.gln;
  L.gtn[0] = n[0];
  L.gtn[1] = n[1];
  L.pick = n[0] <= gn ? 0 : (n[1] <= gn ? 1 : -1);
}

// The accepted trial: its x, and its g and |g| carried (not recomputed at
// the new iterate).
template <int N, int NR, class Rec>
CHORD_HD void guard_accept(int t, Rec& L, int pick) {
  if (t >= NR) return;
  L.x[t] = L.xt[pick][t];
  L.g[t] = L.gt[pick][t];
  if (t == 0) L.gln = L.gtn[pick];
}

// Rejection (non-finite, residual grown past growth_reject, or above
// tol_reject; with stayput, a guard that stayed put and never halved |g|)
// and the write-out: x [NR, B] (NaN on a rejected lane), H^-1 [NR * NR, B].
template <int N, int NR>
CHORD_HD void write_out(int t, const Lane<N, NR>& L, ChordConfig cfg, int lane, int B,
                        float* x_out, float* hinv_out, bool stayput = false) {
  bool finite = finitef(L.gln);
  for (int r = 0; r < NR; ++r) finite = finite && finitef(L.x[r]);
  bool diverged = !finite || (stayput && L.gln > 0.5f * L.g0n);
  if (cfg.growth_reject != 0.0f) diverged = diverged || (L.gln > cfg.growth_reject * L.g0n);
  if (cfg.tol_reject != 0.0f) diverged = diverged || (L.gln > cfg.tol_reject);
  if (t < NR) x_out[t * B + lane] = diverged ? NAN : L.x[t];
  for (int e = t; e < NR * NR; e += kWarp) hinv_out[e * B + lane] = L.hinv(e / NR, e % NR);
}

// The lane's params: lane-shared from topo_i / stat_f or, in a kPerlane
// build, read from the lane's record, which a phase first copies from
// lane_f (Shared::read_lane's layout).
template <int N, int NR, int FEAT, class Run>
CHORD_HD Shared<N, NR> lane_params(const Run& run, LaneOf<N, NR, FEAT>& L, const int* topo_i,
                                   const float* stat_f, const float* lane_f, int lane, int B) {
  Shared<N, NR> sh(topo_i, stat_f);
  if constexpr ((FEAT & kPerlane) != 0) {
    run(kLaneRecord, [&](int t) { lane_record<N, NR>(t, sh, L, lane_f, lane, B); });
    sh.use_record(L.rec);
  } else {
    (void)run, (void)L, (void)lane_f, (void)lane, (void)B;
  }
  return sh;
}

// The kinematic phases at the iterate xe: the joints' terms and E_pj (and,
// under kQdep, the q-dependent joints' E_pj, S and Sdot), FK, J, the
// twists, Wdot and Jdot.
template <int N, int NR, int FEAT, class Run>
CHORD_HD void kinematics(const Run& run, const Shared<N, NR>& sh, LaneOf<N, NR, FEAT>& L,
                         const float* xe) {
  constexpr bool QDEP = (FEAT & kQdep) != 0;
  run(kJoints, [&](int t) { joints<N, NR, QDEP>(t, sh, L, xe); });
  if constexpr (QDEP) run(kQdepJoints, [&](int t) { qdep_joints<N, NR>(t, sh, L, xe); });
  run(kTree, [&](int t) { fk_tree<N, NR>(t, L); });
  run(kFrames, [&](int t) { body_frames<N, NR>(t, sh, L); });
  run(kJacobian, [&](int t) { jacobian<N, NR>(t, L); });
  run(kTwists, [&](int t) { twists<N, NR>(t, L); });
  run(kWdot, [&](int t) { world_columns_dot<N, NR, FEAT>(t, L); });
  run(kJdot, [&](int t) { jacobian_dot<N, NR>(t, L); });
}

// The endpoint states and forces of the springs at the kinematics' iterate
// (with A and Bm where H is built: blocks).
template <int N, int NR, class Run, class Rec>
CHORD_HD void spring_state(const Run& run, const Shared<N, NR>& sh, Rec& L, bool blocks) {
  run(kSpringPoints, [&](int t) { spring_points<N, NR>(t, sh, L); });
  run(kSpringForces, [&](int t) { spring_forces<N, NR>(t, sh, L, blocks); });
}

// The point states, segments and forces of the cables at the kinematics'
// iterate (with w_s and a_j where H is built: blocks).
template <int N, int NR, class Run, class Rec>
CHORD_HD void cable_state(const Run& run, const Shared<N, NR>& sh, Rec& L, bool blocks) {
  run(kCablePoints, [&](int t) { cable_points<N, NR>(t, sh, L); });
  run(kCableSegments, [&](int t) { cable_segments<N, NR>(t, L, blocks); });
  run(kCableForces, [&](int t) { cable_forces<N, NR>(t, sh, L, blocks); });
}

// The forces, w and the K/D blocks at the kinematics' iterate (and the
// springs' or cables' pair blocks there), then H and H^-1 there
// (newton_matrix's joint terms at the record's x).
template <int N, int NR, int FEAT, class Run>
CHORD_HD void newton_inverse(const Run& run, const Shared<N, NR>& sh, LaneOf<N, NR, FEAT>& L) {
  run(kForcesBlocks, [&](int t) { body_forces<N, NR, FEAT, true>(t, sh, L); });
  run(kNewtonTerms, [&](int t) { newton_terms<N, NR>(t, sh, L); });
  if constexpr ((FEAT & kSprings) != 0) {
    run(kSpringBlocks, [&](int t) { spring_blocks<N, NR>(t, sh, L); });
    run(kSpringColumns, [&](int t) { spring_columns<N, NR>(t, L); });
  }
  if constexpr ((FEAT & kCables) != 0) {
    run(kCableBlocks, [&](int t) { cable_blocks<N, NR>(t, sh, L); });
    run(kCableColumns, [&](int t) { cable_columns<N, NR>(t, L); });
  }
  run(kNewtonMatrix, [&](int t) { newton_matrix<N, NR, FEAT>(t, sh, L); });
  CHORD_NO_UNROLL
  for (int k = 0; k < NR; ++k) run(kGaussJordan, [&](int t) { gj_pivot<N, NR>(t, L, k); });
}

// One lane's fixed-iteration solve: H and H^-1 at the predictor x0, then
// fixed_iters steps x -= H^-1 g(x), the rejection, the write-out
// (chord_bdf2_lane's semantics). A kPerlane build reads the lane's physical
// params from lane_f. A kSprings build evaluates its springs after the
// kinematics of each iterate (their states and forces; their pair blocks
// where H is built). A kRobust build runs the mode rc names
// (chord_bdf2_lane_robust's semantics): chord=False re-builds H and H^-1 at
// x at every iterate; a guarded iteration (every one, or with guard_last the
// last one only) evaluates the residual at the full and at the half trial
// and takes the first at which |g| did not grow, or stays put, carrying the
// accepted trial's g and |g|; a lane that stayed put is rejected when its
// solve never halved |g|. The other builds run the chord mode whatever rc
// says (the launcher sends a robust mode to a kRobust build only). The
// evaluations e of an iteration (0: the kinematics at x, g there unless a
// trial carried it, H^-1 there where it is rebuilt; 1, 2: the trials) run
// in one loop with the iterate chosen at run time, so each phase has one
// call site (every run(phase, f) is inlined, and a site per trial would
// multiply the build's code and compile time); without kRobust the loop is
// evaluation 0 alone. run(phase, f) runs the phase f(tid) on every thread of
// the lane and waits for all of them (on the card f(lane id) and
// __syncwarp(); on the CPU every tid in turn). Every decision is the warp's:
// the loop bounds from the config, the pick from the record.
// fixed_iters >= 1.
template <int N, int NR, int FEAT, class Run>
CHORD_HD void solve(const Run& run, LaneOf<N, NR, FEAT>& L, int lane, int B, const float* x0s,
                    const float* q0s, const float* qd0s, const float* q1s, const float* qd1s,
                    const float* taus, const int* topo_i, const float* stat_f, ChordConfig cfg,
                    float* x_out, float* hinv_out, const float* lane_f = nullptr,
                    RobustConfig rc = RobustConfig{0, 0, 1}) {
  constexpr bool ROBUST = (FEAT & kRobust) != 0;
  constexpr bool SPRINGS = (FEAT & kSprings) != 0;
  constexpr bool CABLES = (FEAT & kCables) != 0;
  const Shared<N, NR> sh = lane_params<N, NR, FEAT>(run, L, topo_i, stat_f, lane_f, lane, B);
  run(kSetup, [&](int t) {
    setup<N, NR>(t, sh, L, lane, B, x0s, q0s, qd0s, q1s, qd1s, taus);
    if constexpr ((FEAT & kQdep) != 0) setup_qdep<N, NR>(t, L);
  });
  run(kPairs, [&](int t) {
    setup_pairs<N, NR>(t, L);
    if constexpr (SPRINGS) setup_springs<N, NR>(t, sh, L);
    if constexpr (CABLES) setup_cables<N, NR>(t, sh, L);
  });
  bool have_g = false, stayput = false;
  CHORD_NO_UNROLL
  for (int it = 0; it < cfg.fixed_iters; ++it) {
    const bool guard =
        ROBUST && (rc.guarded != 0 || (rc.guard_last != 0 && it == cfg.fixed_iters - 1));
    // H at the predictor, or at every iterate
    const bool rebuild = it == 0 || (ROBUST && rc.chord == 0);
    CHORD_NO_UNROLL
    for (int e = have_g && !rebuild ? 1 : 0; e < (guard ? 3 : 1); ++e) {
      const float* xe = L.x;
      float* ge = L.g;
      if constexpr (ROBUST) {
        if (e == 1) run(kStepDx, [&](int t) { step_dx<N, NR>(t, L, it); });
        if (e > 0) {
          run(kTrial, [&](int t) { trial<N, NR>(t, L, e, cfg.dx_clamp); });
          xe = L.xt[e - 1];
          ge = L.gt[e - 1];
        }
      }
      kinematics<N, NR, FEAT>(run, sh, L, xe);
      if constexpr (SPRINGS) spring_state<N, NR>(run, sh, L, e == 0 && rebuild);
      if constexpr (CABLES) cable_state<N, NR>(run, sh, L, e == 0 && rebuild);
      if (e == 0 && rebuild) {  // H and H^-1 at x
        newton_inverse<N, NR, FEAT>(run, sh, L);
      } else {
        run(kForces, [&](int t) { body_forces<N, NR, FEAT, false>(t, sh, L); });
      }
      if (e > 0 || !have_g) run(kResidual, [&](int t) { residual_columns<N, NR>(t, sh, L, ge); });
    }
    if (!guard) {
      run(kStepDx, [&](int t) { step_dx<N, NR>(t, L, it); });
      run(kStepUpdate, [&](int t) { step_update<N, NR>(t, L, cfg.dx_clamp); });
      have_g = false;
      continue;
    }
    if constexpr (ROBUST) {
      run(kGuardPick, [&](int t) { guard_pick<N, NR>(t, L); });
      const int pick = L.pick;
      if (pick >= 0)
        run(kGuardAccept, [&](int t) { guard_accept<N, NR>(t, L, pick); });
      else
        stayput = true;
      have_g = true;
    }
  }
  run(kWriteOut, [&](int t) { write_out<N, NR>(t, L, cfg, lane, B, x_out, hinv_out, stayput); });
}

}  // namespace coop
}  // namespace chord
