// Cooperative body of the fused dual projected Gauss-Seidel QP solve: a
// group of G threads per lane, every value that crosses a phase in the
// lane's record in shared memory.
//
// Replaces the lane arithmetic of redmax_tpu/pallas_qp.py::_build_kernel
// (:40-92), as dual_pgs_lane.cuh does one thread a lane, in that body's
// order: every sum runs as it runs there (the row dot over j = 0..M-1, then
// + D[i][i] lambda_i; the true division by safe_i; clip_keep_nan), so the two
// give the same result bit for bit wherever the compiler contracts the same
// multiply-adds (always under g++, which contracts none). That matters at
// m > n, where D is singular, lambda is not unique and two orders walk
// different iterate paths.
//
// G is the smallest power of two at or above max(N, M), at most 32: 16 at
// (6, 12), 8 at (6, 8), 2 at (2, 1); 32 / G lanes share a warp. The phases,
// each a function of (tid, record) with the warp's barrier between:
//   load       row t of H into the left half of [H | I] (the identity in its
//              right half), row t of A, and f, b, lo, hi, all as the caller
//              holds them ([B, P] row-major), as 16- or 8-byte accesses
//              where the counts allow
//   GJ         the unpivoted Gauss-Jordan of [H | I], one pivot at a time,
//              row t of the elimination on thread t, from one buffer into
//              the other
//   columns    Hf[t] = H^-1 f on thread t < N; HAT[:, t] = H^-1 A[t, :]^T
//              on thread t < M
//   rows       row t of D = A HAT, r_t = A[t, :] Hf - b_t, safe_t and
//              lambda_t = 0 on thread t < M
//   sweeps     thread t loads row t of D, r_t, safe_t, lo_t and hi_t into
//              its registers once, and every thread a copy of lambda; then
//              sweep by sweep, row by row, every thread computes its row's
//              update from its copy and the group takes thread i's as
//              lambda_i (run.bcast: a __shfl_sync on the card), all in
//              registers: `iters` * M dependent row updates. Row t's dot
//              runs j = 0..M-1 in order, its terms j < t added as each
//              lambda_j arrives (the sum a thread carries from row to row),
//              so at row t thread t adds only the terms j >= t: the same
//              sum in the same order, half the chain; a zero dividend's
//              quotient is taken without a division (row_quotient)
//   write-out  x_t = Hf_t - sum_j HAT[t][j] lambda_j on thread t < N, and
//              lambda_t, as [B, N] and [B, M] row-major.
// On the CPU g++ runs each phase for every tid of the group in turn (either
// order), each thread's registers an element of an array, the broadcast
// reading thread i's (tests/test_torch_qp_coop.py).
//
// What bounds it on an H100: the chain of `iters` * M row updates, each the
// rest of a dot of M, a division, a clip and a shuffle; the operation bound
// (about 1.7e4 flops a lane at (6, 12)) is far below what that chain
// allows.
#pragma once

#include "dual_pgs_lane.cuh"

#ifdef __CUDACC__
#define QP_NO_UNROLL _Pragma("unroll 1")
#else
#define QP_NO_UNROLL
#endif

namespace qp {
namespace coop {

// Threads a lane: the smallest power of two at or above max(N, M) (at most
// 32: the launcher instantiates no wider shape).
template <int N, int M>
__host__ __device__ constexpr int group_threads() {
  const int w = N > M ? N : M;
  int g = 1;
  while (g < w) g *= 2;
  return g;
}

// The phases of a solve, for run(phase, f).
enum Phase {
  kLoad, kPivot, kColumns, kRows, kSweepLoad, kSweepRow, kSweepTake, kSweepStore, kWriteOut,
  kPhases
};

// NF floats from src to dst: on the card as 16-byte accesses where NF is a
// multiple of 4, else 8-byte ones where it is even (both sides aligned to
// that), else one float at a time.
template <int NF>
QP_HD void copy_f(float* __restrict__ dst, const float* __restrict__ src) {
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

// The index I as a value whose type carries it (a __host__ __device__
// std::integral_constant).
template <int I>
struct Index {
  QP_HD constexpr operator int() const { return I; }
};

// f(Index<I>) for I = I0..I1-1 in order: a loop whose index is a constant in
// each body, so that every index into a thread's registers is one (an
// unroll pragma leaves that to the compiler).
template <int I0, int I1, class F>
QP_HD void static_for(F&& f) {
  if constexpr (I0 < I1) {
    f(Index<I0>{});
    static_for<I0 + 1, I1>(f);
  }
}

// Chunk t, t + G, ... of NF floats from src to dst, each chunk one access of
// the widest of 4, 2 or 1 floats that divides NF.
template <int NF, int G>
QP_HD void copy_chunks(int t, float* __restrict__ dst, const float* __restrict__ src) {
  constexpr int W = NF % 4 == 0 ? 4 : (NF % 2 == 0 ? 2 : 1);
  for (int c = t; c < NF / W; c += G) copy_f<W>(dst + W * c, src + W * c);
}

// One lane's record.
template <int N, int M>
struct alignas(16) LaneQP {
  alignas(16) float Mx[2][N][2 * N];  // Gauss-Jordan [H | I], pivot k reads Mx[k & 1]
  alignas(16) float Am[M][N];         // A
  alignas(16) float HAT[N][M];        // H^-1 A^T
  alignas(16) float D[M][M];          // A H^-1 A^T
  alignas(16) float lam[M];
  alignas(16) float fv[N];
  alignas(16) float Hf[N];
  alignas(16) float b[M];
  alignas(16) float lo[M];
  alignas(16) float hi[M];
  alignas(16) float rv[M];
  alignas(16) float safe[M];

  QP_HD float hinv(int i, int k) const { return Mx[N & 1][i][N + k]; }
};

// What a thread keeps in registers through the sweeps: its row of D, the
// diagonal term, r, safe and the box of its row (zeros and safe 1 on a
// thread past the rows), whether safe is finite and non-zero, its copy of
// lambda, the sum of its row's dot carried from row to row, and its
// candidate update of the current row.
template <int M>
struct alignas(16) SweepRegs {
  alignas(16) float D[M];
  alignas(16) float lam[M];
  float dii, rv, safe, lo, hi, acc, cand;
  bool safe_finite;
};

// Row t of H (identity beside it), row t of A, and chunks of f, b, lo, hi of
// lane `lane`, from the [B, P] row-major inputs.
template <int N, int M>
QP_HD void load(int t, LaneQP<N, M>& L, int lane, const float* H, const float* f,
                const float* A, const float* b, const float* lo, const float* hi) {
  constexpr int G = group_threads<N, M>();
  if (t < N) {
    copy_f<N>(L.Mx[0][t], H + (static_cast<long>(lane) * N + t) * N);
    for (int j = 0; j < N; ++j) L.Mx[0][t][N + j] = t == j ? 1.0f : 0.0f;
  }
  if (t < M) copy_f<N>(L.Am[t], A + (static_cast<long>(lane) * M + t) * N);
  copy_chunks<N, G>(t, L.fv, f + static_cast<long>(lane) * N);
  copy_chunks<M, G>(t, L.b, b + static_cast<long>(lane) * M);
  copy_chunks<M, G>(t, L.lo, lo + static_cast<long>(lane) * M);
  copy_chunks<M, G>(t, L.hi, hi + static_cast<long>(lane) * M);
}

// Pivot k of the unpivoted Gauss-Jordan inverse (dual_pgs_lane's), from
// Mx[k & 1] into Mx[(k + 1) & 1], row t on thread t: the pivot row scaled by
// 1 / Mx[k][k], every other row less Mx[t][k] times the scaled pivot row.
template <int N, int M>
QP_HD void gj_pivot(int t, LaneQP<N, M>& L, int k) {
  if (t >= N) return;
  const float(*src)[2 * N] = L.Mx[k & 1];
  alignas(16) float row[2 * N], prow[2 * N];
  copy_f<2 * N>(row, src[t]);
  copy_f<2 * N>(prow, src[k]);
  const float inv_p = 1.0f / src[k][k];
  const float fac = src[t][k];
  for (int j = 0; j < 2 * N; ++j) {
    const float pk = prow[j] * inv_p;
    row[j] = t == k ? pk : row[j] - fac * pk;
  }
  copy_f<2 * N>(L.Mx[(k + 1) & 1][t], row);
}

// Hf[t] = H^-1 f on thread t < N; HAT[:, t] = H^-1 A[t, :]^T on thread t < M.
template <int N, int M>
QP_HD void columns(int t, LaneQP<N, M>& L) {
  if (t < N) {
    alignas(16) float f[N];
    copy_f<N>(f, L.fv);
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc += L.hinv(t, k) * f[k];
    L.Hf[t] = acc;
  }
  if (t < M) {
    alignas(16) float a[N];
    copy_f<N>(a, L.Am[t]);
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
      for (int k = 0; k < N; ++k) acc += L.hinv(i, k) * a[k];
      L.HAT[i][t] = acc;
    }
  }
}

// Row t of D = A HAT, r_t = A[t, :] Hf - b_t, the reg-guarded diagonal
// safe_t and lambda_t = 0, on thread t < M.
template <int N, int M>
QP_HD void rows(int t, LaneQP<N, M>& L, float reg) {
  if (t >= M) return;
  alignas(16) float a[N], d[M];
  float dtt = 0.0f;  // D[t][t], picked as it goes by (no register indexed by t)
  copy_f<N>(a, L.Am[t]);
  for (int j = 0; j < M; ++j) {
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc += a[k] * L.HAT[k][j];
    d[j] = acc;
    dtt = j == t ? acc : dtt;
  }
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) acc += a[k] * L.Hf[k];
  L.rv[t] = acc - L.b[t];
  L.safe[t] = fabsf(dtt) < reg ? 1.0f : dtt;
  L.lam[t] = 0.0f;
  copy_f<M>(L.D[t], d);
}

// Thread t < M: its row of D, D[t][t], r_t, safe_t, lo_t and hi_t into R;
// every thread: lambda (zero) into its copy.
template <int N, int M>
QP_HD void sweep_load(int t, const LaneQP<N, M>& L, SweepRegs<M>& R) {
  copy_f<M>(R.lam, L.lam);
  R.acc = R.cand = 0.0f;
  if (t >= M) {
    for (int j = 0; j < M; ++j) R.D[j] = 0.0f;
    R.dii = R.rv = R.lo = R.hi = 0.0f;
    R.safe = 1.0f;
  } else {
    copy_f<M>(R.D, L.D[t]);
    R.dii = L.D[t][t];
    R.rv = L.rv[t];
    R.safe = L.safe[t];
    R.lo = L.lo[t];
    R.hi = L.hi[t];
  }
  R.safe_finite = fabsf(R.safe) <= 3.402823466e38f && R.safe != 0.0f;
}

// resid / safe, a zero resid (a masked row's, or a thread's past the rows)
// excepted where safe is finite and non-zero: there the quotient is the
// zero of sign(resid) ^ sign(safe), resid * safe, and the division gets 1
// instead. The two agree bit for bit; on the card a division of a zero
// dividend takes the slow path of IEEE division, and a warp's division
// takes it when any of its threads' does.
// (The dividend passes through an empty asm on the card: otherwise nvcc
// sees that the quotient of 1 is never used and divides resid itself.)
template <int M>
QP_HD float row_quotient(const SweepRegs<M>& R, float resid) {
  const bool zero = resid == 0.0f && R.safe_finite;
  float num = zero ? 1.0f : resid;
#ifdef __CUDA_ARCH__
  asm("" : "+f"(num));
#endif
  const float q = num / R.safe;
  return zero ? resid * R.safe : q;
}

// Row i of a Gauss-Seidel sweep, every thread from its own registers:
// its row's dot finished over j = i..M-1 onto the sum it carries (on thread
// i that sum holds the terms j < i, each with the lambda_j of this sweep,
// in order), the update and the clip (dual_pgs_lane's arithmetic); only
// thread i's candidate is taken. Row 0 starts every thread's sum at 0.
template <int M, int I>
QP_HD void sweep_row(SweepRegs<M>& R) {
  if constexpr (I == 0) R.acc = 0.0f;
  float acc = R.acc;
  static_for<I, M>([&](auto j) { acc += R.D[j] * R.lam[j]; });
  const float resid = R.rv - acc + R.dii * R.lam[I];
  R.cand = clip_keep_nan(row_quotient(R, resid), R.lo, R.hi);
}

// lambda_I = thread I's candidate into every thread's copy, and its term of
// each later row's dot onto that row's sum.
template <int M, int I>
QP_HD void sweep_take(SweepRegs<M>& R, float lam_i) {
  R.lam[I] = lam_i;
  R.acc += R.D[I] * lam_i;
}

// Thread 0: lambda from its copy (every thread's is the same) into the
// record.
template <int N, int M>
QP_HD void sweep_store(int t, LaneQP<N, M>& L, const SweepRegs<M>& R) {
  if (t == 0) copy_f<M>(L.lam, R.lam);
}

// x_t = Hf_t - HAT[t, :] lambda on thread t < N and lambda_t on thread
// t < M, into x_out [B, N] and lam_out [B, M].
template <int N, int M>
QP_HD void write_out(int t, const LaneQP<N, M>& L, int lane, float* x_out, float* lam_out) {
  if (t < N) {
    alignas(16) float h[M], lam[M];
    copy_f<M>(h, L.HAT[t]);
    copy_f<M>(lam, L.lam);
    float acc = 0.0f;
    for (int j = 0; j < M; ++j) acc += h[j] * lam[j];
    x_out[static_cast<long>(lane) * N + t] = L.Hf[t] - acc;
  }
  if (t < M) lam_out[static_cast<long>(lane) * M + t] = L.lam[t];
}

// One lane's solve. run(phase, f) runs f(tid) on every thread of the lane's
// group and waits for all of them (on the card f(thread id) and the group's
// __syncwarp; on the CPU every tid in turn); run.local(phase, f) the same
// without the barrier, for a phase on registers only; regs[run.slot(t)] is
// thread t's registers (on the card its own, on the CPU an array of G), and
// run.bcast(regs, i) thread i's candidate (on the card a __shfl_sync, which
// every thread of the group reaches with its own). The row loop is a
// static_for, so every index into a thread's registers is a constant. With
// write false the lane is solved and nothing is written.
template <int N, int M, class Run>
QP_HD void solve(const Run& run, LaneQP<N, M>& L, SweepRegs<M>* regs, int lane, const float* H,
                 const float* f, const float* A, const float* b, const float* lo,
                 const float* hi, int iters, float reg, float* x_out, float* lam_out,
                 bool write = true) {
  run(kLoad, [&](int t) { load<N, M>(t, L, lane, H, f, A, b, lo, hi); });
  QP_NO_UNROLL
  for (int k = 0; k < N; ++k) run(kPivot, [&](int t) { gj_pivot<N, M>(t, L, k); });
  run(kColumns, [&](int t) { columns<N, M>(t, L); });
  run(kRows, [&](int t) { rows<N, M>(t, L, reg); });
  run.local(kSweepLoad, [&](int t) { sweep_load<N, M>(t, L, regs[run.slot(t)]); });
  QP_NO_UNROLL
  for (int it = 0; it < iters; ++it) {
    static_for<0, M>([&](auto i) {
      run.local(kSweepRow, [&](int t) { sweep_row<M, i>(regs[run.slot(t)]); });
      run.local(kSweepTake, [&](int t) { sweep_take<M, i>(regs[run.slot(t)], run.bcast(regs, i)); });
    });
  }
  run(kSweepStore, [&](int t) { sweep_store<N, M>(t, L, regs[run.slot(t)]); });
  run(kWriteOut, [&](int t) {
    if (write) write_out<N, M>(t, L, lane, x_out, lam_out);
  });
}

}  // namespace coop
}  // namespace qp
