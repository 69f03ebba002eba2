// Per-lane arithmetic of the batched projected Gauss-Seidel sweeps (K3), in
// float and double, and the two designs that run it on the card.
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
// The sweep keeps sigma = r - Doff lambda, Doff being D with its diagonal
// set to 0, instead of taking a dot product a row (the same iterates in
// exact arithmetic): row i's residual is sigma_i itself. At each sweep's
// start every sigma_j is computed afresh (refresh: four partial sums over
// the columns, c % 4, in column order), so rounding cannot drift past one
// sweep; within the sweep row i's change delta updates sigma_j -= D_ji delta
// for the rows j > i, the only ones the sweep reads again. A row's dependent
// chain is then: that FMA, the quotient sigma_i * (1 / safe_i) with one FMA
// correction (row_step: the reciprocal is taken once a lane, off the
// chain), a clip, the delta.
//
// Every multiply-add is an explicit fma, so nvcc and g++ compute the same
// bits: the host build (pgs_sweeps_host.cpp, lane_sweeps) gives both card
// designs' results bit for bit, and a g++ unit can run each card design's
// phases thread by thread (tests/test_torch_pgs_body.py).
//
// The designs (pgs_sweeps.cu launches them; pgs_kernel.design_of picks):
// - thread_sweeps: one thread a lane, m a template constant (M), its rows'
//   sigma, lambda, bounds and reciprocals in registers, D in shared memory
//   (thread_load: the block's lanes side by side), no shuffle.
// - warp_sweeps: a warp a lane (Team: the warp on the card, a serial loop of
//   its 32 threads under g++), thread t holding rows t + 32 k (WarpRows), D
//   in shared memory transposed (FullStore) or, for a symmetric D, its lower
//   triangle (TriStore); row i's owner proposes, one shuffle hands its delta
//   to the warp. The owner's slot and lane are compile-time constants: the
//   K slots of 32 rows are unrolled, the slots rotating through slot 0.
// The earlier design (pgs_sweeps.cu's div_kernel, kept as a yardstick) uses
// row_update and refresh_row below: a division a row on the chain.
//
// The functions are __host__ __device__: g++ builds them for CPU tensors,
// nvcc for the card. The macros are defined empty when __CUDACC__ is absent.
#pragma once

#include <type_traits>

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#if defined(__x86_64__)
// fma() inline as one instruction (the host entry checks the CPU has it)
#pragma GCC push_options
#pragma GCC target("fma")
#define PGS_POP_OPTIONS
#endif
#endif

namespace pgs {

#define PGS_HD __host__ __device__ __forceinline__

constexpr int kWarp = 32;

PGS_HD float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
PGS_HD double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The largest finite value: q beyond it is +inf, below its negative -inf.
template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float kMax = 3.40282346638528859812e+38f;
};
template <>
struct Limits<double> {
  static constexpr double kMax = 1.79769313486231570815e+308;
};

// The guarded diagonal: 1 where |d| < reg (a masked or degenerate row).
template <typename T>
PGS_HD T safe_diag(T d, T reg) {
  return (d < T(0) ? -d : d) < reg ? T(1) : d;
}

// A row's constants, once a lane: safe_i and inv_i = 1 / safe_i. A NaN
// bound, or a diagonal that is not finite, sets inv_i to NaN: the plain
// version's row is NaN then whatever its residual (the clip keeps a NaN
// bound; r - D lambda + D_ii lambda_i is NaN with an infinite D_ii).
template <typename T>
PGS_HD void prep_row(T d, T lo, T hi, T reg, T& safe, T& inv) {
  safe = safe_diag(d, reg);
  inv = T(1) / safe;
  const T zero = T(0);
  if (lo != lo || hi != hi || d - d != d - d) inv = zero / zero;
}

// Row i's new lambda from sigma_i: the quotient sigma_i / safe_i as
// q = sigma_i * inv_i corrected by one FMA (the correctly rounded quotient
// but in corner cases), clipped to [lo_i, hi_i] keeping a NaN. An infinite
// q (an infinite residual, or an overflow) has a NaN correction: it clips
// as the infinity it is.
template <typename T>
PGS_HD T row_step(T sig, T inv, T safe, T lo, T hi) {
  const T q = sig * inv;
  const T qc = fma_t(fma_t(-q, safe, sig), inv, q);
  const T v = (qc < lo || q < -Limits<T>::kMax) ? lo : qc;
  return (v > hi || q > Limits<T>::kMax) ? hi : v;
}

// A cursor over row j of a store: next() is Doff_jc for c = 0, 1, ... in
// turn. Strided: the row's entries `step` apart.
template <typename T>
struct Strided {
  const T* p;
  long step;
  PGS_HD T next() {
    const T v = *p;
    p += step;
    return v;
  }
};

// sigma_j = r_j - sum_c Doff_jc lambda_c for N rows at once (out[n], row n
// read by the cursor d[n], r_j = r[n]): for each row four partial sums
// (c % 4), each in column order; the N rows share each read of lambda and
// their chains run side by side.
template <int N, typename T, class Cursor>
PGS_HD void refresh_n(int m, Cursor (&d)[N], const T* r, const T* lam, T* out) {
  T s[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = T(0);
  int c = 0;
#pragma unroll
  for (; c + 4 <= m; c += 4) {
    const T l0 = lam[c], l1 = lam[c + 1], l2 = lam[c + 2], l3 = lam[c + 3];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      s[n][0] = fma_t(d[n].next(), l0, s[n][0]);
      s[n][1] = fma_t(d[n].next(), l1, s[n][1]);
      s[n][2] = fma_t(d[n].next(), l2, s[n][2]);
      s[n][3] = fma_t(d[n].next(), l3, s[n][3]);
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (c + q < m) {
      const T l = lam[c + q];
#pragma unroll
      for (int n = 0; n < N; ++n) s[n][q] = fma_t(d[n].next(), l, s[n][q]);
    }
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = r[n] - ((s[n][0] + s[n][1]) + (s[n][2] + s[n][3]));
}

// refresh_n of one row: sigma_j.
template <typename T, class Cursor>
PGS_HD T refresh(int m, Cursor d, T r_j, const T* lam) {
  Cursor ds[1] = {d};
  T out[1];
  refresh_n<1>(m, ds, &r_j, lam, out);
  return out[0];
}

// One lane on one thread at any m (the host build): lam [m] out; Doff [m, m]
// scratch (D row-major, diagonal 0: the refresh's rows), Dcol [m, m] scratch
// (its transpose: the update's columns), sig, inv, safe [m] scratch.
template <typename T>
PGS_HD void lane_sweeps(int m, const T* D, const T* r, const T* lo, const T* hi, int iters,
                        T reg, T* lam, T* Doff, T* Dcol, T* sig, T* inv, T* safe) {
  for (int j = 0; j < m; ++j)
    for (int c = 0; c < m; ++c) {
      const T v = j == c ? T(0) : D[static_cast<long>(j) * m + c];
      Doff[static_cast<long>(j) * m + c] = v;
      Dcol[static_cast<long>(c) * m + j] = v;
    }
  for (int i = 0; i < m; ++i) {
    prep_row(D[static_cast<long>(i) * m + i], lo[i], hi[i], reg, safe[i], inv[i]);
    lam[i] = T(0);
  }
  for (int it = 0; it < iters; ++it) {
    for (int j = 0; j < m; ++j) {
      sig[j] = refresh(m, Strided<T>{Doff + static_cast<long>(j) * m, 1}, r[j], lam);
    }
    for (int i = 0; i < m; ++i) {
      const T v = row_step(sig[i], inv[i], safe[i], lo[i], hi[i]);
      const T delta = v - lam[i];
      lam[i] = v;
      const T* col = Dcol + static_cast<long>(i) * m;
      for (int j = i + 1; j < m; ++j) sig[j] = fma_t(-col[j], delta, sig[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// One thread a lane (small m)
// ---------------------------------------------------------------------------

// The block's lanes' Doff in shared memory, element e = j * M + c of lane l
// at Ds[e * lanes + l] (a warp's reads of one element are contiguous).
template <typename T, int M>
struct BlockStore {
  const T* Ds;
  int lanes, l;
  PGS_HD T operator()(int j, int c) const { return Ds[(j * M + c) * lanes + l]; }
  PGS_HD Strided<T> row(int j) const { return {Ds + j * M * lanes + l, lanes}; }
};

// Thread tid's share of loading the block's `lanes` lanes (of `n` that
// exist, from lane0 on) into BlockStore's layout, diagonal 0.
template <typename T, int M>
PGS_HD void thread_load(int tid, int lanes, int n, const T* D, T* Ds) {
  constexpr int MM = M * M;
  for (int idx = tid; idx < n * MM; idx += lanes) {
    const int l = idx / MM, e = idx - l * MM;
    Ds[e * lanes + l] = e / M == e % M ? T(0) : D[idx];
  }
}

// Lane l of the block (D its lane in device memory, for the diagonal): its
// iters sweeps into lam [M]. r is read where the refresh needs it, off the
// chain, to spare M registers.
template <typename T, int M>
PGS_HD void thread_sweeps(const BlockStore<T, M>& Ds, const T* D, const T* r, const T* lo,
                          const T* hi, int iters, T reg, T* lam_out) {
  T sig[M], lam[M], lov[M], hiv[M], inv[M], safe[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    lov[j] = lo[j];
    hiv[j] = hi[j];
    prep_row(D[j * M + j], lov[j], hiv[j], reg, safe[j], inv[j]);
    lam[j] = T(0);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < M; ++j) sig[j] = refresh(M, Ds.row(j), r[j], lam);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T v = row_step(sig[i], inv[i], safe[i], lov[i], hiv[i]);
      const T delta = v - lam[i];
      lam[i] = v;
#pragma unroll
      for (int j = i + 1; j < M; ++j) sig[j] = fma_t(-Ds(j, i), delta, sig[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) lam_out[j] = lam[j];
}

// ---------------------------------------------------------------------------
// A warp a lane (larger m)
// ---------------------------------------------------------------------------

// Elements of a lane's D store: m * m (FullStore) or m (m + 1) / 2
// (TriStore), and kWarp more at the end, which the rows past m read.
PGS_HD long store_elems(int m, bool tri) {
  return (tri ? static_cast<long>(m) * (m + 1) / 2 : static_cast<long>(m) * m) + kWarp;
}

// Doff transposed: (j, c) at c * m + j, so that a warp's reads of one column
// (the update) and of one c over its rows (the refresh) are contiguous.
// col(i) + j is (j, i).
template <typename T>
struct FullStore {
  const T* Ds;
  int m;
  PGS_HD static long index(int m, int j, int c) { return static_cast<long>(c) * m + j; }
  PGS_HD long col(int i) const { return static_cast<long>(i) * m; }
  PGS_HD Strided<T> row(int j) const { return {Ds + j, m}; }
};

// The lower triangle of a symmetric Doff, column by column: (j, c) with
// j >= c at off(c) + j - c, off(c) = c m - c (c - 1) / 2; (j, c) with j < c
// read as (c, j). col(i) + j is (j, i) for j >= i, the update's live rows
// (a row j < i reads another entry of the store: its sigma is not read
// again before the refresh), contiguous; the refresh's row j runs down
// column c while c <= j, then along column j, one cursor step each.
template <typename T>
struct TriStore {
  const T* Ds;
  int m;
  PGS_HD static long index(int m, int j, int c) {
    const int a = j >= c ? c : j, b = j >= c ? j : c;
    return static_cast<long>(a) * m - static_cast<long>(a) * (a - 1) / 2 + (b - a);
  }
  PGS_HD long col(int i) const { return index(m, i, i) - i; }
  struct Row {
    const T* Ds;
    int m, j, c;
    long k;
    PGS_HD T next() {
      const T v = Ds[k];
      k += c < j ? m - c - 1 : 1;
      ++c;
      return v;
    }
  };
  PGS_HD Row row(int j) const { return {Ds, m, j, 0, j}; }
};

// Thread t's share of loading a lane's Doff (D row-major in device memory)
// into Store's layout, and the pad past it to 0. A TriStore reads D's lower
// triangle only.
template <typename T, class Store>
PGS_HD void warp_load(int t, int m, bool tri, const T* D, T* Ds) {
  const long mm = static_cast<long>(m) * m;
  for (long k = t; k < mm; k += kWarp) {
    const int j = static_cast<int>(k / m), c = static_cast<int>(k - static_cast<long>(j) * m);
    if (!tri || j >= c) Ds[Store::index(m, j, c)] = j == c ? T(0) : D[k];
  }
  Ds[store_elems(m, tri) - kWarp + t] = T(0);
}

// Thread t's rows j = t + 32 k, k < K, rotated: slot 0 is the slot being
// swept; at a sweep's start (and its end) slot k is rows t + 32 k.
template <typename T, int K>
struct WarpRows {
  T sig[K], lam[K], r[K], lo[K], hi[K], inv[K], safe[K];
  T dcol[K];   // D_ji of the row being swept, for each slot's row j (load_col)
  T cand, d;   // slot 0's proposed lambda and its change (propose)

  PGS_HD void init(int t, int m, const T* D, const T* rr, const T* lo_, const T* hi_, T reg) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = t + kWarp * k;
      const bool in = j < m;
      r[k] = in ? rr[j] : T(0);
      lo[k] = in ? lo_[j] : T(0);
      hi[k] = in ? hi_[j] : T(0);
      prep_row(in ? D[static_cast<long>(j) * m + j] : T(1), lo[k], hi[k], reg, safe[k], inv[k]);
      lam[k] = T(0);
      sig[k] = T(0);
    }
  }
  PGS_HD void publish(int t, T* lam_s) const {
#pragma unroll
    for (int k = 0; k < K; ++k) lam_s[t + kWarp * k] = lam[k];
  }
  template <class Store>
  PGS_HD void refresh_rows(int t, int m, const Store& Ds, const T* lam_s) {
    decltype(Ds.row(0)) rows[K];
#pragma unroll
    for (int k = 0; k < K; ++k) rows[k] = Ds.row(t + kWarp * k);
    refresh_n<K>(m, rows, r, lam_s, sig);
  }
  PGS_HD void propose() {
    cand = row_step(sig[0], inv[0], safe[0], lo[0], hi[0]);
    d = cand - lam[0];
  }
  // Row i = 32 kk + s: D_ji for every live slot's row j (slots kk.. of
  // this sweep) from Ds[col + j] (col: the store's col(i); rows j <= i of
  // slot kk too: those are not read again before the refresh), read before
  // the row's exchange so that no read waits on it.
  PGS_HD void load_col(int t, int kk, const T* Ds, long col) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < K - kk) dcol[k] = Ds[col + t + kWarp * (kk + k)];
  }
  // Row i = 32 kk + s swept with change delta: its owner (t == s) takes
  // the candidate; every live slot's row j takes sigma_j -= D_ji delta.
  PGS_HD void apply(int t, int s, int kk, T delta) {
    lam[0] = t == s ? cand : lam[0];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < K - kk) sig[k] = fma_t(-dcol[k], delta, sig[k]);
  }
  PGS_HD void rotate() {
    rot(sig);
    rot(lam);
    rot(lo);
    rot(hi);
    rot(inv);
    rot(safe);
  }
  PGS_HD static void rot(T* a) {
    const T a0 = a[0];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) a[k] = a[k + 1];
    a[K - 1] = a0;
  }
};

// One lane on a team of 32 threads: Team::each(f) runs f(t, rows of t) on
// each thread (on the card: this thread; under g++: all 32 in turn),
// Team::from(s) is thread s's d (a shuffle), Team::sync() orders the shared
// memory writes of one phase before the reads of the next. D is the lane's
// D in device memory, Ds the shared store (store_elems), lam_s [32 K]
// shared; lam [m] out.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <typename T, int K, bool kTri, class Team>
PGS_HD void warp_sweeps(Team& team, int m, const T* D, const T* r, const T* lo, const T* hi,
                        int iters, T reg, T* Ds, T* lam_s, T* lam) {
  using Store = typename std::conditional<kTri, TriStore<T>, FullStore<T>>::type;
  const Store store{Ds, m};
  team.each([&](int t, WarpRows<T, K>& w) {
    warp_load<T, Store>(t, m, kTri, D, Ds);
    w.init(t, m, D, r, lo, hi, reg);
  });
  for (int it = 0; it < iters; ++it) {
    team.sync();   // the last refresh's reads of lam_s are done
    team.each([&](int t, WarpRows<T, K>& w) { w.publish(t, lam_s); });
    team.sync();
    team.each([&](int t, WarpRows<T, K>& w) { w.refresh_rows(t, m, store, lam_s); });
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int rows = m - kWarp * kk < kWarp ? m - kWarp * kk : kWarp;
#pragma unroll
      for (int s = 0; s < kWarp; ++s) {
        if (s >= rows) break;
        const long col = store.col(kWarp * kk + s);
        team.each([&](int t, WarpRows<T, K>& w) {
          w.load_col(t, kk, Ds, col);
          w.propose();
        });
        const T delta = team.from(s);
        team.each([&](int t, WarpRows<T, K>& w) { w.apply(t, s, kk, delta); });
      }
      team.each([&](int, WarpRows<T, K>& w) { w.rotate(); });
    }
  }
  team.each([&](int t, WarpRows<T, K>& w) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t + kWarp * k < m) lam[t + kWarp * k] = w.lam[k];
  });
}

// ---------------------------------------------------------------------------
// The earlier design's row (div_kernel in pgs_sweeps.cu): rho = r - D lambda
// with the diagonal, a division a row.
// ---------------------------------------------------------------------------

// min(max(v, lo), hi) that keeps a NaN of v, lo or hi.
template <typename T>
PGS_HD T clip_keep_nan(T v, T lo, T hi) {
  v = (v < lo || lo != lo) ? lo : v;
  return (v > hi || hi != hi) ? hi : v;
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

}  // namespace pgs

#ifdef PGS_POP_OPTIONS
#pragma GCC pop_options
#undef PGS_POP_OPTIONS
#endif
