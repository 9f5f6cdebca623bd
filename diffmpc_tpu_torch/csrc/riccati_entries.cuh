// Per-step Riccati helpers for one scenario, shared by the kernels.
//
// Device-function counterparts of the entry-tile helpers of
// diffmpc_tpu/ops/pallas/riccati.py: _chol_entries (:141),
// _cho_solve_entries (:160), _masked_chol_solve (:177), the box QP
// _pnqp_entries (:329-416) with its active-set enumeration
// _pnqp_enum_entries (:204-298) under each DIFFMPC_PNQP_ENUM mode (:301-341,
// here the template flag ENUM), and _value_update (:433), in its full form
// (the default, VALUE_UPDATE_EXACT_REG = -1 at :506) or, with EXACT, its
// simplified one (:456-469). On the TPU each entry is an
// (S, 128) tile over scenarios; here one thread owns one scenario, so each
// entry is one float in a register. diffmpc_tpu_torch/ops/cuda/
// riccati_entries.py is the same arithmetic in plain PyTorch, entry by entry
// and in the same order.
#pragma once

#include "dual.cuh"
#include "lanes.cuh"

// a * b + c: on the card with F in one rounding (fmaf), else as written,
// which nvcc fuses or not as a product's uses lead it. The Riccati sweep
// (riccati.cuh), built without FMA contraction, takes F in every helper
// below, in one thread's step and in a lane group's shares alike, fusing
// where nvcc's contraction fused the one-thread kernel; every other caller
// keeps F false, its code as it was. The tests' host build fuses nothing,
// as for every kernel nvcc contracts on the card.
template <bool F>
DMPC_HD float riccati_mad(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  if constexpr (F) return fmaf(a, b, c);
#endif
  return c + a * b;
}

// c - a * b, the same way.
template <bool F>
DMPC_HD float riccati_msub(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  if constexpr (F) return fmaf(-a, b, c);
#endif
  return c - a * b;
}

// Cholesky of the leading D x D block (D <= M) of an SPD matrix; lower
// factor. The enumeration below factors free blocks of every size D < M.
template <int M, bool F = false>
DMPC_HD void chol_entries(const float (&A)[M][M], float reg, float (&L)[M][M], int D = M) {
  for (int j = 0; j < D; ++j) {
    float s = A[j][j] + reg;
    for (int k = 0; k < j; ++k) s = riccati_msub<F>(L[j][k], L[j][k], s);
    const float d = sqrtf(s);
    L[j][j] = d;
    const float inv = 1.0f / d;
    for (int i = j + 1; i < D; ++i) {
      float t = A[i][j];
      for (int k = 0; k < j; ++k) t = riccati_msub<F>(L[i][k], L[j][k], t);
      L[i][j] = t * inv;
    }
    for (int i = 0; i < j; ++i) L[i][j] = 0.0f;
  }
}

// Solve A x = b (leading D x D block) given the Cholesky factor L of A.
template <int M, bool F = false>
DMPC_HD void cho_solve_entries(const float (&L)[M][M], const float (&b)[M], float (&x)[M], int D = M) {
  float y[M];
  for (int i = 0; i < D; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = riccati_msub<F>(L[i][k], y[k], s);
    y[i] = s / L[i][i];
  }
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < D; ++k) s = riccati_msub<F>(L[k][i], x[k], s);
    x[i] = s / L[i][i];
  }
}

// Solve (masked Quu) X = rhs for NCOL right-hand sides: frozen control dims
// get identity rows/cols and zeroed rhs rows. rhs[c] is column c.
template <int M, int NCOL, bool F = false>
DMPC_HD void masked_chol_solve(const float (&Quu)[M][M], const float (&rhs)[NCOL][M],
                               const float (&frozen)[M], float reg, float (&out)[NCOL][M]) {
  float free_[M];
  for (int i = 0; i < M; ++i) free_[i] = 1.0f - frozen[i];
  if constexpr (M == 1) {
    // scalar system: one reciprocal
    const float inv = 1.0f / (Quu[0][0] * free_[0] + frozen[0] + reg);
    for (int c = 0; c < NCOL; ++c) out[c][0] = rhs[c][0] * free_[0] * inv;
  } else {
    float Am[M][M], L[M][M];
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j)
        Am[i][j] = Quu[i][j] * free_[i] * free_[j] + (i == j ? frozen[i] : 0.0f);
    chol_entries<M, F>(Am, reg, L);
    for (int c = 0; c < NCOL; ++c) {
      float col[M];
      for (int i = 0; i < M; ++i) col[i] = rhs[c][i] * free_[i];
      cho_solve_entries<M, F>(L, col, out[c]);
    }
  }
}

// 0.5 x'Quu x + qu'x, summed in the TPU kernel's order
template <int M, bool F = false>
DMPC_HD float qp_obj(const float (&Quu)[M][M], const float (&qu)[M], const float (&x)[M]) {
  float acc = 0.0f;
  for (int i = 0; i < M; ++i) {
    float Hx = 0.0f;
    for (int j = 0; j < M; ++j) Hx = riccati_mad<F>(Quu[i][j], x[j], Hx);
    if constexpr (F)
      acc = acc + riccati_mad<F>(0.5f * x[i], Hx, qu[i] * x[i]);
    else
      acc += 0.5f * x[i] * Hx + qu[i] * x[i];
  }
  return acc;
}

// The clamped ("frozen") mask at x: at a bound with the gradient pushing
// outward, within the 1e-6 boundary tolerance of ops/pnqp.py.
template <int M, bool F = false>
DMPC_HD void qp_frozen(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                       const float (&hi)[M], const float (&x)[M], float (&frozen)[M]) {
  for (int i = 0; i < M; ++i) {
    float g = 0.0f;
    for (int j = 0; j < M; ++j) g = riccati_mad<F>(Quu[i][j], x[j], g);
    g = g + qu[i];
    const bool clamped = ((x[i] <= lo[i] + 1e-6f) && (g > 0.0f)) ||
                         ((x[i] >= hi[i] - 1e-6f) && (g < 0.0f));
    frozen[i] = clamped ? 1.0f : 0.0f;
  }
}

// The clipped unconstrained Newton point clip(-(Quu + reg)^-1 qu)
template <int M, bool F = false>
DMPC_HD void clipped_newton(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                            const float (&hi)[M], float reg, float (&x)[M]) {
  float L0[M][M], nq[M], x0[M];
  chol_entries<M, F>(Quu, reg, L0);
  for (int i = 0; i < M; ++i) nq[i] = -qu[i];
  cho_solve_entries<M, F>(L0, nq, x0);
  for (int i = 0; i < M; ++i) x[i] = clipf(x0[i], lo[i], hi[i]);
}

// The enumeration's validity bounds of a free dim, lo - tol_b and hi + tol_b
// (tol_b = 1e-6 (1 + |hi - lo|)), with F fused as nvcc contracts them.
template <bool F, int M>
DMPC_HD float tol_lo(const float (&lo)[M], const float (&hi)[M], const float (&tol_b)[M], int i) {
  if constexpr (F) return riccati_msub<F>(1e-6f, 1.0f + fabsf(hi[i] - lo[i]), lo[i]);
  return lo[i] - tol_b[i];
}

template <bool F, int M>
DMPC_HD float tol_hi(const float (&lo)[M], const float (&hi)[M], const float (&tol_b)[M], int i) {
  if constexpr (F) return riccati_mad<F>(1e-6f, 1.0f + fabsf(hi[i] - lo[i]), hi[i]);
  return hi[i] + tol_b[i];
}

// Exact box QP by active-set enumeration (_pnqp_enum_entries): the 3^M
// candidates, each dim free / at lo / at hi, in itertools.product order
// (the first dim varies slowest), each solved on its own free block. The
// KKT-valid candidate of least objective wins by a strict "<", so ties go
// to the earlier candidate; the clipped Newton point starts as the best.
// The validity tolerances are relative, as on the TPU.
template <int M, bool F = false>
DMPC_HD void pnqp_enum_entries(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                               const float (&hi)[M], float reg, float (&best)[M]) {
  constexpr int kCandidates = M == 2 ? 9 : M == 3 ? 27 : 81;
  static_assert(M >= 2 && M <= 4, "the enumeration is for 2 <= m <= 4");
  float tol_b[M], tol_g[M];
  for (int i = 0; i < M; ++i) {
    tol_b[i] = 1e-6f * (1.0f + fabsf(hi[i] - lo[i]));
    tol_g[i] = 1e-6f * (1.0f + fabsf(qu[i]));
  }
  clipped_newton<M, F>(Quu, qu, lo, hi, reg, best);
  float best_obj = qp_obj<M, F>(Quu, qu, best);
#pragma unroll
  for (int code = 1; code < kCandidates; ++code) {  // code 0: all free, the start
    int state[M];  // 0 free, 1 at lo, 2 at hi
    int rem = code;
    for (int i = M - 1; i >= 0; --i) {
      state[i] = rem % 3;
      rem /= 3;
    }
    float x[M];
    int free_idx[M];
    int nf = 0;
    for (int i = 0; i < M; ++i) {
      if (state[i] == 0) {
        free_idx[nf++] = i;
        x[i] = 0.0f;
      } else {
        x[i] = state[i] == 1 ? lo[i] : hi[i];
      }
    }
    if (nf > 0) {
      float A[M][M], b[M], L[M][M], sol[M];
      for (int r = 0; r < nf; ++r) {
        const int i = free_idx[r];
        for (int c = 0; c < nf; ++c) A[r][c] = Quu[i][free_idx[c]];
        float s = 0.0f;
        for (int j = 0; j < M; ++j)
          if (state[j] != 0) s = riccati_mad<F>(Quu[i][j], x[j], s);
        b[r] = -(qu[i] + s);
      }
      chol_entries<M, F>(A, reg, L, nf);
      cho_solve_entries<M, F>(L, b, sol, nf);
      for (int r = 0; r < nf; ++r) x[free_idx[r]] = sol[r];
    }
    bool valid = true;
    for (int i = 0; i < M; ++i) {
      float g = 0.0f;
      for (int j = 0; j < M; ++j) g = riccati_mad<F>(Quu[i][j], x[j], g);
      g = g + qu[i];
      const bool ok = state[i] == 0   ? (x[i] >= tol_lo<F>(lo, hi, tol_b, i)) && (x[i] <= tol_hi<F>(lo, hi, tol_b, i))
                      : state[i] == 1 ? g >= -tol_g[i]
                                      : g <= tol_g[i];
      valid = valid && ok;
    }
    for (int i = 0; i < M; ++i) x[i] = clipf(x[i], lo[i], hi[i]);
    const float o = valid ? qp_obj<M, F>(Quu, qu, x) : 1e30f;
    if (o < best_obj) {
      for (int i = 0; i < M; ++i) best[i] = x[i];
      best_obj = o;
    }
  }
}

// The value of v[i], i a run-time index, by selects over the entries: no
// register array is indexed at run time.
template <int M>
DMPC_HD float pick_entry(const float (&v)[M], int i) {
  float out = v[0];
  for (int k = 1; k < M; ++k) out = i == k ? v[k] : out;
  return out;
}

template <int M>
DMPC_HD float pick_entry(const float (&A)[M][M], int i, int j) {
  float row[M];
  for (int k = 0; k < M; ++k) row[k] = pick_entry<M>(A[k], j);
  return pick_entry<M>(row, i);
}

// chol_entries then cho_solve_entries on the leading D x D block, D a
// run-time count (D <= M): every loop runs over M with the entries past D
// skipped, so each entry takes the operations of the compile-time D in the
// same order.
template <int M, bool F = false>
DMPC_HD void chol_solve_upto(const float (&A)[M][M], const float (&b)[M], float reg, int D, float (&x)[M]) {
  float L[M][M], y[M];
  for (int j = 0; j < M; ++j) {
    if (j < D) {
      float s = A[j][j] + reg;
      for (int k = 0; k < j; ++k) s = riccati_msub<F>(L[j][k], L[j][k], s);
      const float d = sqrtf(s);
      L[j][j] = d;
      const float inv = 1.0f / d;
      for (int i = j + 1; i < M; ++i) {
        if (i < D) {
          float t = A[i][j];
          for (int k = 0; k < j; ++k) t = riccati_msub<F>(L[i][k], L[j][k], t);
          L[i][j] = t * inv;
        }
      }
    }
  }
  for (int i = 0; i < M; ++i) {
    if (i < D) {
      float s = b[i];
      for (int k = 0; k < i; ++k) s = riccati_msub<F>(L[i][k], y[k], s);
      y[i] = s / L[i][i];
    }
  }
  for (int i = M - 1; i >= 0; --i) {
    if (i < D) {
      float s = y[i];
      for (int k = i + 1; k < M; ++k)
        if (k < D) s = riccati_msub<F>(L[k][i], x[k], s);
      x[i] = s / L[i][i];
    }
  }
}

// Candidate `code` of pnqp_enum_entries alone, `code` a run-time index in
// [0, 3^M): its point x and its objective (1e30 where it is not KKT-valid;
// code 0, the clipped Newton point, always valid). Each of x and the
// objective takes the operations of the enumeration's own candidate in the
// same order, so the lanes of a group can take a candidate each (riccati.cuh)
// and fold the objectives in candidate order to the enumeration's pick bit for
// bit. At m = 2 its one free dim (or none) is solved by selects, the same code
// for every code, so that the lanes of a warp do not diverge; m >= 3 gathers
// its free block.
template <int M, bool F = false>
DMPC_HD float pnqp_enum_candidate(int code, const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                                  const float (&hi)[M], float reg, float (&x)[M]) {
  if (code == 0) {
    clipped_newton<M, F>(Quu, qu, lo, hi, reg, x);
    return qp_obj<M, F>(Quu, qu, x);
  }
  float tol_b[M], tol_g[M];
  for (int i = 0; i < M; ++i) {
    tol_b[i] = 1e-6f * (1.0f + fabsf(hi[i] - lo[i]));
    tol_g[i] = 1e-6f * (1.0f + fabsf(qu[i]));
  }
  int state[M];  // 0 free, 1 at lo, 2 at hi
  int rem = code;
  for (int i = M - 1; i >= 0; --i) {
    state[i] = rem % 3;
    rem /= 3;
  }
  if constexpr (M == 2) {
    // at most one free dim f (code 0 is the Newton point), the other, g,
    // at its bound: the 1 x 1 Cholesky solve of the enumeration, by selects
    float fixed[M];
    for (int i = 0; i < M; ++i) fixed[i] = state[i] == 1 ? lo[i] : hi[i];
    const bool f0 = state[0] == 0;
    const float b = -((f0 ? qu[0] : qu[1]) + (0.0f + (f0 ? Quu[0][1] : Quu[1][0]) * (f0 ? fixed[1] : fixed[0])));
    const float d = sqrtf((f0 ? Quu[0][0] : Quu[1][1]) + reg);
    const float sol = b / d / d;
    for (int i = 0; i < M; ++i) x[i] = state[i] == 0 ? sol : fixed[i];
  } else {
    int free_idx[M], nf = 0;  // the free dims in order, free_idx[r] for r < nf
    for (int i = 0; i < M; ++i) {
      free_idx[i] = 0;
      for (int r = 0; r < M; ++r)
        if (state[i] == 0 && r == nf) free_idx[r] = i;
      x[i] = state[i] == 0 ? 0.0f : state[i] == 1 ? lo[i] : hi[i];
      nf += state[i] == 0 ? 1 : 0;
    }
    if (nf > 0) {
    float A[M][M], b[M], sol[M];
    for (int r = 0; r < M; ++r) {
      const int i = free_idx[r];
      for (int c = 0; c < M; ++c) A[r][c] = pick_entry<M>(Quu, i, free_idx[c]);
      float s = 0.0f;
      for (int j = 0; j < M; ++j)
        if (state[j] != 0) s = riccati_mad<F>(pick_entry<M>(Quu, i, j), x[j], s);
      b[r] = -(pick_entry<M>(qu, i) + s);
    }
    chol_solve_upto<M, F>(A, b, reg, nf, sol);
    for (int r = 0; r < M; ++r)
      for (int i = 0; i < M; ++i)
        if (r < nf && free_idx[r] == i) x[i] = sol[r];
    }
  }
  bool valid = true;
  for (int i = 0; i < M; ++i) {
    float g = 0.0f;
    for (int j = 0; j < M; ++j) g = riccati_mad<F>(Quu[i][j], x[j], g);
    g = g + qu[i];
    const bool ok = state[i] == 0   ? (x[i] >= tol_lo<F>(lo, hi, tol_b, i)) && (x[i] <= tol_hi<F>(lo, hi, tol_b, i))
                    : state[i] == 1 ? g >= -tol_g[i]
                                    : g <= tol_g[i];
    valid = valid && ok;
  }
  for (int i = 0; i < M; ++i) x[i] = clipf(x[i], lo[i], hi[i]);
  return valid ? qp_obj<M, F>(Quu, qu, x) : 1e30f;
}

// The projected-Newton loop's Armijo ladder: kArmijo steps alpha = 2^-a, the
// first that improves on the objective taken.
constexpr int kArmijo = 6;

// One step of the projected-Newton loop from x: the clamped mask at x, the
// masked Newton direction dx, whether it is small (step_small, 1 or 0) and
// the objective f0 at x.
template <int M>
DMPC_HD void pnqp_direction(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                            const float (&hi)[M], float reg, const float (&x)[M], float (&dx)[M], float& step_small,
                            float& f0) {
  float frozen[M], rhs[1][M], sol[1][M];
  qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
  for (int i = 0; i < M; ++i) {
    float g = 0.0f;
    for (int j = 0; j < M; ++j) g += Quu[i][j] * x[j];
    rhs[0][i] = -(g + qu[i]);
  }
  masked_chol_solve<M, 1>(Quu, rhs, frozen, reg, sol);
  float slack = 0.0f;
  for (int i = 0; i < M; ++i) {
    dx[i] = sol[0][i];
    slack += fmaxf(fabsf(dx[i]) - 1e-6f, 0.0f);
  }
  step_small = slack == 0.0f ? 1.0f : 0.0f;
  f0 = qp_obj<M>(Quu, qu, x);
}

// Armijo candidate a: clip(x + 2^-a dx) into the box
template <int M>
DMPC_HD void pnqp_candidate(const float (&x)[M], const float (&dx)[M], const float (&lo)[M], const float (&hi)[M],
                            int a, float (&cand)[M]) {
  const float alpha = ldexpf(1.0f, -a);
  for (int i = 0; i < M; ++i) cand[i] = clipf(x[i] + alpha * dx[i], lo[i], hi[i]);
}

// The loop's bookkeeping after a step: x takes the step's point `best`
// unless the QP was done before it, the count adds the step while it was
// not, and the QP is done once the direction is small or no candidate
// improved.
template <int M>
DMPC_HD void pnqp_advance(const float (&best)[M], float step_small, float accepted, float& done, float& n_qp,
                          float (&x)[M]) {
  if (!(done > 0.0f))
    for (int i = 0; i < M; ++i) x[i] = best[i];
  n_qp = n_qp + (1.0f - done);
  done = fmaxf(done, fmaxf(step_small, 1.0f - accepted));
}

// Box QP by projected Newton (the loop of _pnqp_entries: m >= 3, and m = 2
// under the mode "0") by the group g of L lanes (HostLanes<1> is the
// one-thread loop of pnqp_entries; riccati.cuh's lane step passes its
// group): at most n_iter steps, each the masked Newton direction, which
// every lane takes itself, and a first-improving Armijo ladder (alpha = 1,
// 1/2, ...): candidate a by lane a % L, a round of L at a time, the first
// improving one in ladder order by a ballot, the strict "<" of the serial
// ladder (a NaN objective never improves). The loop is left once the QP is
// done on every thread of the group's mask. The TPU kernel runs all n_iter
// with the scenario frozen once done (its lanes hold 128 scenarios); a
// frozen step changes nothing here, so the outputs are those of the fixed
// trip count, and every lane computes the one-lane loop's float32
// operations on the same values, so x and the count are its own bit for
// bit. Returns the steps taken while active.
template <int M, class G>
DMPC_HD float pnqp_loop_lanes(const G& g, const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                              const float (&hi)[M], int n_iter, float reg, float (&x)[M]) {
  constexpr int L = G::kLanes, kRounds = (kArmijo + L - 1) / L;
  clipped_newton<M>(Quu, qu, lo, hi, reg, x);
  float done = 0.0f, n_qp = 0.0f;
  for (int it = 0; it < n_iter && !g.all(done > 0.0f); ++it) {
    float dx[M], step_small, f0;
    pnqp_direction<M>(Quu, qu, lo, hi, reg, x, dx, step_small, f0);
    float best[M], accepted = 0.0f;
    for (int i = 0; i < M; ++i) best[i] = x[i];
    for (int r = 0; r < kRounds; ++r) {
      bool improving[G::kLocal];
      for (int li = 0; li < G::kLocal; ++li) {
        const int a = r * L + g.lane_of(li);
        improving[li] = false;
        if (a < kArmijo) {
          float cand[M];
          pnqp_candidate<M>(x, dx, lo, hi, a, cand);
          improving[li] = qp_obj<M>(Quu, qu, cand) < f0;
        }
      }
      const int first = g.first_set(improving);
      if (first >= 0 && accepted == 0.0f) {
        pnqp_candidate<M>(x, dx, lo, hi, r * L + first, best);
        accepted = 1.0f;
      }
    }
    pnqp_advance<M>(best, step_small, accepted, done, n_qp, x);
  }
  return n_qp;
}

// The box QP's enumeration modes, the JAX package's DIFFMPC_PNQP_ENUM
// (riccati.py:301-341) as a template flag: the default "" enumerates at m = 2;
// "0" takes the projected-Newton loop at m = 2 as well; "1" enumerates the
// 27 active sets at m = 3 too. The wrappers pass the flag only where it
// changes the QP (ops/cuda/riccati_entries.py, pnqp_enum_flag), so every
// other mode is the default's instantiation.
enum PnqpEnum { kPnqpEnumDefault = 0, kPnqpEnumLoop = 1, kPnqpEnumThree = 2 };

// Whether the box QP of M dims enumerates its active sets under ENUM
template <int M, int ENUM>
DMPC_HD constexpr bool pnqp_enumerates() {
  return (M == 2 && ENUM != kPnqpEnumLoop) || (M == 3 && ENUM == kPnqpEnumThree);
}

// Box QP  min 0.5 x'Quu x + qu'x  s.t. lo <= x <= hi. Writes the optimum
// and the clamped ("frozen") mask; returns the solve count (1: a direct
// solve). Dispatch as the TPU kernel's under ENUM: the enumeration where
// pnqp_enumerates, else the closed form at m = 1 and the projected-Newton
// loop of n_iter steps at m >= 2.
template <int M, bool F = false, int ENUM = kPnqpEnumDefault>
DMPC_HD float pnqp_entries(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                           const float (&hi)[M], int n_iter, float reg, float (&x)[M],
                           float (&frozen)[M]) {
  if constexpr (pnqp_enumerates<M, ENUM>()) {
    pnqp_enum_entries<M, F>(Quu, qu, lo, hi, reg, x);
    qp_frozen<M, F>(Quu, qu, lo, hi, x, frozen);
    return 1.0f;
  } else if constexpr (M == 1) {
    const float h = Quu[0][0] + reg;
    x[0] = clipf(-qu[0] / h, lo[0], hi[0]);
    const float g = F ? riccati_mad<F>(Quu[0][0], x[0], qu[0]) : Quu[0][0] * x[0] + qu[0];
    // the same 1e-6 boundary tolerance as ops/pnqp.py
    const bool clamped = ((x[0] <= lo[0] + 1e-6f) && (g > 0.0f)) ||
                         ((x[0] >= hi[0] - 1e-6f) && (g < 0.0f));
    frozen[0] = clamped ? 1.0f : 0.0f;
    return 1.0f;
  } else {
    const float n_qp = pnqp_loop_lanes<M>(HostLanes<1>{nullptr}, Quu, qu, lo, hi, n_iter, reg, x);
    qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
    return n_qp;
  }
}

// Value-function update (V', v') from the gains. The full quadratic form:
//   V' = Qxx + Qxu K + K'Qux + K'Quu K,  v' = qx + Qxu k + K'(qu + Quu k);
// with EXACT, the simplified one, for gains that are exact masked solves of
// an exact box QP (the DDP cancellation; riccati.py:433-458):
//   V' = Qxx + 1/2 (Qxu K + (Qxu K)'),  v' = qx + Qxu k;
// with F, each sum of products fused term by term (riccati_mad).
template <int N, int M, bool EXACT = false, bool F = false>
DMPC_HD void value_update(const float (&Q)[N + M][N + M], const float (&q)[N + M],
                          const float (&Quu)[M][M], const float (&qu)[M], const float (&K)[M][N],
                          const float (&kt)[M], float (&Vn)[N][N], float (&vn)[N]) {
  if constexpr (EXACT) {
    for (int a = 0; a < N; ++a) {
      for (int b = a; b < N; ++b) {
        float ab = 0.0f, ba = 0.0f;
        for (int r = 0; r < M; ++r) ab = riccati_mad<F>(Q[a][N + r], K[r][b], ab);
        for (int r = 0; r < M; ++r) ba = riccati_mad<F>(Q[b][N + r], K[r][a], ba);
        const float val = Q[a][b] + 0.5f * (ab + ba);
        Vn[a][b] = val;
        Vn[b][a] = val;
      }
    }
    for (int a = 0; a < N; ++a) {
      float s1 = 0.0f;
      for (int r = 0; r < M; ++r) s1 = riccati_mad<F>(Q[a][N + r], kt[r], s1);
      vn[a] = q[a] + s1;
    }
    return;
  }
  float QuuK[M][N], Quuk[M];
  for (int a = 0; a < M; ++a) {
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int r = 0; r < M; ++r) s = riccati_mad<F>(Quu[a][r], K[r][j], s);
      QuuK[a][j] = s;
    }
    float s = 0.0f;
    for (int r = 0; r < M; ++r) s = riccati_mad<F>(Quu[a][r], kt[r], s);
    Quuk[a] = s;
  }
  for (int a = 0; a < N; ++a) {
    for (int b = a; b < N; ++b) {
      float ab = 0.0f, ba = 0.0f, kqk = 0.0f;
      for (int r = 0; r < M; ++r) ab = riccati_mad<F>(Q[a][N + r], K[r][b], ab);
      for (int r = 0; r < M; ++r) ba = riccati_mad<F>(Q[b][N + r], K[r][a], ba);
      for (int r = 0; r < M; ++r) kqk = riccati_mad<F>(K[r][a], QuuK[r][b], kqk);
      const float val = Q[a][b] + ab + ba + kqk;
      Vn[a][b] = val;
      Vn[b][a] = val;
    }
  }
  for (int a = 0; a < N; ++a) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < M; ++r) s1 = riccati_mad<F>(Q[a][N + r], kt[r], s1);
    for (int r = 0; r < M; ++r) s2 = riccati_mad<F>(K[r][a], qu[r] + Quuk[r], s2);
    vn[a] = q[a] + s1 + s2;
  }
}
