// Per-step Riccati helpers for one scenario, shared by the kernels.
//
// Device-function counterparts of the entry-tile helpers of
// diffmpc_tpu/ops/pallas/riccati.py: _chol_entries (:141),
// _cho_solve_entries (:160), _masked_chol_solve (:177), the box QP
// _pnqp_entries (:329-416) with its m = 2 active-set enumeration
// _pnqp_enum_entries (:204-298), and the full-form _value_update (:433; the
// default, VALUE_UPDATE_EXACT_REG = -1 at :506). On the TPU each entry is an
// (S, 128) tile over scenarios; here one thread owns one scenario, so each
// entry is one float in a register. diffmpc_tpu_torch/ops/cuda/
// riccati_entries.py is the same arithmetic in plain PyTorch, entry by entry
// and in the same order.
#pragma once

#include "dual.cuh"

// Cholesky of the leading D x D block (D <= M) of an SPD matrix; lower
// factor. The enumeration below factors free blocks of every size D < M.
template <int M>
DMPC_HD void chol_entries(const float (&A)[M][M], float reg, float (&L)[M][M], int D = M) {
  for (int j = 0; j < D; ++j) {
    float s = A[j][j] + reg;
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(s);
    L[j][j] = d;
    const float inv = 1.0f / d;
    for (int i = j + 1; i < D; ++i) {
      float t = A[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
    for (int i = 0; i < j; ++i) L[i][j] = 0.0f;
  }
}

// Solve A x = b (leading D x D block) given the Cholesky factor L of A.
template <int M>
DMPC_HD void cho_solve_entries(const float (&L)[M][M], const float (&b)[M], float (&x)[M], int D = M) {
  float y[M];
  for (int i = 0; i < D; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < D; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// Solve (masked Quu) X = rhs for NCOL right-hand sides: frozen control dims
// get identity rows/cols and zeroed rhs rows. rhs[c] is column c.
template <int M, int NCOL>
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
    chol_entries<M>(Am, reg, L);
    for (int c = 0; c < NCOL; ++c) {
      float col[M];
      for (int i = 0; i < M; ++i) col[i] = rhs[c][i] * free_[i];
      cho_solve_entries<M>(L, col, out[c]);
    }
  }
}

// 0.5 x'Quu x + qu'x, summed in the TPU kernel's order
template <int M>
DMPC_HD float qp_obj(const float (&Quu)[M][M], const float (&qu)[M], const float (&x)[M]) {
  float acc = 0.0f;
  for (int i = 0; i < M; ++i) {
    float Hx = 0.0f;
    for (int j = 0; j < M; ++j) Hx += Quu[i][j] * x[j];
    acc += 0.5f * x[i] * Hx + qu[i] * x[i];
  }
  return acc;
}

// The clamped ("frozen") mask at x: at a bound with the gradient pushing
// outward, within the 1e-6 boundary tolerance of ops/pnqp.py.
template <int M>
DMPC_HD void qp_frozen(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                       const float (&hi)[M], const float (&x)[M], float (&frozen)[M]) {
  for (int i = 0; i < M; ++i) {
    float g = 0.0f;
    for (int j = 0; j < M; ++j) g += Quu[i][j] * x[j];
    g = g + qu[i];
    const bool clamped = ((x[i] <= lo[i] + 1e-6f) && (g > 0.0f)) ||
                         ((x[i] >= hi[i] - 1e-6f) && (g < 0.0f));
    frozen[i] = clamped ? 1.0f : 0.0f;
  }
}

// The clipped unconstrained Newton point clip(-(Quu + reg)^-1 qu)
template <int M>
DMPC_HD void clipped_newton(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                            const float (&hi)[M], float reg, float (&x)[M]) {
  float L0[M][M], nq[M], x0[M];
  chol_entries<M>(Quu, reg, L0);
  for (int i = 0; i < M; ++i) nq[i] = -qu[i];
  cho_solve_entries<M>(L0, nq, x0);
  for (int i = 0; i < M; ++i) x[i] = clipf(x0[i], lo[i], hi[i]);
}

// Exact box QP by active-set enumeration (_pnqp_enum_entries): the 3^M
// candidates, each dim free / at lo / at hi, in itertools.product order
// (the first dim varies slowest), each solved on its own free block. The
// KKT-valid candidate of least objective wins by a strict "<", so ties go
// to the earlier candidate; the clipped Newton point starts as the best.
// The validity tolerances are relative, as on the TPU.
template <int M>
DMPC_HD void pnqp_enum_entries(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                               const float (&hi)[M], float reg, float (&best)[M]) {
  constexpr int kCandidates = M == 2 ? 9 : M == 3 ? 27 : 81;
  static_assert(M >= 2 && M <= 4, "the enumeration is for 2 <= m <= 4");
  float tol_b[M], tol_g[M];
  for (int i = 0; i < M; ++i) {
    tol_b[i] = 1e-6f * (1.0f + fabsf(hi[i] - lo[i]));
    tol_g[i] = 1e-6f * (1.0f + fabsf(qu[i]));
  }
  clipped_newton<M>(Quu, qu, lo, hi, reg, best);
  float best_obj = qp_obj<M>(Quu, qu, best);
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
          if (state[j] != 0) s += Quu[i][j] * x[j];
        b[r] = -(qu[i] + s);
      }
      chol_entries<M>(A, reg, L, nf);
      cho_solve_entries<M>(L, b, sol, nf);
      for (int r = 0; r < nf; ++r) x[free_idx[r]] = sol[r];
    }
    bool valid = true;
    for (int i = 0; i < M; ++i) {
      float g = 0.0f;
      for (int j = 0; j < M; ++j) g += Quu[i][j] * x[j];
      g = g + qu[i];
      const bool ok = state[i] == 0   ? (x[i] >= lo[i] - tol_b[i]) && (x[i] <= hi[i] + tol_b[i])
                      : state[i] == 1 ? g >= -tol_g[i]
                                      : g <= tol_g[i];
      valid = valid && ok;
    }
    for (int i = 0; i < M; ++i) x[i] = clipf(x[i], lo[i], hi[i]);
    const float o = valid ? qp_obj<M>(Quu, qu, x) : 1e30f;
    if (o < best_obj) {
      for (int i = 0; i < M; ++i) best[i] = x[i];
      best_obj = o;
    }
  }
}

// Box QP by projected Newton (the m >= 3 branch of _pnqp_entries): a fixed
// trip count of n_iter with this scenario frozen once converged, each step
// the masked Newton direction and a first-improving 6-step Armijo ladder
// (alpha = 1, 1/2, ...). Returns the iterations used while active.
template <int M>
DMPC_HD float pnqp_loop_entries(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                                const float (&hi)[M], int n_iter, float reg, float (&x)[M]) {
  clipped_newton<M>(Quu, qu, lo, hi, reg, x);
  float done = 0.0f, n_qp = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    float frozen[M], rhs[1][M], dx[1][M];
    qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
    for (int i = 0; i < M; ++i) {
      float g = 0.0f;
      for (int j = 0; j < M; ++j) g += Quu[i][j] * x[j];
      rhs[0][i] = -(g + qu[i]);
    }
    masked_chol_solve<M, 1>(Quu, rhs, frozen, reg, dx);
    float slack = 0.0f;
    for (int i = 0; i < M; ++i) slack += fmaxf(fabsf(dx[0][i]) - 1e-6f, 0.0f);
    const float step_small = slack == 0.0f ? 1.0f : 0.0f;
    const float f0 = qp_obj<M>(Quu, qu, x);
    float best[M], accepted = 0.0f, alpha = 1.0f;
    for (int i = 0; i < M; ++i) best[i] = x[i];
    for (int a = 0; a < 6; ++a) {
      float cand[M];
      for (int i = 0; i < M; ++i) cand[i] = clipf(x[i] + alpha * dx[0][i], lo[i], hi[i]);
      if (qp_obj<M>(Quu, qu, cand) < f0 && accepted == 0.0f) {
        for (int i = 0; i < M; ++i) best[i] = cand[i];
        accepted = 1.0f;
      }
      alpha *= 0.5f;
    }
    if (!(done > 0.0f))
      for (int i = 0; i < M; ++i) x[i] = best[i];
    n_qp = n_qp + (1.0f - done);
    done = fmaxf(done, fmaxf(step_small, 1.0f - accepted));
  }
  return n_qp;
}

// Box QP  min 0.5 x'Quu x + qu'x  s.t. lo <= x <= hi. Writes the optimum
// and the clamped ("frozen") mask; returns the solve count (1: a direct
// solve). Dispatch as the TPU kernel's default: the closed form at m = 1,
// the enumeration at m = 2, the projected-Newton loop at m >= 3.
template <int M>
DMPC_HD float pnqp_entries(const float (&Quu)[M][M], const float (&qu)[M], const float (&lo)[M],
                           const float (&hi)[M], int n_iter, float reg, float (&x)[M],
                           float (&frozen)[M]) {
  if constexpr (M == 1) {
    const float h = Quu[0][0] + reg;
    x[0] = clipf(-qu[0] / h, lo[0], hi[0]);
    const float g = Quu[0][0] * x[0] + qu[0];
    // the same 1e-6 boundary tolerance as ops/pnqp.py
    const bool clamped = ((x[0] <= lo[0] + 1e-6f) && (g > 0.0f)) ||
                         ((x[0] >= hi[0] - 1e-6f) && (g < 0.0f));
    frozen[0] = clamped ? 1.0f : 0.0f;
    return 1.0f;
  } else if constexpr (M == 2) {
    pnqp_enum_entries<M>(Quu, qu, lo, hi, reg, x);
    qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
    return 1.0f;
  } else {
    const float n_qp = pnqp_loop_entries<M>(Quu, qu, lo, hi, n_iter, reg, x);
    qp_frozen<M>(Quu, qu, lo, hi, x, frozen);
    return n_qp;
  }
}

// Value-function update (V', v') from the gains, full quadratic form:
//   V' = Qxx + Qxu K + K'Qux + K'Quu K,  v' = qx + Qxu k + K'(qu + Quu k).
template <int N, int M>
DMPC_HD void value_update(const float (&Q)[N + M][N + M], const float (&q)[N + M],
                          const float (&Quu)[M][M], const float (&qu)[M], const float (&K)[M][N],
                          const float (&kt)[M], float (&Vn)[N][N], float (&vn)[N]) {
  float QuuK[M][N], Quuk[M];
  for (int a = 0; a < M; ++a) {
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int r = 0; r < M; ++r) s += Quu[a][r] * K[r][j];
      QuuK[a][j] = s;
    }
    float s = 0.0f;
    for (int r = 0; r < M; ++r) s += Quu[a][r] * kt[r];
    Quuk[a] = s;
  }
  for (int a = 0; a < N; ++a) {
    for (int b = a; b < N; ++b) {
      float ab = 0.0f, ba = 0.0f, kqk = 0.0f;
      for (int r = 0; r < M; ++r) ab += Q[a][N + r] * K[r][b];
      for (int r = 0; r < M; ++r) ba += Q[b][N + r] * K[r][a];
      for (int r = 0; r < M; ++r) kqk += K[r][a] * QuuK[r][b];
      const float val = Q[a][b] + ab + ba + kqk;
      Vn[a][b] = val;
      Vn[b][a] = val;
    }
  }
  for (int a = 0; a < N; ++a) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < M; ++r) s1 += Q[a][N + r] * kt[r];
    for (int r = 0; r < M; ++r) s2 += K[r][a] * (qu[r] + Quuk[r]);
    vn[a] = q[a] + s1 + s2;
  }
}
