// The depth-blocked unconstrained Riccati sweep of ONE scenario.
//
// Counterpart of the TPU kernel body _make_blocked_kernel in
// diffmpc_tpu/ops/pallas/riccati_blocked.py (:311-442), computing what it
// computes with one thread in place of one lane of an (S, 128) tile.
// csrc/riccati_blocked.cu runs it on the card with one thread per scenario;
// the tests build it with g++ for the host.
// diffmpc_tpu_torch/ops/cuda/riccati_blocked.py
// (riccati_backward_blocked_plain) is the same algorithm in plain PyTorch,
// vectorised over the batch, and ops/assoc_riccati.py the same element
// algebra in matrix form.
//
// Each step t contributes a conditional-value element e_t = (A, b, C, eta, J)
// built from its stage data alone; elements compose associatively, and
// applying a (composed) element to the downstream value (V, v) is one step
// (or one block of steps) of the backward value recursion. Four phases, in
// the TPU kernel's order:
//   1. the T elements (build_element, :142-194), into level 0 of the scratch;
//   2. the composition tree within each block of D = 2 or 4 steps
//      (combine_elements, :197-252): level l holds T >> l elements;
//   3. T / D serial applies of the composed blocks (apply_element,
//      :255-281), right to left, the value carry in registers and each
//      block's right-boundary value stored before its apply;
//   4. per block, from its boundary value, the gains of its D steps right
//      to left (the free-mode step of riccati.cuh without its value
//      update), with D - 1 applies of single-step elements between them.
// No terminal zeroing: the sweep applies the elements to a true terminal
// value V_T = 0, for which apply(e_T-1, 0) = (J, -eta) exactly.
//
// Every system of the algebra is I + (PSD)(PSD), whose eigenvalues are
// >= 1, so solve_general_entries eliminates without pivoting, as the TPU
// kernel does, in its order: forward elimination, then back substitution.
#pragma once

#include "riccati.cuh"

// Launch arguments. The field order is mirrored by ctypes in
// diffmpc_tpu_torch/ops/cuda/riccati_blocked.py (_BlockedArgs): keep the two
// in step.
struct RiccatiBlockedArgs {
  // C, c, F, f (or null) in; K, k, free out; T, B, reg. lo, hi, mask and
  // n_qp are unused: the blocked sweep is the free mode only.
  RiccatiArgs ric;
  // (rows, B) batch-minor: the element levels (T + T/2 [+ T/4] elements of
  // kSize rows each), then T / D boundary values of N*N + N rows each
  float* scratch;
  int block;  // D: 2 or 4
};

// One conditional-value element, its entries in scratch order.
template <int N>
struct ValueElement {
  static constexpr int kSize = 3 * N * N + 2 * N;
  float A[N][N];
  float b[N];
  float C[N][N];
  float eta[N];
  float J[N][N];
};

namespace blocked_detail {

// row r of a batch-minor (rows, B) scratch, for scenario b
struct Scratch {
  float* p;
  int B;
  int b;
  DMPC_HD float& operator[](size_t r) const { return p[r * (size_t)B + b]; }
};

template <int N>
DMPC_HD void store(const Scratch& s, size_t row, const ValueElement<N>& e) {
  size_t r = row;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) s[r++] = e.A[i][j];
  for (int i = 0; i < N; ++i) s[r++] = e.b[i];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) s[r++] = e.C[i][j];
  for (int i = 0; i < N; ++i) s[r++] = e.eta[i];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) s[r++] = e.J[i][j];
}

template <int N>
DMPC_HD void load(const Scratch& s, size_t row, ValueElement<N>& e) {
  size_t r = row;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) e.A[i][j] = s[r++];
  for (int i = 0; i < N; ++i) e.b[i] = s[r++];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) e.C[i][j] = s[r++];
  for (int i = 0; i < N; ++i) e.eta[i] = s[r++];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) e.J[i][j] = s[r++];
}

}  // namespace blocked_detail

// Solve M x = col for K columns with a general N x N matrix, in place:
// Gaussian elimination without pivoting, then back substitution
// (_solve_general_entries, riccati_blocked.py:90-116).
template <int N, int K>
DMPC_HD void solve_general_entries(const float (&M)[N][N], float (&x)[K][N]) {
  float a[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) a[i][j] = M[i][j];
  for (int k = 0; k < N; ++k) {
    const float inv = 1.0f / a[k][k];
    for (int j = k + 1; j < N; ++j) a[k][j] = a[k][j] * inv;
    for (int c = 0; c < K; ++c) x[c][k] = x[c][k] * inv;
    for (int i = k + 1; i < N; ++i) {
      const float fac = a[i][k];
      for (int j = k + 1; j < N; ++j) a[i][j] = a[i][j] - fac * a[k][j];
      for (int c = 0; c < K; ++c) x[c][i] = x[c][i] - fac * x[c][k];
    }
  }
  for (int c = 0; c < K; ++c)
    for (int i = N - 1; i >= 0; --i) {
      float s = x[c][i];
      for (int j = i + 1; j < N; ++j) s = s - a[i][j] * x[c][j];
      x[c][i] = s;
    }
}

// The element of one step from its stage data (_build_element_entries):
// A = Fx - Fu Quu^-1 Qux, b = f - Fu Quu^-1 qu, C = Fu Quu^-1 Fu',
// J = Qxx - Qxu Quu^-1 Qux, eta = -(qx - Qxu Quu^-1 qu).
template <int N, int M, class In>
DMPC_HD void build_element(const In& in, float reg, ValueElement<N>& e) {
  float Quu[M][M], L[M][M];
  for (int a = 0; a < M; ++a)
    for (int b = 0; b < M; ++b) Quu[a][b] = in.C(N + a, N + b);
  chol_entries<M>(Quu, reg, L);
  // column j of Quu^-1 Qux, Quu^-1 qu, column k of Quu^-1 Fu'
  float iQ_Qux[N][M], iQ_qu[M], iQ_FuT[N][M], col[M];
  for (int j = 0; j < N; ++j) {
    for (int a = 0; a < M; ++a) col[a] = in.C(N + a, j);
    cho_solve_entries<M>(L, col, iQ_Qux[j]);
  }
  for (int a = 0; a < M; ++a) col[a] = in.c(N + a);
  cho_solve_entries<M>(L, col, iQ_qu);
  for (int k = 0; k < N; ++k) {
    for (int r = 0; r < M; ++r) col[r] = in.F(k, N + r);
    cho_solve_entries<M>(L, col, iQ_FuT[k]);
  }
  for (int k = 0; k < N; ++k) {
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int r = 0; r < M; ++r) s += in.F(k, N + r) * iQ_Qux[j][r];
      e.A[k][j] = in.F(k, j) - s;
    }
    float s = 0.0f;
    for (int r = 0; r < M; ++r) s += in.F(k, N + r) * iQ_qu[r];
    e.b[k] = (in.has_f() ? in.f(k) : 0.0f) - s;
    for (int l = k; l < N; ++l) {
      float s2 = 0.0f;
      for (int r = 0; r < M; ++r) s2 += in.F(k, N + r) * iQ_FuT[l][r];
      e.C[k][l] = s2;
      e.C[l][k] = s2;
    }
  }
  for (int a = 0; a < N; ++a) {
    for (int b = a; b < N; ++b) {
      float s = 0.0f;
      for (int r = 0; r < M; ++r) s += in.C(a, N + r) * iQ_Qux[b][r];
      e.J[a][b] = in.C(a, b) - s;
      e.J[b][a] = e.J[a][b];
    }
    float s = 0.0f;
    for (int r = 0; r < M; ++r) s += in.C(a, N + r) * iQ_qu[r];
    e.eta[a] = -(in.c(a) - s);
  }
}

// Element e1 then e2 in time (_combine_entries), with P = (I + C1 J2)^-1:
// A = A2 P A1, b = A2 P (b1 + C1 eta2) + b2, C = sym(A2 P C1 A2' + C2),
// eta = A1' P' (eta2 - J2 b1) + eta1, J = sym(A1' P' J2 A1 + J1).
template <int N>
DMPC_HD void combine_elements(const ValueElement<N>& e1, const ValueElement<N>& e2, ValueElement<N>& out) {
  float M[N][N];  // I + C1 J2
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += e1.C[i][k] * e2.J[k][j];
      M[i][j] = (i == j ? 1.0f : 0.0f) + s;
    }
  // right-hand sides: the columns of A1, b1 + C1 eta2, the columns of C1
  float x[2 * N + 1][N];
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) {
      x[j][i] = e1.A[i][j];
      x[N + 1 + j][i] = e1.C[i][j];
    }
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += e1.C[i][k] * e2.eta[k];
    x[N][i] = e1.b[i] + s;
  }
  solve_general_entries<N, 2 * N + 1>(M, x);  // P A1 (columns), P b, P C1 (columns)
  float Y[N][N], X[N][N];  // Y = (P C1) A2', X = A2 Y + C2
  for (int k = 0; k < N; ++k)
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int l = 0; l < N; ++l) s += x[N + 1 + l][k] * e2.A[j][l];
      Y[k][j] = s;
    }
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += e2.A[i][k] * x[j][k];
      out.A[i][j] = s;
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += e2.A[i][k] * Y[k][j];
      X[i][j] = s2 + e2.C[i][j];
    }
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += e2.A[i][k] * x[N][k];
    out.b[i] = s + e2.b[i];
  }
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) out.C[i][j] = 0.5f * (X[i][j] + X[j][i]);
  // (I + J2 C1)^-1 = P': the transposed system, for eta2 - J2 b1 and J2 A1
  float Mt[N][N], y[N + 1][N];
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) {
      Mt[i][j] = M[j][i];
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += e2.J[i][k] * e1.A[k][j];
      y[1 + j][i] = s;
    }
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += e2.J[i][k] * e1.b[k];
    y[0][i] = e2.eta[i] - s;
  }
  solve_general_entries<N, N + 1>(Mt, y);
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += e1.A[k][i] * y[0][k];
    out.eta[i] = s + e1.eta[i];
    for (int j = 0; j < N; ++j) {
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += e1.A[k][i] * y[1 + j][k];
      X[i][j] = s2 + e1.J[i][j];
    }
  }
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) out.J[i][j] = 0.5f * (X[i][j] + X[j][i]);
}

// Apply element e to the downstream value (V, v), in place
// (_apply_element_entries): V' = sym(A' (I + V C)^-1 V A + J),
// v' = -(A' (I + V C)^-1 (-v - V b) + eta).
template <int N>
DMPC_HD void apply_element(const ValueElement<N>& e, float (&V)[N][N], float (&v)[N]) {
  float Nm[N][N], x[N + 1][N];  // I + V C; the columns of V A, then -v - V b
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += V[i][k] * e.C[k][j];
      Nm[i][j] = (i == j ? 1.0f : 0.0f) + s;
      float s2 = 0.0f;
      for (int k = 0; k < N; ++k) s2 += V[i][k] * e.A[k][j];
      x[j][i] = s2;
    }
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += V[i][k] * e.b[k];
    x[N][i] = -v[i] - s;
  }
  solve_general_entries<N, N + 1>(Nm, x);
  float X[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += e.A[k][i] * x[j][k];
      X[i][j] = s + e.J[i][j];
    }
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) V[i][j] = 0.5f * (X[i][j] + X[j][i]);
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s += e.A[k][i] * x[N][k];
    v[i] = -(s + e.eta[i]);
  }
}

// The scratch rows per scenario: the element levels, then the boundary values.
DMPC_HD size_t blocked_level_row(int level, int T, int kSize) {
  size_t row = 0;
  for (int l = 0; l < level; ++l) row += (size_t)(T >> l) * kSize;
  return row;
}

template <int N, int M, int D>
DMPC_HD void riccati_blocked_scenario(const RiccatiBlockedArgs& a, int b) {
  static_assert(D == 2 || D == 4, "the block is 2 or 4 steps");
  constexpr int kLevels = D == 4 ? 2 : 1;
  constexpr int E = ValueElement<N>::kSize;
  const RiccatiArgs& r = a.ric;
  const int T = r.T, P = T / D;
  const blocked_detail::Scratch sc{a.scratch, r.B, b};
  const size_t bnd = blocked_level_row(kLevels + 1, T, E);  // the boundary values

  // ---- phase 1: the per-step elements ----
  for (int t = 0; t < T; ++t) {
    ValueElement<N> e;
    build_element<N, M>(RiccatiGlobal<N, M>{r, t, b}, r.reg, e);
    blocked_detail::store<N>(sc, (size_t)t * E, e);
  }
  // ---- phase 2: the composition tree within each block ----
  for (int lvl = 1; lvl <= kLevels; ++lvl) {
    const size_t below = blocked_level_row(lvl - 1, T, E), here = blocked_level_row(lvl, T, E);
    for (int p = 0; p < (T >> lvl); ++p) {
      ValueElement<N> lo, hi, e;
      blocked_detail::load<N>(sc, below + (size_t)(2 * p) * E, lo);
      blocked_detail::load<N>(sc, below + (size_t)(2 * p + 1) * E, hi);
      combine_elements<N>(lo, hi, e);
      blocked_detail::store<N>(sc, here + (size_t)p * E, e);
    }
  }
  // ---- phase 3 (serial): T / D applies, each block's right value stored ----
  const size_t top = blocked_level_row(kLevels, T, E);
  float V[N][N], v[N];
  for (int i = 0; i < N; ++i) {
    v[i] = 0.0f;
    for (int j = 0; j < N; ++j) V[i][j] = 0.0f;
  }
  for (int s = 0; s < P; ++s) {
    const int p = P - 1 - s;
    size_t row = bnd + (size_t)p * (N * N + N);
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) sc[row++] = V[i][j];
    for (int i = 0; i < N; ++i) sc[row++] = v[i];
    ValueElement<N> e;
    blocked_detail::load<N>(sc, top + (size_t)p * E, e);
    apply_element<N>(e, V, v);
  }
  // ---- phase 4: each block's gains from its right boundary value ----
  const float frozen[M] = {};
  for (int p = 0; p < P; ++p) {
    size_t row = bnd + (size_t)p * (N * N + N);
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j) V[i][j] = sc[row++];
    for (int i = 0; i < N; ++i) v[i] = sc[row++];
    for (int off = D - 1; off >= 0; --off) {
      const int t = p * D + off;
      float K[M][N], kt[M];
      riccati_gains_free<N, M>(RiccatiGlobal<N, M>{r, t, b}, r.reg, V, v, K, kt);
      riccati_store<N, M, kRiccatiFree>(r, t, b, K, kt, frozen, 0.0f);
      if (off) {
        ValueElement<N> e;
        blocked_detail::load<N>(sc, (size_t)t * E, e);
        apply_element<N>(e, V, v);
      }
    }
  }
}
