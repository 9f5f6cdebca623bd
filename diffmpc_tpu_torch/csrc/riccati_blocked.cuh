// The depth-blocked unconstrained Riccati sweep, by one thread per
// (block, scenario).
//
// Counterpart of the TPU kernel body _make_blocked_kernel in
// diffmpc_tpu/ops/pallas/riccati_blocked.py (:311-442), computing what it
// computes. csrc/riccati_blocked.cu runs it on the card
// (riccati_blocked_launch.cuh); the tests build it with g++ for the host,
// where the threads of each CTA run one after another, phase by phase.
// diffmpc_tpu_torch/ops/cuda/riccati_blocked.py
// (riccati_backward_blocked_plain) is the same algorithm in plain PyTorch,
// vectorised over the batch, and ops/assoc_riccati.py the same element
// algebra in matrix form.
//
// Each step t contributes a conditional-value element e_t = (A, b, C, eta, J)
// built from its stage data alone; elements compose associatively, and
// applying a (composed) element to the downstream value (V, v) is one step
// (or one block of steps) of the backward value recursion. The T steps fall
// into P = T / D blocks of D = 2 or 4 steps, and thread (p, s) owns block p
// of scenario s. Four phases, in the TPU kernel's order:
//   1. the D elements of its block (build_element, :142-194);
//   2. their composition tree, lo then hi (combine_elements, :197-252),
//      into the block's element, kept in registers;
//   3. the only chain across blocks: P applies (apply_element, :255-281),
//      right to left from V_T = 0, the value carry (V, v) handed from block
//      p + 1's thread to block p's, which keeps what it receives as its
//      block's right-boundary value and hands on its apply of it;
//   4. from that boundary value, the gains of its D steps right to left (the
//      free-mode step of riccati.cuh without its value update), with D - 1
//      applies of single-step elements between them.
// No terminal zeroing: the sweep applies the elements to a true terminal
// value V_T = 0, for which apply(e_T-1, 0) = (J, -eta) exactly.
//
// Phase 4's single-step elements: each thread keeps e_1 .. e_D-1 of its
// block, built in phase 1, in its own column of shared memory (and at D = 4
// the first level's element of steps 0-1 beside them), and reads them back;
// they are not rebuilt. A rebuild would hold the tree's elements in
// registers: at D = 4 four of them are live at once, 224 floats at n = 4,
// m = 2, where the kernel takes 254 registers with them in shared memory
// (ptxas, sm_90a).
//
// Where the threads go (BlockedGeometry): W neighbouring scenarios on
// neighbouring threads at each block, thread p W + s (W a power of two up
// to 32), so that a warp's loads of one entry of C, c, F, f and its stores
// of K, k coalesce. The carry goes by __shfl_sync while a CTA's W P threads
// fit one warp, one apply per link; otherwise through a double-buffered
// slot of shared memory per scenario, one CTA barrier per link. The other
// layout, a scenario's blocks on neighbouring threads (the carry by
// shuffles up to P = 32, but a warp's load of one entry touching one sector
// per block), was measured and not kept: within 3% of this one where the
// card is short of threads and 1.3-2.2x slower where it is full (PERF.md).
//
// One CTA holds a scenario's P threads, so P is at most the kernel's
// threads a CTA at its registers, and their columns fit an SM's shared
// memory (blocked_max_blocks; about 256 blocks at (4, 2), D = 2 or 4): the
// launcher refuses a longer horizon and the wrapper raises ValueError
// before it, naming the largest T. The TPU kernel's limit is its VMEM
// bytes (vmem_bytes, riccati_blocked.py).
//
// Device traffic is what the function must move: C, c, F, f in (read in
// phase 1 and again in phase 4, the second time from L1 or L2), K, k and
// free out. There is no device scratch.
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
  int block;  // D: 2 or 4
};

// One conditional-value element, its entries in storage order.
template <int N>
struct ValueElement {
  static constexpr int kSize = 3 * N * N + 2 * N;
  float A[N][N];
  float b[N];
  float C[N][N];
  float eta[N];
  float J[N][N];
};

// A thread's column of shared memory: entry r at p[r * stride], stride the
// threads of its CTA, so that a warp's accesses of one entry fall in
// neighbouring banks.
struct ElementColumn {
  float* p;
  int stride;
  DMPC_HD float& operator[](size_t r) const { return p[r * (size_t)stride]; }
};

namespace blocked_detail {

template <int N>
DMPC_HD void store(const ElementColumn& s, size_t row, const ValueElement<N>& e) {
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
DMPC_HD void load(const ElementColumn& s, size_t row, ValueElement<N>& e) {
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

// Elements a thread keeps in its column: e_1 .. e_D-1 (step off of its
// block in slot off - 1), and at D = 4 the first level's element of steps
// 0-1 in slot 3.
DMPC_HD constexpr int blocked_slots(int D) { return D == 2 ? 1 : 4; }

// The floats of one thread's column.
template <int N>
DMPC_HD constexpr int blocked_column_floats(int D) {
  return blocked_slots(D) * ValueElement<N>::kSize;
}

// The floats of a value carry handed between threads: V's upper triangle,
// then v (V is symmetric bit for bit: apply_element's symmetrisation sums
// the same two floats either way round).
template <int N>
DMPC_HD constexpr int blocked_carry_floats() {
  return N * (N + 1) / 2 + N;
}

// Where the threads of a CTA work: P blocks of `width` (W) scenarios,
// thread p W + s for block p of the CTA's scenario s, `threads` W P
// rounded up to whole warps.
struct BlockedGeometry {
  int P;
  int width;
  int threads;
  // thread tid's scenario in the CTA, its block, and whether it has one
  DMPC_HD void place(int tid, int& s, int& p, bool& valid) const {
    s = tid % width;
    p = tid / width;
    valid = tid < width * P;
  }
  // the thread of block p of the CTA's scenario s
  DMPC_HD int thread_of(int s, int p) const { return p * width + s; }
  // the CTA's threads in one warp: the carry goes by shuffles, from the
  // thread `width` lanes up
  DMPC_HD bool shuffles() const { return width * P <= 32; }
  // floats of the CTA's shared memory: the threads' columns, then (without
  // shuffles) two carry slots per scenario
  template <int N>
  DMPC_HD size_t smem_floats(int D) const {
    return (size_t)threads * blocked_column_floats<N>(D) + (shuffles() ? 0 : (size_t)2 * width * blocked_carry_floats<N>());
  }
};

// The geometry of a launch over B scenarios of P blocks for a card of `sms`
// SMs: the most scenarios a CTA (W) that keep the CTAs at one an SM or more,
// within `max_threads` threads (the kernel's limit at its registers),
// `smem_budget` bytes of columns and `cap` scenarios (the launcher lowers it
// where smaller CTAs pack an SM fuller). Returns false where one scenario's
// threads cannot share a CTA (more than `max_threads`, or their shared
// memory past `smem_max` bytes).
template <int N>
DMPC_HD bool blocked_geometry(int B, int P, int D, int sms, int max_threads, size_t smem_budget, size_t smem_max,
                              int cap, BlockedGeometry& geo) {
  const size_t column = sizeof(float) * blocked_column_floats<N>(D);
  const int spread = B / (sms > 0 ? sms : 1);  // scenarios a CTA while CTAs >= SMs
  int w = 1;
  while (2 * w <= 32 && 2 * w <= spread && 2 * w <= cap && (2 * w * P + 31) / 32 * 32 <= max_threads &&
         2 * w * P * column <= smem_budget)
    w *= 2;
  geo.P = P;
  geo.width = w;
  geo.threads = (w * P + 31) / 32 * 32;
  return P >= 1 && geo.threads <= max_threads && geo.smem_floats<N>(D) * sizeof(float) <= smem_max;
}

// The most blocks of one scenario a CTA holds (blocked_geometry at W = 1):
// T = D times this is the longest horizon the kernel takes.
template <int N>
DMPC_HD int blocked_max_blocks(int D, int max_threads, size_t smem_max) {
  BlockedGeometry geo{};
  int P = max_threads;
  while (P > 0 && !blocked_geometry<N>(1, P, D, 1, max_threads, 0, smem_max, 1, geo)) --P;
  return P;
}

// A step's inputs in registers, loaded at once: C (whole where the element
// is built, which reads both off-diagonal blocks; else its upper triangle,
// mirrored, all that the gains read), c, F and f. Read through the
// accessors one entry at a time, the loads would go out in several rounds,
// between the divisions of the factor and the solves and behind the stores
// to the thread's column, which the compiler cannot tell apart from them.
template <int N, int M>
struct StepRegs {
  static constexpr int NM = N + M;
  float C_[NM][NM], c_[NM], F_[N][NM], f_[N];
  bool has_f_;
  DMPC_HD float C(int i, int j) const { return C_[i][j]; }
  DMPC_HD float c(int i) const { return c_[i]; }
  DMPC_HD float F(int i, int j) const { return F_[i][j]; }
  DMPC_HD bool has_f() const { return has_f_; }
  DMPC_HD float f(int i) const { return f_[i]; }
};

template <int N, int M, bool Whole>
DMPC_HD StepRegs<N, M> load_step(const RiccatiArgs& r, int t, int b) {
  constexpr int NM = N + M;
  const RiccatiGlobal<N, M> in{r, t, b};
  StepRegs<N, M> s;
  for (int i = 0; i < NM; ++i)
    for (int j = Whole ? 0 : i; j < NM; ++j) s.C_[i][j] = in.C(i, j);
  if constexpr (!Whole)
    for (int i = 0; i < NM; ++i)
      for (int j = 0; j < i; ++j) s.C_[i][j] = s.C_[j][i];
  for (int i = 0; i < NM; ++i) s.c_[i] = in.c(i);
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < NM; ++j) s.F_[i][j] = in.F(i, j);
  s.has_f_ = in.has_f();
  for (int i = 0; i < N; ++i) s.f_[i] = s.has_f_ ? in.f(i) : 0.0f;
  return s;
}

// Phases 1 and 2 for thread (p, b): the elements of block p (steps p D ..
// p D + D - 1) built, e_1 .. e_D-1 kept in `col`, and composed lo then hi
// into `top`.
template <int N, int M, int D>
DMPC_HD void blocked_compose(const RiccatiArgs& r, int b, int p, const ElementColumn& col, ValueElement<N>& top) {
  static_assert(D == 2 || D == 4, "the block is 2 or 4 steps");
  constexpr int E = ValueElement<N>::kSize;
  const int t0 = p * D;
  {
    ValueElement<N> lo, hi;
    {
      const StepRegs<N, M> in_lo = load_step<N, M, true>(r, t0, b), in_hi = load_step<N, M, true>(r, t0 + 1, b);
      build_element<N, M>(in_lo, r.reg, lo);
      build_element<N, M>(in_hi, r.reg, hi);
    }
    blocked_detail::store<N>(col, 0, hi);
    if constexpr (D == 2) {
      combine_elements<N>(lo, hi, top);
      return;
    } else {
      ValueElement<N> e01;
      combine_elements<N>(lo, hi, e01);
      blocked_detail::store<N>(col, 3 * E, e01);
    }
  }
  if constexpr (D == 4) {
    ValueElement<N> e23;
    {
      ValueElement<N> lo, hi;
      {
        const StepRegs<N, M> in_lo = load_step<N, M, true>(r, t0 + 2, b),
                             in_hi = load_step<N, M, true>(r, t0 + 3, b);
        build_element<N, M>(in_lo, r.reg, lo);
        build_element<N, M>(in_hi, r.reg, hi);
      }
      blocked_detail::store<N>(col, E, lo);
      blocked_detail::store<N>(col, 2 * E, hi);
      combine_elements<N>(lo, hi, e23);
    }
    ValueElement<N> e01;
    blocked_detail::load<N>(col, 3 * E, e01);
    combine_elements<N>(e01, e23, top);
  }
}

// The inputs of block p's last step, the first that phase 4 reads: the
// kernel loads them before phase 3, whose wait for the chain covers the
// loads.
template <int N, int M, int D>
DMPC_HD StepRegs<N, M> blocked_last_inputs(const RiccatiArgs& r, int b, int p) {
  return load_step<N, M, false>(r, p * D + D - 1, b);
}

// Phase 4 for thread (p, b): from its block's right-boundary value (V, v),
// the gains of steps p D + D - 1 .. p D, with an apply of the single-step
// element between two of them; `last` holds the inputs of step p D + D - 1
// (blocked_last_inputs). (V, v) is used up.
template <int N, int M, int D>
DMPC_HD void blocked_gains(const RiccatiArgs& r, int b, int p, const ElementColumn& col, const StepRegs<N, M>& last,
                           float (&V)[N][N], float (&v)[N]) {
  constexpr int E = ValueElement<N>::kSize;
  const float frozen[M] = {};
  for (int off = D - 1; off >= 0; --off) {
    const int t = p * D + off;
    float K[M][N], kt[M];
    if (off == D - 1)
      riccati_gains_free<N, M>(last, r.reg, V, v, K, kt);
    else
      riccati_gains_free<N, M>(load_step<N, M, false>(r, t, b), r.reg, V, v, K, kt);
    riccati_store<N, M, kRiccatiFree>(r, t, b, K, kt, frozen, 0.0f);
    if (off) {
      ValueElement<N> e;
      blocked_detail::load<N>(col, (size_t)(off - 1) * E, e);
      apply_element<N>(e, V, v);
    }
  }
}
