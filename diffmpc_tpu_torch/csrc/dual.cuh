// Forward-mode dual numbers and the scalar helpers every env step uses.
//
// An env's step is written once, as a template on its scalar type S:
// S = float runs the rollout, S = Dual<float, K> carries K tangents through
// the same code and yields K Jacobian columns in one pass. This stands in for
// the jax.linearize probes of the TPU kernel (diffmpc_tpu/ops/pallas/ilqr.py,
// dyn_lin). Everything here is __host__ __device__, so g++ builds the same
// arithmetic for the host-side tests and nvcc builds it for the card.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define DMPC_HD __host__ __device__ __forceinline__
#else
#define DMPC_HD inline
#endif

template <class T, int K>
struct Dual {
  T v;
  T d[K];

  DMPC_HD Dual() : v(0) {
    for (int i = 0; i < K; ++i) d[i] = 0;
  }
  DMPC_HD Dual(T val) : v(val) {
    for (int i = 0; i < K; ++i) d[i] = 0;
  }
  // value `val` with tangent e_j
  DMPC_HD static Dual seed(T val, int j) {
    Dual r(val);
    r.d[j] = 1;
    return r;
  }
};

template <class T, int K>
DMPC_HD Dual<T, K> operator+(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r(a.v + b.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator-(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r(a.v - b.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator-(const Dual<T, K>& a) {
  Dual<T, K> r(-a.v);
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator*(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r(a.v * b.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator/(const Dual<T, K>& a, const Dual<T, K>& b) {
  const T q = a.v / b.v;
  Dual<T, K> r(q);
  for (int i = 0; i < K; ++i) r.d[i] = (a.d[i] - q * b.d[i]) / b.v;
  return r;
}
// mixed with a constant (zero tangent)
template <class T, int K>
DMPC_HD Dual<T, K> operator+(const Dual<T, K>& a, T s) {
  Dual<T, K> r = a;
  r.v = a.v + s;
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator+(T s, const Dual<T, K>& a) {
  return a + s;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator*(const Dual<T, K>& a, T s) {
  Dual<T, K> r(a.v * s);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator*(T s, const Dual<T, K>& a) {
  Dual<T, K> r(s * a.v);
  for (int i = 0; i < K; ++i) r.d[i] = s * a.d[i];
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator/(const Dual<T, K>& a, T s) {
  Dual<T, K> r(a.v / s);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / s;
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator-(const Dual<T, K>& a, T s) {
  Dual<T, K> r = a;
  r.v = a.v - s;
  return r;
}
template <class T, int K>
DMPC_HD Dual<T, K> operator-(T s, const Dual<T, K>& a) {
  Dual<T, K> r(s - a.v);
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}
// s / a, whose tangent is -(s / a) da / a, as Dual(s) / a computes it
template <class T, int K>
DMPC_HD Dual<T, K> operator/(T s, const Dual<T, K>& a) {
  const T q = s / a.v;
  Dual<T, K> r(q);
  for (int i = 0; i < K; ++i) r.d[i] = -(q * a.d[i]) / a.v;
  return r;
}

// ---- float arithmetic that is never contracted ----
//
// nvcc may fuse a product into a following sum (an FMA), and whether it does
// depends on the code around the expression: two instantiations of one step
// (the line search at one lane and at two, say) can round it differently.
// nc_mul, nc_add and nc_sub are single-rounded as written on the card
// (__fmul_rn, __fadd_rn, __fsub_rn are never contracted) and on the host;
// NcFloat is a float whose operators are these. An env step whose
// instantiations part from each other bit for bit computes on NcFloat in
// place of float (NoContract), so that every lane count of every kernel that
// runs it rounds the same float32 operations.

DMPC_HD float nc_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
DMPC_HD float nc_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
DMPC_HD float nc_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

struct NcFloat {
  float v;

  DMPC_HD NcFloat() : v(0.0f) {}
  DMPC_HD NcFloat(float x) : v(x) {}
};

DMPC_HD NcFloat operator+(NcFloat a, NcFloat b) { return nc_add(a.v, b.v); }
DMPC_HD NcFloat operator-(NcFloat a, NcFloat b) { return nc_sub(a.v, b.v); }
DMPC_HD NcFloat operator*(NcFloat a, NcFloat b) { return nc_mul(a.v, b.v); }
DMPC_HD NcFloat operator/(NcFloat a, NcFloat b) { return a.v / b.v; }
DMPC_HD NcFloat operator-(NcFloat a) { return -a.v; }
DMPC_HD NcFloat operator+(NcFloat a, float b) { return nc_add(a.v, b); }
DMPC_HD NcFloat operator+(float a, NcFloat b) { return nc_add(a, b.v); }
DMPC_HD NcFloat operator-(NcFloat a, float b) { return nc_sub(a.v, b); }
DMPC_HD NcFloat operator-(float a, NcFloat b) { return nc_sub(a, b.v); }
DMPC_HD NcFloat operator*(NcFloat a, float b) { return nc_mul(a.v, b); }
DMPC_HD NcFloat operator*(float a, NcFloat b) { return nc_mul(a, b.v); }
DMPC_HD NcFloat operator/(NcFloat a, float b) { return a.v / b; }
DMPC_HD NcFloat operator/(float a, NcFloat b) { return a / b.v; }

// The scalar an env step computes on for S: NcFloat for float, S itself for
// a Dual (its tangents are the linearization's, which no lane count shares
// out); nc_out converts back.
template <class S>
struct NoContract {
  using type = S;
};
template <>
struct NoContract<float> {
  using type = NcFloat;
};
DMPC_HD float nc_out(NcFloat x) { return x.v; }
template <class T, int K>
DMPC_HD Dual<T, K> nc_out(const Dual<T, K>& x) {
  return x;
}

// ---- elementary functions, one overload for float and one for Dual ----

DMPC_HD float value_of(float x) { return x; }
DMPC_HD float value_of(NcFloat x) { return x.v; }
template <class T, int K>
DMPC_HD T value_of(const Dual<T, K>& x) {
  return x.v;
}

DMPC_HD float dmpc_sin(float x) { return sinf(x); }
DMPC_HD float dmpc_cos(float x) { return cosf(x); }
// 1 / sqrt, written out: rsqrtf is an approximation on the card
DMPC_HD float dmpc_rsqrt(float x) { return 1.0f / sqrtf(x); }
DMPC_HD NcFloat dmpc_sin(NcFloat x) { return sinf(x.v); }
DMPC_HD NcFloat dmpc_cos(NcFloat x) { return cosf(x.v); }
DMPC_HD NcFloat dmpc_rsqrt(NcFloat x) { return 1.0f / sqrtf(x.v); }

template <int K>
DMPC_HD Dual<float, K> dmpc_sin(const Dual<float, K>& a) {
  Dual<float, K> r(sinf(a.v));
  const float c = cosf(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * c;
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_cos(const Dual<float, K>& a) {
  Dual<float, K> r(cosf(a.v));
  const float ms = -sinf(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * ms;
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_rsqrt(const Dual<float, K>& a) {
  const float y = 1.0f / sqrtf(a.v);
  Dual<float, K> r(y);
  const float s = -0.5f * (y / a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}

// ---- activations of the MLP step (nn_mlp.cuh), one overload for float and
// one for Dual. The formulas are the plain version's
// (diffmpc_tpu_torch/models/dynamics.py, ACTIVATIONS) and their tangents
// PyTorch's forward-mode rules for them. ----

DMPC_HD float dmpc_relu(float x) { return x < 0.0f ? 0.0f : x; }  // NaN passes
DMPC_HD float dmpc_tanh(float x) { return tanhf(x); }
DMPC_HD float dmpc_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
DMPC_HD float dmpc_elu(float x) { return x > 0.0f ? x : expm1f(x); }
// softplus as jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
DMPC_HD float dmpc_softplus(float x) { return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))); }

template <int K>
DMPC_HD Dual<float, K> dmpc_relu(const Dual<float, K>& a) {
  Dual<float, K> r(dmpc_relu(a.v));
  if (a.v > 0.0f)  // the derivative at 0 is 0, as in both packages
    for (int i = 0; i < K; ++i) r.d[i] = a.d[i];
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_tanh(const Dual<float, K>& a) {
  const float y = tanhf(a.v);
  Dual<float, K> r(y);
  const float s = 1.0f - y * y;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_sigmoid(const Dual<float, K>& a) {
  const float y = dmpc_sigmoid(a.v);
  Dual<float, K> r(y);
  const float s = (1.0f - y) * y;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_elu(const Dual<float, K>& a) {
  if (a.v > 0.0f) return a;
  const float y = expm1f(a.v);
  Dual<float, K> r(y);
  const float s = y + 1.0f;  // d expm1 = exp
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
template <int K>
DMPC_HD Dual<float, K> dmpc_softplus(const Dual<float, K>& a) {
  Dual<float, K> r(dmpc_softplus(a.v));
  const float s = dmpc_sigmoid(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
// gelu in jax.nn.gelu's default tanh form, on any scalar type:
// x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
template <class S>
DMPC_HD S dmpc_gelu(const S& x) {
  const S inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.0f + dmpc_tanh(inner)));
}

// Boundary-strict clamp of env dynamics (utils/batch.py bclamp): the values
// of a clip, with the tangent passed through when lo <= x <= hi INCLUSIVE.
// Box-DDP puts saturated controls exactly on the bound, where a clip's
// derivative of 0 or 0.5 would blind the solver. NaN passes through.
template <class S>
DMPC_HD S bclamp(const S& x, float lo, float hi) {
  if (value_of(x) < lo) return S(lo);
  if (value_of(x) > hi) return S(hi);
  return x;
}

// Solver-side clip (jnp.clip): min(max(x, lo), hi), NaN propagating.
DMPC_HD float clipf(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}
