// The key of a kernel variant, read from the -D macros that csrc/build.py
// (variant_defines) gives each of its translation units:
//   DMPC_N, DMPC_M      the shape (n, m);
//   DMPC_HIDDEN         an MLP env's hidden widths as a string, "16x16";
//   DMPC_ENV            an env with a C++ step of its own, its struct's
//                       name (CartpoleEnv), and DMPC_ENV_HEADER its header
//                       as a string, "cartpole.cuh" (csrc/build.py,
//                       CPP_ENVS);
//   DMPC_ENUM           the box QP's enumeration mode, a PnqpEnum
//                       (riccati_entries.cuh; default 0);
//   DMPC_EXACT          1 for the simplified value update (default 0);
//   DMPC_PASSTHROUGH    1 for the env wrapped in CtrlPassthroughEnv
//                       (passthrough.cuh, the slew-rate penalty's augmented
//                       problem): (DMPC_N, DMPC_M) is then the wrapped
//                       shape, the inner env's (DMPC_N - DMPC_M, DMPC_M)
//                       (default 0);
//   DMPC_VARIANT_L      the lane count whose kernels the unit builds, or 0
//                       for the unit that holds the launchers;
//   DMPC_FLIP_CHEAP_STEP 1 for a C++ env with the other kCheapStep (a
//                       measurement's build, not a key's; default 0).
// A variant is a shape, an MLP or a flag that the prebuilt library
// (csrc/*.cu) does not instantiate; each is built into a library of its own
// at its first use and launched through the same templates.
#pragma once

#include <utility>

#ifndef DMPC_ENUM
#define DMPC_ENUM 0
#endif
#ifndef DMPC_EXACT
#define DMPC_EXACT 0
#endif
#ifndef DMPC_VARIANT_L
#define DMPC_VARIANT_L 0
#endif
#ifndef DMPC_PASSTHROUGH
#define DMPC_PASSTHROUGH 0
#endif

// the value update's form as the templates take it
constexpr bool kVariantExact = DMPC_EXACT != 0;
// The fused solve's sweep (ilqr.cuh): every key's lane groups share the
// Riccati sweep and the linearization out (riccati_sweep_shared), faster at
// every key's rule-picked lane count than the sweep every lane repeats
// (riccati_sweep, which the prebuilt kernels keep; PERF.md, PR 21,
// diagnostics/ab_ilqr_lanes.py --variants --parent).
constexpr bool kVariantSharedSweep = true;
// the inner env's state dims: the key's n less the carried control's
constexpr int kVariantInnerN = DMPC_PASSTHROUGH ? DMPC_N - DMPC_M : DMPC_N;

// The env of the key: Inner, wrapped under DMPC_PASSTHROUGH
#if DMPC_PASSTHROUGH
#include "passthrough.cuh"
template <class Inner>
using VariantWrap = CtrlPassthroughEnv<Inner>;
#else
template <class Inner>
using VariantWrap = Inner;
#endif

#ifdef DMPC_ENV
#include DMPC_ENV_HEADER

// The C++ env of the key, at its own (n, m). DMPC_FLIP_CHEAP_STEP=1, a
// measurement's build (diagnostics/ab_cheap_step.py) and never the key's,
// gives it the other kCheapStep.
#if defined(DMPC_FLIP_CHEAP_STEP) && DMPC_FLIP_CHEAP_STEP
struct VariantCppInner : DMPC_ENV {
  static constexpr bool kCheapStep = !DMPC_ENV::kCheapStep;
};
#else
using VariantCppInner = DMPC_ENV;
#endif
using VariantCppEnv = VariantWrap<VariantCppInner>;
static_assert(VariantCppEnv::N == DMPC_N && VariantCppEnv::M == DMPC_M, "DMPC_N, DMPC_M are the env's shape");
#endif

#ifdef DMPC_HIDDEN
#include "nn_mlp.cuh"

namespace variant_detail {

constexpr char kHidden[] = DMPC_HIDDEN;

// the number of hidden layers: the widths are separated by 'x'
constexpr int hidden_depth() {
  int depth = 1;
  for (int i = 0; kHidden[i] != '\0'; ++i) depth += kHidden[i] == 'x' ? 1 : 0;
  return depth;
}

// the width of hidden layer `layer`
constexpr int hidden_width(int layer) {
  int width = 0, at = 0;
  for (int i = 0; kHidden[i] != '\0'; ++i) {
    if (kHidden[i] == 'x') {
      if (at == layer) return width;
      ++at;
      width = 0;
    } else {
      width = 10 * width + (kHidden[i] - '0');
    }
  }
  return width;
}

template <class Layers>
struct NNOf;
template <int... I>
struct NNOf<std::integer_sequence<int, I...>> {
  using type = NNEnv<kVariantInnerN, DMPC_M, hidden_width(I)...>;
};

}  // namespace variant_detail

// The MLP env of the key: NNEnv<n, m, hidden widths...>, wrapped under
// DMPC_PASSTHROUGH
using VariantNNEnv =
    VariantWrap<typename variant_detail::NNOf<std::make_integer_sequence<int, variant_detail::hidden_depth()>>::type>;
static_assert(VariantNNEnv::N == DMPC_N && VariantNNEnv::M == DMPC_M, "DMPC_N, DMPC_M are the env's shape");
#endif
