"""The port's piece-decomposition kernels (their plain versions) against the
JAX package's, and the two diagnostics modules on the CPU.

``scripts/profile_riccati_pieces.py`` builds its Pallas kernels from two
makers, ``make_sweep_kernel`` and ``make_rollout_kernel``. The test loads the
script by its file path, sets its horizon ``T`` to 4, and runs the makers
through ``pl.pallas_call(..., interpret=True)`` with the script's own specs
(one tile of 8 x 128 scenarios) on the script's inputs. The port's
``sweep_piece_plain`` holds the sweep's ``K, k`` within
``1e-4 * max(1, max|JAX|)`` (the same float32 step; the Jacobian by
``jax.linearize`` against ``torch.func.jvp``, each with its own sin/cos),
and ``rollout_piece_plain`` the rollout's objective within 1e-5 relative.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from diffmpc_tpu.models.envs.pendulum import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu.ops.pallas.riccati import _from_kernel_layout, _to_kernel_layout  # noqa: E402
from diffmpc_tpu_torch.diagnostics import ab_blocked_ilp, ab_nn_reread, profile_riccati_pieces  # noqa: E402
from diffmpc_tpu_torch.diagnostics.card import ptxas_report  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PIECES = _load_script("profile_riccati_pieces")
T_SMALL = 4


def _script_kernel(kind, reps, ins):
    """The script's kernel ``kind`` at ``reps`` through ``pl.pallas_call`` in
    interpret mode, with the script's specs (``main``, ``build``); returns
    ``K (T,B,1,3)``, ``k (T,B,1)``."""
    mod = PIECES
    dx = JaxPendulumDx.default(jnp.float32)
    params_arr = dx.kernel_params().astype(jnp.float32).reshape(-1, 1)
    args = [params_arr]
    in_specs = [pl.BlockSpec((params_arr.shape[0], 1), lambda g: (0, 0), memory_space=pltpu.SMEM)]
    for x in ins:
        x = _to_kernel_layout(jnp.asarray(x), 1)
        args.append(x)
        in_specs.append(pl.BlockSpec((1,) + x.shape[1:], lambda g, nd=x.ndim: (0,) * nd, memory_space=pltpu.VMEM))
    if kind == "rollout":
        kern = mod.make_rollout_kernel(dx.entries_step, 3, reps)
    else:
        kern = mod.make_sweep_kernel(kind, dx.entries_step, 3, reps)
    out_shapes = [
        jax.ShapeDtypeStruct((1, mod.T, mod.m, mod.n, mod.SUBLANE, mod.LANE), jnp.float32),
        jax.ShapeDtypeStruct((1, mod.T, mod.m, mod.SUBLANE, mod.LANE), jnp.float32),
    ]
    out_specs = [pl.BlockSpec(s.shape, lambda g, nd=len(s.shape): (0,) * nd, memory_space=pltpu.VMEM)
                 for s in out_shapes]
    K_l, k_l = jax.jit(pl.pallas_call(kern, grid=(1,), in_specs=in_specs, out_specs=out_specs,
                                      out_shape=out_shapes, interpret=True))(*args)
    return np.asarray(_from_kernel_layout(K_l)), np.asarray(_from_kernel_layout(k_l))


@pytest.mark.parametrize("kind", rp.VARIANTS + ("rollout",))
def test_plain_matches_the_scripts_kernel(kind, monkeypatch):
    monkeypatch.setattr(PIECES, "T", T_SMALL)
    B = PIECES.SUBLANE * PIECES.LANE
    C, c, xh, uh, lo, hi, dx = profile_riccati_pieces.make_inputs(B, "cpu", steps=T_SMALL)
    K, k = _script_kernel(kind, 1, [a.numpy() for a in (C, c, xh, uh, lo, hi)])
    if kind == "rollout":
        got = rp.rollout_piece_plain(C, c, xh, uh, lo, hi, dx).obj.numpy()
        np.testing.assert_allclose(got, k[0, :, 0], rtol=1e-5, atol=0)
        return
    got = rp.sweep_piece_plain(kind, C, c, xh, uh, lo, hi, dx)
    for name, g, w in (("K", got.K.numpy(), K), ("k", got.k.numpy(), k)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=name)


def test_script_inputs():
    """make_inputs draws the script's trajectory (profile_riccati_pieces.py
    :251-257) and its cost."""
    C, c, xh, uh, lo, hi, dx = profile_riccati_pieces.make_inputs(16, "cpu", steps=3, seed=0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(xh.numpy(), rng.normal(size=(3, 16, 3)).astype(np.float32))
    np.testing.assert_array_equal(uh.numpy(), (rng.normal(size=(3, 16, 1)) * 0.5).astype(np.float32))
    assert float(lo.max()) == -2.0 and float(hi.min()) == 2.0
    q, p = dx.get_true_obj()
    assert torch.equal(C[1, 5], torch.diag(q)) and torch.equal(c[2, 7], p)


@pytest.mark.parametrize("kind", rp.VARIANTS + ("rollout",))
def test_reps_chain_leaves_the_result(kind):
    """The seed chain (1e-30 of the last rep's result) does not move what a
    rep computes: reps = 3 gives reps = 1's outputs within float32 rounding,
    and every variant differs from full."""
    ins = profile_riccati_pieces.make_inputs(8, "cpu", steps=5, seed=3)
    if kind == "rollout":
        one, three = rp.rollout_piece_plain(*ins), rp.rollout_piece_plain(*ins, reps=3)
        torch.testing.assert_close(three.obj, one.obj, rtol=1e-6, atol=0)
        return
    one, three = rp.sweep_piece_plain(kind, *ins), rp.sweep_piece_plain(kind, *ins, reps=3)
    torch.testing.assert_close(three.K, one.K, rtol=1e-6, atol=1e-6)
    if kind != "full":
        assert not torch.allclose(one.K, rp.sweep_piece_plain("full", *ins).K, rtol=1e-6, atol=1e-7)


def test_piece_wrappers_launch_or_raise():
    """The CUDA wrappers raise on CPU tensors and launch nothing; the plain
    versions serve them."""
    ins = profile_riccati_pieces.make_inputs(8, "cpu", steps=3)
    counts = (rp.sweep_piece_cuda.launches, rp.rollout_piece_cuda.launches)
    with pytest.raises(ValueError, match="use_cuda"):
        rp.sweep_piece_cuda("full", *ins)
    with pytest.raises(ValueError, match="use_cuda"):
        rp.rollout_piece_cuda(*ins)
    with pytest.raises(ValueError, match="variant"):
        rp.sweep_piece_cuda("no_such_piece", *ins)
    with pytest.raises(ValueError, match="variant"):
        rp.sweep_piece_plain("no_such_piece", *ins)
    assert (rp.sweep_piece_cuda.launches, rp.rollout_piece_cuda.launches) == counts
    with pytest.raises(TypeError, match="float32"):
        rp.run_staged_pieces(lambda *a: None, "full", ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="reps"):
        rp.run_staged_pieces(lambda *a: None, "full", *ins, reps=0)
    seen = {}
    rp.run_staged_pieces(lambda args, env, kind: seen.update(args=args._obj, kind=kind), "rollout", *ins, reps=9)
    assert seen["kind"] == "rollout" and seen["args"].reps == 9 and seen["args"].T == 3 and seen["args"].B == 8


@pytest.mark.parametrize("kind", ["full", "rollout"])
def test_piece_wrappers_refuse_a_lane_count_not_built(kind):
    """Both wrappers take ``lanes`` and ``staged``: a lane count that is not
    built raises ValueError before anything else, a CPU tensor raises at any
    built count and read mode, and nothing is launched."""
    ins = profile_riccati_pieces.make_inputs(8, "cpu", steps=3)
    call = (lambda **kw: rp.rollout_piece_cuda(*ins, **kw)) if kind == "rollout" else (
        lambda **kw: rp.sweep_piece_cuda(kind, *ins, **kw))
    counted = rp.rollout_piece_cuda if kind == "rollout" else rp.sweep_piece_cuda
    before = counted.launches
    with pytest.raises(ValueError, match="lanes must be one of"):
        call(lanes=3)
    for lanes in (None,) + rp.PIECE_LANES:
        for staged in (False, True):
            with pytest.raises(ValueError, match="use_cuda"):
                call(lanes=lanes, staged=staged)
    assert counted.launches == before


@pytest.mark.parametrize("reps", [1, 3])
def test_rollout_abs_cost_scales_its_rounding(reps):
    """The rollout's sum of |stage costs| bounds |objective|, and the float32
    plain version is within 1e-5 of it from the float64 one on every
    scenario, near-zero objectives included (the limit the card is held to)."""
    ins = profile_riccati_pieces.make_inputs(1024, "cpu", steps=20, seed=0)
    r32 = rp.rollout_piece_plain(*ins, reps=reps)
    r64 = rp.rollout_piece_plain(*ins, reps=reps, dtype=torch.float64)
    assert r32.obj.dtype == torch.float32 and r64.obj.dtype == torch.float64
    assert bool((r64.obj.abs() <= r64.abs_cost * (1 + 1e-12)).all())
    # some objective cancels to ~1e-3 of its stage costs: a relative limit fails there
    assert float((r64.obj.abs() / r64.abs_cost).min()) < 1e-2
    assert bool(((r32.obj.double() - r64.obj).abs() <= 1e-5 * r64.abs_cost).all())


@pytest.mark.parametrize("kind", rp.VARIANTS)
def test_sweep_float64_witness(kind):
    """The float64 plain sweep (the witness of float32 rounding): at the
    first of profile_riccati_pieces.BATCHES the float32 sweep is within
    1e-4 * max(1, max|K|) of it on every scenario, the limit the card is
    held to there."""
    ins = profile_riccati_pieces.make_inputs(1024, "cpu", steps=20, seed=0)
    r32 = rp.sweep_piece_plain(kind, *ins)
    r64 = rp.sweep_piece_plain(kind, *ins, dtype=torch.float64)
    assert r64.K.dtype == torch.float64 and r32.K.dtype == torch.float32
    for g, w in zip(r32, r64):
        torch.testing.assert_close(g.double(), w, atol=1e-4 * max(1.0, float(w.abs().max())), rtol=0)


# ---------------------------------------------------------------------------
# The diagnostics on the CPU: their inputs and bounds; the timing needs a card.
# ---------------------------------------------------------------------------


def test_ab_problem_is_the_scripts(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")  # the script sets a default at import
    script = _load_script("ab_blocked_ilp")
    for shape in ((20, 7, 3, 1, 27), (10, 5, 3, 2, 15)):
        want = script.make_problem(*shape)
        got = ab_blocked_ilp.make_problem(*shape)
        for w, g in zip(want, got):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


def test_ab_bounds():
    clock = 1980.0
    for T, B, n, m, blocks in ab_blocked_ilp.SHAPES:
        serial = ab_blocked_ilp.serial_bound(T, B, n, m, clock)
        for D in blocks:
            blocked = ab_blocked_ilp.blocked_bound(T, B, n, m, D, clock)
            # the same bytes; more operations; a shorter chain
            assert blocked["bytes_ms"] == serial["bytes_ms"]
            assert blocked["ops_ms"] > serial["ops_ms"] and blocked["chain_ms"] < serial["chain_ms"]
            assert blocked["bound_ms"] == max(blocked["bytes_ms"], blocked["ops_ms"], blocked["chain_ms"])
    # n = 3, m = 1: 4 (10 + 4 + 12 + 3) + 4 (3 + 1) + 1 bytes per scenario-step
    assert ab_blocked_ilp.sweep_bytes(20, 1024, 3, 1) == 20 * 1024 * 133


def test_rollout_modes_take_each_slope_from_its_own_rounds():
    """The rollout's slope, time a step and one rollout's time in each read
    mode and lane count come from that mode's and count's two rep counts
    alone."""
    pr = profile_riccati_pieces
    ms = {pr.rollout_key(mode, L, reps): base + (pr.REPS_HI - 1) * slope * (reps > 1)
          for mode, L, base, slope in (("device", 16, 0.010, 0.004), ("staged", 16, 0.006, 0.002),
                                       ("device", 1, 0.020, 0.008), ("staged", 1, 0.030, 0.009))
          for reps in (1, pr.REPS_HI)}
    got = pr.rollout_modes(ms, (16, 1))
    assert set(got) == {"device@16", "staged@16", "device@1", "staged@1"}
    for key, base, slope in (("device@16", 0.010, 0.004), ("staged@1", 0.030, 0.009)):
        assert got[key]["one_ms"] == base
        assert got[key]["slope_us"] == pytest.approx(slope * 1e3)
        assert got[key]["rollout_step_ns"] == pytest.approx(slope * 1e6 / pr.T)


@pytest.mark.parametrize("run", [ab_blocked_ilp.run, profile_riccati_pieces.run, ab_nn_reread.run])
def test_diagnostics_need_a_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        run()


# the shape of an nvcc -Xptxas -v report: an entry function, a device
# function it calls with its own properties, then the entry's properties
PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelI5NNEnvEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Function properties for _Z6kernelI5NNEnvEvv
    208 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 208 bytes cumulative stack size, 300 bytes smem
ptxas info    : Compiling entry function '_Z6kernelI11PendulumEnvEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelI11PendulumEnvEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers
"""


def test_ptxas_report():
    nn = {"_Z6kernelI5NNEnvEvv": dict(stack_frame=208, spill_stores=12, spill_loads=8, registers=72)}
    assert ptxas_report(PTXAS_LOG, "NNEnv") == nn
    pendulum = dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=64)
    assert ptxas_report(PTXAS_LOG) == {**nn, "_Z6kernelI11PendulumEnvEvv": pendulum}
    assert ptxas_report("") == {}
