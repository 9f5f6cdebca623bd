"""The serving artifact of a callable cost (diffmpc_tpu_torch/aot.py), on the
CPU in float64 at T=5, B=8: tests/test_mpc.py:160's cosh cost on the
pendulum (tests/torch_aot_callable_cases.py), written once in ``jnp`` and
once in ``torch``.

- The port's artifact against the port's live solve: ``xs``, ``us``,
  ``objs``, ``n_iters`` and the rest of ``info`` bit-equal, cold, with
  ``warm_start`` and ``params_input``, and with the slew penalty; with
  ``vjp_order=1`` the gradients with respect to ``params`` and ``x_init``
  within 1e-10 of live's max-abs.
- The port's artifact against the JAX package's artifact of the same cost
  from the same numpy inputs: within 1e-9 at ``lqr_iter=1``, by
  tests/torch_parity.py's chaos rule at ``lqr_iter=4``, the params gradient
  within 1e-6 of its max-abs on the scenarios at the same fixed point; the
  manifests' shared keys equal.
- No state: ``ep.constants`` empty, the cost's closed-over tensors in the
  payload; the traced expansion equal to ``quadraticize_cost``.
- A program built here for the card: every device it names the card's.
- Under ``mesh=`` the form is ``loop``, and two CPU ranks each solve their
  shard as the live solve does.
- ``verbose > 0`` refused by both packages; a cost that cannot be traced
  raises, naming it.
"""

import io
import struct
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffmpc_tpu as jdm  # noqa: E402
import diffmpc_tpu_torch as tdm  # noqa: E402
from diffmpc_tpu import aot as jaot  # noqa: E402
from diffmpc_tpu.models import PendulumDx as JaxPendulumDx  # noqa: E402
from diffmpc_tpu_torch import aot  # noqa: E402
from diffmpc_tpu_torch.ops.linearize import quadraticize_cost, trace_mapped_cost, trace_quadraticize  # noqa: E402
from diffmpc_tpu_torch.parallel import dryrun  # noqa: E402
from test_torch_aot import SHARED  # noqa: E402
from torch_aot_callable_cases import B, BOX, GOAL, Q, T, problem, rank_mesh_artifact, torch_cost, x_init  # noqa: E402
from torch_parity import assert_chaos  # noqa: E402


def jax_cost(q):
    """The cosh cost in jnp."""
    goal = jnp.asarray(GOAL)

    def cost_fn(tau):
        d = tau - goal
        return 0.5 * jnp.sum(q * d * d) + 0.01 * jnp.sum(jnp.cosh(tau[3:]) - 1.0)

    return cost_fn


def _flat(sol):
    return [sol.xs, sol.us, sol.objs, *sol.info]


def _assert_bit_equal(got, want):
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.detach(), w.detach()), f"output {i} differs"


def _graphs(ep) -> str:
    """The program's graph and its subgraphs (a while_loop's), as text."""
    return "\n".join(str(gm.graph) for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule))


def _baked(blob):
    """The payload's baked tensors, read from its archive without loading
    the program."""
    (mlen,) = struct.unpack(">I", blob[len(aot._MAGIC):len(aot._MAGIC) + 4])
    with zipfile.ZipFile(io.BytesIO(blob[len(aot._MAGIC) + 4 + mlen:])) as z:
        name, = (n for n in z.namelist() if n.endswith("extra/" + aot._BAKED))
        return aot._unpack(z.read(name).decode())


INPUTS_ITER = 2  # the warm-start, params-input, vjp_order=1 artifact's lqr_iter


@pytest.fixture(scope="module")
def port():
    """The port's artifacts, each exported and loaded once: cold at
    lqr_iter 1 and 4, and warm start with params input and vjp_order=1 at
    INPUTS_ITER; ``(blob, solve)`` each."""
    out = {}
    for it in (1, 4):
        cfg, cost, dx, _ = problem(it)
        out[it] = aot.export_solve(cfg, cost, dx, B, **BOX)
    cfg, cost, dx, _ = problem(INPUTS_ITER)
    out["inputs"] = aot.export_solve(cfg, cost, dx, B, warm_start=True, params_input=True, vjp_order=1, **BOX)
    return {k: (blob, aot.load_solve(blob)) for k, blob in out.items()}


@pytest.fixture(scope="module")
def jax_artifacts():
    """The JAX package's artifacts of the same cost and cases."""
    out = {}
    dx = JaxPendulumDx.default(jnp.float64)
    cost = jax_cost(jnp.asarray(Q))
    for it in (1, 4):
        out[it] = jaot.export_solve(_jax_config(it), cost, dx, B=B, **BOX)
    out["inputs"] = jaot.export_solve(_jax_config(INPUTS_ITER), cost, dx, B=B, warm_start=True, params_input=True,
                                      vjp_order=1, **BOX)
    return out


def _jax_config(lqr_iter, **kw):
    return jdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=1e-6, exit_unconverged=False,
                         detach_unconverged=False, dtype=jnp.float64, **kw)


# ---------------------------------------------------------------------------
# Against the port's live solve.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lqr_iter", [1, 4])
def test_cold_artifact_bit_equal_to_live(port, lqr_iter):
    cfg, cost, dx, x = problem(lqr_iter)
    solve = port[lqr_iter][1]
    with torch.no_grad():
        want = tdm.mpc_solve(cfg, x, cost, dx, **BOX)
    _assert_bit_equal(solve(x), want)
    graphs = _graphs(solve.exported)
    assert graphs.count("diffmpc.riccati_backward") == 1 and "while_loop" in graphs  # one traced iteration
    assert "diffmpc.linesearch_rollout" not in graphs and "diffmpc.ilqr_solve_fused" not in graphs


def test_warm_start_and_params_inputs_bit_equal_to_live(port):
    """The warm-start, params-input artifact: two plans and two params rows
    through one program, each equal to the live solve."""
    cfg, cost, dx, x = problem(INPUTS_ITER)
    solve = port["inputs"][1]
    assert solve.manifest["input_names"] == ["x_init", "u_init", "params"]
    rng = np.random.default_rng(5)
    for u, p in ((torch.zeros((T, B, 1), dtype=torch.float64), dx.params),
                 (torch.tensor(rng.uniform(-1, 1, (T, B, 1))), dx.params * torch.tensor([1.05, 0.95, 1.0]))):
        with torch.no_grad():
            want = tdm.mpc_solve(cfg, x, cost, dx.replace(params=p), u_init=u, **BOX)
        _assert_bit_equal(solve(x, u, p), want)


def test_vjp_order_1_gradients_match_live(port):
    """Autograd through the loaded program (the fixed-point op and its KKT
    backward, the linearize op): the gradients with respect to params and
    x_init within 1e-10 of live's max-abs."""
    cfg, cost, dx, x = problem(INPUTS_ITER)
    solve = port["inputs"][1]
    u0 = torch.zeros((T, B, 1), dtype=torch.float64)

    def grads(fn):
        p, xl = dx.params.clone().requires_grad_(True), x.clone().requires_grad_(True)
        sol = fn(xl, p)
        loss = (sol.us ** 2).sum() + (sol.xs[..., 2] ** 2).sum()
        return (loss.detach(), *torch.autograd.grad(loss, (p, xl)))

    got = grads(lambda xl, p: solve(xl, u0, p))
    want = grads(lambda xl, p: tdm.mpc_solve(cfg, xl, cost, dx.replace(params=p), u_init=u0, **BOX))
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert float(w.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-10 * float(w.abs().max()))


def test_slew_penalty_artifact_bit_equal_to_live():
    """The slew penalty augments the callable (mpc.slew_cost): the artifact
    traces the augmented cost's expansion and equals the live solve."""
    cfg, cost, dx, x = problem(1, slew_rate_penalty=0.5)
    solve = aot.load_solve(aot.export_solve(cfg, cost, dx, B, **BOX))
    with torch.no_grad():
        want = tdm.mpc_solve(cfg, x, cost, dx, **BOX)
    _assert_bit_equal(solve(x), want)


# ---------------------------------------------------------------------------
# The program holds no state.
# ---------------------------------------------------------------------------


def test_no_state_and_the_closed_over_tensors_in_the_payload(port):
    blob, solve = port[4]
    ep, baked = solve.exported, _baked(blob)
    assert not ep.constants and not ep.state_dict
    assert len(baked) == 5  # the goal, the weights, the pendulum's params, the box's two ends
    assert torch.equal(baked[0], torch.tensor(GOAL)) and torch.equal(baked[1], torch.tensor(Q))
    assert aot.read_manifest(blob)["platforms"] == ["cpu"]


@pytest.mark.parametrize("samples", [1, T * B])
def test_traced_expansion_equals_quadraticize_cost(samples):
    """trace_quadraticize's graph computes quadraticize_cost's C and c
    bit for bit on a trajectory it was not traced on; its constants are the
    cost's closed-over tensors, each once, and bind puts others in their
    place. trace_mapped_cost is vmap of the cost, traced once, with no vmap
    left in its graph."""
    _, cost, _, _ = problem()
    rng = np.random.default_rng(samples)
    xs, us = torch.tensor(rng.standard_normal((1, samples, 3))), torch.tensor(rng.standard_normal((1, samples, 1)))
    traced = trace_quadraticize(cost, samples, 4, torch.float64, "cpu")
    want = quadraticize_cost(cost, xs, us)
    for g, w in zip(traced(xs, us), want):
        assert torch.equal(g, w)
    assert [t.shape for t in traced.constants] == [(4,), (4,)]
    assert not [n for n in traced.graph.graph.nodes if n.op == "get_attr"]
    q2 = torch.tensor(Q) * 2
    other = traced.bind([traced.constants[0], q2])
    for g, w in zip(other(xs, us), quadraticize_cost(torch_cost(q2), xs, us)):
        assert torch.equal(g, w)
    mapped = trace_mapped_cost(cost, (samples,), 4, torch.float64, "cpu")
    tau = torch.cat([xs, us], -1)[0]
    assert torch.equal(mapped(tau), torch.func.vmap(cost)(tau))
    assert [t.shape for t in mapped.constants] == [(4,), (4,)]
    assert not [n for n in mapped.traces[samples].graph.graph.nodes
                if "vmap" in str(n.target) or "batch_dim" in str(n.target)]


def test_cpu_built_program_for_the_card():
    """platforms=['cuda'] from CPU tensors: every device the program and its
    loop body name (the traced expansion's among them) is the card's; the
    baked tensors stay in the payload for the load."""
    cfg, cost, dx, _ = problem(1)
    blob = aot.export_solve(cfg, cost, dx, B, platforms=["cuda"], **BOX)
    assert aot.read_manifest(blob)["platforms"] == ["cuda"]
    (mlen,) = struct.unpack(">I", blob[len(aot._MAGIC):len(aot._MAGIC) + 4])
    ep, baked = torch.export.load(io.BytesIO(blob[len(aot._MAGIC) + 4 + mlen:])), _baked(blob)
    nodes = [n for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
    devices = [n.kwargs["device"] for n in nodes if n.kwargs.get("device") is not None]
    devices += [n.args[1] for n in nodes if n.target is torch.ops.aten.to.device]
    vals = [v for n in nodes for v in torch.utils._pytree.tree_leaves(n.meta.get("val")) if isinstance(v, torch.Tensor)]
    assert devices and all(torch.device(d).type == "cuda" for d in devices)
    assert vals and all(v.device.type == "cuda" for v in vals)
    assert [t.device.type for t in baked] == ["cpu"] * 5


# ---------------------------------------------------------------------------
# Against the JAX package's artifact.
# ---------------------------------------------------------------------------


def _rows(sol, n_iters):
    return dict(n_iters=np.full(B, n_iters), objs=np.asarray(sol.objs), alpha=np.asarray(sol.info.mean_alpha),
                converged=np.asarray(sol.info.converged), us=np.asarray(sol.us))


@pytest.mark.parametrize("lqr_iter", [1, 4])
def test_against_the_jax_artifact(port, jax_artifacts, lqr_iter):
    jm, tm = jaot.read_manifest(jax_artifacts[lqr_iter]), aot.read_manifest(port[lqr_iter][0])
    assert {k: tm[k] for k in SHARED} == {k: jm[k] for k in SHARED}
    x = x_init()
    got = port[lqr_iter][1](torch.tensor(x))
    want = jaot.load_solve(jax_artifacts[lqr_iter])(jnp.asarray(x))
    if lqr_iter == 1:
        for k in ("xs", "us", "objs"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=0, atol=1e-9,
                                       err_msg=k)
    else:
        assert_chaos(_rows(got, 0), _rows(want, 0))
    assert int(got.info.n_iters) == int(want.info.n_iters)


def test_gradient_against_the_jax_artifact(port, jax_artifacts):
    """vjp_order=1 in both packages: the manifests' shared keys equal, and
    the params gradient of a loss over the scenarios at the same fixed point
    (controls within 1e-6) within 1e-6 of its max-abs."""
    jm, tm = jaot.read_manifest(jax_artifacts["inputs"]), aot.read_manifest(port["inputs"][0])
    assert {k: tm[k] for k in SHARED} == {k: jm[k] for k in SHARED}
    x, u = x_init(), np.zeros((T, B, 1))
    params = np.array([10.0, 1.0, 1.0])
    jsolve = jaot.load_solve(jax_artifacts["inputs"])

    def per_scenario(q):  # each scenario's loss, and the controls
        us = jsolve(jnp.asarray(x), jnp.asarray(u), q).us
        return jnp.sum(us ** 2, (0, 2)), us

    _, vjp, want_us = jax.vjp(per_scenario, jnp.asarray(params), has_aux=True)
    p = torch.tensor(params, requires_grad=True)
    sol = port["inputs"][1](torch.tensor(x), torch.tensor(u), p)
    same = np.abs(sol.us.detach().numpy() - np.asarray(want_us)).max(axis=(0, 2)) < 1e-6
    assert same.sum() >= B // 2, np.abs(sol.us.detach().numpy() - np.asarray(want_us)).max(axis=(0, 2))
    g, = torch.autograd.grad(((sol.us ** 2).sum((0, 2)) * torch.tensor(same, dtype=torch.float64)).sum(), p)
    jg, = (np.asarray(a) for a in vjp(jnp.asarray(same, jnp.float64)))
    assert float(np.abs(jg).max()) > 0
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-6 * float(np.abs(jg).max()))


def test_verbose_refused_by_both_packages():
    """verbose > 0 has no exported form in either package: the JAX export
    raises NotImplementedError (its host callback has no serialization), the
    port's ValueError."""
    cfg = jdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=1, verbose=1, exit_unconverged=False, dtype=jnp.float64)
    with pytest.raises(NotImplementedError, match="host_callbacks"):
        jaot.export_solve(cfg, jax_cost(jnp.asarray(Q)), JaxPendulumDx.default(jnp.float64), B=B, **BOX)
    tcfg, cost, dx, _ = problem(1, verbose=1)
    with pytest.raises(ValueError, match="verbose"):
        aot.export_solve(tcfg, cost, dx, B, **BOX)


def test_untraceable_cost_raises_naming_it():
    """No fallback: a cost that cannot be traced raises, naming it."""
    cfg, _, dx, _ = problem(1)

    def not_a_tensor(tau):
        return float(tau.sum())

    with pytest.raises(RuntimeError, match="not_a_tensor"):
        aot.export_solve(cfg, not_a_tensor, dx, B, **BOX)


# ---------------------------------------------------------------------------
# Under mesh=.
# ---------------------------------------------------------------------------


def test_mesh_artifact_on_two_cpu_ranks():
    """Each of two gloo ranks exports the rank's program (the form ``loop``,
    B / 2 scenarios, T * B / 2 samples traced), loads it and solves its
    shard as the live solve does; n_iters is the max over the ranks."""
    out = dryrun.spawn(2, rank_mesh_artifact, device="cpu")
    for r in out:
        assert r["mesh"] == {"axis_names": ["batch"], "shape": [2], "local_batch": B // 2, "form": "loop"}
        assert r["shape"] == [B // 2, 3]
        assert r["xs"] and r["us"] and r["objs"]
        assert r["n_iters"] == max(o["live_n_iters"] for o in out)
