"""The port's ahead-of-time export (diffmpc_tpu_torch/aot.py) and its ops
(diffmpc_tpu_torch/ops/library.py), on the CPU at B=8, T=6.

- ``torch.library.opcheck`` on every op of the solve path;
- the counterparts of tests/test_aot.py that need one process: the round
  trip through a file equal to the live solve bit for bit (fused and
  non-fused), warm start and params as live inputs, the gradient through a
  ``vjp_order=1`` artifact (the pendulum's closed-form Jacobian and the
  cartpole's ``torch.func`` one), the loaded artifact in a receding loop,
  introspection and arity, the manifest and its validation, the
  format-version gate and a raw payload;
- a program built here for the card (every device argument ``cuda``), the
  mesh form following the dispatch, the contract of torch's private
  ``while_loop_op`` that the exported loop calls, and the refusals (``verbose``, a model
  without tensors for ``params_input``, an
  indivisible mesh batch, per-scenario tensors that a mesh program would
  bake, the JAX package's artifact);
- the same numpy inputs through the JAX package's ``export_solve`` /
  ``load_solve`` and the port's: the manifests' shared fields equal, the
  outputs within 1e-4 at ``lqr_iter=1`` and by the chaos rule beyond.
"""

import dataclasses
import io
import json
import struct

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
from diffmpc_tpu_torch.models import CartpoleDx, CtrlPassthroughDynamics, PendulumDx, VehicleDx, spec  # noqa: E402
from diffmpc_tpu_torch.ops import library  # noqa: E402
from diffmpc_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_parity import assert_chaos  # noqa: E402

B, T = 8, 6
BOX = dict(u_lower=-2.0, u_upper=2.0)


def _x(B=B, seed=42):
    """tests/test_aot.py's starts: random angle, speed in [-1, 1]."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1).astype(np.float32)


def _problem(lqr_iter=4, **kw):
    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    config = tdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=1e-5, exit_unconverged=False,
                           detach_unconverged=False, **kw)
    return config, tdm.QuadCost(torch.diag(q), p), dx, torch.tensor(_x())


def _config2(T=T, B=B, lqr_iter=10):
    """BASELINE.json config 2's shape (box-DDP, n=4, m=2, box +-0.6) on
    tests/oracles.py's random problem."""
    C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32)
                      for a in random_lqr_problem(np.random.default_rng(17), T, B, 4, 2))
    config = tdm.MPCConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=lqr_iter, exit_unconverged=False,
                           detach_unconverged=False)
    return config, tdm.QuadCost(C, c), tdm.LinDx(F, f), x0


def _flat(sol):
    return [sol.xs, sol.us, sol.objs, *sol.info]


def _assert_bit_equal(got, want):
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.detach(), w.detach()), f"output {i} differs"


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(3)
    C, c, F, f, x0 = (torch.tensor(a, dtype=torch.float32) for a in random_lqr_problem(np.random.default_rng(5), 4, 3,
                                                                                        3, 1))
    lo, hi = torch.full((4, 3, 1), -0.5), torch.full((4, 3, 1), 0.5)
    u_hat = torch.randn(4, 3, 1, generator=g) * 0.3
    x_hat = torch.randn(4, 3, 3, generator=g)
    K, k = torch.randn(4, 3, 1, 3, generator=g) * 0.1, torch.randn(4, 3, 1, generator=g) * 0.1
    tight = u_hat.abs() > 0.4
    tau = torch.cat([x_hat, u_hat], -1)
    r = torch.randn(4, 3, 4, generator=g)
    pend = PendulumDx.default(device="cpu")
    name, statics, tensors = spec.encode(pend)
    leaf = [tensors[0].clone().requires_grad_(True)]
    return {
        "riccati_backward": (library.riccati_backward_op,
                             (C, c, F, None, 3, lo, hi, u_hat, None, 1e-7, 8, "", -1.0, None)),
        "linesearch_rollout": (library.linesearch_rollout_op,
                               (x0, C, c, F, f, K, k, x_hat, u_hat, lo, hi, None, "", "", [], 0.2, 10, None)),
        "kkt_backward": (library.kkt_backward_op, (C, c, F, r, tau, tight, 1e-7, -1.0, None)),
        "lqr_fixed_point": (library.lqr_fixed_point_op,
                            (x0.clone().requires_grad_(True), C.clone().requires_grad_(True), c, F, f, x_hat, u_hat,
                             lo, hi, True,
                             1e-6, 1e-7, -1.0, None)),
        "linearize": (library.linearize_op, (name, statics, leaf, x_hat, u_hat, "analytic")),
        "rollout": (library.rollout_op, (x0, u_hat, F, f, "", "", [])),
        "rollout_model": (library.rollout_op, (x0, u_hat, None, None, name, statics, tensors)),
    }


@pytest.mark.parametrize("name", ["riccati_backward", "linesearch_rollout", "kkt_backward", "lqr_fixed_point",
                                  "linearize", "rollout", "rollout_model"])
def test_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


def _fused_args():
    config, cost, dx, x = _problem()
    n, s, t = spec.encode(dx)
    lo, hi = torch.full((T, B, 1), -2.0), torch.full((T, B, 1), 2.0)
    C, c = cost.C.expand(T, B, 4, 4), cost.c.expand(T, B, 4)
    return (x, C, c, n, s, t, lo, hi, None, 3, 8, "", -1.0, 1e-9, 0.2, 10, None, 1e-7, 1e-4, 5, False, False, None)


def _cartpole_linearize_args():
    dx = CartpoleDx.default(device="cpu")
    g = torch.Generator().manual_seed(1)
    n, s, t = spec.encode(dx)
    return (n, s, [t[0].clone().requires_grad_(True)], torch.randn(T, B, 5, generator=g),
            torch.randn(T, B, 1, generator=g), "analytic")


def test_fixed_point_backward_is_once_differentiable():
    """The KKT backward has no derivative of its own: a gradient of the
    gradient raises autograd's once_differentiable error."""
    config, cost, dx, x = _problem(lqr_iter=2)
    prm = dx.params.clone().requires_grad_(True)
    sol = tdm.mpc_solve(config, x, cost, dx.replace(params=prm), **BOX)
    (g,) = torch.autograd.grad((sol.us ** 2).sum(), prm, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.parametrize("case", ["ilqr_solve_fused", "linearize_cartpole"])
def test_opcheck_forward_mode_bodies(case):
    """The fused solve's plain version and the cartpole's Jacobian compute by
    forward-mode AD, which opcheck's dispatch modes do not carry into an
    op's body: the registration is checked by opcheck, the fake
    implementation against the real outputs here (without grad, so that the
    linearization's autograd kernel hands the call to it)."""
    op, args = ((library.ilqr_solve_fused_op, _fused_args()) if case == "ilqr_solve_fused"
                else (library.linearize_op, _cartpole_linearize_args()))
    torch.library.opcheck(op, args, test_utils="test_autograd_registration")
    real = op(*args)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode, torch.no_grad():
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [mode.from_tensor(t) for t in a] if isinstance(a, list) else a for a in args]
        fake = op(*fake_args)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.device) == (f.shape, f.dtype, f.device)
        assert bool(torch.isfinite(r.float()).all())


# ---------------------------------------------------------------------------
# Round trips against the live solve.
# ---------------------------------------------------------------------------


def test_roundtrip_matches_live_solve(tmp_path):
    config, cost, dx, x = _problem()
    blob = aot.export_solve(config, cost, dx, B, **BOX)
    assert isinstance(blob, bytes)
    f = tmp_path / "solve.bin"
    f.write_bytes(blob)
    solve = aot.load_solve(f.read_bytes())
    got = solve(x)
    _assert_bit_equal(got, tdm.mpc_solve(config, x, cost, dx, **BOX))
    assert bool((got.us.abs() <= 2.0).all())
    assert "diffmpc.ilqr_solve_fused" in str(solve.exported.graph)


def test_warm_start_input_is_live():
    config, cost, dx, x = _problem(lqr_iter=2)
    solve = aot.load_solve(aot.export_solve(config, cost, dx, B, warm_start=True, **BOX))
    u0 = torch.zeros((T, B, 1))
    for u in (u0, torch.full_like(u0, 0.5)):
        _assert_bit_equal(solve(x, u), tdm.mpc_solve(config, x, cost, dx, u_init=u, **BOX))
    assert float((solve(x, u0).us - solve(x, torch.full_like(u0, 0.5)).us).abs().max()) > 0


def _grads(f, leaf):
    return torch.autograd.grad((f(leaf).us ** 2).sum(), leaf)[0]


def test_params_input_and_grad_through_artifact():
    """vjp_order=1: autograd through the loaded program runs the fixed point's
    KKT backward and the linearization's backward (the pendulum's closed
    form), per-scenario (B, 3) params as the input."""
    config, cost, dx, x = _problem(lqr_iter=3)
    params = (dx.params * torch.linspace(0.95, 1.05, B)[:, None]).contiguous()
    dxb = dx.replace(params=params)
    solve = aot.load_solve(aot.export_solve(config, cost, dxb, B, params_input=True, vjp_order=1, **BOX))
    p = (params * 1.1).requires_grad_(True)
    got = solve(x, p)
    live = tdm.mpc_solve(config, x, cost, dx.replace(params=p), **BOX)
    _assert_bit_equal(got, live)
    g_aot = _grads(lambda q: solve(x, q), p)
    g_live = _grads(lambda q: tdm.mpc_solve(config, x, cost, dx.replace(params=q), **BOX), p)
    assert g_aot.abs().max() > 0
    np.testing.assert_allclose(g_aot.numpy(), g_live.numpy(), rtol=2e-4, atol=1e-6)


def test_vjp_order_1_cartpole_through_torch_func():
    """The cartpole has no closed-form Jacobian: the attach's linearization
    is the linearize op, whose body and backward use torch.func."""
    dx = CartpoleDx.default(device="cpu")
    rng = np.random.default_rng(4)
    x = torch.tensor(np.stack([rng.uniform(-0.5, 0.5, B), np.zeros(B), np.cos(th := rng.uniform(-0.3, 0.3, B)),
                               np.sin(th), np.zeros(B)], -1), dtype=torch.float32)
    C = torch.diag(torch.tensor([1.0, 0.1, 1.0, 1.0, 0.1, 1e-3]))
    c = torch.tensor([0.0, 0.0, -1.0, 0.0, 0.0, 0.0])
    config = tdm.MPCConfig(n_state=5, n_ctrl=1, T=T, lqr_iter=3, eps=1e-5, exit_unconverged=False,
                           detach_unconverged=False)
    cost, box = tdm.QuadCost(C, c), dict(u_lower=-10.0, u_upper=10.0)
    solve = aot.load_solve(aot.export_solve(config, cost, dx, B, params_input=True, vjp_order=1, **box))
    assert "diffmpc.linearize" in str(solve.exported.graph)
    p = dx.params.clone().requires_grad_(True)
    _assert_bit_equal(solve(x, p), tdm.mpc_solve(config, x, cost, dx.replace(params=p), **box))
    g_aot = _grads(lambda q: solve(x, q), p)
    g_live = _grads(lambda q: tdm.mpc_solve(config, x, cost, dx.replace(params=q), **box), p)
    assert g_aot.abs().max() > 0
    np.testing.assert_allclose(g_aot.numpy(), g_live.numpy(), rtol=2e-4, atol=1e-6)


def test_params_input_requires_a_model_with_tensors():
    config, cost, dx, x = _problem()
    lin = tdm.LinDx(torch.zeros((T, B, 3, 4)), torch.zeros((T, B, 3)))
    with pytest.raises(ValueError, match="params_input"):
        aot.export_solve(config, cost, lin, B, params_input=True)


def test_callable_cost_and_verbose_refused():
    """verbose > 0 is refused (the JAX package's export refuses it too:
    tests/test_torch_aot_callable.py). A callable cost is exported since
    the serving artifact traces it (tests/test_torch_aot_callable.py)."""
    config, cost, dx, x = _problem()
    with pytest.raises(ValueError, match="verbose"):
        aot.export_solve(dataclasses.replace(config, verbose=1), cost, dx, B, **BOX)


def test_non_fused_config2_artifact_matches_live():
    """The non-fused loop under export is a while_loop around one traced
    iteration with the live loop's exit: the same answer and n_iters as the
    live loop, which stops early."""
    config, cost, lin, x = _config2()
    box = dict(u_lower=-0.6, u_upper=0.6)
    solve = aot.load_solve(aot.export_solve(config, cost, lin, B, **box))
    graph = str(solve.exported.graph)
    body = "\n".join(str(gm.graph) for gm in solve.exported.graph_module.modules()
                     if isinstance(gm, torch.fx.GraphModule) and gm is not solve.exported.graph_module)
    assert "while_loop" in graph and "diffmpc.riccati_backward" not in graph
    assert body.count("diffmpc.riccati_backward") == 1 == body.count("diffmpc.linesearch_rollout")
    got, want = solve(x), tdm.mpc_solve(config, x, cost, lin, **box)
    assert int(want.info.n_iters) < config.lqr_iter  # the live loop stopped early
    _assert_bit_equal(got, want)


def test_while_loop_op_contract():
    """The exported loop (mpc._ilqr_loop) calls torch's private
    ``while_loop_op`` as ``(cond_fn, body_fn, carried_inputs,
    additional_inputs)``: that import, those four positional arguments,
    the loop run eagerly and under torch.export, each failing with a
    message naming the op."""
    import inspect

    try:
        from torch._higher_order_ops.while_loop import while_loop_op
    except ImportError as e:
        pytest.fail(f"torch._higher_order_ops.while_loop.while_loop_op no longer imports: {e}")
    params = list(inspect.signature(while_loop_op.__call__).parameters.values())
    positional = [p.name for p in params if p.kind is inspect.Parameter.POSITIONAL_ONLY]
    assert positional[:4] == ["cond_fn", "body_fn", "carried_inputs", "additional_inputs"], \
        f"while_loop_op's positional arguments changed: {positional}"

    class Loop(torch.nn.Module):
        def forward(self, x, step):
            return while_loop_op(lambda i, y, s: (i < 3) & (y.sum() < 100.0),
                                 lambda i, y, s: (i + 1, y + s),
                                 (torch.zeros((), dtype=torch.int32), x), (step,))

    x, step = torch.zeros(2), torch.tensor([1.0, 2.0])
    n, y = Loop()(x, step)
    assert int(n) == 3 and torch.equal(y, 3 * step), f"while_loop_op run eagerly gave {n}, {y}"
    ep = torch.export.export(Loop(), (x, step))
    assert "while_loop" in str(ep.graph), f"while_loop_op left no while_loop in the exported graph:\n{ep.graph}"
    n, y = ep.module()(x, 20 * step)  # stops on the sum after two iterations
    assert int(n) == 2 and torch.equal(y, 40 * step), f"while_loop_op under export gave {n}, {y}"


def test_artifact_in_a_receding_loop():
    """The serving pattern: the loaded warm-start artifact called in a loop
    (shift the plan, solve again) equals the live loop."""
    config, cost, dx, x = _problem(lqr_iter=2)
    solve = aot.load_solve(aot.export_solve(config, cost, dx, B, warm_start=True, **BOX))

    def episode(f, n=4):
        u, objs = torch.zeros((T, B, 1)), []
        for _ in range(n):
            sol = f(u)
            u = torch.roll(sol.us, -1, dims=0)
            objs.append(sol.objs)
        return torch.stack(objs)

    got = episode(lambda u: solve(x, u))
    want = episode(lambda u: tdm.mpc_solve(config, x, cost, dx, u_init=u, **BOX))
    assert torch.equal(got, want)


def test_introspection_and_wrong_arity():
    config, cost, dx, x = _problem(lqr_iter=2)
    solve = aot.load_solve(aot.export_solve(config, cost, dx, B, warm_start=True, params_input=True, **BOX))
    assert solve.exported.graph_signature.user_inputs
    assert solve.manifest["input_names"] == ["x_init", "u_init", "params"]
    with pytest.raises(TypeError, match="missing: u_init, params"):
        solve(x)
    with pytest.raises(TypeError, match="expects 3 positional"):
        solve(x, torch.zeros((T, B, 1)), dx.params, x)


# ---------------------------------------------------------------------------
# The manifest.
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_and_validation():
    config, cost, dx, x = _problem(lqr_iter=2)
    kw = dict(warm_start=True, params_input=True, vjp_order=1, **BOX)
    blob = aot.export_solve(config, cost, dx, B, **kw)
    m = aot.read_manifest(blob)
    assert m["format_version"] == 1 and m["library"] == "diffmpc_tpu_torch"
    assert m["torch_version"] == torch.__version__
    assert m["input_names"] == ["x_init", "u_init", "params"]
    assert m["inputs"][0] == {"name": "x_init", "shape": [B, 3], "dtype": "float32"}
    assert m["inputs"][1]["shape"] == [T, B, 1]
    assert m["inputs"][2] == {"name": "params", "leaves": [{"name": "params", "shape": [3], "dtype": "float32"}]}
    assert m["bounds"] == {"u_lower": -2.0, "u_upper": 2.0}
    assert m["vjp_order"] == 1 and m["mesh"] is None and m["batch_size"] == B
    assert m["dynamics"] == "PendulumDx" and m["platforms"] == ["cpu"]
    assert m["config"]["T"] == T and len(m["config_digest"]) == 64
    assert aot.read_manifest(aot.export_solve(config, cost, dx, B, **kw))["config_digest"] == m["config_digest"]
    other = aot.export_solve(dataclasses.replace(config, lqr_iter=3), cost, dx, B, **BOX)
    assert aot.read_manifest(other)["config_digest"] != m["config_digest"]
    solve = aot.load_solve(blob)
    assert solve.manifest == m
    # a small per-dimension box is recorded by value, a large one by digest
    veh = VehicleDx.default(device="cpu")
    vq, vp = veh.get_true_obj()
    vconfig = tdm.MPCConfig(n_state=4, n_ctrl=2, T=T, lqr_iter=2, exit_unconverged=False)
    lo, hi = torch.tensor([-6.0, -0.5]), torch.tensor([3.0, 0.5])
    vm = aot.read_manifest(aot.export_solve(vconfig, tdm.QuadCost(torch.diag(vq), vp), veh, B, u_lower=lo,
                                            u_upper=hi))
    assert vm["bounds"]["u_lower"] == {"shape": [2], "dtype": "float32", "values": [-6.0, -0.5]}
    assert vm["bounds"]["u_upper"]["values"] == [3.0, 0.5]
    big = aot._bound_json(torch.full((T, B, 2), -1.0))
    assert "values" not in big and len(big["sha256"]) == 64 and big["shape"] == [T, B, 2]


def test_manifest_format_version_gate_and_raw_payload():
    config, cost, dx, x = _problem(lqr_iter=2)
    blob = aot.export_solve(config, cost, dx, B, **BOX)
    (mlen,) = struct.unpack(">I", blob[len(aot._MAGIC):len(aot._MAGIC) + 4])
    payload = blob[len(aot._MAGIC) + 4 + mlen:]
    raw = aot.load_solve(payload)  # the torch.export archive alone
    assert raw.manifest is None
    _assert_bit_equal(raw(x), aot.load_solve(blob)(x))

    def forged(manifest):
        body = json.dumps(manifest).encode()
        return aot._MAGIC + struct.pack(">I", len(body)) + body + payload

    with pytest.raises(ValueError, match="format_version 99"):
        aot.read_manifest(forged({"format_version": 99}))
    with pytest.raises(ValueError, match="format_version 99"):
        aot.load_solve(forged({"format_version": 99}))
    with pytest.raises(ValueError, match="no integer format_version"):
        aot.read_manifest(forged({"library": "diffmpc_tpu_torch"}))
    with pytest.raises(ValueError, match="truncated"):
        aot.read_manifest(blob[:len(aot._MAGIC) + 2])
    with pytest.raises(ValueError, match="declares"):
        aot.read_manifest(aot._MAGIC + struct.pack(">I", 10 ** 6) + b"xx")


def test_cpu_built_program_for_the_card():
    """platforms=['cuda'] from CPU tensors: every device the program names is
    the card's; the baked tensors stay in the payload for the load."""
    config, cost, dx, x = _problem(lqr_iter=2)
    blob = aot.export_solve(config, cost, dx, B, platforms=["cuda"], warm_start=True, **BOX)
    assert aot.read_manifest(blob)["platforms"] == ["cuda"]
    (mlen,) = struct.unpack(">I", blob[len(aot._MAGIC):len(aot._MAGIC) + 4])
    extra = {aot._BAKED: ""}
    ep = torch.export.load(io.BytesIO(blob[len(aot._MAGIC) + 4 + mlen:]), extra_files=extra)
    devices = [n.kwargs["device"] for n in ep.graph.nodes if n.kwargs.get("device") is not None]
    devices += [n.args[1] for n in ep.graph.nodes if n.target is torch.ops.aten.to.device]
    vals = [v for n in ep.graph.nodes for v in torch.utils._pytree.tree_leaves(n.meta.get("val"))
            if isinstance(v, torch.Tensor)]
    assert devices and all(torch.device(d).type == "cuda" for d in devices)
    assert vals and all(v.device.type == "cuda" for v in vals)
    assert [t.device.type for t in aot._unpack(extra[aot._BAKED])] == ["cpu"] * 5


def test_mesh_form_follows_the_dispatch():
    config, cost, dx, x = _problem(lqr_iter=2)
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    m = aot.read_manifest(aot.export_solve(config, cost, dx, B, mesh=mesh, **BOX))
    assert m["mesh"] == {"axis_names": ["batch"], "shape": [2], "local_batch": B // 2, "form": "fused"}
    assert m["inputs"][0]["shape"] == [B // 2, 3] and m["batch_size"] == B
    fd = dataclasses.replace(config, grad_method=tdm.GradMethods.FINITE_DIFF)
    assert aot.read_manifest(aot.export_solve(fd, cost, dx, B, mesh=mesh, **BOX))["mesh"]["form"] == "loop"
    with pytest.raises(ValueError, match="3 ranks must evenly divide B=8"):
        aot.export_solve(config, cost, dx, B, mesh=dataclasses.replace(mesh, size=3), **BOX)
    with pytest.raises(ValueError, match="2-rank mesh"):
        aot.load_solve(aot.export_solve(config, cost, dx, B, mesh=mesh, **BOX))(x[:4])


@pytest.mark.parametrize("case", ["params", "passthrough", "C", "bound", "LinDx"])
def test_mesh_refuses_per_scenario_tensors_it_would_bake(case):
    """Every rank's program carries the same baked tensors, so under mesh=
    a per-scenario model needs params_input (each rank passing its rows),
    and a per-scenario cost, bound or LinDx raises. With params_input the
    per-scenario model is the rank's program at B / 2 rows."""
    config, cost, dx, x = _problem(lqr_iter=2)
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    rows = dx.params * torch.linspace(0.9, 1.1, B)[:, None]
    bnd = dict(BOX)
    if case in ("params", "passthrough"):
        dx = dx.replace(params=rows)
        if case == "passthrough":
            dx = CtrlPassthroughDynamics(inner=dx, n_ctrl=1)
            config = dataclasses.replace(config, n_state=4)
        with pytest.raises(ValueError, match="needs params_input=True"):
            aot.export_solve(config, cost if case == "params" else tdm.QuadCost(torch.eye(5), torch.zeros(5)), dx, B,
                             mesh=mesh, **bnd)
        return
    if case == "C":
        cost = tdm.QuadCost(cost.C.expand(T, B, 4, 4).contiguous(), cost.c)
    elif case == "bound":
        bnd["u_lower"] = torch.full((T, B, 1), -2.0)
    else:
        config, cost, dx, _ = _config2()
        bnd = dict(u_lower=-0.6, u_upper=0.6)
    with pytest.raises(ValueError, match="row per scenario"):
        aot.export_solve(config, cost, dx, B, mesh=mesh, **bnd)


def test_mesh_takes_per_scenario_params_as_the_ranks_input():
    config, cost, dx, x = _problem(lqr_iter=2)
    rows = dx.params * torch.linspace(0.9, 1.1, B)[:, None]
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    blob = aot.export_solve(config, cost, dx.replace(params=rows), B, params_input=True, mesh=mesh, **BOX)
    m = aot.read_manifest(blob)
    assert m["inputs"][1]["leaves"][0]["shape"] == [B // 2, 3] and m["mesh"]["form"] == "fused"


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_artifacts():
    """The JAX package's artifacts of the pendulum at lqr_iter 1 and 4 (cold),
    and with warm start and params input (one export each)."""
    out = {}
    dx = JaxPendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = jdm.QuadCost(jnp.diag(q), p)
    for it in (1, 4):
        config = jdm.MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=it, eps=1e-5, exit_unconverged=False,
                               detach_unconverged=False, dtype=jnp.float32)
        out[it] = jaot.export_solve(config, cost, dx, B=B, **BOX)
    out["inputs"] = jaot.export_solve(config, cost, dx, B=B, warm_start=True, params_input=True, **BOX)
    return out


SHARED = ("input_names", "inputs", "bounds", "batch_size", "vjp_order", "dynamics", "platforms", "mesh",
          "format_version")


@pytest.mark.parametrize("lqr_iter", [1, 4])
def test_against_the_jax_artifact(jax_artifacts, lqr_iter):
    config, cost, dx, x = _problem(lqr_iter=lqr_iter)
    blob = aot.export_solve(config, cost, dx, B, **BOX)
    jm, tm = jaot.read_manifest(jax_artifacts[lqr_iter]), aot.read_manifest(blob)
    assert {k: tm[k] for k in SHARED} == {k: jm[k] for k in SHARED}
    got = aot.load_solve(blob)(x)
    want = jaot.load_solve(jax_artifacts[lqr_iter])(jnp.asarray(x.numpy()))
    if lqr_iter == 1:
        np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), atol=1e-4)
        np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), atol=1e-4)
        np.testing.assert_allclose(got.objs.numpy(), np.asarray(want.objs), atol=1e-4)
    else:
        rows = lambda s: dict(n_iters=np.zeros(B), objs=np.asarray(s.objs), alpha=np.asarray(s.info.mean_alpha),  # noqa: E731
                              converged=np.asarray(s.info.converged), us=np.asarray(s.us))
        assert_chaos(rows(got), rows(want))
    assert int(got.info.n_iters) == int(want.info.n_iters)


def test_manifests_with_inputs_match_jax_and_each_refuses_the_other(jax_artifacts):
    config, cost, dx, x = _problem(lqr_iter=4)
    blob = aot.export_solve(config, cost, dx, B, warm_start=True, params_input=True, **BOX)
    jm, tm = jaot.read_manifest(jax_artifacts["inputs"]), aot.read_manifest(blob)
    assert {k: tm[k] for k in SHARED} == {k: jm[k] for k in SHARED}
    assert aot.read_manifest(jax_artifacts["inputs"]) == jm  # the port reads the JAX package's manifest
    with pytest.raises(ValueError, match="diffmpc_tpu"):
        aot.load_solve(jax_artifacts["inputs"])
    u = np.zeros((T, B, 1), np.float32)
    got = aot.load_solve(blob)(x, torch.tensor(u), dx.params)
    want = jaot.load_solve(jax_artifacts["inputs"])(jnp.asarray(x.numpy()), jnp.asarray(u),
                                                    jnp.asarray(dx.params.numpy()))
    rows = lambda s: dict(n_iters=np.zeros(B), objs=np.asarray(s.objs), alpha=np.asarray(s.info.mean_alpha),  # noqa: E731
                          converged=np.asarray(s.info.converged), us=np.asarray(s.us))
    assert_chaos(rows(got), rows(want))
    jax.clear_caches()


def test_export_artifact_example_on_the_cpu(tmp_path, capsys):
    """The example's build, inspect and run on the vehicle (its per-dimension
    box recorded by value, its params a runtime input): the run's solve
    equals the live one."""
    from diffmpc_tpu_torch.examples import export_artifact as ex

    out = str(tmp_path / "vehicle.bin")
    flags = ["--env", "vehicle", "--batch", "8", "--horizon", "4", "--lqr-iter", "2", "--params-input", "--cpu"]
    ex.main(["build", *flags, "--out", out])
    m = ex.main(["inspect", out])
    assert m["bounds"]["u_lower"]["values"] == [-6.0, -0.5] and m["input_names"] == ["x_init", "params"]
    got = ex.main(["run", out, "--reps", "1", "--params", "2.5,0.1"])
    config, cost, dx, lo, hi = ex.problem("vehicle", 4, 2, "cpu")
    x = ex.random_vehicle_x_init(8, 0)
    want = tdm.mpc_solve(config, x, cost, dx.replace(params=torch.tensor([2.5, 0.1])), u_lower=lo, u_upper=hi)
    assert torch.equal(got["objs"], want.objs)
    assert "ms/batch on the CPU" in capsys.readouterr().out
