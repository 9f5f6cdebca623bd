"""Ahead-of-time export of MPC solve programs (counterpart of :mod:`diffmpc_tpu.aot`), through ``torch.export``.

A solve program (config, cost, dynamics, bounds and batch size fixed) is
written as a ``torch.export`` program that a serving process loads and calls
without the caller's model or config code and without tracing again. The
kernels are in it as the ops of :mod:`diffmpc_tpu_torch.ops.library`, so
the loaded program launches the same hand-written kernels as the live
solve, from the build on disk; importing this module registers the ops.

Runtime inputs are opt-in and positional, in this order:
``f(x_init[, u_init][, params])`` —

- ``warm_start=True`` adds ``u_init (T, B, m)`` (the receding-horizon
  pattern: one artifact, the shifted plan passed at each call);
- ``params_input=True`` adds the model's tensors (``params`` of an env, its
  per-scenario ``(B, P)`` rows included; an MLP's weights and biases as a
  list in the codec's order, :mod:`diffmpc_tpu_torch.models.spec`);
- ``vjp_order=1`` traces the differentiable attach, so that autograd through
  ``load_solve(blob)`` runs the ``kkt_backward`` op and the ``linearize``
  op's backward; with 0 the artifact is forward-only and runs without grad.

The program takes every tensor as an input: the cost's (a ``QuadCost``'s
``C, c``, a callable's closed-over tensors), the bounds and, without
``params_input``, the model's tensors are carried in
the payload beside it (an extra file of the ``torch.export`` archive) and
moved to the program's device at load. So the program holds no state, and
one built on a host without a card can be written for the card
(``platforms=["cuda"]``): its device arguments are rewritten in place
(:func:`_move_program`).

Container (the JAX package's): ``MAGIC | u32 manifest length (big-endian) |
manifest JSON | payload``, the payload from ``torch.export.save``;
:func:`read_manifest` reads the manifests of both libraries' artifacts.

A callable cost is traced at export (:class:`_CallableCost`): the cost
mapped over the program's samples and its quadraticization, by ``make_fx``
(``torch.func``'s transforms do not trace under ``torch.export``, and a
``vmap`` in the program does not serialize); the tensors it closes over
are baked like a ``QuadCost``'s. ``verbose > 0`` is refused, as
the JAX package's export refuses it (its host callback has no
serialization).

The non-fused loop is one traced iteration inside a ``while_loop`` with the
live loop's exit (:func:`diffmpc_tpu_torch.mpc._ilqr_loop`): the program
runs the iterations the live solve runs.

Kept divergences from the JAX package: under ``mesh=`` a batch that the
ranks do not divide raises (there is no replicated form to fall back to),
and so do per-scenario tensors that every rank's program would bake alike
(a model's take ``params_input=True``).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import io
import json
import struct
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils import _pytree as pytree

from .models import spec
from .models.dynamics import AffineDynamics, CtrlPassthroughDynamics, Dynamics
from .mpc import MPCInfo, MPCSolution, _mpc_solve, _would_use_fused, slew_cost
from .ops import library  # noqa: F401  (registers the diffmpc:: ops that a loaded program calls)
from .ops.linearize import distinct_tensors, trace_mapped_cost, trace_quadraticize
from .types import LinDx, MPCConfig, QuadCost

_MAGIC = b"DMPCAOT1"
_FORMAT_VERSION = 1
LIBRARY = "diffmpc_tpu_torch"
PLATFORMS = ("cpu", "cuda")
_BAKED = "diffmpc_baked_tensors"  # the archive's extra file that holds the baked tensors
# a bound array of at most this many entries is recorded by value in the
# manifest, a larger one by its shape, dtype and digest
SMALL_BOUND = 64


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _aval(name: str, t: torch.Tensor) -> dict:
    return {"name": name, "shape": list(t.shape), "dtype": _dtype_name(t.dtype)}


def _bound_json(b):
    if b is None:
        return None
    t = torch.as_tensor(b)
    if t.ndim == 0:
        return float(t)
    out = {"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
    if t.numel() <= SMALL_BOUND:
        out["values"] = t.tolist()
    else:
        out["sha256"] = hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    return out


def _config_json(config: MPCConfig) -> dict:
    return {k: (v if isinstance(v, (bool, int, float, str, type(None))) else str(v))
            for k, v in dataclasses.asdict(config).items()}


class _SolveProgram(torch.nn.Module):
    """``forward(x_init[, u_init][, params], baked)``: the flat
    :class:`~diffmpc_tpu_torch.mpc.MPCSolution` (xs, us, objs and the
    fields of its info) of one :func:`~diffmpc_tpu_torch.mpc.mpc_solve`,
    ``baked`` the cost's tensors (a ``QuadCost``'s ``C, c``; a callable's
    :class:`_CallableCost` tensors), the model's tensors unless they are an
    input, then each bound that is set (a number as a 0-d tensor: a constant
    would be state of the program)."""

    def __init__(self, config, cost, model: tuple, n_model: int, bounds: tuple, warm_start: bool, params_input: bool,
                 attach: bool):
        super().__init__()
        self.config, self.cost, self.model, self.n_model = config, cost, model, n_model
        self.bounds, self.warm_start, self.params_input, self.attach = bounds, warm_start, params_input, attach

    def forward(self, x_init, *args):
        args = list(args)
        baked = iter(args.pop())
        u_init = args.pop(0) if self.warm_start else None
        if self.cost is None:
            cost, traced = QuadCost(next(baked), next(baked)), {}
        else:
            cost, traced = self.cost.cost_fn, self.cost.bind([next(baked) for _ in self.cost.tensors])
        tensors = args.pop(0) if self.params_input else [next(baked) for _ in range(self.n_model)]
        lo, hi = (next(baked) if b else None for b in self.bounds)
        dx = spec.decode(*self.model, tensors)
        sol = _mpc_solve(self.config, x_init, cost, dx, u_init, lo, hi, attach=self.attach, **traced)
        return (sol.xs, sol.us, sol.objs, *sol.info)


class _CallableCost:
    """A callable cost as a program holds it, traced once at each shape the
    program evaluates it at (of the slew-augmented cost where the config has
    the penalty): mapped over the ``T * B`` samples of a trajectory and the
    ``max_linesearch_iter * T * B`` of the line search's ladder
    (:func:`~diffmpc_tpu_torch.ops.linearize.trace_mapped_cost`), and its
    quadraticization about a trajectory
    (:func:`~diffmpc_tpu_torch.ops.linearize.trace_quadraticize`); the
    program runs neither ``vmap`` nor ``torch.func``'s transforms.
    ``tensors`` holds every tensor the traces read, each once: the cost's
    closed-over tensors and any the trace made. The program takes them as
    inputs and :meth:`bind` puts them in the traces' place; the callable
    itself is not called in the program (where it were, its tensors would be
    the program's state, which export refuses)."""

    def __init__(self, config: MPCConfig, cost_fn, samples: int, dtype, device):
        n, m = config.n_state, config.n_ctrl
        slew = config.slew_rate_penalty is not None and config.slew_rate_penalty > 0
        sample_cost = slew_cost(cost_fn, n, m, config.slew_rate_penalty) if slew else cost_fn
        nm = n + m + m * slew
        self.cost_fn = cost_fn
        self.traces = [trace_mapped_cost(sample_cost, (samples, config.max_linesearch_iter * samples), nm, dtype,
                                         device),
                       trace_quadraticize(sample_cost, samples, nm, dtype, device)]
        self.tensors, self._index = distinct_tensors([traced.constants for traced in self.traces])

    def bind(self, tensors: list) -> dict:
        """``mapped_cost`` and ``expansion`` for ``_mpc_solve``, on ``tensors``
        in place of :attr:`tensors`."""
        mapped, expansion = (traced.bind([tensors[i] for i in idx]) for traced, idx in zip(self.traces, self._index))
        return dict(mapped_cost=mapped, expansion=expansion)


def _move_program(ep, device: str) -> None:
    """Rewrite the device arguments and the tensor metadata of ``ep``'s
    graph (its submodules included) to ``device``, in place: the graph half
    of ``torch.export.passes.move_to_device_pass``, which moves the metadata
    through the device's runtime and so needs the card on the build host.
    The program holds no state to move."""
    target = torch.device(device)

    def move(v):
        if isinstance(v, FakeTensor) and v.device != target:
            meta = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
            return FakeTensor(v.fake_mode, meta, target)
        return v

    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if node.kwargs.get("device") is not None:
                node.kwargs = {**node.kwargs, "device": target}
            if node.op == "call_function" and node.target is torch.ops.aten.to.device:
                node.args = (node.args[0], target, *node.args[2:])
            if "val" in node.meta:
                node.meta["val"] = pytree.tree_map(move, node.meta["val"])
        gm.recompile()


def _pack(tensors: list) -> str:
    buf = io.BytesIO()
    torch.save([t.detach().cpu().contiguous() for t in tensors], buf)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _unpack(text: str) -> list:
    return torch.load(io.BytesIO(base64.b64decode(text)), weights_only=True)


def _scenario_rows(dx) -> tuple:
    """The leading batch shape of a model's per-scenario tensors, ``()``
    where they are shared over the batch."""
    if isinstance(dx, CtrlPassthroughDynamics):
        return _scenario_rows(dx.inner)
    if isinstance(dx, AffineDynamics):
        shapes = (dx.A.shape[:-2], dx.B.shape[:-2], () if dx.c is None else dx.c.shape[:-1])
        return next((tuple(s) for s in shapes if len(s)), ())
    return getattr(dx, "param_batch_shape", ())


def _batched_over_scenarios(cost, dx, bounds) -> list:
    """The names of a ``QuadCost``'s, the bounds' and a ``LinDx``'s tensors
    that hold a row per scenario (a batch axis, after the horizon, that is
    not 1). A callable cost is one sample's: shared by construction."""
    fields = [("u_lower", bounds[0], 3), ("u_upper", bounds[1], 3)]
    if isinstance(cost, QuadCost):
        fields += [("C", cost.C, 4), ("c", cost.c, 3)]
    if isinstance(dx, LinDx):
        fields += [("F", dx.F, 4), ("f", dx.f, 3)]
    return [name for name, t, ndim in fields
            if t is not None and torch.as_tensor(t).ndim == ndim and torch.as_tensor(t).shape[1] != 1]


def _model_device(*tensors) -> torch.device:
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def export_solve(
    config: MPCConfig,
    cost,
    dx,
    B: int,
    *,
    u_lower=None,
    u_upper=None,
    warm_start: bool = False,
    params_input: bool = False,
    vjp_order: int = 0,
    platforms: Optional[list] = None,
    mesh=None,
) -> bytes:
    """Serialize the solve program for batch size ``B`` to bytes.

    ``platforms`` is ``["cpu"]`` or ``["cuda"]``; the default is the
    device of the model's tensors (on the card unless the caller made them
    elsewhere). A program traced on one device and written for the other
    has its device arguments rewritten (:func:`_move_program`): a CPU build
    host writes the card's artifact.

    ``mesh``: a :class:`~diffmpc_tpu_torch.parallel.mesh.Mesh` — the program
    of one rank, at ``B / mesh.size`` scenarios, each rank calling it on its
    shard. A model with per-scenario tensors needs ``params_input=True``,
    each rank passing its own rows (the example's rows are the first
    ``B / mesh.size``); the cost, the bounds and a ``LinDx`` must be shared
    over the batch. Either raises ``ValueError`` otherwise: every rank's
    program carries the same baked tensors. The
    manifest records the world size and the form the solve takes at the
    rank's batch by the real dispatch (``mpc._would_use_fused``): ``fused``
    (one fused kernel launch a call) or ``loop`` (the non-fused loop);
    :func:`load_solve` makes ``info.n_iters`` the max over the ranks. A
    ``B`` that the ranks do not divide raises.

    ``cost`` is a ``QuadCost`` or a callable ``cost(tau)`` on one ``(n+m,)``
    sample, as :func:`~diffmpc_tpu_torch.mpc.mpc_solve` takes it. A callable
    is traced here (:class:`_CallableCost`), mapped over samples and as its
    quadraticization, at the program's ``T * B / mesh.size`` samples and the
    line search's ``max_linesearch_iter`` times as many; the tensors it
    closes over are baked as a ``QuadCost``'s are. A cost that cannot be traced raises ``RuntimeError``
    naming it. ``verbose > 0`` raises ``ValueError``: the program does not
    print (the JAX package's export refuses it too, its host callback
    having no serialization).
    """
    if vjp_order not in (0, 1):
        raise ValueError(f"vjp_order must be 0 or 1; got {vjp_order}")
    if config.verbose > 0:
        raise ValueError("export_solve needs verbose <= 0: an exported program does not print")
    if not spec.has_codec(dx):
        raise ValueError(f"export_solve: no codec for {type(dx).__name__} (models/spec.py CLASSES)")
    name, statics, model_tensors, paths = spec.encode_with_paths(dx)
    if params_input and not (isinstance(dx, Dynamics) and model_tensors):
        raise ValueError(f"params_input=True requires a dynamics model with tensors; {type(dx).__name__} has none")
    is_quad = isinstance(cost, QuadCost)
    device = _model_device(*model_tensors, *(cost if is_quad else ()))
    target = str(platforms[0]).lower() if platforms else device.type
    if len(platforms or [target]) != 1 or target not in PLATFORMS:
        raise ValueError(f"platforms must be ['cpu'] or ['cuda']; got {platforms}")
    world = 1 if mesh is None else mesh.size
    if B % world:
        raise ValueError(f"the mesh's {world} ranks must evenly divide B={B}: each rank's program solves B / {world} "
                         "scenarios, and there is no replicated form to fall back to")
    B_local = B // world
    if mesh is not None:
        # every rank's program carries the same baked tensors: a row per
        # scenario there would give each rank rows that are not its own
        if batched := _batched_over_scenarios(cost, dx, (u_lower, u_upper)):
            raise ValueError(f"under mesh= the cost, the bounds and a LinDx must be shared over the batch: "
                             f"{', '.join(batched)} hold a row per scenario, which the ranks' programs cannot split")
        if _scenario_rows(dx) and not params_input:
            raise ValueError(f"under mesh= a {type(dx).__name__} with per-scenario tensors needs params_input=True, "
                             "each rank passing its own rows: every rank's program carries the same baked tensors")
    per_scenario = _scenario_rows(dx) == (B,)

    def local(t):  # a per-scenario model's rows of one rank
        return t[:B_local] if per_scenario and t.ndim >= 2 and t.shape[0] == B else t

    model_tensors = [local(t).detach() for t in model_tensors]
    T, n, m = config.T, config.n_state, config.n_ctrl
    if is_quad:
        held, cost_tensors = None, [torch.as_tensor(a).detach() for a in cost]
        dtype = cost_tensors[0].dtype
    else:
        dtype = next((t.dtype for t in model_tensors if t.is_floating_point()), torch.get_default_dtype())
        held = _CallableCost(config, cost, T * B_local, dtype, device)
        cost_tensors = [t.detach() for t in held.tensors]
    bounds = (u_lower is not None, u_upper is not None)
    baked = cost_tensors + ([] if params_input else model_tensors)
    baked += [torch.as_tensor(b, dtype=dtype).detach() for b in (u_lower, u_upper) if b is not None]
    kw = dict(dtype=dtype, device=device)
    example = [torch.zeros((B_local, n), **kw)]
    if warm_start:
        example.append(torch.zeros((T, B_local, m), **kw))
    if params_input:
        example.append(model_tensors)
    example.append([t.to(device) for t in baked])
    program = _SolveProgram(config, held, (name, statics), len(model_tensors), bounds, warm_start, params_input,
                            attach=vjp_order == 1 and config.backprop)
    # forward-only: traced without grad, so no grad-mode change is recorded
    with torch.no_grad() if vjp_order == 0 else contextlib.nullcontext():
        ep = torch.export.export(program, tuple(example), strict=False)
    if ep.state_dict or ep.constants:
        raise RuntimeError(f"the exported program holds state ({list(ep.state_dict)} {list(ep.constants)}); every "
                           "tensor must be an input")
    if target != device.type:
        _move_program(ep, target)
    ep.example_inputs = None  # the baked tensors are written once, beside the program
    payload = io.BytesIO()
    torch.export.save(ep, payload, extra_files={_BAKED: _pack(baked)})

    input_names = ["x_init"] + ["u_init"] * warm_start + ["params"] * params_input
    inputs = [_aval("x_init", example[0])]
    if warm_start:
        inputs.append(_aval("u_init", example[1]))
    if params_input:
        leaves = [_aval("params" if p == "params" else f"params.{p}", t) for p, t in zip(paths, model_tensors)]
        inputs.append({"name": "params", "leaves": leaves})
    config_dict = _config_json(config)
    form = _would_use_fused(config, dx, is_quad=is_quad, constrained=u_lower is not None, is_lin=isinstance(dx, LinDx))
    manifest = {
        "format_version": _FORMAT_VERSION,
        "library": LIBRARY,
        "torch_version": torch.__version__,
        "inputs": inputs,
        "input_names": input_names,
        "config": config_dict,
        "config_digest": hashlib.sha256(json.dumps(config_dict, sort_keys=True).encode()).hexdigest(),
        "bounds": {"u_lower": _bound_json(u_lower), "u_upper": _bound_json(u_upper)},
        "batch_size": B,
        "platforms": [target],
        "vjp_order": vjp_order,
        "mesh": None if mesh is None else {
            "axis_names": [mesh.axis], "shape": [world], "local_batch": B_local,
            "form": "fused" if form else "loop",
        },
        "dynamics": type(dx).__name__,
    }
    mbytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack(">I", len(mbytes)) + mbytes + payload.getvalue()


def read_manifest(blob: bytes) -> Optional[dict]:
    """Parse an artifact's manifest without loading the program: the
    fleet-side check of input names, config digest, platforms and mesh
    before a blob goes to a worker. Reads the artifacts of this package and
    of the JAX package (one container). Returns None for a raw payload
    without a manifest; raises ``ValueError`` on a truncated header, a
    manifest without an integer ``format_version`` or one newer than this
    package reads."""
    if not blob.startswith(_MAGIC):
        return None
    hdr = len(_MAGIC) + 4
    if len(blob) < hdr:
        raise ValueError(f"corrupt/truncated artifact: {len(blob)} bytes is shorter than the manifest header")
    (mlen,) = struct.unpack(">I", blob[len(_MAGIC):hdr])
    if len(blob) < hdr + mlen:
        raise ValueError(f"corrupt/truncated artifact: manifest declares {mlen} bytes but only {len(blob) - hdr} "
                         "follow the header")
    manifest = json.loads(blob[hdr:hdr + mlen])
    version = manifest.get("format_version") if isinstance(manifest, dict) else None
    if not isinstance(version, int) or isinstance(version, bool):
        raise ValueError(f"artifact manifest has no integer format_version (got {version!r})")
    if version > _FORMAT_VERSION:
        raise ValueError(f"artifact manifest format_version {version} is newer than this library supports "
                         f"({_FORMAT_VERSION}); upgrade {LIBRARY} to load it")
    return manifest


def _program_device(ep) -> torch.device:
    for node in ep.graph.nodes:
        if node.op == "placeholder" and isinstance(node.meta.get("val"), torch.Tensor):
            return node.meta["val"].device
    return torch.device("cpu")


def load_solve(blob: bytes):
    """Load an :func:`export_solve` artifact as a callable.

    The callable takes the positional runtime inputs chosen at export time
    and returns the :class:`~diffmpc_tpu_torch.mpc.MPCSolution`; with
    ``vjp_order=1`` it is differentiable in ``x_init`` and ``params``. It
    carries ``.exported`` (the ``torch.export.ExportedProgram``) and
    ``.manifest`` (None for a raw payload); a call with the wrong number of
    inputs raises ``TypeError`` naming the expected ones. An artifact of the
    JAX package raises ``ValueError``. An artifact exported with ``mesh=``
    needs a process group of the recorded size and makes ``info.n_iters``
    the max over the ranks (one ``all_reduce``)."""
    manifest = read_manifest(blob)
    payload = blob
    if manifest is not None:
        if manifest.get("library") != LIBRARY:
            raise ValueError(f"the artifact was written by {manifest.get('library')!r}, not {LIBRARY}: load it "
                             "with that library's load_solve")
        payload = blob[len(_MAGIC) + 4 + struct.unpack(">I", blob[len(_MAGIC):len(_MAGIC) + 4])[0]:]
    extra = {_BAKED: ""}
    ep = torch.export.load(io.BytesIO(payload), extra_files=extra)
    device = torch.device(manifest["platforms"][0]) if manifest is not None else _program_device(ep)
    baked = [t.to(device) for t in _unpack(extra[_BAKED])]
    module = ep.module()
    names = None if manifest is None else manifest["input_names"]
    forward_only = manifest is not None and manifest["vjp_order"] == 0
    world = None if manifest is None or manifest["mesh"] is None else manifest["mesh"]["shape"][0]

    def call(*args):
        if names is not None and len(args) != len(names):
            missing = names[len(args):]
            raise TypeError(f"artifact expects {len(names)} positional input(s) ({', '.join(names)}), got "
                            f"{len(args)}" + (f" — missing: {', '.join(missing)}" if missing else ""))
        args = list(args)
        if names is not None and "params" in names and isinstance(args[-1], torch.Tensor):
            args[-1] = [args[-1]]
        if world is not None and (not dist.is_initialized() or dist.get_world_size() != world):
            raise ValueError(f"the artifact is one rank's program of a {world}-rank mesh; the process group has "
                             f"{dist.get_world_size() if dist.is_initialized() else 0} rank(s)")
        with torch.no_grad() if forward_only else contextlib.nullcontext():
            out = module(*args, baked)
        sol = MPCSolution(out[0], out[1], out[2], MPCInfo(*out[3:]))
        if world is not None:
            n_iters = sol.info.n_iters.clone()
            dist.all_reduce(n_iters, op=dist.ReduceOp.MAX)
            sol = sol._replace(info=sol.info._replace(n_iters=n_iters))
        return sol

    call.exported = ep
    call.manifest = manifest
    return call
