"""The port's data-parallel layer on two ranks: gloo on the CPU, a
``file://`` rendezvous, each rank a process of its own.

The ranks are spawned once for the whole file
(``diffmpc_tpu_torch.parallel.dryrun.spawn``, one intra-op thread each) and
run every case of tests/torch_dist_cases.py's ``rank_cases``; the tests
compare what they sent back.

- The training step in its four configurations (float64) against the port's
  single-process step: loss rtol 1e-12, gradient norm rtol 1e-10, params
  atol 1e-12, ``converged_frac`` exact (the standard of
  tests/test_multiprocess.py:125-135; the two halves' means against one
  mean differ only in summation order), the replicated params equal on both
  ranks; and against the JAX package's step on its 8-device mesh within the
  bounds of tests/test_torch_parallel.py.
- ``gather_results``, ``shard_batch``, ``replicate`` and
  ``host_local_to_global`` across the ranks, with their errors.
- ``riccati_backward_time_sharded`` at D=2 against the JAX package's at D=2
  on a ``"time"`` mesh and against the port's sequential sweep, on the
  shapes of tests/test_assoc_riccati.py:70, each rank given only its time
  slice, within 1e-9 in float64; the ``T % D`` error of sharding the
  horizon, and the mesh-axis error.
- The probe's plain version on each rank's shard, gathered; the dry run
  (``parallel/dryrun.py``) at a small size, held by its own ``check``, its
  sharded serving artifacts (shared params baked, per-scenario params an
  input) among its phases.
- The ``initialize`` contracts of tests/test_multiprocess.py:140-252, in
  this process.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from diffmpc_tpu.ops.assoc_riccati import riccati_backward_time_sharded as jax_time_sharded  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.riccati import riccati_backward_plain  # noqa: E402
from diffmpc_tpu_torch.ops.cuda.shard_probe import shard_probe_plain  # noqa: E402
from diffmpc_tpu_torch.parallel import distributed, dryrun, make_mesh  # noqa: E402
from oracles import random_lqr_problem  # noqa: E402
from torch_dist_cases import CONFIGS, inputs, port_step, rank_cases  # noqa: E402
from test_torch_parallel import assert_steps_match, jax_result  # noqa: E402

SHAPES = [(16, 3, 1), (64, 3, 2), (120, 2, 1)]  # tests/test_assoc_riccati.py:70
ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _problem(T, n, m):
    C, c, F, f, _ = random_lqr_problem(np.random.default_rng(500 + T), T, 4, n, m)
    return C, c, F, f, n


@pytest.fixture(scope="module")
def ranks():
    data = inputs()
    spec = dryrun.make_spec("cpu", B=32, T=6, lqr_iter=3, il_batch=16, il_steps=2)
    out = dryrun.spawn(2, rank_cases, data, [_problem(*s) for s in SHAPES], spec, device="cpu")
    return data, spec, out


@pytest.mark.parametrize("name", CONFIGS)
def test_dp_step_on_two_ranks_matches_one_process(ranks, name):
    data, _, out = ranks
    want = port_step(name, data)
    got = out[0]["steps"][name]
    assert_steps_match(got, want, 1e-12, 1e-12, 1e-10)
    assert got["converged_frac"] == want["converged_frac"]
    other = out[1]["steps"][name]
    for g, w in zip(jax.tree.leaves(other["params"]), jax.tree.leaves(got["params"])):
        np.testing.assert_array_equal(g, w)  # every rank holds the same params


@pytest.mark.parametrize("name", CONFIGS)
def test_dp_step_on_two_ranks_matches_jax_on_eight_devices(ranks, name):
    _, _, out = ranks
    assert_steps_match(out[0]["steps"][name], jax_result(name, True), 1e-9, 1e-7, 1e-6)


def test_gather_results_returns_the_batch_in_rank_order(ranks):
    data, _, out = ranks
    for rank in out:
        np.testing.assert_array_equal(rank["gather"]["x"], data["x"])
        np.testing.assert_array_equal(rank["gather"]["u"], data["u"])


def test_sharding_helpers_across_ranks(ranks):
    _, _, out = ranks
    for rank in out:
        assert "does not divide evenly" in rank["uneven_shard"]
        assert rank["host_local"] == (8, 3)
        assert "differ in shape" in rank["host_local_mismatch"]
        np.testing.assert_array_equal(rank["replicate"], np.ones(3))  # rank 0's


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=[f"T{T}n{n}m{m}" for T, n, m in SHAPES])
def test_time_sharded_riccati_on_two_ranks(ranks, i):
    _, _, out = ranks
    C, c, F, f, n = _problem(*SHAPES[i])
    K, k = out[0]["riccati"][i]
    mesh = jax.make_mesh((2,), ("time",), devices=jax.devices()[:2])
    want = jax.jit(lambda a, b, d, e: jax_time_sharded(mesh, a, b, d, e, n))(*map(jnp.asarray, (C, c, F, f)))
    np.testing.assert_allclose(K, np.asarray(want.K), atol=1e-9, rtol=0)
    np.testing.assert_allclose(k, np.asarray(want.k), atol=1e-9, rtol=0)
    serial = riccati_backward_plain(*(torch.tensor(a) for a in (C, c, F, f)), n)
    np.testing.assert_allclose(K, serial.K.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(k, serial.k.numpy(), atol=1e-9, rtol=0)


def test_time_sharded_riccati_errors(ranks):
    _, _, out = ranks
    assert "does not divide evenly over 2 ranks" in out[0]["riccati_uneven"]
    assert "'time'" in out[0]["riccati_wrong_axis"]


def test_probe_plain_on_each_rank_gathered(ranks):
    _, _, out = ranks
    x = torch.arange(16, dtype=torch.float32) ** 1.5
    want = torch.cat([shard_probe_plain(x[:8]), shard_probe_plain(x[8:])]).numpy()
    np.testing.assert_array_equal(out[0]["probe"], want)


def test_dryrun_on_two_cpu_ranks(ranks):
    _, spec, out = ranks
    report = dryrun.check([r["dryrun"] for r in out], dryrun.single_process(spec, "cpu"), spec)
    assert report["world"] == 2 and report["backend"] == "gloo" and report["probe_bit_equal"]
    assert report["solve_scenarios_bit_equal"] == report["scenarios"] == 32


def test_dryrun_sharded_artifact_on_two_cpu_ranks(ranks):
    """The dry run's sharded serving artifact: each rank's program (B / 2
    scenarios, the fused form) loaded on its rank, its objs and us bit-equal
    to the live solve of the shard, n_iters the max over the ranks."""
    _, spec, out = ranks
    report = dryrun.check([r["dryrun"] for r in out], dryrun.single_process(spec, "cpu"), spec)
    art = report["artifact"]
    assert art["form"] == ["fused", "fused"] and art["objs_bit_equal"] and art["us_bit_equal"]
    assert len(set(art["n_iters"])) == 1 and art["bytes"] > 0
    assert all(r["dryrun"]["artifact"]["n_iters"] >= r["dryrun"]["artifact"]["live_n_iters"] for r in out)


def test_dryrun_sharded_per_scenario_artifact_on_two_cpu_ranks(ranks):
    """The dry run's sharded artifact with the ensemble's per-scenario
    params as its input: each rank passes its own rows, and its objs and us
    are bit-equal to the live solve of its shard with those rows."""
    _, spec, out = ranks
    report = dryrun.check([r["dryrun"] for r in out], dryrun.single_process(spec, "cpu"), spec)
    art = report["artifact"]
    assert art["params_form"] == ["fused", "fused"]
    assert art["params_objs_bit_equal"] and art["params_us_bit_equal"]
    assert len(set(art["params_n_iters"])) == 1
    assert spec["params"].shape[0] == len(spec["x"]) and not np.array_equal(spec["params"][0], spec["params"][-1])


def test_initialize_explicit_args_raise_on_inconsistency(tmp_path):
    """Explicit arguments assert a topology: a partial or impossible one
    raises before any group is made."""
    url = f"file://{tmp_path}/store"
    for kw, match in (
        (dict(process_id=1), "missing"),
        (dict(num_processes=2), "missing"),
        (dict(coordinator_address=url, num_processes=2, process_id=5), "outside"),
        (dict(coordinator_address=url, num_processes=0, process_id=0), "positive"),
    ):
        with pytest.raises(ValueError, match=match):
            distributed.initialize(**kw, device="cpu")
    assert not dist.is_initialized()


def test_initialize_auto_path(monkeypatch):
    """Without torchrun's variables the auto path is a no-op returning 0;
    a partial or malformed set raises."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() == 0 and not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="partial"):
        distributed.initialize(device="cpu")
    for k, v in zip(ENV, ("x", "2", "127.0.0.1", "29500")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="malformed"):
        distributed.initialize(device="cpu")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize(device="cpu")
    assert not dist.is_initialized()


def test_initialize_needs_a_card_or_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


def test_initialize_reentry_is_idempotent(tmp_path, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    url = f"file://{tmp_path}/store"
    try:
        assert distributed.initialize(url, 1, 0, device="cpu") == 0
        assert distributed.initialize(url, 1, 0, device="cpu") == 0
        assert distributed.initialize() == 0
        assert dist.get_backend() == "gloo" and make_mesh().device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="exists"):
            distributed.initialize(url, 2, 1, device="cpu")
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_initialize_tcp_coordinator_address():
    """``host:port`` is a ``tcp://`` rendezvous (one rank on localhost)."""
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    except OSError:
        pytest.skip("localhost sockets unavailable: the tcp rendezvous needs a loopback listener")
    try:
        assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu") == 0
        assert dist.get_world_size() == 1
    finally:
        distributed.shutdown()
