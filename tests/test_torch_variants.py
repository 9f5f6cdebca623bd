"""The kernels built at first use (``csrc/build.py``'s variants), on the CPU.

There is no nvcc here: the tests stand in for it. A stand-in compile records
each command and writes its output file, and a stand-in loader hands back
a library whose every symbol is a recorded launcher. So they show what the
card would build and launch: which shapes, MLPs and flags resolve to a
variant (``ops/cuda/ilqr.py``: ``kernel_symbol``, ``env_variant_key``), the
``-D`` macros of each translation unit, the key's hash, the rename-atomic
build and its errors, and that every wrapper of every family reaches the
variant's launcher instead of raising.
"""

import ctypes
import os
import shutil
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from diffmpc_tpu_torch import MPCConfig  # noqa: E402
from diffmpc_tpu_torch.csrc import build  # noqa: E402
from diffmpc_tpu_torch.csrc.build import ENUM_DEFAULT, ENUM_LOOP, ENUM_THREE, VariantKey  # noqa: E402
from diffmpc_tpu_torch.models import (  # noqa: E402
    AcrobotDx,
    CartpoleDx,
    NNDynamics,
    PendulumDx,
    QuadrotorDx,
    VehicleDx,
)
from diffmpc_tpu_torch.ops.cuda import ilqr as il  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt as kkt_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt_stream as kkt_stream_mod  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import riccati as ric  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import rollout as rol  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import rollout_stream as ros  # noqa: E402

# the linear shapes the zoo's envs need, and the slice's
SHAPES = [(2, 1), (5, 1), (6, 2), (6, 3)]


class FakeFn:
    """A library symbol: records its calls and returns 0 (cudaSuccess)."""

    def __init__(self, name):
        self.__name__ = name
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class FakeLib:
    def __init__(self, path):
        self.path = path
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, FakeFn(name))


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Variants built into ``tmp_path`` by a stand-in compile that records
    each command, loaded by a stand-in loader; the prebuilt library is a
    stand-in too. Yields the list of commands."""
    cmds = []

    def run_each(batch, workers=0):
        for cmd in batch:
            cmds.append(cmd)
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("object")
        return ["" for _ in batch], [0.0 for _ in batch]

    def link(nvcc, objs, so):
        assert all(os.path.exists(o) for o in objs)
        with open(so, "w") as f:
            f.write("library")
        return ""

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_run_each", run_each)
    monkeypatch.setattr(build, "_link", link)
    monkeypatch.setattr(build, "_dlopen", FakeLib)
    monkeypatch.setattr(build, "load", lambda: FakeLib("prebuilt"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=7))
    build.load_variant.cache_clear()
    yield cmds
    build.load_variant.cache_clear()


def defines(cmd):
    return {a for a in cmd if a.startswith("-D")}


# ---------------------------------------------------------------------------
# What resolves to a variant, and its translation units.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("kind", ["riccati", "riccati_stream", "rollout", "rollout_stream", "kkt_backward",
                                  "kkt_backward_stream", "riccati_blocked"])
def test_shapes_outside_the_table_resolve_to_their_variant(fake_build, kind, n, m):
    """``kernel_symbol`` at a shape outside the prebuilt table builds the
    family's variant (one nvcc per lane count and one for the launchers,
    each with the shape's macros) and returns its ``diffmpc_<kind>_variant``,
    where it used to raise ``NotImplementedError``."""
    family = il._KIND_FAMILY[kind][0]
    key = il.kernel_variant_key(kind, n, m)
    assert key == VariantKey(family, n, m)
    fn = il.kernel_symbol(kind, n, m, [ctypes.c_void_p])
    assert fn.__name__ == f"diffmpc_{kind}_variant" and fn.restype is ctypes.c_int
    source, lanes = build.VARIANT_SOURCES[family]
    assert len(fake_build) == len(lanes) + 1
    for cmd, L in zip(fake_build, (*lanes, 0)):
        assert cmd[-1] == os.path.join(build.VARIANTS, source)
        assert {f"-DDMPC_N={n}", f"-DDMPC_M={m}", "-DDMPC_ENUM=0", "-DDMPC_EXACT=0",
                f"-DDMPC_VARIANT_L={L}"} == defines(cmd)
        assert ("-fmad=false" in cmd) == (family in ("riccati", "kkt"))
        assert cmd[1 : 1 + len(build.NVCC_FLAGS)] == list(build.NVCC_FLAGS)
    # built once: a second lookup loads the same library
    il.kernel_symbol(kind, n, m, [ctypes.c_void_p])
    assert len(fake_build) == len(lanes) + 1


@pytest.mark.parametrize("kind", ["riccati", "rollout", "kkt_backward", "riccati_blocked"])
@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_table_shapes_keep_the_prebuilt_library(fake_build, kind, n, m):
    """The table's shapes at the default flags take the prebuilt launchers
    and build nothing: the existing paths pay no nvcc time."""
    assert il.kernel_variant_key(kind, n, m) is None
    assert il.kernel_symbol(kind, n, m, [ctypes.c_void_p]).__name__ == f"diffmpc_{kind}_n{n}m{m}"
    assert fake_build == []


def test_flags_resolve_to_variants_only_where_they_change_the_kernel(fake_build):
    """The enumeration flag reaches the Riccati kernels only, the value
    update's form the KKT kernels only; a mode that leaves the QP as it is
    keeps the default's kernel (ops/cuda/riccati_entries.py, pnqp_enum_flag)."""
    assert il.kernel_variant_key("riccati", 4, 2, enum=ENUM_LOOP) == VariantKey("riccati", 4, 2, enum=ENUM_LOOP)
    assert il.kernel_variant_key("rollout", 4, 2, enum=ENUM_LOOP) is None
    assert il.kernel_variant_key("kkt_backward", 3, 1, exact=True) == VariantKey("kkt", 3, 1, exact=True)
    assert il.kernel_variant_key("riccati", 3, 1, exact=True) is None
    launch = ric._cuda_launcher(torch.device("cpu"), 4, 2, pnqp_enum="0")
    assert {"-DDMPC_ENUM=1"} <= defines(fake_build[0])
    fake_build.clear()
    ric._cuda_launcher(torch.device("cpu"), 4, 2, pnqp_enum="1")  # m = 2 enumerates under "1" too
    ric._cuda_launcher(torch.device("cpu"), 3, 1, pnqp_enum="0")  # m = 1's closed form under every mode
    assert fake_build == []
    rs._stream_launcher(torch.device("cpu"), 6, 3, pnqp_enum="1")
    assert {"-DDMPC_N=6", "-DDMPC_M=3", "-DDMPC_ENUM=2"} <= defines(fake_build[0])
    fake_build.clear()
    kkt_stream_mod._stream_launcher(torch.device("cpu"), 3, 1, exact=True)
    assert defines(fake_build[0]) >= {"-DDMPC_EXACT=1", "-DDMPC_N=3", "-DDMPC_M=1"}
    assert callable(launch)


# ---------------------------------------------------------------------------
# MLPs and the fused solve.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,hidden", [(6, 3, (16, 16)), (3, 1, (32,)), (2, 1, (4, 4, 4)), (5, 2, (7,))])
def test_fusable_mlps_resolve_to_their_variant(fake_build, n, m, hidden):
    """Any MLP the fusable gate takes reaches a kernel: ``kernel_env`` gives
    its env (no raise), and the fused solve's and the line search's
    launchers take the variant's ``diffmpc_*_variant`` symbols, built with
    the widths as ``DMPC_HIDDEN``."""
    nn = NNDynamics.init(n, m, hidden=hidden, residual=True, device="cpu")
    assert nn.kernel_fusable
    env = il.kernel_env(nn)
    assert env.symbol is None and env.kind == "nn" and env.hidden == hidden
    widths = "-DDMPC_HIDDEN=\"{}\"".format("x".join(map(str, hidden)))
    for hoist in (False, True):
        launch = il._cuda_launcher(torch.device("cpu"), env, hoist)
        assert callable(launch)
    assert len(fake_build) == len(build.VARIANT_SOURCES["ilqr"][1]) + 1
    assert all(widths in defines(cmd) and f"-DDMPC_N={n}" in defines(cmd) for cmd in fake_build)
    fake_build.clear()
    rol._cuda_launcher(torch.device("cpu"), n, m, nn)
    ros._stream_launcher(torch.device("cpu"), n, m, nn)
    assert len(fake_build) == len(build.VARIANT_SOURCES["rollout"][1]) + 1
    assert all(cmd[-1].endswith(os.path.join("variants", "rollout.cu")) and widths in cmd for cmd in fake_build)


@pytest.mark.parametrize("n,m", [(4, 2), (6, 3)])
def test_blocked_max_blocks_resolves_beside_its_launcher(fake_build, n, m):
    """The blocked kernel's longest-horizon query lives in its launcher's
    library: the prebuilt one at the table's shapes
    (``diffmpc_riccati_blocked_max_blocks_n<n>m<m>``), else the variant's
    (``..._variant``), built once for both."""
    query = il.kernel_symbol("riccati_blocked_max_blocks", n, m, [ctypes.c_int, ctypes.c_void_p])
    launch = il.kernel_symbol("riccati_blocked", n, m, [ctypes.c_void_p])
    if (n, m) in il.KERNEL_SHAPES:
        assert query.__name__ == f"diffmpc_riccati_blocked_max_blocks_n{n}m{m}" and fake_build == []
    else:
        assert query.__name__ == "diffmpc_riccati_blocked_max_blocks_variant"
        assert launch.__name__ == "diffmpc_riccati_blocked_variant"
        assert len(fake_build) == len(build.VARIANT_SOURCES["riccati_blocked"][1]) + 1


def test_a_diagnostic_build_takes_the_main_flags_and_its_defines(fake_build, tmp_path):
    """``build_with`` (the diagnostics' profile and parent builds): one nvcc
    a source with NVCC_FLAGS, a source of this checkout with its own flags
    (the Riccati sweep's ``-fmad=false``), another checkout's without, each
    define as ``-D`` and the source's directory as ``-I``; linked into
    ``out_dir/lib<label>.so`` and loaded."""
    other = tmp_path / "other"
    other.mkdir()
    (other / "riccati.cu").write_text("")
    srcs = [os.path.join(build.CSRC, "riccati.cu"), os.path.join(build.CSRC, "riccati_blocked.cu"),
            str(other / "riccati.cu")]
    lib = build.build_with(srcs, str(tmp_path), ("DMPC_BLOCKED_PROFILE=1",), "probe")
    assert lib.path == str(tmp_path / "libprobe.so") and os.path.exists(lib.path)
    assert len(fake_build) == 3
    for cmd, src, own_flags in zip(fake_build, srcs, (True, False, False)):
        assert cmd[0] == "nvcc" and cmd[-1] == src
        assert cmd[1 : 1 + len(build.NVCC_FLAGS)] == list(build.NVCC_FLAGS)
        assert ("-fmad=false" in cmd) == own_flags
        assert defines(cmd) == {"-DDMPC_BLOCKED_PROFILE=1"}
        assert cmd[cmd.index("-I") + 1] == os.path.dirname(src)


def test_fused_launcher_symbols(fake_build):
    """The prebuilt MLPs and the pendulum keep their launchers at the
    default flags; a flag makes a variant of the same env, naming the
    pendulum's C++ step (DMPC_ENV, DMPC_ENV_HEADER); an MLP past the fusable
    gate raises."""
    pend = il.kernel_env(PendulumDx.default(device="cpu"))
    nn8 = il.kernel_env(NNDynamics.init(3, 1, hidden=(8,), device="cpu"))
    assert il.env_variant_key(pend, "ilqr") is None and il.env_variant_key(nn8, "ilqr") is None
    assert il.env_variant_key(nn8, "ilqr", ENUM_DEFAULT, True) == VariantKey("ilqr", 3, 1, "nn", (8,), exact=True)
    assert il.env_variant_key(pend, "ilqr", exact=True) == VariantKey("ilqr", 3, 1, "pendulum", exact=True)
    il._cuda_launcher(torch.device("cpu"), pend, False)
    assert fake_build == []
    il._cuda_launcher(torch.device("cpu"), pend, False, exact=True)
    assert {"-DDMPC_ENV=PendulumEnv", '-DDMPC_ENV_HEADER="pendulum.cuh"', "-DDMPC_EXACT=1"} <= defines(fake_build[0])
    fake_build.clear()
    nn63 = il.kernel_env(NNDynamics.init(6, 3, hidden=(16, 16), device="cpu"))
    il._cuda_launcher(torch.device("cpu"), nn63, True, pnqp_enum="1")
    assert all("-DDMPC_ENUM=2" in cmd for cmd in fake_build)
    big = NNDynamics.init(3, 1, hidden=(64, 64), device="cpu")
    assert not big.kernel_fusable
    with pytest.raises(ValueError, match="kernel-fusable"):
        il.kernel_env(big)


def test_the_fused_wrapper_takes_the_variant_on_the_card_path(fake_build, monkeypatch):
    """``ilqr_solve_fused`` on the card path (its device check, lane rule and
    stream stood in for) launches the (6, 3) MLP's variant with the
    args' ``pnqp_iter`` and the flags of its keywords."""
    nn = NNDynamics.init(6, 3, hidden=(16, 16), residual=True, device="cpu")
    T, B = 4, 5
    launched = []
    monkeypatch.setattr(il, "resolve_use_cuda", lambda use_cuda, device: True)
    monkeypatch.setattr(il, "_sm_count", lambda index: 132)

    class Dev:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "device", Dev)
    real = il.run_staged_f32

    def spy(launch, *args, **knobs):
        launched.append(knobs)
        return real(lambda a, e: None, *args, **knobs)

    monkeypatch.setattr(il, "run_staged_f32", spy)
    C = torch.eye(9).expand(T, B, 9, 9)
    box = torch.full((T, B, 3), 0.5)
    il.ilqr_solve_fused(torch.zeros(B, 6), C, torch.zeros(T, B, 9), nn, -box, box, pnqp_iter=5, pnqp_enum="1",
                        lqr_iter=1)
    assert launched[0]["pnqp_iter"] == 5
    assert {"-DDMPC_ENUM=2", "-DDMPC_EXACT=0", '-DDMPC_HIDDEN="16x16"'} <= defines(fake_build[0])


# ---------------------------------------------------------------------------
# The build itself: the hash, the rename, the errors.
# ---------------------------------------------------------------------------


def test_variant_hash_changes_with_a_source_a_flag_or_the_key(tmp_path, monkeypatch):
    key = VariantKey("ilqr", 6, 3, "nn", (16, 16), ENUM_THREE)
    base = build.variant_path(key)
    assert os.path.basename(base).startswith("libdiffmpc_ilqr_n6m3_nn_h16x16_e2_x0-")
    others = [key._replace(enum=ENUM_DEFAULT), key._replace(exact=True), key._replace(hidden=(16, 8)),
              key._replace(n=5), key._replace(family="rollout")]
    paths = {build.variant_path(k) for k in others}
    assert len(paths) == len(others) and base not in paths
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.variant_path(key) != base
    monkeypatch.undo()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(build, "CSRC", str(copy))
    monkeypatch.setattr(build, "VARIANTS", str(copy / "variants"))
    same = build.variant_path(key)
    for edited in (copy / "variants" / "ilqr.cu", copy / "riccati_entries.cuh"):
        with open(edited, "a") as f:
            f.write("\n// an edit\n")
        changed = build.variant_path(key)
        assert changed != same
        same = changed


def test_variant_build_is_rename_atomic_and_reports_nvcc_errors(tmp_path, monkeypatch):
    """A stand-in nvcc: a failed compile raises with its output and leaves
    no library; a good one links each key's objects into its own library,
    renamed into place, once, also when two threads race it; the
    per-unit seconds come back by key."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        'if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: bad variant" >&2; exit 2; fi\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi; shift; done\n'
    )
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    keys = [VariantKey("riccati", 6, 3, enum=ENUM_THREE), VariantKey("kkt", 6, 3)]
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="bad variant"):
        build.build_variants(keys)
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".so")]
    monkeypatch.delenv("FAKE_NVCC_FAIL")
    errors = []

    def race():
        try:
            build.build_variants(keys)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=race) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    libs = sorted(p for p in os.listdir(tmp_path / "out") if p.endswith(".so"))
    assert libs == sorted(os.path.basename(build.variant_path(k)) for k in keys)
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".tmp")]
    seconds = {}
    assert all(log == "" for _, log in build.build_variants(keys, seconds).values()) and seconds == {}
    fresh = VariantKey("rollout", 5, 1)
    out = build.build_variants([fresh], seconds)
    assert out[fresh][0] == build.variant_path(fresh) and os.path.exists(out[fresh][0])
    assert set(seconds[fresh.name]) == {"L=1", "L=2", "L=4", "L=16", "L=0", "link"}


def test_variant_sources_and_lane_lists():
    """Every family's source is in csrc/variants/, outside the main
    library's glob; its lane counts are the wrappers' lists and the
    launchers' macros (DMPC_LANES, DMPC_RICCATI_LANES, DMPC_KKT_LANES)."""
    assert all(os.path.dirname(s) == build.CSRC for s in build.sources())
    for source, _ in build.VARIANT_SOURCES.values():
        assert os.path.exists(os.path.join(build.VARIANTS, source))
    assert build.VARIANT_SOURCES["ilqr"][1] == il.ILQR_LANES
    assert build.VARIANT_SOURCES["rollout"][1] == rol.ROLLOUT_LANES
    assert build.VARIANT_SOURCES["riccati"][1] == ric.RICCATI_LANES
    assert build.VARIANT_SOURCES["kkt"][1] == kkt_mod.KKT_LANES
    with pytest.raises(ValueError, match="family"):
        build.variant_defines(VariantKey("pieces", 3, 1))


# ---------------------------------------------------------------------------
# The two config fields reach every family.
# ---------------------------------------------------------------------------


def test_config_fields_reach_every_family(monkeypatch):
    """``MPCConfig.pnqp_enum`` and ``value_update_exact_reg`` reach the
    fused solve, the non-fused loop's Riccati sweep and the KKT backward of
    both paths (the keywords each family takes); the defaults stay those of
    the JAX package."""
    from diffmpc_tpu_torch import LinDx, QuadCost, mpc_solve
    from diffmpc_tpu_torch import mpc as mpc_mod
    from diffmpc_tpu_torch.ops import lqr as lqr_mod
    from diffmpc_tpu_torch.ops import library as op_mod

    seen = []

    def recorder(name, fn):
        def call(*a, **kw):
            seen.append((name, kw.get("pnqp_enum"), kw.get("value_update_exact_reg")))
            return fn(*a, **kw)

        return call

    monkeypatch.setattr(mpc_mod, "ilqr_solve_fused", recorder("ilqr", il.ilqr_solve_fused))
    monkeypatch.setattr(lqr_mod, "riccati_backward_plain", recorder("riccati", ric.riccati_backward_plain))
    monkeypatch.setattr(op_mod, "kkt_backward_fused", recorder("kkt", kkt_mod.kkt_backward_fused))
    default = MPCConfig(n_state=3, n_ctrl=1, T=4)
    assert (default.pnqp_enum, default.value_update_exact_reg) == ("", -1.0)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(3, 3, generator=gen, requires_grad=True)
    knobs = dict(pnqp_enum="1", value_update_exact_reg=1e-6, lqr_iter=2, exit_unconverged=False,
                 detach_unconverged=False)
    pend = PendulumDx.default(device="cpu")
    q, p = pend.get_true_obj()
    sol = mpc_solve(MPCConfig(n_state=3, n_ctrl=1, T=4, **knobs), x0, QuadCost(torch.diag(q), p), pend,
                    u_lower=-2.0, u_upper=2.0)
    sol.us.sum().backward()
    F = torch.randn(4, 3, 3, 5, generator=gen) * 0.3
    lin = mpc_solve(MPCConfig(n_state=3, n_ctrl=2, T=4, **knobs), x0, QuadCost(torch.eye(5), torch.zeros(5)),
                    LinDx(F, torch.zeros(4, 3)), u_lower=-0.5, u_upper=0.5)
    lin.us.sum().backward()
    assert {("ilqr", "1", 1e-6), ("riccati", "1", 1e-6), ("kkt", None, 1e-6)} <= set(seen)
    assert all(s[2] == 1e-6 for s in seen)


# ---------------------------------------------------------------------------
# The dynamics zoo: each env's C++ step as a variant.
# ---------------------------------------------------------------------------

ZOO = [(CartpoleDx, "cartpole", "CartpoleEnv", 5, 1), (VehicleDx, "vehicle", "VehicleEnv", 4, 2),
       (QuadrotorDx, "quadrotor", "QuadrotorEnv", 6, 2), (AcrobotDx, "acrobot", "AcrobotEnv", 6, 1)]


@pytest.mark.parametrize("cls,name,struct,n,m", ZOO, ids=[z[1] for z in ZOO])
def test_zoo_envs_resolve_to_their_variant(fake_build, cls, name, struct, n, m):
    """Each env of the zoo reaches its kernels through a variant of its own
    key (no prebuilt launcher): the fused solve's (with and without the
    pre-pass) and the line search's and its twin's launchers take the
    variant's ``diffmpc_*_variant`` symbols, every unit built from the env's
    struct and header (``DMPC_ENV``, ``DMPC_ENV_HEADER``) at its (n, m), and
    the launch passes the env's own struct."""
    dyn = cls.default(device="cpu")
    env = il.kernel_env(dyn)
    assert (env.symbol, env.kind, env.n, env.m, env.per_scenario) == (None, name, n, m, True)
    assert il.env_variant_key(env, "ilqr") == VariantKey("ilqr", n, m, name)
    assert il.env_variant_key(env, "rollout") == VariantKey("rollout", n, m, name)
    assert il.env_variant_key(env, "ilqr", ENUM_DEFAULT, True) == VariantKey("ilqr", n, m, name, exact=True)
    macros = {f"-DDMPC_ENV={struct}", f'-DDMPC_ENV_HEADER="{name}.cuh"', f"-DDMPC_N={n}", f"-DDMPC_M={m}"}
    for hoist in (False, True):
        assert callable(il._cuda_launcher(torch.device("cpu"), env, hoist))
    assert len(fake_build) == len(build.VARIANT_SOURCES["ilqr"][1]) + 1
    assert all(macros <= defines(cmd) and cmd[-1].endswith(os.path.join("variants", "ilqr.cu")) for cmd in fake_build)
    fake_build.clear()
    rol._cuda_launcher(torch.device("cpu"), n, m, dyn)
    ros._stream_launcher(torch.device("cpu"), n, m, dyn)
    assert len(fake_build) == len(build.VARIANT_SOURCES["rollout"][1]) + 1
    assert all(macros <= defines(cmd) and cmd[-1].endswith(os.path.join("variants", "rollout.cu")) for cmd in fake_build)
    assert type(env.struct).__name__ == f"_{struct}"
    assert [getattr(env.struct, f) for f, _ in env.struct._fields_] == pytest.approx(
        [float(getattr(dyn, f)) for f, _ in env.struct._fields_])


def test_zoo_linear_shapes_and_the_acrobots_kkt_resolve_to_their_variant(fake_build):
    """The Riccati sweep, the line search's linear kernel and the KKT
    backward at the zoo's shapes other than the prebuilt (4, 2) are
    variants, the KKT pair at the acrobot's (6, 1) among them; (4, 2), the
    vehicle's, keeps its prebuilt launchers."""
    for n, m in ((5, 1), (6, 2), (6, 1)):
        for kind in ("riccati", "riccati_stream", "kkt_backward", "kkt_backward_stream", "rollout"):
            family = il._KIND_FAMILY[kind][0]
            assert il.kernel_variant_key(kind, n, m) == VariantKey(family, n, m)
        kkt_mod._cuda_launcher(torch.device("cpu"), n, m)
        kkt_stream_mod._stream_launcher(torch.device("cpu"), n, m)
    assert any(defines(cmd) >= {"-DDMPC_N=6", "-DDMPC_M=1"} for cmd in fake_build)
    assert all(cmd[-1].endswith(os.path.join("variants", "kkt.cu")) for cmd in fake_build)
    for kind in ("riccati", "kkt_backward", "rollout"):
        assert il.kernel_variant_key(kind, 4, 2) is None


def test_a_variant_key_names_a_known_env():
    """A key whose env has no C++ step raises before any nvcc starts."""
    with pytest.raises(ValueError, match="no C\\+\\+ step for the env 'segway'"):
        build.variant_defines(VariantKey("ilqr", 4, 1, "segway"))
    assert set(build.CPP_ENVS) == {k for _, k, *_ in il._CPP_ENVS.values()}
