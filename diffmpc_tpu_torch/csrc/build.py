"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` file is compiled, with the ``.cuh`` headers beside it,
by its own ``nvcc`` process, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.
The library goes to ``diffmpc_tpu_torch/_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so an edit rebuilds and a stale
library is never loaded. The build writes a temporary file of its own process
and thread and renames it into place, so parallel builds may race it safely.

A kernel that the library does not instantiate (a shape outside the port's
table, an MLP architecture outside ``nn_archs.cuh``, a flag other than the
default) is a *variant* (:class:`VariantKey`): its translation units are the
sources of ``csrc/variants/``, compiled from ``-D`` macros that name its key
(:func:`variant_defines`), one nvcc per lane count, and linked into a library
of its own beside the main one, built at the variant's first use
(:func:`load_variant`), keyed by a hash of the sources, the flags and the key,
and loaded once per process.

Nothing outside the repository is used but the CUDA toolkit: ``nvcc`` from
``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

CSRC = os.path.dirname(os.path.abspath(__file__))
VARIANTS = os.path.join(CSRC, "variants")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

# sm_90a: Hopper with its arch-specific features. No --use_fast_math: the env
# steps call sinf/cosf/sqrtf, whose fast forms would break parity.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


# The Riccati sweep's and the KKT backward's sources, and the fused solve's
# variants (whose sweep is the Riccati step's), are built without FMA
# contraction. Whether nvcc fuses a product into a sum depends on how many
# uses the product has in the surrounding code, which differs between one
# thread's step and a lane group's share of it; the kernels fuse by hand
# instead (riccati_mad in riccati_entries.cuh), where contraction fused the
# one-thread kernel, so that every lane count computes the same float32
# operations, bit for bit. The prebuilt fused solve (ilqr.cu, ilqr_nn*.cu)
# keeps its contraction and its sweep.
NO_CONTRACTION = ("-fmad=false",)


def source_flags(src: str) -> tuple:
    """The flags of ``src`` beyond NVCC_FLAGS."""
    name = os.path.basename(src)
    return NO_CONTRACTION if re.fullmatch(r"(riccati|kkt)(_stream|_l\d+)?\.cu", name) else ()


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NO_CONTRACTION).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libdiffmpc_kernels-{_source_hash()}.so")


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


def _run(cmds: list[list[str]]) -> tuple[str, list[float]]:
    """Run the commands in parallel; return their output and each one's
    seconds from the common start to its exit, or raise with the output of
    the first that failed."""
    logs, seconds = _run_each(cmds)
    return "".join(logs), seconds


def _run_each(cmds: list[list[str]], workers: int = 0) -> tuple[list[str], list[float]]:
    """:func:`_run`, with each command's output apart; at most ``workers``
    at once (0: all)."""
    t0 = time.perf_counter()

    def one(cmd):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=min(len(cmds), workers or len(cmds))) as pool:
        done = list(pool.map(one, cmds))
    for cmd, (proc, _) in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    return [proc.stdout for proc, _ in done], [s for _, s in done]


def _link(nvcc: str, objs: list[str], so: str) -> str:
    """Link ``objs`` into the shared library ``so`` through a temporary file
    of this process and thread, renamed into place; returns the linker's
    output."""
    tmp = f"{so}.{os.getpid()}-{threading.get_ident()}.tmp"
    try:
        log, _ = _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return log


def build(seconds: dict | None = None) -> tuple[str, str]:
    """Build the library if it is not built yet. Returns ``(path, log)``:
    ``log`` is nvcc's output (``-Xptxas -v`` register and spill report) for a
    fresh build, and ``""`` when the library was already there. A fresh
    build fills ``seconds``, where given, with each source's compile time
    (from the common start of the parallel compiles) and the link's."""
    so = library_path()
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    objdir = tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR)
    try:
        objs = [os.path.join(objdir, os.path.basename(src) + ".o") for src in sources()]
        log, compile_s = _run([[nvcc, *NVCC_FLAGS, *source_flags(src), "-I", CSRC, "-c", "-o", obj, src]
                               for obj, src in zip(objs, sources())])
        t0 = time.perf_counter()
        log += _link(nvcc, objs, so)
        if seconds is not None:
            seconds.update({os.path.basename(src): s for src, s in zip(sources(), compile_s)},
                           link=time.perf_counter() - t0)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return so, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    so, _ = build()
    return _dlopen(so)


def _dlopen(path: str) -> ctypes.CDLL:
    return ctypes.CDLL(path)


def build_with(srcs, out_dir: str, defines=(), label: str = "custom") -> ctypes.CDLL:
    """A library of ``srcs`` (paths, each with its headers beside it) for a
    diagnostic that needs another build than :func:`load`'s: one nvcc a
    source, all at once, with :data:`NVCC_FLAGS`, a source's own
    :func:`source_flags` where it is one of this checkout's, and ``-D`` for
    each of ``defines`` (``NAME`` or ``NAME=VALUE``); linked into
    ``out_dir/lib<label>.so`` and loaded. Raises with nvcc's output where a
    compile fails."""
    nvcc = find_nvcc()
    objs = [os.path.join(out_dir, f"{label}-{os.path.basename(src)}.o") for src in srcs]
    cmds = []
    for obj, src in zip(objs, srcs):
        where = os.path.dirname(os.path.abspath(src))
        own = os.path.realpath(where) == os.path.realpath(CSRC)
        cmds.append([nvcc, *NVCC_FLAGS, *(source_flags(src) if own else ()), *(f"-D{d}" for d in defines),
                     "-I", where, "-c", "-o", obj, src])
    _run(cmds)
    so = os.path.join(out_dir, f"lib{label}.so")
    _link(nvcc, objs, so)
    return _dlopen(so)


def unique_symbols(path: str) -> list[str]:
    """The GNU unique symbols (``nm -D --defined-only``, type ``u``) that
    the shared library ``path`` exports. Each is a function-local static of
    an inline function or template, bound to one object across every
    library of the process even under ``RTLD_LOCAL``, so that a second build
    loaded beside (:func:`build_with`, another checkout's) would share it:
    the port's libraries keep such caches in unnamed namespaces and export
    none."""
    out = subprocess.run(["nm", "-D", "--defined-only", path], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return [f[2] for f in (line.split() for line in out.splitlines()) if len(f) == 3 and f[1] == "u"]


# ---------------------------------------------------------------------------
# Variants: kernels built at first use.
# ---------------------------------------------------------------------------

# The box QP's enumeration modes as the kernels' template flag (PnqpEnum in
# riccati_entries.cuh): the default, the loop at m = 2 ("0"), the
# enumeration at m = 3 ("1").
ENUM_DEFAULT, ENUM_LOOP, ENUM_THREE = 0, 1, 2


# The envs with a C++ step of their own (csrc/<name>.cuh, struct
# <Name>Env): a fused-solve or line-search variant of one is built from
# -DDMPC_ENV=<Name>Env and -DDMPC_ENV_HEADER="<name>.cuh".
CPP_ENVS = ("pendulum", "cartpole", "vehicle", "quadrotor", "acrobot")


class VariantKey(NamedTuple):
    """A kernel variant: the family (``ilqr``, ``rollout``, ``riccati``,
    ``kkt``, ``riccati_blocked``), the shape ``(n, m)``, the env (``linear``,
    ``nn`` or one of :data:`CPP_ENVS`) with an MLP's hidden widths, the box QP's
    enumeration mode (``ENUM_*``: ``ilqr`` and ``riccati``), the value
    update's form (``exact``: ``ilqr`` and ``kkt``) and whether the env is
    wrapped in ``CtrlPassthroughEnv`` (``passthrough``: ``ilqr`` and
    ``rollout``; ``(n, m)`` is then the wrapped shape, the inner env's
    ``(n - m, m)``). The MLP's activation and ``residual`` are run-time
    fields of its env, not part of the key."""

    family: str
    n: int
    m: int
    env: str = "linear"
    hidden: tuple = ()
    enum: int = ENUM_DEFAULT
    exact: bool = False
    passthrough: bool = False

    @property
    def name(self) -> str:
        parts = [self.family, f"n{self.n}m{self.m}", self.env]
        if self.hidden:
            parts.append("h" + "x".join(map(str, self.hidden)))
        parts += [f"e{self.enum}", f"x{int(self.exact)}"]
        return "_".join(parts + (["p1"] if self.passthrough else []))


# Each family's source in csrc/variants/ and the lane counts it is built for,
# one nvcc each, beside the unit of its launchers (lane count 0): the
# prebuilt kernels' DMPC_LANES, DMPC_RICCATI_LANES and DMPC_KKT_LANES (the
# tests hold them equal), none for the kernels of one thread a scenario.
VARIANT_SOURCES = {
    "ilqr": ("ilqr.cu", (1, 2, 4, 16)),
    "rollout": ("rollout.cu", (1, 2, 4, 16)),
    "riccati": ("riccati.cu", (1, 16)),
    "kkt": ("kkt.cu", (1, 16)),
    "riccati_blocked": ("riccati_blocked.cu", ()),
}


def variant_workers() -> int:
    """The nvcc processes a variant build runs at once: two per CPU core, so
    that a batch of variants keeps the cores busy without holding more
    compilers in memory than the host has room for."""
    return 2 * (os.cpu_count() or 4)


def variant_defines(key: VariantKey) -> list[str]:
    """The ``-D`` macros of ``key`` (csrc/variants/variant.cuh reads them)."""
    if key.family not in VARIANT_SOURCES:
        raise ValueError(f"no variant source for the kernel family {key.family!r}")
    defs = [f"-DDMPC_N={key.n}", f"-DDMPC_M={key.m}", f"-DDMPC_ENUM={key.enum}", f"-DDMPC_EXACT={int(key.exact)}"]
    if key.env == "nn":
        defs.append('-DDMPC_HIDDEN="{}"'.format("x".join(map(str, key.hidden))))
    elif key.env in CPP_ENVS:
        defs += [f"-DDMPC_ENV={key.env.capitalize()}Env", f'-DDMPC_ENV_HEADER="{key.env}.cuh"']
    elif key.env != "linear":
        raise ValueError(f"no C++ step for the env {key.env!r}: linear, nn or one of {CPP_ENVS}")
    if key.passthrough:
        if key.env == "linear" or key.family not in ("ilqr", "rollout"):
            raise ValueError(f"a passthrough variant wraps an env's step in the ilqr or rollout family; got {key}")
        defs.append("-DDMPC_PASSTHROUGH=1")
    return defs


# the variant families built without FMA contraction (NO_CONTRACTION)
CONTRACTION_FREE_FAMILIES = ("riccati", "kkt", "ilqr")


def variant_units(key: VariantKey) -> list[list[str]]:
    """The compile flags of each of ``key``'s translation units, one nvcc
    each: the main library's flags (without FMA contraction for the Riccati
    sweep and the KKT backward, as their prebuilt sources, and for the fused
    solve, whose variants share the Riccati step out over the lanes), the
    key's macros and the unit's lane count; the source is
    ``variant_source(key)``."""
    _, lanes = VARIANT_SOURCES[key.family]
    flags = [*NVCC_FLAGS, *(NO_CONTRACTION if key.family in CONTRACTION_FREE_FAMILIES else ()),
             *variant_defines(key), "-I", CSRC]
    return [flags + [f"-DDMPC_VARIANT_L={L}"] for L in (*lanes, 0)]


def variant_source(key: VariantKey) -> str:
    return os.path.join(VARIANTS, VARIANT_SOURCES[key.family][0])


def variant_path(key: VariantKey) -> str:
    """The library of ``key``, named by the key and a hash of every source
    (the headers and csrc/variants/), the flags and the key."""
    h = hashlib.sha256(_source_hash().encode())
    for path in sorted(glob.glob(os.path.join(VARIANTS, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    for unit in variant_units(key):
        h.update(" ".join(unit).encode())
    h.update(repr(tuple(key)).encode())
    return os.path.join(BUILD_DIR, f"libdiffmpc_{key.name}-{h.hexdigest()[:16]}.so")


def build_variants(keys, seconds: dict | None = None) -> dict:
    """Build every variant of ``keys`` that is not built yet, all their
    units' nvcc started together, then each link. Returns ``{key: (path,
    log)}`` (``log`` ``""`` for one already built); fills ``seconds``, where
    given, with ``{key.name: {unit: seconds from the common start, "link":
    seconds}}`` for the fresh ones. A failed nvcc raises with its output."""
    keys = list(dict.fromkeys(keys))
    out = {key: (variant_path(key), "") for key in keys}
    fresh = [key for key in keys if not os.path.exists(out[key][0])]
    if not fresh:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    objdir = tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR)
    try:
        cmds, units = [], {}
        for i, key in enumerate(fresh):
            for flags in variant_units(key):
                label = flags[-1].rsplit("_", 1)[1]  # "L=<lanes>"
                obj = os.path.join(objdir, f"{i}-{label}.o")
                units.setdefault(key, []).append((label, obj))
                cmds.append([nvcc, *flags, "-c", "-o", obj, variant_source(key)])
        logs, compile_s = _run_each(cmds, variant_workers())
        at = 0
        for key in fresh:
            labels, objs = zip(*units[key])
            log = "".join(logs[at : at + len(objs)])
            t0 = time.perf_counter()
            log += _link(nvcc, list(objs), out[key][0])
            if seconds is not None:
                seconds[key.name] = dict(zip(labels, compile_s[at : at + len(objs)]), link=time.perf_counter() - t0)
            out[key] = (out[key][0], log)
            at += len(objs)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def build_variants_with(keys, out_dir: str, defines=(), label: str = "custom", workers: int = 0) -> tuple:
    """Other builds of the variants ``keys`` for a diagnostic: each key's
    units as :func:`variant_units` has them, each with ``-D`` for each of
    ``defines`` (``NAME`` or ``NAME=VALUE``), all compiled at once (at most
    ``workers`` nvcc processes; 0: :func:`variant_workers`), each
    key's linked into ``out_dir/lib<label>_<key.name>.so``. Returns ``({key:
    CDLL}, {key: nvcc's log})``; raises with nvcc's output where a compile
    fails."""
    keys = list(dict.fromkeys(keys))
    nvcc = find_nvcc()
    objs, cmds = {}, []
    for key in keys:
        for i, flags in enumerate(variant_units(key)):
            objs.setdefault(key, []).append(os.path.join(out_dir, f"{label}-{key.name}-{i}.o"))
            cmds.append([nvcc, *flags, *(f"-D{d}" for d in defines), "-c", "-o", objs[key][-1], variant_source(key)])
    logs, _ = _run_each(cmds, workers or variant_workers())
    libs, key_logs, at = {}, {}, 0
    for key in keys:
        so = os.path.join(out_dir, f"lib{label}_{key.name}.so")
        _link(nvcc, objs[key], so)
        libs[key] = _dlopen(so)
        key_logs[key] = "".join(logs[at : at + len(objs[key])])
        at += len(objs[key])
    return libs, key_logs


@functools.lru_cache(maxsize=None)
def load_variant(key: VariantKey) -> ctypes.CDLL:
    """The library of variant ``key``, built on its first use and loaded once
    per process."""
    (so, _), = build_variants([key]).values()
    return _dlopen(so)
