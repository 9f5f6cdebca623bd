"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` file is compiled, with the ``.cuh`` headers beside it,
by its own ``nvcc`` process, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.
The library goes to ``diffmpc_tpu_torch/_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so an edit rebuilds and a stale
library is never loaded. The build writes a per-process temporary file and
renames it into place, so parallel processes may race it safely.

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
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

# sm_90a: Hopper with its arch-specific features. No --use_fast_math: the env
# steps call sinf/cosf/sqrtf, whose fast forms would break parity.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


# The Riccati sweep's sources are built without FMA contraction. Whether
# nvcc fuses a product into a sum depends on how many uses the product has in
# the surrounding code, which differs between one thread's step and a lane
# group's share of it; the sweep fuses by hand instead (riccati_mad in
# riccati_entries.cuh), where contraction fused the one-thread kernel, so
# that every lane count computes the same float32 operations, bit for bit.
NO_CONTRACTION = ("-fmad=false",)


def source_flags(src: str) -> tuple:
    """The flags of ``src`` beyond NVCC_FLAGS."""
    name = os.path.basename(src)
    return NO_CONTRACTION if re.fullmatch(r"riccati(_stream|_l\d+)?\.cu", name) else ()


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
    t0 = time.perf_counter()

    def one(cmd):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        done = list(pool.map(one, cmds))
    for cmd, (proc, _) in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    return "".join(proc.stdout for proc, _ in done), [s for _, s in done]


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
    tmp = f"{so}.{os.getpid()}.tmp"
    objdir = tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR)
    try:
        objs = [os.path.join(objdir, os.path.basename(src) + ".o") for src in sources()]
        log, compile_s = _run([[nvcc, *NVCC_FLAGS, *source_flags(src), "-I", CSRC, "-c", "-o", obj, src]
                               for obj, src in zip(objs, sources())])
        link_log, link_s = _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]])
        log += link_log
        if seconds is not None:
            seconds.update({os.path.basename(src): s for src, s in zip(sources(), compile_s)}, link=link_s[0])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return so, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    so, _ = build()
    return ctypes.CDLL(so)
