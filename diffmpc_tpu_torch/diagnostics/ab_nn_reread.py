"""What re-reading the MLP's weights each step buys, on the card.

``NNEnv::step`` (``csrc/nn_mlp.cuh``) hides the weights' pointer from the
compiler at every step (an empty ``asm volatile`` on it), so that each step
reads the weights anew from shared memory. Without it the compiler hoists
the loads of all the weights out of the kernels' loops over steps and holds
them in registers, which spill. This script builds the MLPs' fused solve
(``csrc/ilqr_nn.cu`` and the kernels of ``csrc/ilqr_nn_l<L>.cu``) twice,
from copies of the sources with and without that line (both nvcc processes
at once), and compares the two builds on the JAX bench's MLP (3-16-16-3,
residual, tanh; ``bench.py:592-624``): each kernel's registers and spills as
ptxas reports them, and the 3-16-16-3 kernel's time alone (CUDA events,
interleaved, the minimum of the rounds) at T=15, ``lqr_iter=8``, B=1024 and
65,536, in-sweep and with the ``hoist_lin`` pre-pass, at the lane count the
wrapper picks for the batch.

Run on a machine with a CUDA device:

    python -m diffmpc_tpu_torch.diagnostics.ab_nn_reread

It prints the card's name and power limit, then one JSON record per
build and per batch.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import tempfile

import torch

from ..csrc import build
from ..models import NNDynamics, PendulumDx
from ..ops.cuda import ilqr as il
from .card import interleaved_ms, ptxas_report, require_card

BARRIER = 'asm volatile("" : "+l"(params));'
BATCHES, T, LQR_ITER = (1024, 65536), 15, 8
LABELS = ("with_barrier", "without_barrier")


def build_both(tmp: str) -> dict:
    """The MLPs' fused solve built from two copies of the sources, one with
    the barrier and one without it: ``{label: (library, ptxas log)}``."""
    cmds = {}
    for label in LABELS:
        src_dir = os.path.join(tmp, label)
        os.makedirs(src_dir)
        for f in os.listdir(build.CSRC):
            if f.endswith((".cu", ".cuh")):
                with open(os.path.join(build.CSRC, f)) as src:
                    text = src.read()
                if f == "nn_mlp.cuh" and label == "without_barrier":
                    if BARRIER not in text:
                        raise RuntimeError("the barrier is not in csrc/nn_mlp.cuh")
                    text = text.replace(BARRIER, "")
                with open(os.path.join(src_dir, f), "w") as dst:
                    dst.write(text)
        so = os.path.join(src_dir, "ilqr_nn.so")
        cmds[label] = (so, [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I", src_dir, "-o", so,
                            *sorted(glob.glob(os.path.join(src_dir, "ilqr_nn*.cu")))])
    procs = {label: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for label, (_, cmd) in cmds.items()}
    logs = {label: proc.communicate(timeout=900)[0] for label, proc in procs.items()}
    for label, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{logs[label]}")
    return {label: (ctypes.CDLL(cmds[label][0]), logs[label]) for label in LABELS}


def run() -> list:
    """One record per build (its ptxas report) and per batch (the times)."""
    device = require_card()
    nn = NNDynamics.init(3, 1, hidden=(16, 16), residual=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    env = il.kernel_env(nn)
    q, p = PendulumDx.default(device=device).get_true_obj()
    stream = torch.cuda.current_stream(device).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        built = build_both(tmp)
        records = [dict(build=label, ptxas=ptxas_report(log, "NNEnv")) for label, (_, log) in built.items()]

        def launcher(lib, hoist):
            fn = getattr(lib, f"diffmpc_ilqr_solve_{env.symbol}" + ("_hoist" if hoist else ""))
            fn.argtypes = [ctypes.POINTER(il._IlqrArgs), ctypes.POINTER(il._NNEnv), ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch(args, env_ref):
                if fn(args, env_ref, stream) != 0:
                    raise RuntimeError("launch failed")

            return launch

        for B in BATCHES:
            sm_count = torch.cuda.get_device_properties(device).multi_processor_count
            g = torch.Generator(device=device).manual_seed(7)
            th = (torch.rand(B, generator=g, device=device) * 2 - 1) * torch.pi
            x = torch.stack([th.cos(), th.sin(), torch.rand(B, generator=g, device=device) * 2 - 1], -1)
            box = torch.full((T, B, 1), 2.0, device=device)
            args = (x, torch.diag(q).expand(T, B, 4, 4), p.expand(T, B, 4), nn, -box, box)
            stagers = {
                f"{label}_{'hoist_lin' if hoist else 'in_sweep'}": (
                    launcher(lib, hoist),
                    lambda launch, hoist=hoist: il.run_staged(launch, *args, lqr_iter=LQR_ITER, eps=1e-5,
                                                              hoist_lin=hoist,
                                                              lanes=il.ilqr_lanes(B, env, sm_count, hoist)),
                )
                for label, (lib, _) in built.items()
                for hoist in (False, True)
            }
            ms = interleaved_ms(stagers, rounds=3, loops=5 if B <= 4096 else 2)
            records.append(dict(B=B, T=T, lqr_iter=LQR_ITER, hidden=[16, 16],
                                lanes={h: il.ilqr_lanes(B, env, sm_count, h) for h in (False, True)}, ms=ms,
                                without_over_with={k: ms[f"without_barrier_{k}"] / ms[f"with_barrier_{k}"]
                                                   for k in ("in_sweep", "hoist_lin")}))
    return records


def main() -> None:
    require_card()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for rec in run():
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
