"""What the diagnostics measure with: the card's published rates, its clock,
CUDA-event timing of a call and, interleaved, of kernels alone on staged
inputs or replayed from CUDA graphs, and the registers and spills that
ptxas reports for each kernel."""

from __future__ import annotations

import re
import subprocess

import torch

# NVIDIA's H100 SXM data sheet: HBM bandwidth and dense float32 rate
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# the latency of one dependent float32 operation (an FMA) on the SMs, in
# clock cycles
DEP_OP_CYCLES = 4


def require_card() -> torch.device:
    """The first CUDA device; raises without one (a measurement never falls
    back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the diagnostics time kernels on a CUDA device, and there is none")
    return torch.device("cuda", 0)


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.split()[0])


def chain_ms(depth: int, clock_mhz: float) -> float:
    """``depth`` dependent operations at ``DEP_OP_CYCLES`` each."""
    return depth * DEP_OP_CYCLES / (clock_mhz * 1e6) * 1e3


def bound(n_bytes: float, n_ops: float, chain: float = 0.0) -> dict:
    """The least time the card could take: the bytes over the memory rate, the
    operations over the float32 rate, or (``chain``, in ms) the dependent
    operations at their latency, whichever is largest."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS_PER_S * 1e3
    out = dict(bytes_ms=t_bytes, ops_ms=t_ops, chain_ms=chain)
    out.update(bound_ms=max(t_bytes, t_ops, chain), bound_by="bytes" if t_bytes >= max(t_ops, chain) else "operations")
    return out


def ptxas_report(log: str, match: str = "") -> dict:
    """``{kernel: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}}`` (the last three in bytes) for the entry functions of an
    ``nvcc -Xptxas -v`` log whose mangled names contain ``match``."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif entry is None or match not in entry:
            continue
        elif props == entry and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                                 r"(\d+) bytes spill loads", line)):
            out.setdefault(entry, {}).update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                                             spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def cuda_ms(fn, loops: int, reps: int = 3) -> float:
    """Best over ``reps`` of the mean time of ``loops`` calls of ``fn``, by
    CUDA events, after one call to warm up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(loops):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / loops)
    return best


def graph_ms(launches: dict, count: int = 100, rounds: int = 5) -> dict:
    """Each launch alone with the host out of the way: ``count`` calls of
    each ``launches[name]()`` (launches on the current stream) captured in
    one CUDA graph, then in each of ``rounds`` rounds every graph's replay
    timed in turn by CUDA events. Returns each name's minimum over the
    rounds, in ms per call."""
    graphs = {}
    for name, launch in launches.items():
        launch()  # warm: the first call of a launcher may query the card
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(count):
                launch()
    torch.cuda.synchronize()
    best = {}
    for _ in range(rounds):
        for name, g in graphs.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            best[name] = min(best.get(name, float("inf")), start.elapsed_time(end) / count)
    return best


def interleaved_ms(stagers: dict, rounds: int, loops: int) -> dict:
    """Time kernels alone on their staged inputs, interleaved: ``stagers``
    maps a name to ``(launcher, stage)``, where ``stage(launch)`` stages the
    inputs and calls ``launch`` once, as a wrapper's ``run_staged_*`` does,
    and ``launcher`` launches the kernel. Every stage's inputs stay alive
    (each stage runs inside the one before), then each round times ``loops``
    launches of each kernel in turn between CUDA events. Returns each name's
    minimum over the rounds, in ms per launch."""
    names, calls, best = list(stagers), {}, {}

    def nest(i):
        if i == len(names):
            torch.cuda.synchronize()
            for _ in range(rounds):
                for name in names:
                    launch, args = calls[name]
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(loops):
                        launch(*args)
                    end.record()
                    end.synchronize()
                    best[name] = min(best.get(name, float("inf")), start.elapsed_time(end) / loops)
            return
        launcher, stage = stagers[names[i]]

        def capture(*args):
            launcher(*args)  # the staged call's own launch, which fills its outputs
            calls[names[i]] = (launcher, args)
            nest(i + 1)

        stage(capture)

    nest(0)
    return best
