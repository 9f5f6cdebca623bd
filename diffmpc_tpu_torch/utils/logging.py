"""Host-side logging (counterpart of :mod:`diffmpc_tpu.utils.logging`).

``table_log`` prints one aligned line of stats, the reference's
per-iteration print idiom; ``CSVLogger`` and ``JSONLLogger`` append metric
rows to a file; ``profile_trace`` wraps a region in a ``torch.profiler``
trace, written where TensorBoard and Perfetto can read it.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from typing import Iterable, Optional, Sequence, Tuple


def table_log(tag: str, values: Iterable[Tuple]) -> str:
    """Format and print a compact stat line, such as
    ``table_log('lqr', (('iter', i), ('obj', obj, '{:.3e}')))``: each value
    ``(name, value)`` or ``(name, value, format)``. Returns the line."""
    parts = []
    for v in values:
        name, val, fmt = v if len(v) == 3 else (*v, "{}")
        parts.append(f"{name}=" + fmt.format(val))
    line = f"[{tag}] " + " ".join(parts)
    print(line)
    return line


class CSVLogger:
    """Append-only CSV metric logger: the header is written when the file is
    new, and each row is flushed as it is logged."""

    def __init__(self, path: str, fieldnames: Sequence[str]):
        self.path = path
        self.fieldnames = list(fieldnames)
        new = not os.path.exists(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.fieldnames)
        if new:
            self._writer.writeheader()

    def log(self, **row):
        self._writer.writerow({k: row.get(k) for k in self.fieldnames})
        self._fh.flush()

    def close(self):
        self._fh.close()


class JSONLLogger:
    """Append-only JSON-lines metric logger; each row gets a ``time`` stamp
    unless it has one."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def log(self, **row):
        row.setdefault("time", time.time())
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the region with ``torch.profiler`` (the host, and the card
    where there is one) into ``log_dir`` when it is set; nothing otherwise.
    Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
