"""Accept/reject bands for tracked benchmark rows (counterpart of
:mod:`diffmpc_tpu.utils.bench_bands`, copied: the JAX package's
``__init__`` imports JAX).

A single reading of a shared card can swing, so a row is judged by bands
with memory:

- a bands file (``{"rows": {row: {"min": ..., "max": ...}}}``) records each
  tracked row's accepted band;
- :func:`check_bands` flags the rows outside their band in one run;
- :func:`evaluate_with_history` appends each run's out-of-band rows to a
  JSONL history and promotes a row to **REGRESSION** when it is out of band
  in two consecutive runs that measured it.

Kept divergence from the JAX module: a row absent from a run (its block
dropped, or errored) neither confirms nor resets its two-run count. The
run's history line carries such a row's previous status forward, so a
regression on both sides of a run that did not measure it is still
promoted; the JAX module records it as in band and starts the count again.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple


def load_bands(path: str) -> Dict[str, dict]:
    """Read the ``rows`` table of a bands file."""
    with open(path) as fh:
        return json.load(fh)["rows"]


def _measured(details: dict, row: str) -> bool:
    return isinstance(details.get(row), (int, float))


def check_bands(details: dict, bands: Dict[str, dict]) -> List[dict]:
    """Return one record per tracked row that is outside its band.

    Rows absent from ``details`` are skipped: absence is visible in the
    artifact itself and is not a band violation.
    """
    out = []
    for row, band in bands.items():
        if not _measured(details, row):
            continue
        val = details[row]
        if "min" in band and val < band["min"]:
            out.append({"row": row, "value": val, "bound": band["min"], "kind": "below_min"})
        if "max" in band and val > band["max"]:
            out.append({"row": row, "value": val, "bound": band["max"], "kind": "above_max"})
    return out


def evaluate_with_history(
    details: dict,
    bands_path: str,
    history_path: Optional[str] = None,
) -> Tuple[List[dict], List[str]]:
    """Check ``details`` against the bands and apply the two-consecutive-
    runs rule against the recorded history.

    Returns ``(violations, regressions)``, ``regressions`` naming the rows
    out of band in this run and in the previous recorded run. The history
    file is appended (JSONL: ``{"t": ..., "out_of_band": [...]}``) so that
    the next run sees this one; a tracked row that this run did not measure
    keeps its previous line's status there.
    """
    bands = load_bands(bands_path)
    violations = check_bands(details, bands)
    now_bad = {v["row"] for v in violations}

    prev_bad: List[str] = []
    if history_path and os.path.exists(history_path):
        with open(history_path) as fh:
            lines = [line for line in fh.read().splitlines() if line.strip()]
        if lines:
            prev_bad = json.loads(lines[-1]).get("out_of_band", [])
    regressions = sorted(now_bad & set(prev_bad))
    carried = {row for row in prev_bad if row in bands and not _measured(details, row)}

    if history_path:
        os.makedirs(os.path.dirname(history_path) or ".", exist_ok=True)
        with open(history_path, "a") as fh:
            fh.write(json.dumps({"t": time.time(), "out_of_band": sorted(now_bad | carried)}) + "\n")
    return violations, regressions


def format_warnings(violations: List[dict], regressions: List[str]) -> List[str]:
    """Human-readable WARN/REGRESSION lines for stderr."""
    lines = []
    for v in violations:
        rel = "below" if v["kind"] == "below_min" else "above"
        tag = "REGRESSION" if v["row"] in regressions else "WARN"
        lines.append(
            f"{tag}: bench row '{v['row']}' = {v['value']:g} is {rel} its band bound {v['bound']:g}"
            + (" (out of band two consecutive runs — regression by definition; bisect with an interleaved A/B)"
               if v["row"] in regressions
               else " (single reading — could be contention; decisive only if repeated next run)")
        )
    return lines
