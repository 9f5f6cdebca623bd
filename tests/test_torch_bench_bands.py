"""The port's bench bands (diffmpc_tpu_torch/utils/bench_bands.py) against
the JAX package's module, on tests/test_aux.py:87's cases, with a bands file
and a history that the test writes under ``tmp_path``.

Every case gives the same violations, regressions, warning lines (up to
their advice's wording) and history rows in both modules, but the kept
divergence: a row absent from a
run neither confirms nor resets its two-run count in the port, where the
JAX module resets it.
"""

import json

import pytest

pytest.importorskip("torch")

from diffmpc_tpu.utils import bench_bands as jax_bands  # noqa: E402
from diffmpc_tpu_torch.utils import bench_bands as port_bands  # noqa: E402

BANDS = {"rows": {"solves_per_s": {"min": 850000.0}, "riccati_pass_ms": {"max": 0.95},
                  "roofline_frac": {"min": 0.2, "max": 0.9}}}
GOOD = {"solves_per_s": 1_000_000.0, "riccati_pass_ms": 0.7, "roofline_frac": 0.35}
BAD = {"solves_per_s": 790_000.0, "riccati_pass_ms": 1.4}


@pytest.fixture
def paths(tmp_path):
    bands = tmp_path / "bands.json"
    bands.write_text(json.dumps(BANDS))
    return str(bands), {name: str(tmp_path / f"{name}_hist.jsonl") for name in ("jax", "port")}


def _runs(paths, runs):
    """Each module through the same runs, each with its own history:
    ``(violations, regressions, warning lines)`` a run, and the history's
    rows without their times. A warning line is compared up to its
    parenthesised advice, whose wording differs."""
    bands, hist = paths
    out = {}
    for name, mod in (("jax", jax_bands), ("port", port_bands)):
        results = []
        for details in runs:
            v, r = mod.evaluate_with_history(details, bands, hist[name])
            results.append((v, r, [line.split(" (")[0] for line in mod.format_warnings(v, r)]))
        with open(hist[name]) as fh:
            rows = [json.loads(line)["out_of_band"] for line in fh]
        out[name] = results, rows
    return out


def test_check_bands_in_band_and_out(paths):
    bands = port_bands.load_bands(paths[0])
    assert bands == jax_bands.load_bands(paths[0])
    assert port_bands.check_bands(GOOD, bands) == jax_bands.check_bands(GOOD, bands) == []
    got = port_bands.check_bands(BAD, bands)
    assert got == jax_bands.check_bands(BAD, bands)
    assert {x["row"] for x in got} == {"solves_per_s", "riccati_pass_ms"}
    assert {x["kind"] for x in got} == {"below_min", "above_max"}
    both = {"roofline_frac": 0.1}, {"roofline_frac": 0.95}
    for details in both:
        assert port_bands.check_bands(details, bands) == jax_bands.check_bands(details, bands) != []
    assert port_bands.check_bands({}, bands) == jax_bands.check_bands({}, bands) == []


@pytest.mark.parametrize("case", ["two_runs", "recovery", "in_band"])
def test_history_rule_matches_jax(paths, case):
    """One low run warns, two in a row are a REGRESSION, an in-band run in
    between starts the count again; in-band runs stay silent."""
    runs = {"two_runs": [BAD, BAD], "recovery": [BAD, BAD, GOOD, BAD], "in_band": [GOOD, GOOD]}[case]
    out = _runs(paths, runs)
    assert out["port"] == out["jax"]
    results, _ = out["port"]
    if case == "in_band":
        assert all(v == [] and r == [] for v, r, _ in results)
        return
    v1, r1, lines1 = results[0]
    assert r1 == [] and len(v1) == 2 and all(line.startswith("WARN") for line in lines1)
    assert any("solves_per_s" in line and "790000" in line for line in lines1)
    _, r2, lines2 = results[1]
    assert r2 == ["riccati_pass_ms", "solves_per_s"] and all(line.startswith("REGRESSION") for line in lines2)
    if case == "recovery":
        assert results[2][:2] == ([], []) and results[3][1] == []


def test_absent_row_neither_confirms_nor_resets(paths):
    """The kept divergence: a row out of band, then absent (its block not
    run), then out of band again. The absent run raises nothing in either
    module; the port then promotes the row to REGRESSION, the JAX module
    has reset its count and warns."""
    partial = {"riccati_pass_ms": 0.7}  # solves_per_s absent
    out = _runs(paths, [BAD, partial, BAD])
    (jax_results, jax_rows), (port_results, port_rows) = out["jax"], out["port"]
    assert jax_results[:2] == port_results[:2]
    assert port_results[1][:2] == ([], [])
    assert jax_results[2][1] == [] and port_results[2][1] == ["solves_per_s"]
    assert jax_rows[1] == [] and port_rows[1] == ["solves_per_s"]
    lines = dict(zip((v["row"] for v in port_results[2][0]), port_results[2][2]))
    assert lines["solves_per_s"].startswith("REGRESSION") and lines["riccati_pass_ms"].startswith("WARN")
