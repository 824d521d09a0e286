"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
leading to its files."""
from __future__ import annotations

import json
import re

import pytest

from portbench import run
from portbench.tests._small import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    command = MANIFEST["command"]
    assert 1 <= len(command) <= 32 and all(_line(w) for w in command)
    assert not any(w.startswith("/") or ".." in w for w in command)


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in MANIFEST["workloads"]]
    names += [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        listed = [x["name"] for x in MANIFEST[group]]
        assert len(listed) == len(set(listed))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) or
                       any(w in k for w in WIDTHS) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert _line(w["why"])
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for group, want in keys.items():
        for entry in MANIFEST[group]:
            assert set(entry) - {"workloads"} == want - {"workloads"}, \
                entry["name"]
    # the harness reports a per-layer metric in the cells it lists
    assert all("workloads" in m for m in MANIFEST["per_layer"])


def test_cells_configs_and_chips():
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    assert {w["config"] for w in cells} == configs
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(tuple(p + "/" for p in MANIFEST["paths"]))


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_cell_reports_and_files(workload):
    spec = run.load_cell(ROOT, workload)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert run.reader_path(m["name"]).is_file()
    config = spec["config"]
    for kind in ("entry", "reference"):
        d = {"entry": "entries", "reference": "reference"}[kind]
        assert (run.PKG / d / f"{config[kind]}.py").is_file()
    family = spec["traffic"]["family"]
    assert (run.PKG / "families" / f"{family}.py").is_file()


def test_every_moves_is_reported_by_the_metrics_cells():
    """Each per-layer metric moves an end-to-end metric that every cell it
    lists reports."""
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        moved = [e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"]]
        assert len(moved) == 1, m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in moved[0] or \
                cell in moved[0]["workloads"], (m["name"], cell)


def test_layers_named_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf or layer in perf, layer
