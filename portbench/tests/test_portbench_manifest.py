"""Every entry of BENCHMARK.json resolves to its files, and the manifest
keeps the contract's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import manifest, scenes

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = manifest.Cell(cell)
    assert c.config["name"] == c.spec["config"]
    assert os.path.exists(c.driver_path)
    mod = c.driver()
    assert callable(mod.combine) and hasattr(mod.Entry, "request")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for lim in c.traffic["limits"].values():
        assert 0.0 < lim < 1.0
    # every per-layer metric's end-to-end metric is reported in the cell
    for m in c.per_layer:
        assert m["moves"] in names
    assert c.chips == 1


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"]
                                    + MAN["per_layer"]])
def test_metric_reader_exists(metric):
    assert callable(manifest.metric_reader(metric))


def test_names_units_and_layers():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for group in (MAN["configs"], MAN["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for c in m.get("workloads", []):
            assert c in CELLS
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("portbench/")
    with open(os.path.join(manifest.ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    scenes.check_assets(body, manifest.ROOT)
    # the scene as the repository ships it; the CLI's overrides are the
    # traffic's
    with open(os.path.join(manifest.ROOT, body["asset_dir"],
                           cfg["name"] + ".json")) as f:
        assert body["scene"] == json.load(f)
    assert {cfg["name"] for cfg in MAN["configs"]} == {
        w["config"] for w in MAN["workloads"]}
