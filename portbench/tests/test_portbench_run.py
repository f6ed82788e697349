"""A whole run on the CPU at a tiny size (all but the look for a card):
the result's shape, and the checks it prints."""

from __future__ import annotations

import json

import pytest

from portbench_tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("cell", ["highpoly_render", "instances_render"])
def test_result_line(cell, capsys):
    res = run_tiny(tiny_cell(cell))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert {"setup_s", "paths_per_s", "frame_ms_p90"} == set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for k, v in res["checks"].items():
        assert k.startswith("off_share.") and v["value"] <= v["limit"]
    json.loads(json.dumps(res))
    assert "portbench check:" in capsys.readouterr().err
