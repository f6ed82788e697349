"""Each entry owns the check that decides `correct`: a run hands its kept
outputs to the driver's `check` and holds each number it returns to the
traffic's `limits`; a driver without `check` is refused when it loads;
run.py loads nothing of the reference."""

from __future__ import annotations

import ast
import os

import pytest

from portbench import manifest
from portbench import run as bench

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "toy_entry.py")


def _toy_cell(fault: float) -> manifest.Cell:
    cell = manifest.Cell("instances_render")
    cell.traffic = {"entry": "toy_entry", "fault": fault,
                    "limits": {"err": 0.5}}
    cell.driver_path = TOY
    return cell


@pytest.mark.parametrize("fault,correct", [(0.0, True), (1.0, False)])
def test_toy_check_decides_correct(fault, correct, capsys):
    res = bench.run_cell(_toy_cell(fault), 2 ** 31 + 21, 0.0, False, "cpu")
    assert res["correct"] is correct
    assert res["failed"] == (0 if correct else 2)
    assert set(res["checks"]) == {"err.drawn", "err.last"}
    for v in res["checks"].values():
        assert v == {"value": fault, "limit": 0.5}
    assert "portbench check: last output" in capsys.readouterr().err


def test_driver_without_check_refused(tmp_path):
    path = tmp_path / "no_check.py"
    with open(TOY) as f:
        src = f.read()
    path.write_text(src.replace("def check(", "def not_check("))
    cell = _toy_cell(0.0)
    cell.driver_path = str(path)
    with pytest.raises(ImportError, match=str(path)):
        cell.driver()


def test_run_loads_nothing_of_the_reference():
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    assert not [n for n in names if n.startswith("portbench.reference")
                or n.startswith("portbench.check")]
