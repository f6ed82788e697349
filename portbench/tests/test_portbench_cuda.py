"""On the card: one short run of each cell through the command the
driver runs, correct and with the contract's last line. Marked cuda;
skips without a card (decided in the fixture)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import manifest

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=manifest.ROOT,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
