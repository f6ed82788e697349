"""The control at a size a test run holds: the reference with its lanes'
state stored in bfloat16 fails the check's limit by far, where the
program's own frame passes it."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench_tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("cell", ["highpoly_render", "instances_render"])
def test_bfloat16_control_fails(cell):
    torch.set_num_threads(2)
    c = tiny_cell(cell, width=48, height=32, pixels=96)
    r = control.readings(c, 2 ** 31 + 77, "cpu")
    lim = c.traffic["limits"]["off_share"]
    assert r["off_share"] > 3 * lim


def test_program_passes_at_the_same_size():
    res = run_tiny(tiny_cell("instances_render", width=48, height=32,
                             pixels=96), seed=2 ** 31 + 77)
    assert res["correct"] is True
    assert all(v["value"] == 0.0 for v in res["checks"].values())
