"""On the card: one short run of each cell through the command the
driver runs, correct and with the contract's last line; and the
reference's BVH walk against its every-triangle search on 65,536 drawn
paths of each stress scene at the cell's size. Marked cuda; skips
without a card (decided in the fixture)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import manifest

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
SCENES = ["highpoly_render", "instances_render"]


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


@pytest.mark.parametrize("cell", SCENES)
def test_walk_bit_equal_to_every_triangle_search(card, cell):
    """65,536 distinct pixels drawn from the seed, one pass each, 12
    bounces at 1920x1080: the same (t, prim, inst) on every lane of every
    bounce, and the same radiance bit for bit."""
    import numpy as np
    import torch
    from portbench import scenes
    from portbench.reference import scene as rs
    from portbench.reference import trace as rt
    from portbench.reference import walk
    c = manifest.Cell(cell)
    text = scenes.scene_text(c.config, c.traffic)
    tab = rs.build(text, scenes.check_assets(c.config, c.root), "cuda")
    assert tab.bounces == 12 and (tab.width, tab.height) == (1920, 1080)
    xs, ys = scenes.check_pixels(json.loads(text), 1 << 16, 2 ** 31 + 303)
    x = torch.tensor(xs, device="cuda")
    y = torch.tensor(ys, device="cuda")
    first = int(np.random.default_rng(2 ** 31 + 303).integers(0, tab.spp))
    w = walk.Walk(tab)
    lanes, off = [], []

    def both(tab, o, d):
        a = rt.closest_hit(tab, o, d)
        b = w(tab, o, d)
        lanes.append(o.shape[0])
        off.append(int(((a[0].view(torch.int32) != b[0].view(torch.int32))
                        | (a[1] != b[1]) | (a[2] != b[2])).sum()))
        return a
    ref = rt.render_pixels(tab, x, y, first, 1, block=1 << 16, search=both)
    got = rt.render_pixels(tab, x, y, first, 1, block=1 << 16, search=w)
    # most paths leave for the sky within a few bounces
    assert lanes[0] == 1 << 16 and len(lanes) >= 4
    assert off == [0] * len(off)
    assert torch.equal(ref.view(torch.int32), got.view(torch.int32))
