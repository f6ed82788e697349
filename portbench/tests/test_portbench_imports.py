"""What a run loads: no module whose top-level name is jax, jaxlib, flax,
optax or craytpu (whole names: craytpu_torch is the program), and the
reference, its BVH walk and the control load nothing of craytpu_torch
either. Each in a fresh process."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import manifest

RUN = """
import sys, json, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from portbench_tiny import run_tiny, tiny_cell
from portbench import run as bench
res = run_tiny(tiny_cell("instances_render"))
print(json.dumps({{"correct": res["correct"],
                   "bad": bench.forbidden_modules(),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REF = """
import sys, json, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from portbench_tiny import tiny_cell
from portbench import control
r = control.readings(tiny_cell("instances_render", pixels=16), 5, "cpu")
print(json.dumps({{"off_share": r["off_share"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

WALK = """
import sys, json, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from portbench_tiny import tiny_cell
from portbench import scenes
from portbench.reference import scene as rs, trace as rt, walk
c = tiny_cell("instances_render")
text = scenes.scene_text(c.config, c.traffic)
tab = rs.build(text, scenes.check_assets(c.config, c.root), "cpu")
x, y = scenes.check_pixels(json.loads(text), 16, 5)
out = rt.render_pixels(tab, torch.tensor(x), torch.tensor(y), 0, 1,
                       search=walk.Walk(tab))
print(json.dumps({{"lit": bool((out > 0).any()),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

BARRED = {"jax", "jaxlib", "flax", "optax", "craytpu", "craytpu_torch"}


def _child(src: str) -> dict:
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", src.format(root=manifest.ROOT, tests=tests)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax_and_no_jax_package():
    got = _child(RUN)
    assert got["correct"] is True and got["bad"] == []
    assert "craytpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "optax", "craytpu"} & set(
        got["top"])


def test_reference_loads_nothing_of_the_program():
    got = _child(REF)
    assert got["off_share"] > 0.0
    assert not BARRED & set(got["top"])


def test_walk_loads_nothing_of_the_program():
    got = _child(WALK)
    assert got["lit"] and "portbench" in got["top"]
    assert not BARRED & set(got["top"])
