"""The plain reference against the port's CPU path at a tiny size: every
path's radiance bit for bit (the same closest hits, the same rounding).
The port is imported here, in the test only; the reference never
imports it."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.reference import scene as rs
from portbench.reference import trace as rt
from portbench_tiny import tiny_cell


@pytest.mark.parametrize("cell", ["highpoly_render", "instances_render"])
def test_paths_bit_equal_to_the_port(cell):
    """A chunk of passes past the first (passes 2 and 3 of 4): streams
    seeded with the render's pass count, as the timed requests are."""
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    torch.set_num_threads(2)
    c = tiny_cell(cell, width=48, height=32, samples=4)
    seed = 2 ** 31 + 5
    adir = scenes.check_assets(c.config, c.root)
    text = scenes.scene_text(c.config, c.traffic)
    xs, ys = scenes.check_pixels(json.loads(text), 40, seed)
    ren = WavefrontRenderer(compile_scene(load_scene_from_buf(text, adir),
                                          "cpu"))
    x32 = torch.tensor(xs, dtype=torch.int32)
    y32 = torch.tensor(ys, dtype=torch.int32)
    port = torch.stack([ren.trace_batch(x32, y32, p, 4) for p in (2, 3)],
                       1).numpy()
    tab = rs.build(text, adir, "cpu")
    ref = rt.render_pixels(tab, torch.tensor(xs), torch.tensor(ys), 2,
                           2).numpy()
    assert port.shape == ref.shape == (40, 2, 4)
    assert np.array_equal(port.view(np.uint32), ref.view(np.uint32))
    # not a dark frame: the paths found the sky, the light or the mesh
    assert (ref[..., :3] > 0).mean() > 0.9


def test_unsupported_scene_refused():
    c = tiny_cell("highpoly_render")
    c.config["scene"]["scene"]["meshes"][0]["bsdf"] = "glass"
    text = scenes.scene_text(c.config, c.traffic)
    with pytest.raises(NotImplementedError):
        rs.build(text, scenes.check_assets(c.config, c.root), "cpu")
