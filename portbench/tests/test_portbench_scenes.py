"""The seed's part: one scene for every seed (the same work), the CLI's
overrides from the traffic, pixels and the first chunk drawn from the
seed; the reference's camera composite."""

from __future__ import annotations

import json

import numpy as np

from portbench import manifest, scenes
from portbench.reference import scene as rs


def test_scene_and_pixels_follow_the_seed():
    cell = manifest.Cell("highpoly_render")
    cfg, traffic = cell.config, cell.traffic
    big = 2 ** 31 + 12345
    sc = json.loads(scenes.scene_text(cfg, traffic))
    assert sc["renderer"]["width"] == 1920 and sc["renderer"]["height"] == (
        1080) and sc["renderer"]["samples"] == 64
    assert {k: v for k, v in sc.items() if k != "renderer"} == {
        k: v for k, v in cfg["scene"].items() if k != "renderer"}
    # the configuration itself is left as shipped
    assert cfg["scene"]["renderer"]["width"] == 1280
    xs, ys = scenes.check_pixels(sc, 1024, big)
    flat = ys * 1920 + xs
    assert len(np.unique(flat)) == 1024 and flat.max() < 1920 * 1080
    xs2, ys2 = scenes.check_pixels(sc, 1024, big)
    assert np.array_equal(xs, xs2) and np.array_equal(ys, ys2)
    xs3, _ = scenes.check_pixels(sc, 1024, big + 1)
    assert not np.array_equal(xs, xs3)
    scenes.check_pixels(sc, 8, -3)


def test_chunks_cycle_from_the_seed():
    cell = manifest.Cell("highpoly_render")
    drv = cell.driver()
    n, k = drv.chunks(cell.traffic)
    assert (n, k) == (4, 16)
    firsts = {drv.first_chunk(cell.traffic, 2 ** 31 + s) for s in range(64)}
    assert firsts <= set(range(k)) and len(firsts) > 8
    e = drv.Entry("{}", "", cell.traffic, 2 ** 32 + 3, "cpu")
    start = drv.first_chunk(cell.traffic, 2 ** 32 + 3)
    seen = []
    for _ in range(k + 1):
        seen.append((e.next % k) * n)
        e.next += 1
    assert seen[0] == start * n and seen[k] == seen[0]
    assert sorted(seen[:k]) == list(range(0, 64, 4))


def test_camera_composite_translates_then_rotates():
    """c-ray composes every translate, then every rotation, whatever the
    order listed: the camera sits at its translate, pitched down."""
    cam = manifest.Cell("highpoly_render").config["scene"]["camera"]
    A = rs.composite(list(reversed(cam["transforms"])))
    assert np.array_equal(A, rs.composite(cam["transforms"]))
    assert np.allclose(A[:3, 3], [0.0, 2.0, -6.0])
    # rotateX 12 degrees: the forward axis tips down
    fwd = A[:3, :3] @ np.array([0.0, 0.0, 1.0], np.float32)
    assert fwd[1] < 0 and np.isclose(np.degrees(np.arcsin(-fwd[1])), 12,
                                     atol=1e-4)
