"""K1's and K2's byte counts: per lane by hand, and the lanes the entry
takes from its dispatches' widths against every K1 and K2 call of a
frame, counted on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import profiling, roofline
from portbench_tiny import tiny_cell


def test_bytes_per_lane_by_hand():
    # K1: o (3) + d (3) + t (1) floats, prim and inst ids in, 16 floats out
    assert roofline.k1_bytes(1) == (3 + 3 + 1 + 1 + 1 + 16) * 4 == 100
    # K2: o (3) + d (3) + limit (1) in, t, prim, inst out
    assert roofline.k2_bytes(1) == (3 + 3 + 1 + 3) * 4 == 40
    assert roofline.k1_bytes(1 << 20) == 100 << 20
    # 3.35e12 B/s: 3.35 GB take 1 ms; in 2 ms that is 50%
    assert roofline.share(3_350_000_000, 2e-3) == pytest.approx(50.0)
    assert roofline.share(0, 1.0) is None
    assert roofline.share(100, 0.0) is None


@pytest.mark.parametrize("cell", ["highpoly_render", "instances_render"])
def test_lanes_of_a_frame(cell, monkeypatch):
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from portbench import scenes
    from portbench import run as bench
    torch.set_num_threads(2)
    c = tiny_cell(cell, width=32, height=24)
    mod = c.driver()
    e = mod.Entry(scenes.scene_text(c.config, c.traffic),
                  scenes.check_assets(c.config, c.root), c.traffic, 7, "cpu")
    e.setup(bench.capture_timer)
    sizes = {"closest_hit": [], "hitrec": []}

    def counting(mod_, name, key):
        orig = getattr(mod_, name)

        def f(*a, **k):
            sizes[key].append(a[1].shape[0] if key == "closest_hit"
                              else a[2].shape[0])
            return orig(*a, **k)
        monkeypatch.setattr(mod_, name, f)
    counting(trv, "closest_hit", "closest_hit")
    counting(hr, "hitrec_record", "hitrec")
    spans = profiling.Spans()
    e.install_spans(spans)
    try:
        e.request()
    finally:
        spans.remove()
    assert e.lanes(spans) == sum(sizes["closest_hit"]) == sum(
        sizes["hitrec"]) > 0
    assert e.launches(spans) == len(sizes["closest_hit"])
