"""Entry: the CLI's persistent frame. `make_renderer(...).render_persistent()`
on a compiled scene, one persistent pool of 2^20 lanes through CUDA
graphs, the framebuffer fetched to the host as the CLI fetches it before
writing its PNG.

A request renders the next `passes_per_request` passes of a render of
the CLI's `-s` passes (a progressive preview: the CLI's resumable queue
of (pixel, pass) ids, handed one chunk of passes at a time), so every
request traces its own paths at the same amount of work. The chunks
cycle; the seed draws the first.

`check` compares a kept frame with the plain reference on pixels drawn
from the seed (portbench/check.py).
"""

from __future__ import annotations

import json
import time

import numpy as np

# the dispatch whose (k bounces, pool width B) launch K1 and K2 k times
# at width B each
DISPATCH = "_pool_step"
DISPATCH_SPAN = "pool_step"


def combine(passes, max_passes: int):
    """(P, n, 4) radiance of a chunk's n passes -> (P, 4) as the frame
    holds it: the passes summed in order, then divided by the render's
    pass count."""
    acc = passes[:, 0]
    for p in range(1, passes.shape[1]):
        acc = acc + passes[:, p]
    return acc / acc.new_tensor(float(max_passes))


def chunks(traffic: dict) -> tuple:
    """(passes a request, chunks in the render)."""
    n = int(traffic["passes_per_request"])
    return n, int(traffic["cli"]["samples"]) // n


def first_chunk(traffic: dict, seed: int) -> int:
    """The chunk the seed's first request renders."""
    from portbench import scenes
    return int(scenes.rng(seed, scenes.CHUNK).integers(
        0, chunks(traffic)[1]))


def check(cell, text: str, adir: str, seed: int, outputs: list,
          device: str) -> list:
    """Each output's gaps (check.gaps) to the reference, which traces the
    seed's pixels of the output's passes on `device`."""
    import torch
    from portbench import check as chk
    from portbench import scenes
    from portbench.reference import scene as rs
    from portbench.reference import trace as rt
    xs, ys = scenes.check_pixels(json.loads(text), int(cell.traffic[
        "check_pixels"]), seed)
    tab = rs.build(text, adir, device)
    x = torch.tensor(xs, device=device)
    y = torch.tensor(ys, device=device)
    res = []
    for (first, n), frame in outputs:
        passes = rt.render_pixels(tab, x, y, first, n)
        ref = combine(passes, tab.spp).cpu().numpy()
        res.append(chk.gaps(np.asarray(frame), ref, xs, ys))
    return res


class Entry:
    def __init__(self, scene_text: str, asset_dir: str, traffic: dict,
                 seed: int, device: str = "cuda"):
        self.text = scene_text
        self.asset_dir = asset_dir
        self.traffic = traffic
        self.device = device
        self.n, self.chunks = chunks(traffic)
        self.next = first_chunk(traffic, seed)
        self.ren = None

    def setup(self, capture_timer) -> dict:
        from craytpu_torch.ops import cuda_build
        from craytpu_torch.parallel.pool_shard import make_renderer
        from craytpu_torch.scene.compile import compile_scene
        from craytpu_torch.scene.sceneloader import load_scene_from_buf
        if self.device == "cuda":
            cuda_build.build_all()
        t0 = time.perf_counter()
        scene = load_scene_from_buf(self.text, self.asset_dir)
        cs = compile_scene(scene, self.device)
        load_s = time.perf_counter() - t0
        self.ren = make_renderer(cs)
        self.spp = scene.prefs.sample_count
        self.npix = self.ren.width * self.ren.height
        self.zeros = np.zeros((self.npix, 4), np.float32)
        self.paths = self.npix * self.n
        warm_s = float(self.traffic["warmup_s"])
        with capture_timer() as cap:
            t0 = time.perf_counter()
            done = 0
            while (done < int(self.traffic["warmup_requests"])
                   or time.perf_counter() - t0 < warm_s):
                self.request()
                done += 1
        return {"scene_load_s": load_s, "graph_capture_s": cap["s"],
                "warmup_requests": done}

    def request(self) -> tuple:
        """((first pass, passes), the frame (H, W, 4) on the host)."""
        first = (self.next % self.chunks) * self.n
        self.next += 1
        lo = first * self.npix
        frame = self.ren.render_persistent(self.spp, resume={
            "final_sum": self.zeros, "pending": np.zeros(0, np.int64),
            "ranges": [[lo, lo + self.n * self.npix]]})
        return (first, self.n), frame

    def install_spans(self, spans) -> None:
        """Host spans around the pool loop's dispatches (the instance's
        methods)."""
        ren = self.ren
        spans.wrap(ren, DISPATCH, DISPATCH_SPAN, keep_args=True)
        for name, label in (("_prime_dev", "prime"),
                            ("_flush_pack_refill", "refill"),
                            ("_pack_shrink", "shrink"),
                            ("_drain_all", "drain"),
                            ("_final_flush", "flush"),
                            ("render_persistent", "frame")):
            spans.wrap(ren, name, label)

    @staticmethod
    def lanes(spans) -> int:
        """K1's (and K2's) lanes in the window: each pool step of k
        bounces over B lanes launches each k times at width B."""
        return sum(k * pool.alive.shape[0]
                   for k, pool in spans.args[DISPATCH_SPAN])

    @staticmethod
    def launches(spans) -> int:
        return sum(k for k, _ in spans.args[DISPATCH_SPAN])

    def close(self) -> None:
        self.ren = self.zeros = None
