"""Performance microtests (`--test-perf`), the counterpart of the
reference's perf table (tests/perf/tests.h + testrunner.c:127-148):
each test runs PERF_AVG_COUNT times and reports the average. The JAX
package's utils/perftest.py, the same five tests on the port's modules.

Tests cover the host-side hot paths: scene JSON load, OBJ parse, SAH BVH
build, texture packing, base64 asset-cache encode/decode (the cluster
wire format), and PNG encode (the standard-library encoder).
"""

from __future__ import annotations

import time

import numpy as np

PERF_AVG_COUNT = 10  # the reference uses 100 on microsecond-scale tests


def _avg(fn, n=PERF_AVG_COUNT):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def perf_scene_load():
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "assets",
        "entry_scene.json")
    return _avg(lambda: load_scene_from_file(path), 5)


def perf_bvh_build():
    from craytpu_torch.accel.bvh import build_bvh
    rng = np.random.default_rng(0)
    n = 50000
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    bmin = v0 - 0.1
    bmax = v0 + 0.1
    return _avg(lambda: build_bvh(bmin, bmax, v0), 5)


def perf_base64_cache():
    from craytpu_torch.utils import fileio
    blob = {"big.bin": np.random.default_rng(1).bytes(4 << 20)}
    return _avg(lambda: fileio.decode_cache(fileio.encode_cache(blob)))


def perf_texture_pack():
    from craytpu_torch.ops.texture import pack_rgba_rows
    img = np.random.default_rng(2).random((1024, 1024, 3)).astype(np.float32)
    return _avg(lambda: pack_rgba_rows(img))


def perf_png_encode(tmp=None):
    from craytpu_torch.io.png import write_png
    import tempfile
    import os
    fb = np.random.default_rng(3).random((256, 256, 4)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "perf.png")
        return _avg(lambda: write_png(path, fb, {}))


PERF_TESTS = [
    ("scene::load", perf_scene_load),
    ("bvh::build-50k", perf_bvh_build),
    ("filecache::base64-4MB", perf_base64_cache),
    ("texture::pack-1Mpx", perf_texture_pack),
    ("png::encode-256", perf_png_encode),
]


def run_perf_tests(suite: str | None = None) -> int:
    from craytpu_torch.utils import logging
    for name, fn in PERF_TESTS:
        if suite and not name.startswith(suite):
            continue
        dt = fn()
        logging.info("[perf] %-24s %8.2f ms", name, dt * 1e3)
    return 0
