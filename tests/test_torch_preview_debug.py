"""The port's live preview (runtime/preview.py, runtime/regions.py), debug
mode (CRAYTPU_DEBUG), the pool's frame record (CRAYTPU_TRACE) and the
rest of the API, on the CPU, against the JAX package where it has the same
function: the preview's PNG decodes to the RGB bytes of craytpu's
PIL-encoded preview, and the region snapshots are equal to craytpu's for
the same pixel schedule. Debug mode mirrors tests/test_debug.py."""

import io
import json
import socket
import urllib.error
import urllib.request
from dataclasses import replace

import numpy as np
import pytest
import torch

from craytpu_torch import api
from craytpu_torch.io.png import decode_png_rgb
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops.hitrec import Isect
from craytpu_torch.runtime.preview import PreviewServer, frame_hook
from craytpu_torch.runtime.regions import RegionTracker
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_buf

torch.set_num_threads(2)

# tests/test_debug.py's scene
SCENE = {
    "renderer": {"samples": 1, "bounces": 4, "width": 16, "height": 12},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.2, "g": 0.2, "b": 0.2},
                         "up": {"r": 0.6, "g": 0.6, "b": 0.8}},
        "primitives": [
            {"type": "sphere", "radius": 1.2,
             "color": {"r": 0.7, "g": 0.3, "b": 0.2},
             "bsdf": "lambertian",
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
        ],
    },
}
TEXT = json.dumps(SCENE)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read(), r.headers.get("Content-Type")


def _cs():
    return compile_scene(load_scene_from_buf(TEXT), "cpu")


def test_preview_server_serves_frame_and_status():
    srv = PreviewServer(32, 24, port=0)   # ephemeral port
    base = srv.start()
    try:
        fb = np.zeros((24, 32, 4), np.float32)
        fb[:, :, 0] = 0.5
        srv.update(fb, done=100, total=400)
        body, ctype = _get(base)
        assert b"craytpu live render" in body and "html" in ctype
        png, ctype = _get(base + "frame.png")
        assert ctype == "image/png"
        rgb = decode_png_rgb(png)
        assert rgb.shape == (24, 32, 3) and (rgb[..., 0] > 0).all()
        s = json.loads(_get(base + "status.json")[0])
        assert s["done"] == 100 and s["total"] == 400 and s["version"] == 1
        # progress-only updates bump counters without a new frame
        srv.progress_only(200, 400)
        s2 = json.loads(_get(base + "status.json")[0])
        assert s2["done"] == 200 and s2["version"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "nope")
        assert e.value.code == 404
    finally:
        srv.stop()


def test_preview_png_matches_jax_pil_encoding():
    """The standard-library PNG holds the RGB bytes of craytpu's PIL
    PNG for the same framebuffer (HDR values, a y-up flip)."""
    from PIL import Image

    from craytpu.runtime.preview import PreviewServer as JPreviewServer
    fb = (np.random.default_rng(7).random((24, 32, 4)) * 1.5).astype(
        np.float32)
    port, jax_side = PreviewServer(32, 24), JPreviewServer(32, 24)
    port.update(fb, 1, 2)
    jax_side.update(fb, 1, 2)
    want = np.asarray(Image.open(io.BytesIO(jax_side._frame_png())))
    np.testing.assert_array_equal(decode_png_rgb(port._frame_png()), want)


@pytest.fixture(scope="module")
def schedules():
    """The port's and craytpu's pixel schedules (xs, ys) of a 32x24 frame
    with 16x16 tiles, as tests/test_cluster.py's scene has."""
    from craytpu.models.wavefront_pt import WavefrontRenderer as JRenderer
    from craytpu.scene.compile import compile_scene as jcompile
    from craytpu.scene.sceneloader import load_scene_from_buf as jload
    scene = dict(SCENE, renderer={"samples": 2, "bounces": 3, "width": 32,
                                  "height": 24, "tileWidth": 16,
                                  "tileHeight": 16})
    text = json.dumps(scene)
    r = WavefrontRenderer(compile_scene(load_scene_from_buf(text), "cpu"))
    jr = JRenderer(jcompile(jload(text)))
    npix = 32 * 24
    jxs, jys = jr._pixel_schedule[:2]
    return (r._sched_host,
            (np.asarray(jxs)[:npix], np.asarray(jys)[:npix]))


@pytest.mark.parametrize("issued", [0, 300, 768 + 100, 2 * 768])
def test_region_snapshot_matches_jax(schedules, issued):
    from craytpu.runtime.regions import RegionTracker as JTracker
    (xs, ys), (jxs, jys) = schedules
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    got = RegionTracker(32, 24, xs, ys, gw=4, gh=3).snapshot(issued, 2, 256)
    want = JTracker(32, 24, jxs, jys, gw=4, gh=3).snapshot(issued, 2, 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_preview_frame_hook_feeds_the_server():
    """render_persistent's on_frame through frame_hook feeds the server
    frames and progress, and the status carries the region grid."""
    cs = _cs()
    r = WavefrontRenderer(cs, tile_rays=64)
    srv = PreviewServer(r.width, r.height, port=0)
    base = srv.start()
    try:
        hook = frame_hook(srv, r, 2, every_s=0.0)
        fb = r.render_persistent(2, on_frame=hook)
        s = json.loads(_get(base + "status.json")[0])
        assert s["version"] >= 1 and 0 < s["done"] <= s["total"] == 384
        xs, ys = r._sched_host
        srv.update_regions(*RegionTracker(16, 12, xs, ys).snapshot(
            384, 2, 0))
        s = json.loads(_get(base + "status.json")[0])
        assert np.allclose(s["regions"], 1.0)
        assert decode_png_rgb(_get(base + "frame.png")[0]).shape == (
            12, 16, 3)
    finally:
        srv.stop()
    assert np.isfinite(fb).all()


def _render_poisoned(poison: bool):
    cs = _cs()
    if poison:
        colors = cs.params.colors.clone()
        colors[:, 0] = float("nan")    # a NaN albedo channel: a bad bsdf
        cs.params = replace(cs.params, colors=colors)
    r = WavefrontRenderer(cs)
    assert r._debug
    return r.render(spp=1)


def test_debug_mode_raises_on_nan_material(monkeypatch):
    monkeypatch.setenv("CRAYTPU_DEBUG", "1")
    with pytest.raises(FloatingPointError) as ei:
        _render_poisoned(True)
    msg = str(ei.value)
    assert "non-finite" in msg and "bounce 0" in msg


def test_debug_mode_clean_render_passes(monkeypatch):
    monkeypatch.setenv("CRAYTPU_DEBUG", "1")
    img = _render_poisoned(False)
    assert np.isfinite(img).all()
    monkeypatch.delenv("CRAYTPU_DEBUG")
    np.testing.assert_array_equal(img, WavefrontRenderer(_cs()).render(1))


def test_debug_off_by_default(monkeypatch):
    monkeypatch.delenv("CRAYTPU_DEBUG", raising=False)
    r = WavefrontRenderer(_cs())
    assert not r._debug and not r.isect.debug


def test_debug_out_of_range_id_raises(monkeypatch):
    """An id past the instance table reaching Isect.resolve raises under
    debug; without debug the wrapper checks nothing."""
    monkeypatch.setenv("CRAYTPU_DEBUG", "1")
    cs = _cs()
    isect = Isect(cs)
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    found = isect.search(cs.geom, o, d, torch.ones(4, dtype=torch.bool))
    t, prim, inst, rec = found
    bad = inst.clone()
    bad[2] = cs.inst_wide.shape[0]
    with pytest.raises(IndexError, match="out-of-range id"):
        isect.resolve((t, prim, bad, rec), o, d)
    isect.resolve(found, o, d)
    monkeypatch.delenv("CRAYTPU_DEBUG")
    assert not Isect(cs).debug


def test_debug_census_overflow_raises(monkeypatch):
    """A compaction width below the live lanes poisons the trace with
    NaN; under debug it raises."""
    cs = _cs()
    i = torch.arange(16 * 12, dtype=torch.int32)
    xs, ys = i % 16, i // 16
    sched = [(0, 192), (1, 8)]
    r = WavefrontRenderer(cs)
    img = r.make_trace_fn(compaction=sched)(cs.params, xs, ys, 0, 1)
    assert torch.isnan(img).all()
    monkeypatch.setenv("CRAYTPU_DEBUG", "1")
    r = WavefrontRenderer(cs)
    with pytest.raises(FloatingPointError, match="overflow"):
        r.make_trace_fn(compaction=sched)(cs.params, xs, ys, 0, 1)


def test_pool_stats_count_the_loop(monkeypatch):
    """CRAYTPU_TRACE's frame record counts the pool steps, refills and
    shrinks that the loop calls, and leaves the frame bit for bit; each
    dispatch's device interval (the host clock on the CPU) lies in the
    frame's device span, in the order of the calls."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    r = WavefrontRenderer(_cs(), tile_rays=64)
    want = r.render_persistent(2)
    assert r.trace.last is None
    calls = {"_pool_step": 0, "_flush_pack_refill": 0, "_pack_shrink": 0}
    for name in calls:
        fn = getattr(r, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        setattr(r, name, counted)
    monkeypatch.setenv("CRAYTPU_TRACE", "1")
    np.testing.assert_array_equal(r.render_persistent(2), want)
    st = r.trace.last
    c = st["counts"]
    assert (c["steps"], c["refills"], c.get("shrinks", 0)) == (
        calls["_pool_step"], calls["_flush_pack_refill"],
        calls["_pack_shrink"])
    assert c["refills"] > 0 and 0 < st["occupancy"] <= 1
    assert st["bounces_per_path"] > 0 and not st["profiled"]
    ivs = [d["dev_ms"] for d in st["dispatches"]]
    assert [d["kind"] for d in st["dispatches"]].count("pool") == c["steps"]
    lo, hi = st["device_span_ms"]
    assert all(lo <= a <= b <= hi for a, b in ivs)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(ivs, ivs[1:]))
    assert st["device_ms"]["pool"] > 0


def test_api_remainder():
    r = api.initialize()
    assert isinstance(r, api.Renderer) and r.thread_count() == 0
    assert api.get_version() == "0.6.3"
    r.device = "cpu"
    assert r.load_scene_from_buf(TEXT)
    r.set_thread_count(6)
    assert r.thread_count() == 6 and not r.scene.prefs.from_system
    r.set_sample_count(3)
    # abort from the progress callback: the frame ends after that pass
    done = []

    def progress(p, spp, accum):
        done.append(p)
        r.abort()
    r.start_renderer(progress)
    assert done == [1] and r.current_image().shape == (12, 16, 4)
    np.testing.assert_array_equal(
        r.current_image(),
        WavefrontRenderer(r.compiled).render(3, stop=lambda: True))


def test_preview_binds_localhost():
    """The preview binds 127.0.0.1 only (not every interface)."""
    srv = PreviewServer(4, 4, port=0)
    srv.start()
    try:
        assert srv._httpd.server_address[0] == "127.0.0.1"
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5):
            pass
    finally:
        srv.stop()
