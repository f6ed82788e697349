"""The port's frame records (craytpu_torch/utils/trace.py) on the CPU, on
one tiny resumed frame of spheres (64x48, 4 passes, a pool of 4,096
lanes, one bounce a step): the record's counts against counts taken by
wrapping the pool loop's methods, its live lane-bounces against live
lanes summed on the host before each step, its spans' nesting, nothing
traced when tracing is off, and the spans in a profile. The card's case
checks the device intervals from CUDA events."""

import json
import types

import numpy as np
import pytest
import torch

from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from craytpu_torch.utils import trace

torch.set_num_threads(2)

W, H, SPP = 64, 48, 4
SCENE = {
    "renderer": {"samples": SPP, "bounces": 4, "width": W, "height": H},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.2, "g": 0.2, "b": 0.2},
                         "up": {"r": 0.6, "g": 0.6, "b": 0.8}},
        "primitives": [{
            "type": "sphere", "radius": 1.2, "bsdf": "lambertian",
            "color": {"r": 0.7, "g": 0.3, "b": 0.2},
            "instances": [{"transforms": [
                {"type": "translate", "x": 0, "y": 0, "z": 0}]}]}]}}
NPIX = W * H


def _resume() -> dict:
    """A checkpoint of half the paths pending, more than the pool holds
    (the prime and the first refills build lanes on the host), and the
    other half a range (refills on the device)."""
    half = NPIX * SPP // 2
    return {"final_sum": np.zeros((NPIX, 4), np.float32),
            "pending": np.arange(0, half, dtype=np.int64),
            "ranges": [[half, NPIX * SPP]]}


def _renderer(device="cpu", size=(W, H), **kw) -> WavefrontRenderer:
    scene = dict(SCENE, renderer=dict(SCENE["renderer"], width=size[0],
                                      height=size[1]))
    return WavefrontRenderer(compile_scene(load_scene_from_buf(json.dumps(
        scene)), device), **kw)


def _wrap(r) -> dict:
    """Count the loop's calls by wrapping its methods on the instance, and
    sum each step's live lanes on the host (a synchronising read) before
    it runs: one bounce a step, or k a step where k > 1."""
    calls = {"_pool_step": 0, "_flush_pack_refill": 0,
             "_flush_pack_refill_host": 0, "_pack_shrink": 0,
             "drain": 0, "live_k1": 0, "live_k": 0}
    inside = []
    for name in ("_pool_step", "_flush_pack_refill",
                 "_flush_pack_refill_host", "_pack_shrink", "_drain_all"):
        fn = getattr(r, name)

        def counted(*a, _fn=fn, _name=name):
            if _name == "_drain_all":
                inside.append(1)
                try:
                    return _fn(*a)
                finally:
                    inside.pop()
            calls[_name] += 1
            if _name == "_pool_step":
                k, pool = a
                n = int(pool.alive.sum())
                calls["live_k1" if k == 1 else "live_k"] += k * n
                calls["drain"] += bool(inside)
            return _fn(*a)
        setattr(r, name, counted)
    return calls


def test_record_counts_the_loop(monkeypatch):
    """The record's steps, drain steps, refills and shrinks equal the
    wrapped methods' calls; its live lane-bounces of the one-bounce steps
    equal the live lanes summed on the host, and those of the drain's
    8-bounce steps are their bound, live-in * 8; the frame is the
    untraced one bit for bit."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    r = _renderer()
    want = r.render_persistent(SPP, resume=_resume())
    calls = _wrap(r)
    monkeypatch.setenv(trace.ENV, "1")
    np.testing.assert_array_equal(r.render_persistent(SPP, resume=_resume()),
                                  want)
    rec = r.trace.last
    c = rec["counts"]
    assert c["steps"] == calls["_pool_step"] and c["steps"] > 3
    assert c["drain_steps"] == calls["drain"] > 0
    assert c["refills"] == (calls["_flush_pack_refill"]
                            + calls["_flush_pack_refill_host"])
    assert calls["_flush_pack_refill"] and calls["_flush_pack_refill_host"]
    assert c["shrinks"] == calls["_pack_shrink"] == 1
    assert c["live"] - c["live_bound"] == calls["live_k1"] > 0
    assert c["live_bound"] == calls["live_k"] > 0
    assert c["lanes"] == sum(
        n * (k[1] * k[2] if k[0] == "step" else 8 * k[1])
        for k, n in rec["hist"].items() if k[0] in ("step", "drain"))
    assert c["dispatches"]["pool"] == c["steps"]
    assert c["dispatches"]["fpr"] == calls["_flush_pack_refill"]
    assert c["h2d_bytes"] > NPIX * 16 and c["d2h_bytes"] >= NPIX * 16
    assert c["paths"] == NPIX * SPP and 0 < rec["occupancy"] <= 1
    json.dumps(trace.to_json([rec]))


def test_spans_nest_in_their_frame(monkeypatch):
    """Every span but the root lies inside its parent, one level deeper,
    and carries its frame's id; the loop's spans are all there, and
    each dispatch runs inside the span of its kind, whose device interval
    holds the dispatch's; no frame captures."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    monkeypatch.setenv(trace.ENV, "1")
    r = _renderer()
    r.render_persistent(SPP, resume=_resume())
    r.render_persistent(SPP)
    a, b = r.trace.frames
    assert (a["id"], b["id"]) == (1, 2)
    for rec in (a, b):
        spans = rec["spans"]
        assert spans[0]["name"] == "frame" and spans[0]["parent"] is None
        for s in spans[1:]:
            p = spans[s["parent"]]
            assert s["frame"] == rec["id"] and s["depth"] == p["depth"] + 1
            assert p["t0_ms"] <= s["t0_ms"] <= s["t1_ms"] <= p["t1_ms"]
        for d in rec["dispatches"]:
            s = spans[d["span"]]
            assert s["name"] in ("prime", "pool_step", "refill", "shrink",
                                 "flush")
            lo, hi = d["dev_ms"]
            assert s["dev_ms"][0] <= lo <= hi <= s["dev_ms"][1]
        assert rec["counts"]["captures"] == 0
    names = {s["name"] for s in a["spans"]}
    assert {"upload", "prime", "pool_step", "count_wait", "refill",
            "refill.host_lanes", "shrink", "drain", "flush",
            "fetch"} <= names


def test_off_traces_nothing(monkeypatch):
    """With tracing off a frame makes no clock read in the tracer, no
    CUDA event and no profiler range, and keeps no record; the counters
    still count its dispatches."""
    monkeypatch.delenv(trace.ENV, raising=False)

    def boom(*a, **k):
        raise AssertionError("traced while tracing is off")
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter=boom))
    monkeypatch.setattr(trace.Tracer, "event", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    r = _renderer()
    r.render_persistent(SPP, resume=_resume())
    assert r.trace.last is None and not r.trace.frames
    assert r.trace.dispatches["pool"] > 0 and r.trace.rec is trace.OFF


def test_profiler_gets_the_spans(monkeypatch):
    """A frame that starts under torch.profiler is traced without
    CRAYTPU_TRACE: its record says so, and its spans are ranges of the
    profile (a 16x12 frame of one pass and one bounce: the profiler
    records every op)."""
    monkeypatch.delenv(trace.ENV, raising=False)
    r = _renderer(size=(16, 12), bounces=1)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_persistent(1)
    rec = r.trace.last
    assert rec["profiled"] and len(r.trace.frames) == 1
    # the profile's raw events (prof.events() would build some 40,000
    # function events, seconds on the CPU)
    seen = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {s["name"] for s in rec["spans"]} <= seen
    r.render_persistent(1)
    assert len(r.trace.frames) == 1


@pytest.mark.cuda
def test_device_intervals_on_the_card(monkeypatch):
    """On the card (CUDA events): each dispatch's interval is ordered and
    follows the one before, the gaps are not negative, and the intervals
    sum to no more than the frame's device span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the intervals come from CUDA "
                    "events")
    monkeypatch.setenv(trace.ENV, "1")
    r = _renderer("cuda")
    r.render_persistent(SPP, resume=_resume())
    r.render_persistent(SPP, resume=_resume())
    rec = r.trace.last
    assert rec["counts"]["captures"] == 0
    ivs = [d["dev_ms"] for d in rec["dispatches"]]
    lo, hi = rec["device_span_ms"]
    assert all(lo <= a <= b <= hi for a, b in ivs)
    assert all(b0 <= a1 + 1e-3 for (_, b0), (a1, _) in zip(ivs, ivs[1:]))
    assert all(g["ms"] >= 0 for g in rec["gaps"])
    assert sum(b - a for a, b in ivs) <= hi - lo + 1e-3
    assert rec["device_busy_ms"] + sum(g["ms"] for g in rec["gaps"]) == \
        pytest.approx(hi - lo, abs=1e-3)
