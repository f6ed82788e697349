"""The port's persistent-pool renderer (render_persistent) and its
checkpoints, on the CPU (the kernels' plain versions), against the port's
per-pass render and against craytpu's render_persistent.

Tolerances: the port's persistent and per-pass renders trace the same
per-(pixel, pass) streams and differ only in accumulation order,
rtol=2e-5, atol=2e-6 (as tests/test_persistent.py holds craytpu). Across
the two packages images cannot be bit-equal (diffuse scatter calls
sin/cos, whose libm results differ between XLA and PyTorch in the last
bits), so they are held to the golden thresholds of
craytpu/utils/golden.py:26-27 on sRGB u8 (golden.compare_u8). The step,
refill and shrink schedule is a pure function of the inputs: the port
refills to the live count of the step just run, craytpu to a count one
step old, so each is held to its own rule."""

import os

import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.runtime import checkpoint as jckpt
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.runtime import checkpoint
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_file
from craytpu_torch.utils import golden, trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "assets", "entry_scene.json")
SPP = 3
RTOL, ATOL = 2e-5, 2e-6


def port_renderer(**kw):
    return WavefrontRenderer(compile_scene(load_scene_from_file(SCENE),
                                           "cpu"), **kw)


def assert_golden_close(got, want):
    ok, within, mean_abs = golden.compare_u8(golden.srgb_u8(got),
                                             golden.srgb_u8(want))
    assert ok, (within, mean_abs)


def interrupt_at(n):
    """An interrupt callable that fires at its n-th poll."""
    polls = []

    def interrupt():
        polls.append(1)
        return len(polls) >= n
    interrupt.polls = polls
    return interrupt


def record_jax(r, log):
    """Wrap craytpu's pool methods to log (step, width, k), (refill, m),
    (shrink, Bn) and (drain,) in call order."""
    pool_step, fpr = r._pool_step, r._flush_pack_refill
    shrink, drain = r._pack_shrink, r._drain_all

    def step(k):
        f = pool_step(k)

        def g(*a):
            log.append(("step", a[8].shape[0], k))
            return f(*a)
        return g

    def refill(B, m, Q):
        log.append(("refill", m))
        return fpr(B, m, Q)

    def pack_shrink(Bn):
        log.append(("shrink", Bn))
        return shrink(Bn)

    def drain_all():
        log.append(("drain",))
        return drain()
    r._pool_step, r._flush_pack_refill = step, refill
    r._pack_shrink, r._drain_all = pack_shrink, drain_all


def record_port(r, log):
    """The same log of the port's pool methods; a step also logs the live
    lanes it leaves (pool.alive.sum(): the exact count, read on the
    CPU)."""
    pool_step, fpr = r._pool_step, r._flush_pack_refill
    shrink, drain = r._pack_shrink, r._drain_all

    def step(k, pool):
        width = pool.alive.shape[0]
        out = pool_step(k, pool)
        log.append(("step", width, k, int(out[0].alive.sum())))
        return out

    def refill(B, m, Q, *a):
        log.append(("refill", m))
        return fpr(B, m, Q, *a)

    def pack_shrink(Bn, *a):
        log.append(("shrink", Bn))
        return shrink(Bn, *a)

    def drain_all(pool):
        log.append(("drain",))
        return drain(pool)
    r._pool_step, r._flush_pack_refill = step, refill
    r._pack_shrink, r._drain_all = pack_shrink, drain_all


def up_to_drain(log):
    return log[:log.index(("drain",))] if ("drain",) in log else log


def assert_port_schedule(log, B, Q, total, drains):
    """The port's rule, entry by entry of a record_port log of one
    uninterrupted render_persistent: after each step of the full pool
    while the queue holds ids, a refill of m = min((B - n) // Q,
    ceil(left / Q)) quanta exactly when n <= B - Q (n: the step's live
    count); once the queue is empty, a shrink to the bucket of n
    (max(next_pow2(n), 1024), by quarters), then either the drain
    (`drains`) or steps until no lane is alive."""
    left = total - B
    i = 0
    while i < len(log):
        e = log[i]
        assert e[0] == "step", (i, e)
        _, width, _, n = e
        nxt = log[i + 1] if i + 1 < len(log) else None
        if left > 0:
            assert width == B, (i, e)
            if n <= B - Q:
                m = min((B - n) // Q, -(-left // Q))
                assert nxt == ("refill", m), (i, e, nxt)
                left -= min(m * Q, left)
                i += 2
                continue
            assert nxt is not None and nxt[0] == "step", (i, e, nxt)
            i += 1
            continue
        if n == 0:
            assert nxt is None, (i, e, nxt)
            return
        need, Bn = max(1 << (n - 1).bit_length(), 1024), width
        while Bn // 4 >= need:
            Bn //= 4
        if Bn < width:
            assert nxt == ("shrink", Bn), (i, e, nxt)
            i += 1
            nxt = log[i + 1] if i + 1 < len(log) else None
        if drains:
            assert nxt == ("drain",), (i, e, nxt)
            return
        assert nxt is not None and nxt[0] == "step", (i, e, nxt)
        i += 1
    raise AssertionError("the log ends before the pool is empty")


@pytest.fixture(scope="module")
def pair():
    """craytpu's and the port's renderer on entry_scene (96x64, pool 8192,
    k=1 so that paths are in flight at every refill), each package's
    uninterrupted render_persistent and its schedule log."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRAYTPU_POOL_K", "1")
        jr = JaxRenderer(jcompile(jload(SCENE)), tile_rays=8192)
        tr = port_renderer(tile_rays=8192)
        jlog, tlog = [], []
        record_jax(jr, jlog)
        record_port(tr, tlog)
        jref = jr.render_persistent(spp=SPP)
        tref = tr.render_persistent(spp=SPP)
    return dict(jr=jr, tr=tr, jref=np.asarray(jref), tref=tref, jlog=jlog,
                tlog=tlog)


def test_persistent_matches_per_pass():
    # small pool so the refill path actually exercises (96x64=6144 pixels,
    # pool 2048 -> multiple refill rounds per pass, queue spans passes)
    r = port_renderer(tile_rays=2048)
    per_pass = r.render(spp=SPP)
    persistent = r.render_persistent(spp=SPP)
    assert persistent.shape == per_pass.shape == (64, 96, 4)
    np.testing.assert_allclose(persistent, per_pass, rtol=RTOL, atol=ATOL)


def test_persistent_respects_bounce_cap():
    r = port_renderer(bounces=1, tile_rays=2048)
    np.testing.assert_allclose(r.render_persistent(spp=1), r.render(spp=1),
                               rtol=RTOL, atol=ATOL)


def test_persistent_matches_jax_package(pair):
    assert pair["tref"].shape == pair["jref"].shape
    assert np.isfinite(pair["tref"]).all()
    assert_golden_close(pair["tref"], pair["jref"])


@pytest.mark.parametrize("tail", ["up_to_drain", "host_drain"])
def test_schedule_matches_jax_package(pair, tail, monkeypatch):
    """The sequence of pool steps (width, k), refills (m) and shrinks (Bn)
    follows the port's rule (assert_port_schedule), and, refilling to
    the newest count, takes fewer steps than craytpu's for the same
    paths. up_to_drain: the default render, up to the drain (craytpu
    drains in one device loop, the port in 8-bounce steps). host_drain:
    with an interrupt callable (that never fires) both packages drain
    step by step, so the whole sequence is held."""
    tr = pair["tr"]
    B, total = tr.tile_rays, tr.width * tr.height * SPP
    if tail == "up_to_drain":
        jlog, tlog = pair["jlog"], pair["tlog"]
        assert ("drain",) in jlog and ("drain",) in tlog
        assert ("shrink", 2048) in jlog
        assert_port_schedule(up_to_drain(tlog) + [("drain",)], B,
                             tr.refill_quantum(B), total, drains=True)
        jlog, tlog = up_to_drain(jlog), up_to_drain(tlog)
    else:
        monkeypatch.setenv("CRAYTPU_POOL_K", "1")
        jr = pair["jr"]
        jlog, tlog = [], []
        record_jax(jr, jlog)
        record_port(tr, tlog)
        jr.render_persistent(spp=SPP, interrupt=lambda: False)
        tr.render_persistent(spp=SPP, interrupt=lambda: False)
        assert ("drain",) not in tlog
        assert any(e[0] == "shrink" for e in tlog)
        assert_port_schedule(tlog, B, tr.refill_quantum(B), total,
                             drains=False)
    assert sum(e[0] == "refill" for e in tlog) >= 3
    assert (sum(e[0] == "step" for e in tlog)
            < sum(e[0] == "step" for e in jlog))


def test_pool_refilled_to_newest_count(monkeypatch):
    """From the frame record's live counts (CRAYTPU_TRACE=1, k=1): each
    step's live-in is the pool's exact live count; every full-width step
    after the first refill, while the queue holds ids, starts with fewer
    than Q dead lanes; and refill_short is the dead lanes the refills
    left (the queue is whole quanta, so every fresh lane is live)."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    monkeypatch.setenv(trace.ENV, "1")
    r = port_renderer(tile_rays=8192)
    B = r.tile_rays
    Q = r.refill_quantum(B)
    total = r.width * r.height * SPP
    assert (total - B) % Q == 0
    events = []
    pool_step, fpr = r._pool_step, r._flush_pack_refill
    frame_step = trace._Frame.step

    def step(k, pool):
        events.append(("step", pool.alive.shape[0],
                       int(pool.alive.sum())))
        return pool_step(k, pool)

    def refill(B, m, Q, final, pool, *a):
        events.append(("refill", m, int(pool.alive.sum())))
        return fpr(B, m, Q, final, pool, *a)

    def record_step(rec, k, width, drain=False):
        events.append(("record", rec.live_in))
        return frame_step(rec, k, width, drain)
    r._pool_step, r._flush_pack_refill = step, refill
    monkeypatch.setattr(trace._Frame, "step", record_step)
    r.render_persistent(spp=SPP)
    rec = r.trace.last
    steps = [(e[1], e[2]) for e in events if e[0] == "step"]
    assert [e[1] for e in events if e[0] == "record"] == [
        n for _, n in steps]
    refills = [i for i, e in enumerate(events) if e[0] == "refill"]
    assert len(refills) >= 3
    short = 0
    for j, i in enumerate(refills):
        _, m, n = events[i]
        after = next(e for e in events[i:] if e[0] == "step")
        assert after[1] == B and B - after[2] == B - n - m * Q
        short += B - n - m * Q
        if j + 1 < len(refills):
            # the queue still holds ids: every step up to the next
            # refill starts with fewer than Q dead lanes
            for e in events[i:refills[j + 1]]:
                if e[0] == "step":
                    assert e[1] == B and B - e[2] < Q, (j, e)
    assert rec["counts"]["refill_short"] == short
    assert rec["counts"]["refills"] == len(refills)
    assert rec["counts"]["captures"] == 0


def test_interrupt_checkpoint_resume_lossless(tmp_path, monkeypatch):
    """Interrupt at the 3rd poll, checkpoint to disk, resume: the image
    equals the uninterrupted render up to accumulation order (same paths
    traced once each)."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    r = port_renderer(tile_rays=8192)
    ref = r.render_persistent(spp=SPP)
    out = r.render_persistent(spp=SPP, interrupt=interrupt_at(3))
    assert isinstance(out, tuple) and out[0] == "interrupted"
    _, final_sum, pending, ranges = out
    npix = r.width * r.height
    assert ranges and 0 < ranges[0][0] <= npix * SPP
    assert len(pending) > 0          # genuinely mid-flight

    resumed = r.render_persistent(
        spp=SPP, resume={"final_sum": final_sum, "pending": pending,
                         "ranges": ranges})
    np.testing.assert_allclose(resumed, ref, rtol=RTOL, atol=ATOL)

    p = str(tmp_path / "c.npz")
    checkpoint.save_persistent(p, final_sum, pending, ranges, SPP,
                               (r.height, r.width))
    assert checkpoint.kind(p) == "persistent"
    resume2, total2, shape2 = checkpoint.load_persistent(p)
    assert total2 == SPP and shape2 == (r.height, r.width)
    resumed2 = r.render_persistent(spp=SPP, resume=resume2)
    np.testing.assert_allclose(resumed2, ref, rtol=RTOL, atol=ATOL)


def test_interrupt_latency_bounded(monkeypatch):
    """The interrupt callable is polled once per pool step, so an abort
    lands within ONE step at any render phase."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    r = port_renderer(tile_rays=8192)
    steps = []
    pool_step = r._pool_step

    def counted(k, pool):
        steps.append(1)
        return pool_step(k, pool)
    r._pool_step = counted
    interrupt = interrupt_at(3)   # fire mid-render, before any drain
    out = r.render_persistent(spp=SPP, interrupt=interrupt)
    assert isinstance(out, tuple) and out[0] == "interrupted"
    assert len(steps) <= len(interrupt.polls) + 1, (steps, interrupt.polls)


def test_pool_tensors_contiguous(monkeypatch):
    """Every pool tensor a step gets is contiguous (the kernels' wrappers
    refuse strided tensors on the card), through prime, device refills,
    host refills of a resume, and shrinks."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    r = port_renderer(tile_rays=8192)
    pool_step = r._pool_step
    seen = []

    def checked(k, pool):
        for name, t in vars(pool).items():
            ts = vars(t).values() if name == "s" else [t]
            assert all(x.is_contiguous() for x in ts), name
        seen.append(pool.alive.shape[0])
        return pool_step(k, pool)
    r._pool_step = checked
    out = r.render_persistent(spp=SPP, interrupt=interrupt_at(3))
    # an interrupt callable that never fires drains step by step, through
    # the shrinks
    r.render_persistent(spp=SPP, resume={"final_sum": out[1],
                                         "pending": out[2],
                                         "ranges": out[3]},
                        interrupt=lambda: False)
    assert 8192 in seen and 2048 in seen


@pytest.mark.parametrize("writer", ["craytpu", "craytpu_torch"])
def test_checkpoint_resumes_across_packages(pair, writer, tmp_path,
                                            monkeypatch):
    """A checkpoint written by one package resumes in the other, within
    the golden thresholds of the other's uninterrupted render."""
    monkeypatch.setenv("CRAYTPU_POOL_K", "1")
    jr, tr = pair["jr"], pair["tr"]
    src, dst = (jr, tr) if writer == "craytpu" else (tr, jr)
    save = (jckpt if writer == "craytpu" else checkpoint).save_persistent
    load = (checkpoint if writer == "craytpu" else jckpt).load_persistent
    _, final_sum, pending, ranges = src.render_persistent(
        spp=SPP, interrupt=interrupt_at(3))
    assert len(pending) > 0
    p = str(tmp_path / "c.npz")
    save(p, np.asarray(final_sum), pending, ranges, SPP,
         (src.height, src.width))
    resume, total, shape = load(p)
    assert total == SPP and shape == (dst.height, dst.width)
    got = np.asarray(dst.render_persistent(spp=SPP, resume=resume))
    assert_golden_close(got, pair["tref"] if dst is tr else pair["jref"])


def test_nee_renderer_builds():
    """WavefrontRenderer(nee=True) builds, with the scene's light table."""
    r = port_renderer(nee=True)
    assert r.nee and r.nee_fn is not None
    assert not port_renderer().nee


def test_tile_rays_from_environment(monkeypatch):
    monkeypatch.setenv("CRAYTPU_TILE_RAYS", "4096")
    assert port_renderer().tile_rays == 4096
    assert port_renderer(tile_rays=2048).tile_rays == 2048
