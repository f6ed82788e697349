"""The port's forward dispatches in the form its CUDA graphs capture
(craytpu_torch/utils/graphs.py: static pools written back in place,
per-call numbers as 0-d device tensors), run eagerly on the CPU:

(a) every dispatch (pool step, prime, refill, flush, shrink, the trace's
    init, multi-step and compaction) runs under a capture guard
    (tests/torch_capture_guard.py) through the persistent and the
    per-pass render without tripping it, with NEE on and off, the RANDOM
    and HALTON samplers and the walk and dense traversals; a step that
    calls .item() or torch.tensor trips it;
(b) each dispatch is bit-equal to craytpu's jitted counterpart on the
    same pool state, made from a numpy seed, on a scene whose materials
    call no transcendental function (a smooth metal cube and sphere, a
    smooth glass sphere, a gradient background): the whole bounce is
    then exact in both packages;
(c) the radical inverse over a fixed count of digit steps is bit-equal
    to craytpu's data-dependent loop over passes 0..4095 in every base;
(d) a flush with duplicate lanes (two passes of one pixel) equals
    craytpu's .at[].add bit for bit.

Tolerances: none; every comparison is bit for bit (integers equal)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.ops import pcg as jpcg
from craytpu.ops import sampler as jsmp
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.models import wavefront_pt as wpt
from craytpu_torch.models.wavefront_pt import Pool, WavefrontRenderer
from craytpu_torch.ops import pcg
from craytpu_torch.ops import sampler as smp
from craytpu_torch.scene.compile import compile_scene, scene_from_arrays
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_torch_detmath import assert_bits
from tests.test_torch_scene import jax_arrays
from tests.torch_capture_guard import (CaptureError, CaptureGuard,
                                       kernels_unchecked)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
ENTRY = os.path.join(ASSETS, "entry_scene.json")


# ----------------------------------------------------------------------
# (a) the capture guard
# ----------------------------------------------------------------------

class GuardedDispatch:
    """Stands in for a renderer's GraphCache: the first call of a key runs
    unguarded (the card's warm-up), every later call under the guard (the
    card's capture; its replays run what was captured). `checked`: the
    kinds of dispatch that ran guarded."""
    on = False

    def __init__(self, guard: CaptureGuard):
        self.guard = guard
        self.warm: set = set()
        self.checked: set = set()

    def context(self, ctx) -> None:
        pass

    def __call__(self, key, fn, reads=()) -> None:
        if key not in self.warm:
            self.warm.add(key)
            fn()
            return
        with self.guard:
            fn()
        self.checked.add(key[0])


KINDS = {"pool", "prime", "fpr", "flush", "shrink", "init", "multi",
         "compact"}


def run_dispatches(r, spp: int):
    """Every dispatch of the table in utils/graphs.py, twice over, in the
    order the persistent loop and trace_batch call them: prime, step,
    refill, step, shrink, the drain's steps, the final flush, and a
    trace_batch (its init, multi-step and compaction). Returns the
    framebuffer sum."""
    B = r.tile_rays
    fb = torch.zeros((r.width * r.height, 4))
    xs, ys, _, T = r._pixel_schedule
    with r._forward(spp):
        for _ in range(2):
            pool = r._prime_dev(B, 0, 0, B, spp)
            pool, _ = r._pool_step(1, pool)
            pool = r._flush_pack_refill(B, 1, B // 4, fb, pool, 7, 0,
                                        B // 4, spp)
            pool, _ = r._pool_step(2, pool)
            pool = r._pack_shrink(B // 4, fb, pool)
            pool, _ = r._drain_all(pool)
            r._final_flush(fb, pool)
            r.trace_batch(xs[:T], ys[:T], 1, spp)
    return fb


@pytest.mark.parametrize("traversal,kind,nee", [
    ("auto", smp.RANDOM, False), ("auto", smp.HALTON, True),
    ("dense", smp.RANDOM, True), ("dense", smp.HALTON, False)])
def test_every_dispatch_is_capture_safe(traversal, kind, nee, monkeypatch):
    """run_dispatches on entry_scene at 32x32 (a pool of 1,024 lanes, 3
    bounces), every dispatch after its key's first call under the
    guard."""
    monkeypatch.setenv("CRAYTPU_TRAVERSAL", traversal)
    r = WavefrontRenderer(compile_scene(load_scene_from_file(
        ENTRY, {"width": 32, "height": 32}), "cpu"), kind=kind, nee=nee,
        bounces=3)
    assert r.nee_fn is not None and r.tile_rays == 1024
    guard = CaptureGuard()
    r.graphs = GuardedDispatch(guard)
    with kernels_unchecked(guard):
        fb = run_dispatches(r, 2)
    assert torch.isfinite(fb).all() and fb[:, :3].max() > 0
    assert r.graphs.checked == KINDS, r.graphs.checked


@pytest.mark.parametrize("bad", ["item", "tensor"])
def test_guard_trips_on_a_host_read_or_copy(bad):
    """Mutations: a step that reads a value on the host (.item()) or
    copies host data (torch.tensor) fails under the guard."""
    r = WavefrontRenderer(compile_scene(load_scene_from_file(
        ENTRY, {"width": 32, "height": 24}), "cpu"), tile_rays=1024)
    bounces = r._bounces

    def broken(k, o, *a):
        if bad == "item":
            o.sum().item()
        else:
            torch.tensor(0.5)
        return bounces(k, o, *a)
    r._bounces = broken
    guard = CaptureGuard()
    r.graphs = GuardedDispatch(guard)
    want = "_local_scalar_dense" if bad == "item" else "lift_fresh"
    with kernels_unchecked(guard), pytest.raises(CaptureError, match=want):
        r.render_persistent(spp=2)


# ----------------------------------------------------------------------
# (b) each dispatch against craytpu's jitted counterpart
# ----------------------------------------------------------------------

EXACT_SCENE = {
    "renderer": {"samples": 2, "bounces": 6, "width": 24, "height": 16,
                 "tileWidth": 8, "tileHeight": 8},
    "camera": {"FOV": 60.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0.4, "z": -3.0}]},
    "scene": {
        "ambientColor": {"down": {"r": 1.0, "g": 0.9, "b": 0.8},
                         "up": {"r": 0.4, "g": 0.6, "b": 1.0}},
        "primitives": [
            {"type": "sphere", "radius": 0.5,
             "color": {"r": 1.0, "g": 1.0, "b": 1.0}, "bsdf": "glass",
             "IOR": 1.5, "roughness": 0.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": -0.9, "y": 0.0, "z": 0.0}]}]},
            {"type": "sphere", "radius": 0.4,
             "color": {"r": 0.8, "g": 0.7, "b": 0.9}, "bsdf": "metal",
             "roughness": 0.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": 1.0, "y": 0.2, "z": 0.3}]}]}],
        "meshes": [{"fileName": "cube.obj", "bsdf": "metal",
                    "roughness": 0.0, "instances": [{"transforms": [
                        {"type": "scale", "x": 0.6, "y": 0.6, "z": 0.6},
                        {"type": "rotateY", "degrees": 30},
                        {"type": "translate", "x": 0.1, "y": -0.5,
                         "z": 0.8}]}]}]}}
B = 512
SPP = 2


@pytest.fixture(scope="module")
def exact():
    """craytpu's renderer on EXACT_SCENE and the port's on the same
    arrays, for each sampler kind."""
    jcs = jcompile(jload_buf(json.dumps(EXACT_SCENE), ASSETS + "/"))
    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    return {kind: (JaxRenderer(jcs, kind=kind, tile_rays=B),
                   WavefrontRenderer(cs, kind=kind, tile_rays=B))
            for kind in (smp.RANDOM, smp.HALTON)}


def seeded_pool(r, seed: int, n: int = B) -> dict:
    """A pool state of n lanes from a numpy seed: rays in and around the
    scene, throughputs, depths (some past the Russian-roulette start),
    about a fifth of the lanes dead, radiance not yet flushed, lane ids
    with repeats (passes of one pixel), sampler states."""
    rng = np.random.default_rng(seed)
    bb = r.cscene.geom.node_bounds[0].numpy()
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    f32, i32 = np.float32, np.int32
    return dict(
        o=rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo),
                      (n, 3)).astype(f32),
        d=(d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32),
        weight=rng.uniform(0.05, 1.0, (n, 4)).astype(f32),
        alive=rng.random(n) < 0.8,
        lane=rng.integers(0, r.width * r.height, n).astype(i32),
        lpass=rng.integers(0, SPP, n).astype(i32),
        pdepth=rng.integers(0, 6, n).astype(i32),
        delta=rng.uniform(0.0, 1.0, (n, 4)).astype(f32),
        pcg_hi=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        pcg_lo=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        rnd_offset=rng.random(n).astype(f32),
        curr_prime=rng.integers(0, 9, n).astype(i32),
        curr_pass=rng.integers(0, SPP, n).astype(i32),
        max_passes=np.full(n, SPP, i32))


SAMPLER = ("pcg_hi", "pcg_lo", "rnd_offset", "curr_prime", "curr_pass",
           "max_passes")


def port_pool(st: dict) -> Pool:
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    s = smp.SamplerState(*(t[k].to(torch.int64) if k.startswith("pcg")
                           else t[k] for k in SAMPLER))
    return Pool(t["o"], t["d"], t["weight"], s, t["alive"], t["lane"],
                t["lpass"], t["pdepth"], t["delta"])


def jax_state(st: dict):
    return jsmp.SamplerState(*(jnp.asarray(st[k]) for k in SAMPLER))


def same(got, want, name: str) -> None:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.float32:
        assert_bits(got, want, name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def same_pool(pool: Pool, want: tuple, kind: str, what: str) -> None:
    """pool against craytpu's (o, d, weight, s, alive, lane, lpass,
    pdepth, delta); for RANDOM only the PCG fields of s (craytpu's pool
    permutes drop the others)."""
    o, d, weight, s, alive, lane, lpass, pdepth, delta = want
    for name, a, b in (("o", pool.o, o), ("d", pool.d, d),
                       ("weight", pool.weight, weight),
                       ("alive", pool.alive, alive), ("lane", pool.lane, lane),
                       ("lpass", pool.lpass, lpass),
                       ("pdepth", pool.pdepth, pdepth),
                       ("delta", pool.delta, delta)):
        same(a, b, f"{what} {name}")
    for f in (SAMPLER[:2] if kind == smp.RANDOM else SAMPLER):
        same(getattr(pool.s, f), getattr(s, f), f"{what} s.{f}")


def scene_args(jr):
    cs = jr.cscene
    return cs.params, cs.geom, cs.shade, cs.mat_graph


@pytest.mark.parametrize("kind", [smp.RANDOM, smp.HALTON])
def test_pool_step_equals_craytpu(exact, kind):
    jr, r = exact[kind]
    st = seeded_pool(r, 1)
    k = 3
    with pcg.pass_bound(SPP):
        pool, n_live = r._pool_step(k, port_pool(st))
    want = jr._pool_step(k)(*scene_args(jr), st["o"], st["d"], st["weight"],
                            jax_state(st), st["alive"], st["pdepth"],
                            st["delta"])
    o, d, weight, s, alive, pdepth, delta, n = want
    same_pool(pool, (o, d, weight, s, alive, st["lane"], st["lpass"],
                     pdepth, delta), smp.HALTON, "pool step")
    assert int(n_live) == int(n) and 0 < int(n) < B


@pytest.mark.parametrize("kind", [smp.RANDOM, smp.HALTON])
def test_prime_equals_craytpu(exact, kind):
    jr, r = exact[kind]
    npix = r.width * r.height
    qpix, qpass, take_n = npix - 100, 0, 300
    pool = r._prime_dev(B, qpix, qpass, take_n, SPP)
    fo, fd, fs, flane, fpass, falive = jr._prime_dev(B)(
        jnp.int32(qpix), jnp.int32(qpass), jnp.int32(take_n),
        jnp.int32(SPP))
    same_pool(pool, (fo, fd, np.ones((B, 4), np.float32), fs, falive,
                     flane, fpass, np.zeros(B, np.int32),
                     np.zeros((B, 4), np.float32)), smp.HALTON, "prime")


# (m, Q, live share): a power of two within half the pool, and the
# pool loop's sizes since it refills to the newest count: an m that is no
# power of two, with m * Q above B / 2
@pytest.mark.parametrize("m,qdiv,live", [(2, 8, 0.4), (12, 16, 0.2)])
def test_flush_pack_refill_equals_craytpu(exact, m, qdiv, live):
    jr, r = exact[smp.RANDOM]
    st = seeded_pool(r, 2)
    st["alive"][:] = np.random.default_rng(3).random(B) < live
    npix = r.width * r.height
    final = np.random.default_rng(4).uniform(0, 2, (npix, 4)).astype(
        np.float32)
    Q = B // qdiv
    # the tail the refill clears is dead, as the pool loop's count ensures
    assert st["alive"].sum() <= B - m * Q
    qpix, qpass, take_n = 17, 1, 100
    fin = torch.from_numpy(final.copy())
    pool = r._flush_pack_refill(B, m, Q, fin, port_pool(st), qpix, qpass,
                                take_n, SPP)
    out = jr._flush_pack_refill(B, m, Q)(
        jnp.asarray(final), st["o"], st["d"], st["weight"], jax_state(st),
        st["alive"], st["lane"], st["lpass"], st["pdepth"], st["delta"],
        jnp.int32(qpix), jnp.int32(qpass), jnp.int32(take_n),
        jnp.int32(SPP))
    same(fin, out[0], "refill final")
    o, d, weight, s, alive, lane, lpass, pdepth, delta = out[1:]
    same_pool(pool, (o, d, weight, s, alive, lane, lpass, pdepth, delta),
              smp.RANDOM, "refill")


def test_pack_shrink_and_final_flush_equal_craytpu(exact):
    jr, r = exact[smp.RANDOM]
    st = seeded_pool(r, 5)
    st["alive"][:] = np.random.default_rng(6).random(B) < 0.15
    npix = r.width * r.height
    final = np.random.default_rng(7).uniform(0, 2, (npix, 4)).astype(
        np.float32)
    Bn = B // 4
    fin = torch.from_numpy(final.copy())
    pool = r._pack_shrink(Bn, fin, port_pool(st))
    out = jr._pack_shrink(Bn)(
        jnp.asarray(final), st["o"], st["d"], st["weight"], jax_state(st),
        st["alive"], st["lane"], st["lpass"], st["pdepth"], st["delta"])
    same(fin, out[0], "shrink final")
    o, d, weight, s, alive, lane, lpass, pdepth, delta = out[1:]
    same_pool(pool, (o, d, weight, s, alive, lane, lpass, pdepth, delta),
              smp.RANDOM, "shrink")
    # the shrunk pool's final flush (craytpu's _final_flush)
    r._final_flush(fin, pool)
    want = jr._final_flush()(out[0], lane, delta, alive)
    same(fin, want, "final flush")


@pytest.mark.parametrize("kind", [smp.RANDOM, smp.HALTON])
def test_multi_step_and_compact_equal_craytpu(exact, kind):
    """The per-pass trace's dispatch (k bounces, the radiance deltas
    added by lane into the batch buffer) and its compaction."""
    jr, r = exact[kind]
    st = seeded_pool(r, 8)
    st["lane"] = np.random.default_rng(9).permutation(B).astype(np.int32)
    st["delta"][:] = 0.0
    final = np.random.default_rng(10).uniform(0, 1, (B, 4)).astype(
        np.float32)
    k = 4
    fin = torch.from_numpy(final.copy())
    with pcg.pass_bound(SPP):
        pool, n_live = r._multi_step(k, port_pool(st), fin)
    out = jr._multi_step(k)(*scene_args(jr), st["o"], st["d"], st["weight"],
                            jax_state(st), st["alive"], st["pdepth"],
                            jnp.asarray(final), st["lane"])
    o, d, weight, s, alive, pdepth, final_full, n = out
    same(fin, final_full, "multi final")
    same_pool(pool, (o, d, weight, s, alive, st["lane"], st["lpass"],
                     pdepth, pool.delta), smp.HALTON, "multi")
    n_alive = int(n)
    assert int(n_live) == n_alive and 0 < n_alive < B // 4
    Bn = B // 4
    packed = r._compact(pool, Bn)
    _, compact = jr._make_compact()
    jo, jd, jw, js, jl, jp = jax.jit(compact, static_argnums=(7,))(
        o, d, weight, s, alive, jnp.asarray(st["lane"]), pdepth, Bn)
    same_pool(packed, (jo, jd, jw, js, np.arange(Bn) < n_alive, jl,
                       packed.lpass, jp, packed.delta), smp.HALTON,
              "compact")


# ----------------------------------------------------------------------
# (c) the radical inverse; (d) the flush with repeated lanes
# ----------------------------------------------------------------------

def test_radical_inverse_fixed_steps_equal_craytpu():
    """Passes 0..4095 in bases 2..16 and the Halton primes: 12 digit
    steps (pcg.pass_bound(4096)) against craytpu's while_loop."""
    passes = np.arange(4096, dtype=np.int32)
    bases = np.arange(2, 17, dtype=np.int32)
    p = np.repeat(passes, bases.size)
    b = np.tile(bases, passes.size)
    want = jax.jit(jpcg.radical_inverse_dyn)(jnp.asarray(p), jnp.asarray(b))
    with pcg.pass_bound(4096):
        assert pcg.current_digit_steps() == 12
        got = pcg.radical_inverse_dyn(torch.from_numpy(p),
                                      torch.from_numpy(b))
    assert_bits(got, want, "radical inverse")
    # the default count (any int32 pass) gives the same values
    assert_bits(pcg.radical_inverse_dyn(torch.from_numpy(p),
                                        torch.from_numpy(b)), want,
                "radical inverse, 31 steps")


def test_flush_with_repeated_lanes_equals_craytpu():
    """Two (and more) passes of one pixel in one flush, with values whose
    sum depends on the order of the adds (1 + 2^-24 + 2^-24 rounds to 1
    one after the other, to 1 + 2^-23 the other way)."""
    rng = np.random.default_rng(11)
    npix, n = 64, 1024
    final = rng.uniform(0, 1, (npix, 4)).astype(np.float32)
    final[:8] = 1.0
    lane = rng.integers(8, npix, n).astype(np.int32)
    delta = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    lane[:32] = np.repeat(np.arange(8, dtype=np.int32), 4)
    delta[:32] = np.float32(2.0 ** -24)
    want = jax.jit(lambda f, i, v: f.at[i].add(v))(final, lane, delta)
    fin = torch.from_numpy(final.copy())
    wpt._scatter_add(fin, torch.from_numpy(lane), torch.from_numpy(delta))
    assert_bits(fin, want, "flush")
    assert (np.asarray(want)[:8] == 1.0).all()
