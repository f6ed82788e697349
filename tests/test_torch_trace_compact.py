"""The port's compaction-scheduled differentiable trace on the CPU:
census_schedule against craytpu's, and the compacted trace against the
port's plain fixed-depth trace for every remat and sort mode (the same
paths run with the same sample streams; compaction only packs live
lanes, so image and gradients agree up to summation order).

Tolerances are those of tests/test_trace_compact.py: compacted against
plain, image rtol=1e-6, atol=1e-7 (the per-segment radiance flush
reassociates sums) and gradients rtol=2e-4, atol=1e-7; sorted against
unsorted compacted, image equal and gradients rtol=2e-5, atol=1e-7 (the
per-lane cotangents are the same, only the order of the cross-lane
sums changes)."""

import os
from dataclasses import fields, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import traverse as trv
from craytpu_torch.scene.compile import scene_from_arrays
from tests.test_torch_scene import jax_arrays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "assets", "entry_scene.json")
DEPTH = 10
PASS, SPP = 1, 3


@pytest.fixture(scope="module")
def setup():
    """craytpu's compiled entry_scene and the port's scene on the same
    arrays, with every pixel of the 96x64 frame."""
    jcs = jcompile(jload(SCENE))
    r = WavefrontRenderer(scene_from_arrays(jax_arrays(jcs), "cpu"))
    xs = torch.from_numpy(np.tile(np.arange(r.width, dtype=np.int32),
                                  r.height))
    ys = torch.from_numpy(np.repeat(np.arange(r.height, dtype=np.int32),
                                    r.width))
    return jcs, r, xs, ys


@pytest.fixture(scope="module")
def sched(setup):
    _, r, xs, ys = setup
    return r.census_schedule(xs, ys, spp=SPP, depth=DEPTH, min_width=64)


def run(trace, params, xs, ys):
    """(image, gradient tables) of the cos-weighted loss of
    tests/test_trace_compact.py."""
    p = replace(params, **{f.name: getattr(params, f.name).clone()
                           .requires_grad_() for f in fields(params)})
    img = trace(p, xs, ys, PASS, SPP)
    w = torch.cos(torch.arange(img.shape[0], dtype=torch.float32))
    (img[:, :3] * w[:, None]).mean().backward()
    g = {f.name: getattr(p, f.name).grad for f in fields(p)}
    return img.detach().numpy(), {k: (v if v is not None else
                                      torch.zeros_like(getattr(params, k)))
                                  .numpy() for k, v in g.items()}


@pytest.fixture(scope="module")
def plain(setup):
    _, r, xs, ys = setup
    return run(r.make_trace_fn(DEPTH), r.cscene.params, xs, ys)


@pytest.fixture(scope="module")
def base(setup, sched):
    """The unsorted compacted trace with segment remat."""
    _, r, xs, ys = setup
    return run(r.make_trace_fn(DEPTH, remat="segment", compaction=sched),
               r.cscene.params, xs, ys)


@pytest.mark.parametrize("quant", [None, 64])
def test_census_schedule_equals_craytpu(setup, quant):
    jcs, r, xs, ys = setup
    kw = dict(spp=SPP, depth=DEPTH, min_width=64)
    if quant:
        kw.update(passes=[PASS], safety=1.01, quant=quant, shrink_ratio=0.5)
    want = JaxRenderer(jcs).census_schedule(jnp.asarray(xs.numpy()),
                                            jnp.asarray(ys.numpy()), **kw)
    got = r.census_schedule(xs, ys, **kw)
    assert got == [(int(a), int(b)) for a, b in want]
    assert got[0] == (0, xs.shape[0]) and len(got) >= 2
    widths = [w for _, w in got]
    assert widths == sorted(widths, reverse=True)
    if quant is None:
        assert all(w & (w - 1) == 0 for w in widths[1:])


@pytest.mark.parametrize("remat", [False, True, "segment", "segment_hits"])
def test_compacted_matches_plain(setup, sched, plain, remat):
    _, r, xs, ys = setup
    img, g = run(r.make_trace_fn(DEPTH, remat=remat, compaction=sched),
                 r.cscene.params, xs, ys)
    np.testing.assert_allclose(img, plain[0], rtol=1e-6, atol=1e-7)
    assert np.abs(plain[1]["colors"]).max() > 0
    for k, v in plain[1].items():
        np.testing.assert_allclose(g[k], v, rtol=2e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("remat", [False, True, "segment", "segment_hits"])
@pytest.mark.parametrize("sort", [True, "boundary"])
def test_sorted_matches_unsorted(setup, sched, base, remat, sort):
    _, r, xs, ys = setup
    img, g = run(r.make_trace_fn(DEPTH, remat=remat, compaction=sched,
                                 sort=sort), r.cscene.params, xs, ys)
    np.testing.assert_array_equal(img, base[0])
    for k, v in base[1].items():
        np.testing.assert_allclose(g[k], v, rtol=2e-5, atol=1e-7, err_msg=k)


def test_exact_census_bench_config(setup, plain):
    """The chip's fwd+bwd configuration (an exact census of the rendered
    pass, quant widths, shrink-gated boundaries, segment_hits, boundary
    sort) reproduces the plain trace with no dropped path."""
    _, r, xs, ys = setup
    sched = r.census_schedule(xs, ys, spp=SPP, depth=DEPTH, passes=[PASS],
                              safety=1.01, min_width=64, quant=64,
                              shrink_ratio=0.5)
    assert len(sched) >= 2
    trace = r.make_trace_fn(DEPTH, remat="segment_hits", compaction=sched,
                            sort="boundary")
    with torch.no_grad():
        img = trace(r.cscene.params, xs, ys, PASS, SPP).numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, plain[0], rtol=3e-7, atol=1e-6)


def test_schedule_overflow_poisons(setup):
    _, r, xs, ys = setup
    trace = r.make_trace_fn(DEPTH, compaction=[(0, xs.shape[0]), (1, 64)])
    with torch.no_grad():
        assert torch.isnan(trace(r.cscene.params, xs, ys, PASS, SPP)).all()


@pytest.mark.parametrize("sort", [True, "boundary"])
def test_sort_without_compaction_raises(setup, sort):
    _, r, _, _ = setup
    with pytest.raises(ValueError, match="compaction"):
        r.make_trace_fn(DEPTH, sort=sort)


def count_searches(monkeypatch):
    calls = []
    closest_hit = trv.closest_hit

    def counted(*a, **k):
        calls.append(1)
        return closest_hit(*a, **k)
    monkeypatch.setattr(trv, "closest_hit", counted)
    return calls


@pytest.mark.parametrize("compacted", [False, True])
def test_segment_hits_replays_the_search(setup, sched, monkeypatch,
                                         compacted):
    """remat="segment_hits": fwd+bwd calls the closest-hit search as often
    as the forward alone; "segment" calls it again in the recompute."""
    _, r, xs, ys = setup
    calls = count_searches(monkeypatch)
    kw = dict(compaction=sched, sort="boundary") if compacted else {}
    with torch.no_grad():
        r.make_trace_fn(DEPTH, remat="segment_hits", **kw)(
            r.cscene.params, xs, ys, PASS, SPP)
    n_fwd = len(calls)
    assert n_fwd > 0
    for remat, more in (("segment_hits", False), ("segment", True)):
        calls.clear()
        run(r.make_trace_fn(DEPTH, remat=remat, **kw), r.cscene.params, xs,
            ys)
        assert (len(calls) > n_fwd) if more else (len(calls) == n_fwd), \
            (remat, len(calls), n_fwd)
