"""The port's next-event estimation on the CPU: the light table against
craytpu's, the three paths (persistent pool, per-pass render, summed
fixed-depth trace passes) against one another, the image against
craytpu's NEE image, and the NEE gradient against finite differences
and against craytpu's.

Tolerances: the port's paths trace the same per-(pixel, pass) streams
and differ only in accumulation order, rtol=1e-5, atol=1e-6 (as
tests/test_nee.py holds craytpu's). Across the two packages images are
held to the golden thresholds of craytpu/utils/golden.py:26-27 (diffuse
scatter calls sin/cos, whose libm results differ), gradients to a
relative L2 error of 2e-2; the FD check is test_nee.py's rtol=2e-3."""

import copy
import json
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.scene.compile import (compile_scene, scene_arrays,
                                         scene_from_arrays)
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from craytpu_torch.utils import golden
from tests.test_nee import GRAD_SCENE
from tests.test_torch_scene import assert_same, jax_arrays

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def scaled_scene():
    """GRAD_SCENE plus a non-uniformly scaled emitter, which the light
    table drops (its emission still arrives along BSDF paths)."""
    sc = copy.deepcopy(GRAD_SCENE)
    sc["scene"]["primitives"].append(
        {"type": "sphere", "radius": 0.1,
         "color": {"r": 0.5, "g": 1.0, "b": 0.5}, "bsdf": "emissive",
         "intensity": 300.0,
         "instances": [{"transforms": [
             {"type": "scale", "x": 3.0, "y": 1.0, "z": 1.0},
             {"type": "translate", "x": -2.5, "y": 2.0, "z": -1.5}]}]})
    return sc


def lamp_scene(d):
    """A diffuse sphere lit by an emissive, rotated triangle mesh (the
    table's mesh branch), written to d."""
    (d / "lamp.obj").write_text(
        "mtllib lamp.mtl\n"
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "usemtl glow\n"
        "f 1 2 3\nf 1 3 4\n")
    (d / "lamp.mtl").write_text("newmtl glow\nKd 0 0 0\nKe 6 5 4\n")
    return json.dumps({
        "renderer": {"samples": 2, "bounces": 3, "width": 24, "height": 16},
        "camera": {"FOV": 70.0, "transforms": [
            {"type": "translate", "x": 0, "y": 0, "z": -4}]},
        "scene": {
            "ambientColor": {"down": {"r": 0.1, "g": 0.1, "b": 0.1},
                             "up": {"r": 0.1, "g": 0.1, "b": 0.1}},
            "primitives": [
                {"type": "sphere", "radius": 1.0,
                 "color": {"r": 0.7, "g": 0.3, "b": 0.2},
                 "bsdf": "lambertian",
                 "instances": [{"transforms": [
                     {"type": "translate", "x": 0, "y": 0, "z": 0}]}]}],
            "meshes": [{"fileName": "lamp.obj", "instances": [
                {"transforms": [{"type": "rotateX", "degrees": 20},
                                {"type": "translate", "x": 0, "y": 2.5,
                                 "z": -0.5}]}]}]}})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("nee")
    return {"grad": (json.dumps(GRAD_SCENE), ""),
            "scaled": (json.dumps(scaled_scene()), ""),
            "lamp": (lamp_scene(d), str(d) + "/")}


LIGHT_KEYS = ("lights.kind", "lights.mat", "lights.p0", "lights.e1",
              "lights.e2", "lights.n", "lights.area", "lights_mat_mask",
              "mat_nee", "diffuse_color_ir")


@pytest.mark.parametrize("name", ["grad", "scaled", "lamp"])
def test_light_table_equals_craytpu(scenes, name):
    text, path = scenes[name]
    jcs = jcompile(jload_buf(text, path))
    cs = compile_scene(load_scene_from_buf(text, path), "cpu")
    want = jax_arrays(jcs)
    assert_same({k: want[k] for k in LIGHT_KEYS}, scene_arrays(cs))
    assert cs.lights is not None and cs.mat_nee.any()
    if name == "scaled":
        assert cs.lights.count == 1
        assert (~cs.lights_mat_mask).sum() >= 1
    if name == "lamp":
        assert cs.lights.count == 2 and (cs.lights.kind == 0).all()


def grid(r):
    return (torch.from_numpy(np.tile(np.arange(r.width, dtype=np.int32),
                                     r.height)),
            torch.from_numpy(np.repeat(np.arange(r.height, dtype=np.int32),
                                       r.width)))


def trace_frame(r, trace, spp):
    """Mean of the trace's passes 0..spp-1 as an (H, W, 4) frame."""
    xs, ys = grid(r)
    with torch.no_grad():
        img = sum(trace(r.cscene.params, xs, ys, p, spp) for p in range(spp))
    return (img / spp).reshape(r.height, r.width, 4).numpy()


@pytest.mark.parametrize("name", ["grad", "scaled", "lamp"])
def test_nee_paths_agree(scenes, name):
    """The persistent pool (NEE flag in bit 16 of the path depth), the
    per-pass render and the summed fixed-depth trace passes, plain and
    compacted, give the same NEE image."""
    cs = compile_scene(load_scene_from_buf(*scenes[name]), "cpu")
    spp = 4
    r = WavefrontRenderer(cs, nee=True)
    depth = r.max_depth
    want = trace_frame(r, r.make_trace_fn(depth, nee=True), spp)
    xs, ys = grid(r)
    sched = r.census_schedule(xs, ys, spp=spp, depth=depth, min_width=64)
    comp = trace_frame(r, r.make_trace_fn(
        depth, nee=True, compaction=sched, sort="boundary",
        remat="segment_hits"), spp)
    np.testing.assert_allclose(comp, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r.render_persistent(spp=spp), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r.render(spp=spp), want, rtol=RTOL,
                               atol=ATOL)
    plain = WavefrontRenderer(cs).render(spp=spp)
    assert not np.allclose(plain, want)   # NEE changed the estimator


@pytest.mark.parametrize("name", ["grad", "scaled", "lamp"])
def test_nee_image_matches_craytpu(scenes, name):
    text, path = scenes[name]
    jcs = jcompile(jload_buf(text, path))
    want = np.asarray(JaxRenderer(jcs, nee=True).render(spp=4))
    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    got = WavefrontRenderer(cs, nee=True).render(spp=4)
    assert np.isfinite(got).all() and got[..., :3].max() > 0
    ok, within, mean_abs = golden.compare_u8(golden.srgb_u8(got),
                                             golden.srgb_u8(want))
    assert ok, (within, mean_abs)


def nee_loss(r, xs, ys):
    trace = r.make_trace_fn(depth=3, nee=True)

    def loss(params):
        return trace(params, xs, ys, 0, 1)[:, :3].mean()
    return loss


def test_nee_gradient_matches_fd():
    """test_nee.py's check: the NEE gradient of the emitter's red emission
    (the shadow-ray estimate differentiates through Le) against FD."""
    cs = compile_scene(load_scene_from_buf(json.dumps(GRAD_SCENE)), "cpu")
    r = WavefrontRenderer(cs)
    loss = nee_loss(r, *grid(r))
    em = cs.params.emission.clone().requires_grad_()
    loss(replace(cs.params, emission=em)).backward()
    k = int(torch.argmax(cs.params.emission[:, 0]))
    eps = 1e-2

    def at(v):
        e2 = cs.params.emission.clone()
        e2[k, 0] = v
        with torch.no_grad():
            return float(loss(replace(cs.params, emission=e2)))
    e0 = float(cs.params.emission[k, 0])
    fd = (at(e0 + eps) - at(e0 - eps)) / (2 * eps)
    assert fd != 0.0
    np.testing.assert_allclose(float(em.grad[k, 0]), fd, rtol=2e-3,
                               atol=1e-6)


def test_nee_grads_near_craytpu():
    jcs = jcompile(jload_buf(json.dumps(GRAD_SCENE)))
    jr = JaxRenderer(jcs)
    jt = jr.make_trace_fn(depth=3, nee=True)
    xs, ys = grid(jr)
    jx, jy = jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy())
    jg = jax.grad(lambda p: jnp.mean(jt(p, jx, jy, jnp.int32(0),
                                        jnp.int32(1))[:, :3]))(jcs.params)

    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    p = replace(cs.params, **{f.name: getattr(cs.params, f.name).clone()
                              .requires_grad_() for f in fields(cs.params)})
    nee_loss(WavefrontRenderer(cs), xs, ys)(p).backward()
    for k, want in jg._asdict().items():
        want = np.asarray(want, np.float64)
        g = getattr(p, k).grad
        got = np.zeros_like(want) if g is None else g.numpy()
        if np.abs(want).max() == 0:
            np.testing.assert_array_equal(got, 0.0, err_msg=k)
        else:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= 2e-2, (k, err)
