"""The port's edge-aware silhouette gradients (craytpu_torch/ops/
edge_grad.py) on the CPU (the kernels' plain versions), against craytpu's
ops/edge_grad.py on the same scene arrays (scene_from_arrays), one pass
at a tiny size each.

Tolerances (relative L2 error of the tri_packed gradient for a seeded
image cotangent): 1e-4 for the primary term on a single triangle against
a constant ambient (every side radiance there is deterministic); 2e-2
for the primary term on a mesh-over-mesh occluder with a gradient
background, and for the secondary term, whose side rays scatter diffusely
(sin/cos, whose libm results differ between the packages). Edge tables
are equal. The finite-difference validation runs on the card
(chip_smoke.py phase 8); none runs here.

craytpu's secondary term is NaN for every triangle as soon as one primary
ray of the frame misses: its miss lanes' hit points are NaN and reach each
edge's gradient as 0 * NaN. The port gives such lanes the shading
record's stand-ins; it is held to craytpu's estimator with the same
stand-ins fed in through its renderer's isect (craytpu is unchanged)."""

import json
import os
from dataclasses import fields
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.ops import edge_grad as jeg
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import edge_grad as eg
from craytpu_torch.scene.compile import scene_from_arrays
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from tests import test_edge_occluder, test_edge_secondary
from tests.test_grad import SCENE as SPHERES_SCENE
from tests.test_torch_grad import leaf_params, rel_l2
from tests.test_torch_scene import jax_arrays
from tests.test_vertex_grad import FLAT_SCENE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets") + "/"
W, H = 16, 12
DEPTH = 2
PASS, SPP = 3, 8

_QUAD = ("v -1.4 -1.1 0.8\nv 1.4 -1.1 0.8\nv 1.4 1.1 0.8\nv -1.4 1.1 0.8\n"
         "vt 0.5 0.5\nvn 0 0 -1\nusemtl bright\n"
         "f 1/1/1 2/1/1 3/1/1\nf 1/1/1 3/1/1 4/1/1\n")
_BRIGHT = "newmtl bright\nKd 0.85 0.85 0.85\nillum 2\n"
# the OBJ/MTL files of tests/test_edge_grad.py, test_edge_occluder.py and
# test_edge_secondary.py
FILES = {
    "tri": {"tri.obj": "mtllib tri.mtl\nv -0.8 -0.6 0.0\nv 0.8 -0.6 0.0\n"
                       "v 0.0 0.7 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "tri.mtl": "newmtl dark\nKd 0.12 0.12 0.12\nillum 2\n"},
    "occ": {"quad.obj": "mtllib quad.mtl\n" + _QUAD, "quad.mtl": _BRIGHT,
            "occ.obj": "mtllib occ.mtl\nv -0.55 -0.4 0.0\nv 0.55 -0.4 0.0\n"
                       "v 0.0 0.5 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "occ.mtl": "newmtl dark\nKd 0.08 0.08 0.08\nillum 2\n"},
    "sec": {"wall.obj": "mtllib wall.mtl\n" + _QUAD, "wall.mtl": _BRIGHT,
            "occ.obj": "mtllib occ.mtl\nv 1.4 -0.8 0.0\nv 2.4 -0.8 0.0\n"
                       "v 1.4 0.9 0.0\nvt 0.5 0.5\nvn 0 0 -1\nusemtl dark\n"
                       "f 1/1/1 2/1/1 3/1/1\n",
            "occ.mtl": "newmtl dark\nKd 0.05 0.05 0.05\nillum 2\n"},
}


def scene_dict(name: str) -> dict:
    """The edge tests' scenes at W x H:
    tri   tests/test_edge_grad.py's triangle against a constant ambient;
    occ   tests/test_edge_occluder.py's occluder over a receiver quad,
          under a gradient background (up != down);
    sec   tests/test_edge_secondary.py's wall and off-screen occluder;
    sphere  occ plus a sphere instance (no edges of its own);
    metal   occ with both meshes metal (no diffuse color IR)."""
    if name == "tri":
        sc = {"renderer": {"samples": 2, "bounces": 2},
              "camera": {"FOV": 60.0, "transforms": [
                  {"type": "translate", "x": 0, "y": 0, "z": -2.0}]},
              "scene": {"ambientColor": {
                  "down": {"r": 0.9, "g": 0.9, "b": 0.9},
                  "up": {"r": 0.9, "g": 0.9, "b": 0.9}},
                  "meshes": [{"fileName": "tri.obj", "bsdf": "lambertian",
                              "instances": [{"transforms": [
                                  {"type": "translate", "x": 0, "y": 0,
                                   "z": 0}]}]}]}}
    elif name == "sec":
        sc = json.loads(test_edge_secondary.SCENE_JSON)
    else:
        sc = json.loads(test_edge_occluder.SCENE_JSON)
        sc["scene"]["ambientColor"]["up"] = {"r": 0.3, "g": 0.5, "b": 0.9}
        if name == "sphere":
            sc["scene"]["primitives"] = [{
                "type": "sphere", "radius": 0.3, "bsdf": "lambertian",
                "color": {"r": 0.5, "g": 0.5, "b": 0.5},
                "instances": [{"transforms": [
                    {"type": "translate", "x": 0.8, "y": 0.6, "z": -0.3}]}]}]
        if name == "metal":
            for m in sc["scene"]["meshes"]:
                m["bsdf"] = "metal"
    sc["renderer"].update(width=W, height=H)
    return sc


def write_scene(d, name: str) -> tuple:
    """(scene JSON text, asset path) with the scene's files written to d."""
    files = FILES["occ" if name in ("sphere", "metal") else name]
    for fname, text in files.items():
        (d / fname).write_text(text)
    return json.dumps(scene_dict(name)), str(d) + "/"


class Pair:
    """One scene in both packages: craytpu's SceneHost, CompiledScene and
    renderer (dense traversal, as craytpu's edge tests build it), and the
    port's SceneHost, compiled scene (from craytpu's arrays) and
    renderer."""

    def __init__(self, text: str, path: str):
        self.jscene = jload_buf(text, path)
        self.jcs = jcompile(self.jscene)
        os.environ["CRAYTPU_TRAVERSAL"] = "dense"
        try:
            self.jr = JaxRenderer(self.jcs)
        finally:
            del os.environ["CRAYTPU_TRAVERSAL"]
        self.scene = load_scene_from_buf(text, path)
        self.cs = scene_from_arrays(jax_arrays(self.jcs), "cpu")
        self.r = WavefrontRenderer(self.cs)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """pairs(name) -> Pair, built once per scene for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(f"edge_{name}")
            cache[name] = Pair(*write_scene(d, name))
        return cache[name]
    return get


def cotangent(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(H * W, 4)).astype(
        np.float32)


def jax_d_tri(boundary, jcs, gbar) -> np.ndarray:
    """craytpu's tri_packed gradient of boundary(params, tp, PASS, SPP)
    for the image cotangent gbar (one jitted vjp)."""
    def vjp(tp, g):
        _, pull = jax.vjp(lambda t: boundary(jcs.params, t, jnp.int32(PASS),
                                             jnp.int32(SPP)), tp)
        return pull(g)[0]
    return np.asarray(jax.jit(vjp)(jcs.geom.tri_packed, jnp.asarray(gbar)))


def port_d_tri(boundary, cs, gbar) -> np.ndarray:
    tp = cs.geom.tri_packed.clone().requires_grad_()
    out = boundary(cs.params, tp, PASS, SPP)
    (g,) = torch.autograd.grad(out, tp, torch.from_numpy(gbar))
    return g.numpy()


MAKERS = {"primary": (eg.make_edge_grad_fn, jeg.make_edge_grad_fn),
          "secondary": (eg.make_edge_grad2_fn, jeg.make_edge_grad2_fn)}


def port_boundary(p: Pair, which: str, samples: int):
    return MAKERS[which][0](p.cs, p.scene, p.r, depth=DEPTH,
                            samples_per_edge=samples)


def jax_boundary(p: Pair, which: str, samples: int, renderer=None):
    return MAKERS[which][1](p.jcs, p.jscene, renderer or p.jr, depth=DEPTH,
                            samples_per_edge=samples)


def miss_stand_ins(jr):
    """craytpu's renderer as its secondary estimator reads it, with the
    shading record's stand-ins for the hit point and normal of lanes that
    miss (P = 0, n = +z), as the port's estimator takes them."""
    def isect(geom, o, d, alive):
        is_hit, p, n, uv, mat_id, t = jr.isect(geom, o, d, alive)
        ih = is_hit[..., None]
        return (is_hit, jnp.where(ih, p, 0.0),
                jnp.where(ih, n, jnp.array([0.0, 0.0, 1.0], jnp.float32)),
                uv, mat_id, t)
    return SimpleNamespace(kind=jr.kind, cam_fn=jr.cam_fn, isect=isect,
                           trace_rays_fn=jr.trace_rays_fn)


# ---- the edge table --------------------------------------------------------

@pytest.mark.parametrize("name", ["flatcube", "occ", "sphere"])
def test_build_edges_equal(name, tmp_path):
    """Same arrays in the same order as craytpu's; the sphere instance
    contributes no edge."""
    if name == "flatcube":
        text, path = json.dumps(FLAT_SCENE), ASSETS
    else:
        text, path = write_scene(tmp_path, name)
    want = jeg.build_edges(jload_buf(text, path))
    scene = load_scene_from_buf(text, path)
    got = eg.build_edges(scene)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["tri_a"].shape[0] > 0
    mesh_insts = [i for i, inst in enumerate(scene.instances)
                  if inst.kind == 0]
    assert set(got["inst"].tolist()) == set(mesh_insts)
    if name == "sphere":
        assert len(mesh_insts) < len(scene.instances)


# ---- the boundary terms against craytpu's ----------------------------------

@pytest.mark.parametrize("name,tol", [("tri", 1e-4), ("occ", 2e-2)])
def test_primary_matches_craytpu(pairs, name, tol):
    p = pairs(name)
    gbar = cotangent()
    want = jax_d_tri(jax_boundary(p, "primary", 8), p.jcs, gbar)
    got = port_d_tri(port_boundary(p, "primary", 8), p.cs, gbar)
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    assert rel_l2(got, want) <= tol


def test_secondary_matches_craytpu(pairs):
    p = pairs("sec")
    gbar = cotangent()
    want = jax_d_tri(jax_boundary(p, "secondary", 4, miss_stand_ins(p.jr)),
                     p.jcs, gbar)
    got = port_d_tri(port_boundary(p, "secondary", 4), p.cs, gbar)
    # the occluder (the last triangle) is off screen: only the secondary
    # term reaches it
    assert np.abs(want[2]).max() > 0 and np.isfinite(got).all()
    assert rel_l2(got, want) <= 2e-2


def test_secondary_finite_where_craytpu_is_nan(pairs):
    """Primary rays miss in this frame: craytpu's secondary term is NaN,
    the port's is finite (and non-zero on the occluder)."""
    p = pairs("sec")
    gbar = cotangent()
    want = jax_d_tri(jax_boundary(p, "secondary", 4), p.jcs, gbar)
    assert np.isnan(want[:, :9]).all()
    got = port_d_tri(port_boundary(p, "secondary", 4), p.cs, gbar)
    assert np.isfinite(got).all() and np.abs(got[2]).max() > 0


@pytest.mark.parametrize("which", ["primary", "secondary"])
def test_forward_zero_params_untouched(pairs, which):
    """The forward value is exactly zero; the ShadeParams tables take no
    gradient, tri_packed does."""
    p = pairs("occ")
    params = leaf_params(p.cs.params)
    tp = p.cs.geom.tri_packed.clone().requires_grad_()
    out = port_boundary(p, which, 4)(params, tp, PASS, SPP)
    assert out.shape == (H * W, 4) and out.dtype == torch.float32
    assert bool((out == 0).all()) and out.requires_grad
    (out * torch.from_numpy(cotangent())).sum().backward()
    for f in fields(params):
        g = getattr(params, f.name).grad
        assert g is None or not bool(g.any()), f.name
    assert float(tp.grad.abs().max()) > 0


def test_zero_functions(tmp_path):
    """No mesh: both terms are the zero function; no diffuse color IR:
    the secondary term is, the primary is not."""
    jcs = jcompile(jload_buf(json.dumps(SPHERES_SCENE)))
    assert jeg.build_edges(jload_buf(json.dumps(SPHERES_SCENE)))[
        "tri_a"].shape[0] == 0
    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    scene = load_scene_from_buf(json.dumps(SPHERES_SCENE))
    r = WavefrontRenderer(cs)
    npix = cs.camera.width * cs.camera.height
    tp = cs.geom.tri_packed.clone().requires_grad_()
    for make in (eg.make_edge_grad_fn, eg.make_edge_grad2_fn):
        out = make(cs, scene, r, depth=DEPTH)(cs.params, tp, 0, 1)
        assert out.shape == (npix, 4) and not bool(out.any())
        assert not out.requires_grad

    text, path = write_scene(tmp_path, "metal")
    jcs = jcompile(jload_buf(text, path))
    assert not jcs.dense_meta.get("diffuse_color_ir")
    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    scene = load_scene_from_buf(text, path)
    r = WavefrontRenderer(cs)
    tp = cs.geom.tri_packed.clone().requires_grad_()
    assert not eg.make_edge_grad2_fn(cs, scene, r, depth=DEPTH)(
        cs.params, tp, 0, 1).requires_grad
    assert eg.make_edge_grad_fn(cs, scene, r, depth=DEPTH)(
        cs.params, tp, 0, 1).requires_grad


@pytest.mark.parametrize("which,name", [("primary", "occ"),
                                        ("secondary", "sec")])
def test_compacted_side_rays_equal_all(pairs, monkeypatch, which, name):
    """Tracing side rays only for the samples that contribute gives the
    same d_tri, bit for bit, as tracing every sample's."""
    p = pairs(name)
    gbar = cotangent(11)
    boundary = port_boundary(p, which, 4)
    rays0 = eg.STATS["side_rays"]
    compact = port_d_tri(boundary, p.cs, gbar)
    rays1 = eg.STATS["side_rays"]
    side_diff = eg._side_diff

    def every(trace, params, kind, pass_idx, spp, rays, pix, keep):
        return side_diff(trace, params, kind, pass_idx, spp, rays, pix,
                         torch.ones_like(keep))
    monkeypatch.setattr(eg, "_side_diff", every)
    full = port_d_tri(boundary, p.cs, gbar)
    rays2 = eg.STATS["side_rays"]
    assert 0 < rays1 - rays0 < rays2 - rays1
    assert np.abs(compact).max() > 0
    np.testing.assert_array_equal(compact, full)
