"""The port's differentiable trace on the CPU (the kernels' plain
versions): the derivative rules of the float layer against craytpu's
custom JVPs, the port's gradients against finite differences on the
scenes of tests/test_grad.py, test_grad_texture.py and test_vertex_grad.py
at those tests' tolerances, and against craytpu's gradients on the same
arrays (scene_from_arrays).

Tolerances: the rules' gradients equal jax.grad's within rtol=1e-6 (the
same arithmetic, summed in another order where an operand broadcasts).
On a scene whose image calls no sin/cos (a mirror, an emitter, the
background) the port's image and every gradient table equal craytpu's
within rtol=1e-5, atol=1e-7. Where diffuse scatter calls sin/cos (libm
results differ between XLA and PyTorch in the last bits), each table is
held to a relative L2 error of 2e-2."""

import json
import os
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.ops import vecmath as jvm
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.compile import compile_scene, scene_from_arrays
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from tests.test_grad import SCENE as GRAD_SCENE
from tests.test_torch_scene import jax_arrays
from tests.test_vertex_grad import FLAT_SCENE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets") + "/"

# a scene whose image calls no sin/cos: primary rays hit a mirror (metal,
# roughness 0: no sampler dimension) or the background; the emitter sits
# behind the camera, seen only in the mirror at the last bounce
MIRROR_SCENE = {
    "renderer": {"samples": 1, "bounces": 2, "width": 24, "height": 16},
    "camera": {"FOV": 70.0, "transforms": [
        {"type": "translate", "x": 0, "y": 0, "z": -4}]},
    "scene": {
        "ambientColor": {"down": {"r": 0.8, "g": 0.6, "b": 0.4},
                         "up": {"r": 0.3, "g": 0.5, "b": 0.9}},
        "primitives": [
            {"type": "sphere", "radius": 1.5,
             "color": {"r": 0.9, "g": 0.7, "b": 0.5}, "bsdf": "metal",
             "roughness": 0.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0, "y": 0, "z": 0}]}]},
            {"type": "sphere", "radius": 1.0,
             "color": {"r": 1.0, "g": 0.8, "b": 0.6}, "bsdf": "emissive",
             "intensity": 3.0,
             "instances": [{"transforms": [
                 {"type": "translate", "x": 0.5, "y": 0.5, "z": -7.0}]}]},
        ],
    },
}


def grid(W, H):
    """xs, ys of every pixel (numpy int32, row-major)."""
    return (np.tile(np.arange(W, dtype=np.int32), H),
            np.repeat(np.arange(H, dtype=np.int32), W))


def leaf_params(params):
    """A copy of ShadeParams whose tensors require grad."""
    return replace(params, **{f.name: getattr(params, f.name).clone()
                              .requires_grad_() for f in fields(params)})


def grads(params) -> dict:
    """Each table's gradient as numpy (zeros where none reached it)."""
    out = {}
    for f in fields(params):
        x = getattr(params, f.name)
        out[f.name] = (x.grad if x.grad is not None
                       else torch.zeros_like(x)).numpy()
    return out


def port_loss(trace, xs, ys, pass_idx, spp):
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)

    def loss(*args):
        img = trace(*args, xs, ys, pass_idx, spp)
        return img[:, :3].mean()
    return loss


# ---- the derivative rules -------------------------------------------------

def _inputs(name, rng):
    """Seeded operands of each rule, with broadcast operands."""
    u = lambda *s: rng.uniform(-2.0, 2.0, s).astype(np.float32)  # noqa
    if name == "exact_div":
        b = rng.uniform(0.5, 2.0, (64, 1)) * rng.choice([-1.0, 1.0], (64, 1))
        return [u(64, 3), b.astype(np.float32)]
    if name == "exact_sqrt":
        return [rng.uniform(0.1, 4.0, (64,)).astype(np.float32)]
    if name == "fma_raw":
        return [u(64, 3), u(64, 1), u(64, 3)]
    return [u(64, 3), u(64, 3), u(1, 3)]


RULES = ["exact_div", "exact_sqrt", "fma_raw", "det_fma"]


@pytest.mark.parametrize("name", RULES)
def test_rule_forward_bit_equal(name):
    """With inputs that require grad the Function runs; its forward gives
    the plain op sequence's bits."""
    xs = _inputs(name, np.random.default_rng(7))
    fn = getattr(vm, name)
    plain = fn(*(torch.from_numpy(x) for x in xs))
    got = fn(*(torch.from_numpy(x).requires_grad_() for x in xs))
    assert got.grad_fn is not None and plain.grad_fn is None
    np.testing.assert_array_equal(got.detach().numpy().view(np.uint32),
                                  plain.numpy().view(np.uint32))


@pytest.mark.parametrize("name", RULES)
def test_rule_grad_matches_jax(name):
    rng = np.random.default_rng(11)
    xs = _inputs(name, rng)
    out_shape = np.broadcast_shapes(*(x.shape for x in xs))
    w = rng.uniform(-1.0, 1.0, out_shape).astype(np.float32)
    jfn = getattr(jvm, name)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                    argnums=tuple(range(len(xs))))(
        *(jnp.asarray(x) for x in xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    (getattr(vm, name)(*ts) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6)


@pytest.mark.parametrize("rows,width", [(5, 4), (5, None), (100, 4)])
def test_take_rows_grad(rows, width):
    """The table-gather rule (one-hot product for small tables,
    index_add_ for large) against autograd's index backward."""
    rng = np.random.default_rng(rows)
    shape = (rows,) if width is None else (rows, width)
    table = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, rows, 4096))
    g = torch.from_numpy(rng.uniform(-1, 1, (4096,) + shape[1:])
                         .astype(np.float32))
    a = table.clone().requires_grad_()
    out = vm.take_rows(a, idx)
    np.testing.assert_array_equal(out.detach().numpy(), table[idx].numpy())
    (out * g).sum().backward()
    b = table.clone().requires_grad_()
    (b[idx] * g).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_forward_render_takes_no_function():
    """Without grad the float layer calls the plain ops: no autograd
    graph is built."""
    a = torch.ones(4, requires_grad=True)
    with torch.no_grad():
        assert vm.exact_div(a, a).grad_fn is None
    assert vm.exact_sqrt(torch.ones(4)).grad_fn is None


# ---- finite differences ----------------------------------------------------

@pytest.fixture(scope="module")
def grad_setup():
    cs = compile_scene(load_scene_from_buf(json.dumps(GRAD_SCENE)), "cpu")
    r = WavefrontRenderer(cs, bounces=3)
    loss = port_loss(r.make_trace_fn(3), *grid(24, 16), 0, 2)
    p = leaf_params(cs.params)
    loss(p).backward()
    return cs, loss, grads(p)


def _fd(loss, params, name, idx, eps):
    t0 = getattr(params, name)
    out = []
    for sgn in (1.0, -1.0):
        t = t0.clone()
        t[idx] += sgn * eps
        with torch.no_grad():
            out.append(float(loss(replace(params, **{name: t}))))
    return (out[0] - out[1]) / (2 * eps)


def test_color_grad_matches_fd(grad_setup):
    cs, loss, g = grad_setup
    gc = g["colors"].astype(np.float64)
    assert np.isfinite(gc).all() and np.abs(gc).max() > 0.0
    checked = 0
    for idx in np.argwhere(np.abs(gc) > 1e-4)[:8]:
        i, j = int(idx[0]), int(idx[1])
        fd = _fd(loss, cs.params, "colors", (i, j), 2e-3)
        assert fd == pytest.approx(gc[i, j], rel=2e-2, abs=1e-4)
        checked += 1
    assert checked >= 2


def test_emission_grad_matches_fd(grad_setup):
    cs, loss, g = grad_setup
    ge = g["emission"].astype(np.float64)
    assert np.isfinite(ge).all() and np.abs(ge).max() > 0.0
    i, j = np.unravel_index(np.abs(ge).argmax(), ge.shape)
    fd = _fd(loss, cs.params, "emission", (int(i), int(j)), 1e-2)
    assert fd == pytest.approx(float(ge[i, j]), rel=2e-2, abs=1e-5)


def _texture_scene(d):
    """The textured quad of tests/test_grad_texture.py, written to d."""
    from PIL import Image
    rng = np.random.default_rng(11)
    tex = (rng.uniform(0.2, 0.9, (4, 4, 3)) * 255).astype(np.uint8)
    Image.fromarray(tex).save(d / "checker.png")
    (d / "quad.obj").write_text(
        "mtllib quad.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 -1\n"
        "usemtl tex\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
    (d / "quad.mtl").write_text(
        "newmtl tex\nKd 1.0 1.0 1.0\nmap_Kd checker.png\nillum 2\n")
    return json.dumps({
        "renderer": {"samples": 2, "bounces": 2, "width": 24, "height": 16},
        "camera": {"FOV": 70.0, "transforms": [
            {"type": "translate", "x": 0, "y": 0, "z": -2.5}]},
        "scene": {
            "ambientColor": {"down": {"r": 0.8, "g": 0.8, "b": 0.8},
                             "up": {"r": 0.8, "g": 0.8, "b": 0.8}},
            "meshes": [{"fileName": "quad.obj", "instances": [
                {"transforms": [{"type": "translate", "x": 0, "y": 0,
                                 "z": 0}]}]}]}})


@pytest.fixture(scope="module")
def texture_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("texgrad")
    return _texture_scene(d), str(d) + "/"


def test_texel_grad_matches_fd(texture_scene):
    text, path = texture_scene
    cs = compile_scene(load_scene_from_buf(text, path), "cpu")
    assert cs.params.texels.shape[0] > 1, "texture did not load"
    r = WavefrontRenderer(cs, bounces=2)
    loss = port_loss(r.make_trace_fn(2), *grid(24, 16), 0, 2)
    p = leaf_params(cs.params)
    loss(p).backward()
    gt = p.texels.grad.numpy().astype(np.float64)
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0.0
    checked = 0
    for idx in np.argwhere(np.abs(gt) > np.abs(gt).max() * 0.25)[:4]:
        i, j = int(idx[0]), int(idx[1])
        fd = _fd(loss, cs.params, "texels", (i, j), 5e-3)
        assert fd == pytest.approx(gt[i, j], rel=3e-2, abs=1e-5)
        checked += 1
    assert checked >= 2


def flat_pixels():
    ys, xs = np.mgrid[20:44, 30:60]
    return (xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32))


def test_vertex_grad_matches_fd():
    """AD through the differentiable record against FD on the packed
    triangle rows, with test_vertex_grad.py's rule for entries on
    visibility edges (the detached search makes AD the interior
    derivative)."""
    cs = compile_scene(load_scene_from_buf(json.dumps(FLAT_SCENE), ASSETS),
                       "cpu")
    r = WavefrontRenderer(cs, bounces=2)
    loss = port_loss(r.make_trace_fn(2, diff_geometry=True), *flat_pixels(),
                     0, 1)
    tp0 = cs.geom.tri_packed
    tp = tp0.clone().requires_grad_()
    loss(cs.params, tp).backward()
    g = tp.grad.numpy().astype(np.float64)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    checked = 0
    for f in np.argsort(-np.abs(g).reshape(-1))[:40]:
        i, j = np.unravel_index(f, g.shape)
        eps = 1e-3
        vals = []
        for sgn in (1.0, -1.0):
            t = tp0.clone()
            t[i, j] += sgn * eps
            with torch.no_grad():
                vals.append(float(loss(cs.params, t)))
        fd = (vals[0] - vals[1]) / (2 * eps)
        ad = g[i, j]
        if abs(fd - ad) > 0.05 * max(abs(fd), abs(ad)) and \
                abs(fd - ad) > 1e-4:
            continue
        assert fd == pytest.approx(ad, rel=5e-2, abs=1e-4)
        checked += 1
    assert checked >= 25, f"only {checked} entries verified"


# ---- against craytpu's gradients on the same arrays -----------------------

def both_grads(jcs, depth, xs, ys, pass_idx, spp, cs=None):
    """(craytpu image, gradient tables), (port image, gradient tables) of
    loss = mean(img[:, :3]) on the same scene arrays."""
    jr = JaxRenderer(jcs, bounces=depth)
    jt = jr.make_trace_fn(depth)
    jxs, jys = jnp.asarray(xs), jnp.asarray(ys)

    def jimg(p):
        return jt(p, jxs, jys, jnp.int32(pass_idx), jnp.int32(spp))
    want_img = np.asarray(jimg(jcs.params))
    jg = jax.grad(lambda p: jnp.mean(jimg(p)[:, :3]))(jcs.params)
    want = {k: np.asarray(v) for k, v in jg._asdict().items()}

    cs = cs or scene_from_arrays(jax_arrays(jcs), "cpu")
    r = WavefrontRenderer(cs, bounces=depth)
    p = leaf_params(cs.params)
    img = r.make_trace_fn(depth)(p, torch.from_numpy(xs),
                                 torch.from_numpy(ys), pass_idx, spp)
    img[:, :3].mean().backward()
    return (want_img, want), (img.detach().numpy(), grads(p))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / max(np.linalg.norm(b.astype(np.float64)), 1e-30))


def test_mirror_scene_equals_craytpu():
    """No sin/cos reaches the image: image and every gradient table
    within rtol=1e-5, atol=1e-7."""
    jcs = jcompile(jload_buf(json.dumps(MIRROR_SCENE)))
    (wi, wg), (gi, gg) = both_grads(jcs, 2, *grid(24, 16), 0, 1)
    assert np.abs(wi).max() > 0
    np.testing.assert_allclose(gi, wi, rtol=1e-5, atol=1e-7)
    assert np.abs(wg["colors"]).max() > 0 and np.abs(wg["emission"]).max() > 0
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_trace_rays_equals_craytpu():
    """trace_rays_fn on each package's own camera rays and sampler states
    of the mirror scene: image and every gradient table as craytpu's
    trace_rays within rtol=1e-5, atol=1e-7, and the image bit-equal to
    the port's make_trace_fn."""
    jcs = jcompile(jload_buf(json.dumps(MIRROR_SCENE)))
    xs, ys = grid(24, 16)
    jr = JaxRenderer(jcs, bounces=2)
    jo, jd, js = jr._init_rays(jnp.asarray(xs), jnp.asarray(ys),
                               jnp.int32(0), jnp.int32(1))
    jtr = jr.trace_rays_fn(2)
    want_img = np.asarray(jtr(jcs.params, jo, jd, js))
    wg = jax.grad(lambda p: jnp.mean(jtr(p, jo, jd, js)[:, :3]))(jcs.params)

    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    r = WavefrontRenderer(cs, bounces=2)
    txs, tys = torch.from_numpy(xs), torch.from_numpy(ys)
    o, d, s = r._init_rays(txs, tys, 0, 1)
    p = leaf_params(cs.params)
    img = r.trace_rays_fn(2)(p, o, d, s)
    img[:, :3].mean().backward()
    got = img.detach().numpy()
    assert np.abs(want_img).max() > 0
    np.testing.assert_allclose(got, want_img, rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        traced = r.make_trace_fn(2)(cs.params, txs, tys, 0, 1).numpy()
    np.testing.assert_array_equal(got, traced)
    gg = grads(p)
    for k, v in wg._asdict().items():
        np.testing.assert_allclose(gg[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("which", ["grad", "texture"])
def test_diffuse_scene_grads_near_craytpu(which, texture_scene):
    """Diffuse scatter calls sin/cos: each gradient table within a
    relative L2 error of 2e-2 of craytpu's."""
    if which == "grad":
        jcs = jcompile(jload_buf(json.dumps(GRAD_SCENE)))
        depth = 3
    else:
        jcs = jcompile(jload_buf(*texture_scene))
        depth = 2
    (_, wg), (gi, gg) = both_grads(jcs, depth, *grid(24, 16), 0, 2)
    assert np.isfinite(gi).all()
    for k in wg:
        if np.abs(wg[k]).max() == 0:
            np.testing.assert_array_equal(gg[k], 0.0, err_msg=k)
        else:
            assert rel_l2(gg[k], wg[k]) <= 2e-2, k


def test_vertex_grads_near_craytpu(monkeypatch):
    """The flat cube's tri_packed gradient against craytpu's (dense
    traversal, its vertex-gradient path on the CPU): relative L2 error
    within 2e-2."""
    monkeypatch.setenv("CRAYTPU_TRAVERSAL", "dense")
    from craytpu.scene.sceneloader import load_scene_from_buf as jl
    jcs = jcompile(jl(json.dumps(FLAT_SCENE), ASSETS))
    jr = JaxRenderer(jcs, bounces=2)
    assert jr.traversal_mode == "dense"
    xs, ys = flat_pixels()
    jt = jr.make_trace_fn(2, diff_geometry=True)
    want = np.asarray(jax.grad(lambda tp: jnp.mean(jt(
        jcs.params, tp, jnp.asarray(xs), jnp.asarray(ys), jnp.int32(0),
        jnp.int32(1))[:, :3]))(jcs.geom.tri_packed))

    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    r = WavefrontRenderer(cs, bounces=2)
    loss = port_loss(r.make_trace_fn(2, diff_geometry=True), xs, ys, 0, 1)
    tp = cs.geom.tri_packed.clone().requires_grad_()
    loss(cs.params, tp).backward()
    got = tp.grad.numpy()
    assert np.abs(want).max() > 0 and np.isfinite(got).all()
    assert rel_l2(got, want) <= 2e-2
