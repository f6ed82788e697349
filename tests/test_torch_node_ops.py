"""The port's node-graph operations and square-root sites, one by one,
against the JAX package on the CPU, on seeded numpy inputs.

  - every math op of `_MATH_IMPL` (ops/shading.py) through compile_value
    (a per-lane ray length against a per-material value) and every vector
    op of compile_vector (the lane's normal against a per-material
    vector), 1,024 lanes;
  - `grayscale_hsp` on 100,000 colours;
  - NEE's sampled light point and shadow ray (the shadow ray's origin and
    direction as the step's isect receives them, and the lane's
    estimate) on a scene lit by triangle lights;
  - `edge_grad._norm` against jnp.linalg.norm, three Adam steps against
    optax.adam, and the gradient of the routed root (`ieee_sqrt`) and of
    `_norm` against jax.grad.

Tolerances: a result that calls no transcendental function is held bit
for bit (NaN equals NaN). Power, Log, Sine, Cosine and Tangent call
libm, whose results differ between XLA and PyTorch by an ulp or two:
those are held to rtol=2e-6, atol=1e-6 (the atol for results near zero,
where an ulp of the argument is a large relative error)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from craytpu.ops import colorops as jco
from craytpu.ops import nee as jnee
from craytpu.ops import sampler as jsmp
from craytpu.ops import shading as jsh
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.ops import colorops as tco
from craytpu_torch.ops import edge_grad as teg
from craytpu_torch.ops import nee as tnee
from craytpu_torch.ops import sampler as tsmp
from craytpu_torch.ops import shading as tsh
from craytpu_torch.ops import vecmath as tvm
from craytpu_torch.parallel import shard
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_buf
from tests.test_torch_detmath import assert_bits
from tests.test_torch_nee import lamp_scene

torch.set_num_threads(2)

B = 1024
RTOL, ATOL = 2e-6, 1e-6
LIBM = ("Power", "Log", "Sine", "Cosine", "Tangent")
MATH_OPS = sorted(tsh._MATH_IMPL)
VEC_OPS = ("VecAdd", "VecSubtract", "VecMultiply", "VecAverage", "VecDot",
           "VecCross", "VecNormalize", "VecReflect", "VecLength", "VecAbs")


def test_op_lists_are_complete():
    """Both packages list the same 15 math ops; the vector ops here are
    every branch of compile_vector."""
    assert sorted(jsh._MATH_IMPL) == MATH_OPS and len(MATH_OPS) == 15
    with pytest.raises(ValueError):
        _vector_outputs("VecNone")


def _records():
    """Per-lane inputs and a per-material table of values and vectors
    (material k is lane k's)."""
    rng = np.random.default_rng(41)
    inc = rng.normal(size=(B, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, 3)).astype(np.float32) * rng.uniform(
        0.2, 5.0, (B, 1)).astype(np.float32)
    uv = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    hp = rng.uniform(-3, 3, (B, 3)).astype(np.float32)
    dist = rng.uniform(0.1, 10, B).astype(np.float32)
    emission = np.zeros((B, 4), np.float32)
    ior = np.ones(B, np.float32)
    mat = np.arange(B, dtype=np.int32)
    values = rng.uniform(-3, 3, B).astype(np.float32)
    vecs = rng.normal(size=(B, 3)).astype(np.float32)
    return (inc, nrm, uv, hp, dist, emission, ior, mat), values, vecs


def _graph_outputs(build, value: bool):
    """(port, JAX) outputs of the node `build(tbl_v, tbl_vec)` compiled by
    compile_value (value) or compile_vector, on _records()."""
    rec, values, vecs = _records()
    out = []
    for sh, reg in ((tsh, tsh.Registry([], "cpu")), (jsh, jsh.Registry([]))):
        tv = np.array([reg.value_idx(x) for x in values], np.int32)
        tw = np.array([reg.vec_idx(x) for x in vecs], np.int32)
        ir = build(tv, tw)
        fn = (sh.compile_value if value else sh.compile_vector)(ir, reg)
        p = reg.finalize(np.zeros((1, 4), np.float32),
                         np.ones(1, np.float32))
        if sh is tsh:
            out.append(fn(p, tsh.HitRec(*[torch.from_numpy(x)
                                          for x in rec])))
        else:
            out.append(jax.jit(lambda *a: fn(p, jsh.HitRec(*a)))(
                *[jnp.asarray(x) for x in rec]))
    return out


def _check(got, want, exact, name):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        assert_bits(got, want, name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("op", MATH_OPS)
def test_math_op_matches_jax(op):
    """("math", ray length, per-material value, op): bit for bit, or
    within the libm tolerance for Power, Log, Sine, Cosine, Tangent."""
    got, want = _graph_outputs(
        lambda tv, tw: ("math", ("raylength",), ("param_value", tv), op),
        True)
    assert np.isfinite(np.asarray(want)).mean() > 0.99
    _check(got.numpy(), want, op not in LIBM, op)


def _vector_outputs(op):
    return _graph_outputs(
        lambda tv, tw: ("vec_math", ("normal",), ("param_vec", tw), op),
        False)


@pytest.mark.parametrize("op", VEC_OPS)
def test_vector_op_matches_jax(op):
    """("vec_math", normal, per-material vector, op): the vector and the
    value bit for bit."""
    (gv, gf), (wv, wf) = _vector_outputs(op)
    _check(gv.numpy(), wv, True, f"{op} vector")
    _check(gf.numpy(), np.broadcast_to(np.asarray(wf), (B,)), True,
           f"{op} value")


def test_grayscale_hsp_matches_jax():
    """HSP luminance of 100,000 colours (and of black and white) bit for
    bit: its root is correctly rounded in both packages."""
    c = np.random.default_rng(42).uniform(0, 1, (100_000, 4)).astype(
        np.float32)
    c[:2, :3] = [[0, 0, 0], [1, 1, 1]]
    want = jax.jit(jco.grayscale_hsp)(jnp.asarray(c))
    assert_bits(tco.grayscale_hsp(torch.from_numpy(c)).numpy(), want,
                "grayscale_hsp")


@pytest.fixture(scope="module")
def lamp(tmp_path_factory):
    d = tmp_path_factory.mktemp("lamp")
    text, path = lamp_scene(d), str(d) + "/"
    return (jcompile(jload_buf(text, path)),
            compile_scene(load_scene_from_buf(text, path), "cpu"))


def test_nee_sample_matches_jax(lamp):
    """NEE at 1,024 diffuse vertices of a scene lit by two triangle
    lights (no sin or cos on that branch): the shadow rays the step's
    isect receives (origin, direction: the sampled point's offset over
    its square-root length), which lanes shoot, the estimate and the
    sampler states, bit for bit."""
    jcs, cs = lamp
    assert (cs.lights.kind == 0).all()
    rng = np.random.default_rng(43)
    mat = np.full(B, int(np.nonzero(cs.mat_nee.numpy())[0][0]), np.int32)
    hp = rng.uniform(-1.2, 1.2, (B, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    is_hit = np.arange(B) % 7 != 3
    weight = rng.uniform(0.1, 1.0, (B, 4)).astype(np.float32)
    pix = rng.integers(0, 1 << 20, B).astype(np.uint32)
    rec = (rng.normal(size=(B, 3)).astype(np.float32), nrm,
           np.zeros((B, 2), np.float32), hp,
           rng.uniform(0.1, 5, B).astype(np.float32),
           np.zeros((B, 4), np.float32), np.ones(B, np.float32), mat)
    seen = {}

    def jisect(geom, o, d, shoot):
        seen["jax"] = (o, d, shoot)
        return (jnp.zeros(B, bool),) + (None,) * 4 + (jnp.zeros(B),)

    def tisect(geom, o, d, shoot):
        seen["port"] = (o, d, shoot)
        return (torch.zeros(B, dtype=torch.bool),) + (None,) * 4 + (
            torch.zeros(B),)

    jfn = jnee.make_nee_fn(jcs, jsmp.RANDOM, jisect)
    s = jsmp.init_sampler(jsmp.RANDOM, jnp.full(B, 2, jnp.int32),
                          jnp.full(B, 8, jnp.int32), jnp.asarray(pix))
    jd, js, jact = jfn(jcs.params, jcs.geom,
                       jsh.HitRec(*[jnp.asarray(x) for x in rec]), s,
                       jnp.asarray(is_hit), jnp.asarray(weight))
    tfn = tnee.make_nee_fn(cs, tsmp.RANDOM)
    s = tsmp.init_sampler(tsmp.RANDOM, torch.full((B,), 2, dtype=torch.int32),
                          torch.full((B,), 8, dtype=torch.int32),
                          torch.from_numpy(pix.astype(np.int64)))
    td, ts, tact = tfn(cs.params, tsh.HitRec(*[torch.from_numpy(x)
                                               for x in rec]), s,
                       torch.from_numpy(is_hit), torch.from_numpy(weight),
                       tisect)
    (jo, jdir, jshoot), (to, tdir, tshoot) = seen["jax"], seen["port"]
    assert np.array_equal(tshoot.numpy(), np.asarray(jshoot))
    assert tshoot.sum() > B // 4
    assert np.array_equal(tact.numpy(), np.asarray(jact))
    assert_bits(to.numpy(), jo, "shadow ray origin")
    assert_bits(tdir.numpy(), jdir, "shadow ray direction")
    assert_bits(td.numpy(), jd, "estimate")
    assert np.abs(np.asarray(jd)).max() > 0
    assert np.array_equal(ts.pcg_hi.numpy(),
                          np.asarray(js.pcg_hi).astype(np.int64))
    assert np.array_equal(ts.pcg_lo.numpy(),
                          np.asarray(js.pcg_lo).astype(np.int64))


def _vectors(n=4096, seed=44):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v * np.float32(10.0) ** np.random.default_rng(seed + 1).uniform(
        -3, 3, (n, 1)).astype(np.float32)


def test_edge_norm_matches_jax():
    """edge_grad._norm, |x| = sqrt(sum(x * x)), bit for bit against
    jnp.linalg.norm(x, axis=-1), and its gradient against jax.grad."""
    x = _vectors()
    w = np.random.default_rng(45).normal(size=x.shape[0]).astype(np.float32)
    want = jax.jit(lambda a: jnp.linalg.norm(a, axis=-1))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = teg._norm(xt)
    assert_bits(got.detach().numpy(), want, "norm")
    (got * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jnp.linalg.norm(a, axis=-1)
                                    * jnp.asarray(w)))(jnp.asarray(x))
    assert_bits(xt.grad.numpy(), jg, "norm gradient")


def test_ieee_sqrt_and_its_gradient_match_jax():
    """The routed root on 100,000 floats over 12 decades (and 0, 1)
    against jnp.sqrt (normal floats: XLA's CPU flushes subnormals), and
    its backward, g * (0.5 / sqrt(x)) in float32, against jax.grad, bit
    for bit; no graph when nothing requires grad."""
    rng = np.random.default_rng(46)
    x = (10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    x[:2] = [0.0, 1.0]
    g = rng.normal(size=x.shape).astype(np.float32)
    assert_bits(tvm.ieee_sqrt(torch.from_numpy(x)).numpy(),
                jax.jit(jnp.sqrt)(jnp.asarray(x)), "sqrt")
    sel = slice(1, None)  # the gradient of a root of 0 is inf in both
    xt = torch.from_numpy(x[sel].copy()).requires_grad_(True)
    (tvm.ieee_sqrt(xt) * torch.from_numpy(g[sel])).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jnp.sqrt(a) * jnp.asarray(g[sel])))(
        jnp.asarray(x[sel]))
    assert_bits(xt.grad.numpy(), jg, "sqrt gradient")
    assert tvm.ieee_sqrt(torch.from_numpy(x)).grad_fn is None


def test_adam_steps_match_optax():
    """Three Adam steps of the port's train step (shard._adam) against
    optax.adam's update and apply_updates, bit for bit, on seeded tables
    and gradients. optax runs op by op here: under jit XLA rewrites the
    divisions by a bias correction as products by its reciprocal (an ulp
    off on about a quarter of the entries), which the train step's own
    test holds to a tolerance (tests/test_torch_train.py)."""
    rng = np.random.default_rng(47)
    shapes = {"colors": (6, 4), "values": (9,), "vecs": (5, 3),
              "texels": (2048, 4), "emission": (3, 4), "ior": (3,)}
    theta = {k: rng.uniform(-1, 1, s).astype(np.float32)
             for k, s in shapes.items()}
    lr = 1e-2
    opt = optax.adam(lr)
    jth = {k: jnp.asarray(v) for k, v in theta.items()}
    jst = opt.init(jth)
    tth = tsh.ShadeParams(**{k: torch.from_numpy(v.copy())
                             for k, v in theta.items()})
    zeros = [torch.zeros_like(x) for x in shard._leaves(tth)]
    tst = shard.AdamState(shard._like(tth, zeros),
                          shard._like(tth, list(zeros)), 0)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 1, s)).astype(
            np.float32) for k, s in shapes.items()}
        upd, jst = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jth)
        jth = optax.apply_updates(jth, upd)
        new, tst = shard._adam(shard._leaves(tth),
                               [torch.from_numpy(g[f]) for f in shapes],
                               tst, lr)
        tth = shard._like(tth, new)
        for k in shapes:
            assert_bits(getattr(tth, k).numpy(), jth[k], f"step {step} {k}")
