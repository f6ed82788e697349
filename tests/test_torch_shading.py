"""Compiled node graphs of the port against the JAX package's, on the same
synthetic hit records and sampler states.

Tolerances: a graph that calls no transcendental function must agree bit
for bit. Where a graph calls sin/cos/atan2/acos/pow (diffuse and fuzz
scatter, checker, background), the two sides use different libm
implementations (XLA's and PyTorch's), which may differ by an ulp or two
in those calls (pow in the sRGB decode of an image node too); those outputs are held to rtol=1e-6 (and atol=1e-6 for
components near zero, where one ulp of the trig result is a large relative
error). Sampler states are integer and always bit-equal."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from craytpu.ops import sampler as jsmp
from craytpu.ops import shading as jsh
from craytpu.scene import nodegraph as jng
from craytpu_torch.ops import sampler as tsmp
from craytpu_torch.ops import shading as tsh
from tests.test_torch_detmath import assert_bits

torch.set_num_threads(2)

ng = jng  # the IR is plain tuples; both packages build the same ones
C = ng.const_color
V = ng.const_value

# (graph, exact): exact graphs use no transcendental function
GRAPHS = {
    "diffuse": (ng.diffuse(C((0.9, 0.2, 0.1, 1.0))), False),
    "metal_smooth": (ng.metal(C((0.8, 0.8, 0.9, 1.0)), V(0.0)), True),
    "metal_rough": (ng.metal(C((0.8, 0.8, 0.9, 1.0)), V(0.1)), False),
    "glass": (ng.glass(C((1.0, 1.0, 1.0, 1.0)), V(0.0), V(1.5)), True),
    "glass_rough": (ng.glass(C((1.0, 1.0, 1.0, 1.0)), V(0.2), V(1.33)),
                    False),
    "plastic": (ng.plastic(C((0.2, 0.4, 0.9, 1.0))), False),
    "emissive": (ng.emissive(C((1.0, 0.9, 0.7, 1.0)), V(8.0)), False),
    "mix_alpha": (ng.append_alpha(ng.metal(C((0.5, 0.5, 0.5, 1.0)),
                                           V(0.0)),
                                  C((0.5, 0.5, 0.5, 0.7))), True),
    "add": (ng.add(ng.transparent(C((0.3, 0.3, 0.3, 1.0))),
                   ng.metal(C((0.2, 0.9, 0.2, 1.0)), V(0.0))), True),
    "isotropic": (ng.isotropic(C((0.5, 0.6, 0.7, 1.0))), False),
    "checker": (ng.diffuse(ng.checker(C((0.1, 0.1, 0.1, 1.0)),
                                      C((0.9, 0.9, 0.9, 1.0)), V(7.0))),
                False),
    "fresnel_mix": (ng.mix(ng.metal(C((0.9, 0.9, 0.9, 1.0)), V(0.0)),
                           ng.transparent(C((1.0, 1.0, 1.0, 1.0))),
                           ng.fresnel(V(1.45))), True),
    "math_rgb": (ng.metal(("combine_rgb",
                           ng.math(V(0.25), V(0.5), "Multiply"),
                           ng.math(V(0.9), V(0.3), "Subtract"),
                           ("raylength",)),
                          ng.math(V(0.0), V(0.5), "Min")), True),
    "vec_color": (ng.metal(("vec_to_color",
                            ng.vec_math(("normal",), ng.const_vec(
                                (0.1, 0.2, 0.3)), "VecCross")),
                           V(0.0)), True),
    "gradient": (ng.metal(ng.gradient((1.0, 1.0, 1.0, 1.0),
                                      (0.5, 0.7, 1.0, 1.0)), V(0.0)), True),
    "image_bilinear": (ng.metal(ng.image(0, 0), V(0.0)), True),
    "image_nearest": (ng.metal(ng.image(1, ng.NO_BILINEAR), V(0.0)), True),
    "image_srgb": (ng.metal(ng.image(0, ng.SRGB_TRANSFORM), V(0.0)), False),
}


class _Tex:
    def __init__(self, data):
        self.data = data


def _textures():
    """A 3-channel and a 1-channel texture (texel rows of both packages'
    registries)."""
    rng = np.random.default_rng(31)
    return [_Tex(rng.uniform(0, 1, (7, 5, 3)).astype(np.float32)),
            _Tex(rng.uniform(0, 1, (4, 6, 1)).astype(np.float32))]

B = 1024


def _records(seed):
    rng = np.random.default_rng(seed)
    inc = rng.normal(size=(B, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    uv[::5] = -1.0  # no texcoords: checker falls back to world space
    hp = rng.uniform(-3, 3, (B, 3)).astype(np.float32)
    dist = rng.uniform(0.1, 10, B).astype(np.float32)
    emission = np.zeros((B, 4), np.float32)
    ior = rng.uniform(1.0, 2.0, B).astype(np.float32)
    pix = rng.integers(0, 1 << 20, B).astype(np.uint32)
    return inc, nrm, uv, hp, dist, emission, ior, pix


def _check(got, want, exact, name):
    got = np.asarray(got)
    want = np.asarray(want)
    if exact:
        assert_bits(got, want, name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bsdf_matches_jax(name):
    ir, exact = GRAPHS[name]
    inc, nrm, uv, hp, dist, emission, ior, pix = _records(17)
    mat = np.zeros(B, np.int32)
    jreg = jsh.Registry(_textures())
    jfn = jsh.compile_bsdf(ir, jreg, jsmp.RANDOM)
    jp = jreg.finalize(np.zeros((1, 4), np.float32),
                       np.ones(1, np.float32))
    treg = tsh.Registry(_textures(), "cpu")
    tfn = tsh.compile_bsdf(ir, treg, tsmp.RANDOM)
    tp = treg.finalize(np.zeros((1, 4), np.float32), np.ones(1, np.float32))
    for f in ("colors", "values", "vecs", "texels"):
        assert_bits(getattr(tp, f), getattr(jp, f), f)

    def jrun(inc, nrm, uv, hp, dist, emission, ior, mat, pix):
        rec = jsh.HitRec(inc, nrm, uv, hp, dist, emission, ior, mat)
        s = jsmp.init_sampler(jsmp.RANDOM, jnp.full(B, 3, jnp.int32),
                              jnp.full(B, 16, jnp.int32), pix)
        out, col, s = jfn(jp, rec, s)
        return out, col, s.pcg_hi, s.pcg_lo

    jo = jax.jit(jrun)(*[jnp.asarray(x) for x in
                         (inc, nrm, uv, hp, dist, emission, ior, mat, pix)])
    t = [torch.from_numpy(x) for x in (inc, nrm, uv, hp, dist, emission,
                                       ior, mat)]
    s = tsmp.init_sampler(tsmp.RANDOM, torch.full((B,), 3, dtype=torch.int32),
                          torch.full((B,), 16, dtype=torch.int32),
                          torch.from_numpy(pix.astype(np.int64)))
    out, col, s = tfn(tp, tsh.HitRec(*t), s)
    _check(out, jo[0], exact, f"{name} direction")
    _check(col, jo[1], exact, f"{name} color")
    np.testing.assert_array_equal(s.pcg_hi.numpy(),
                                  np.asarray(jo[2]).astype(np.int64))
    np.testing.assert_array_equal(s.pcg_lo.numpy(),
                                  np.asarray(jo[3]).astype(np.int64))


BACKGROUNDS = {
    "default": ng.background(),
    "gradient": ng.background(ng.gradient((1.0, 1.0, 1.0, 1.0),
                                          (0.5, 0.7, 1.0, 1.0)), V(2.0),
                              V(0.25)),
    "checker": ng.background(ng.checker(None, None, V(9.0)), V(1.0)),
}


@pytest.mark.parametrize("name", sorted(BACKGROUNDS))
def test_background_matches_jax(name):
    ir = BACKGROUNDS[name]
    inc = _records(23)[0]
    jreg = jsh.Registry([])
    jfn = jsh.compile_background(ir, jreg)
    jp = jreg.finalize(np.zeros((1, 4), np.float32), np.ones(1, np.float32))
    treg = tsh.Registry([], "cpu")
    tfn = tsh.compile_background(ir, treg)
    tp = treg.finalize(np.zeros((1, 4), np.float32), np.ones(1, np.float32))
    want = jax.jit(lambda d: jfn(jp, d))(jnp.asarray(inc))
    got = tfn(tp, torch.from_numpy(inc))
    # equirect lookup: atan2/acos, not bit-stable across libms
    _check(got, want, name == "gradient", name)
