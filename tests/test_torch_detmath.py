"""The port's deterministic float layer, PCG streams, samplers and camera
primaries, bit for bit against the JAX package on the same inputs.

Every comparison is bitwise on float32 (NaNs compare equal to NaNs):
these stages use no transcendental function, so any difference is a
fault in the port."""

import os
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from craytpu.ops import pcg as jpcg
from craytpu.ops import sampler as jsmp
from craytpu.ops import vecmath as jvm
from craytpu_torch.ops import pcg as tpcg
from craytpu_torch.ops import sampler as tsmp
from craytpu_torch.ops import vecmath as tvm
from tests import reference_models as ref

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def assert_bits(a, b, name=""):
    """Bitwise float32 equality; NaN equals NaN whatever its payload."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape, (name, a.shape, b.shape)
    both_nan = np.isnan(a) & np.isnan(b)
    bad = (a.view(np.uint32) != b.view(np.uint32)) & ~both_nan
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} differ, e.g. "
                           f"{a[bad][:3]} vs {b[bad][:3]}")


def _vals(rng, n, lo=-50.0, hi=50.0):
    """Scene-scale float32 values with some exact zeros and tiny values."""
    x = rng.uniform(lo, hi, n).astype(np.float32)
    x[::17] = 0.0
    x[5::23] *= np.float32(1e-6)
    return x


N = 4096


def _inputs(name, shapes):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    xs = [_vals(rng, int(np.prod(s))).reshape(s) for s in shapes]
    if name == "exact_sqrt":
        xs = [np.abs(x) for x in xs]
    if name == "triangle_distribution":  # a sampler value in [0, 1)
        xs = [np.abs(x) / np.float32(50.0) for x in xs]
    return xs


CASES = {
    "exact_div": ([(N,), (N,)], lambda m, a, b: m.exact_div(a, b)),
    "exact_sqrt": ([(N,)], lambda m, a: m.exact_sqrt(a)),
    "fma_raw": ([(N,), (N,), (N,)], lambda m, a, b, c: m.fma_raw(a, b, c)),
    "det_fma": ([(N,), (N,), (N,)], lambda m, a, b, c: m.det_fma(a, b, c)),
    "dot3_cray": ([(N,)] * 6, lambda m, *x: m.dot3_cray(*x)),
    "vcross": ([(N, 3), (N, 3)], lambda m, a, b: m.vcross(a, b)),
    "mat34_point": ([(N, 3, 4), (N, 3)], lambda m, A, p: m.mat34_point(A, p)),
    "mat33_vec": ([(N, 3, 4), (N, 3)], lambda m, A, v: m.mat33_vec(A, v)),
    "mat33_vec_T": ([(N, 3, 4), (N, 3)],
                    lambda m, A, v: m.mat33_vec_T(A, v)),
    "along_ray": ([(N, 3), (N, 3), (N,)],
                  lambda m, o, d, t: m.along_ray(o, d, t)),
    "vnormalize": ([(N, 3)], lambda m, a: m.vnormalize(a)),
    "triangle_distribution": ([(N,)],
                              lambda m, a: m.triangle_distribution(a)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_float_layer_bitexact(name):
    shapes, fn = CASES[name]
    xs = _inputs(name, shapes)
    want = jax.jit(lambda *a: fn(jvm, *a))(*[jnp.asarray(x) for x in xs])
    got = fn(tvm, *[torch.from_numpy(x) for x in xs])
    assert_bits(got, want, name)


def _split64(x):
    return (torch.tensor([x >> 32], dtype=torch.int64),
            torch.tensor([x & 0xFFFFFFFF], dtype=torch.int64))


def _join64(h, l):
    return (int(h[0]) << 32) | int(l[0])


def test_pcg_primitives_match_reference_models():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        b = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        assert _join64(*tpcg.mul64(*_split64(a), *_split64(b))) == \
            (a * b) & ref.M64
        assert _join64(*tpcg.hash64(*_split64(a))) == ref.hash64(a)
        state = ref.pcg32_seed(a)
        sh, sl = tpcg.pcg32_seed(*_split64(a))
        assert _join64(sh, sl) == state
        for _ in range(4):
            out_ref, state = ref.pcg32_next(state)
            out, sh, sl = tpcg.pcg32_next(sh, sl)
            assert int(out[0]) == out_ref and _join64(sh, sl) == state
    xs = [0, 1, 17, 123456, 0xFFFFFFFF, 2654435769, 0x80000000]
    got = tpcg.hash32(torch.tensor(xs, dtype=torch.int64))
    assert [int(g) for g in got] == [ref.hash32(x) for x in xs]
    got = tpcg.uint_to_unit_real(torch.tensor(xs, dtype=torch.int64))
    assert [np.float32(g) for g in got] == \
        [np.float32(ref.uint_to_unit_real(x)) for x in xs]


@pytest.mark.parametrize("kind", [tsmp.RANDOM, tsmp.HALTON,
                                  tsmp.HAMMERSLEY])
def test_sampler_streams_bitexact(kind):
    """init_sampler + 10 get_dimension calls on 512 (pixel, pass) lanes,
    against the JAX package vmapped over the same lanes."""
    rng = np.random.default_rng(7)
    B = 512
    pix = rng.integers(0, 1920 * 1080, B).astype(np.uint32)
    passes = rng.integers(0, 300, B).astype(np.int32)
    spp = np.full(B, 300, np.int32)

    def jax_stream(pix, passes, spp):
        s = jsmp.init_sampler(kind, passes, spp, pix)
        vals = []
        for _ in range(10):
            v, s = jsmp.get_dimension(kind, s)
            vals.append(v)
        return jnp.stack(vals), s.curr_prime, s.pcg_hi, s.pcg_lo

    want = jax.jit(jax.vmap(jax_stream, out_axes=(1, 0, 0, 0)))(
        pix, passes, spp)
    s = tsmp.init_sampler(kind, torch.from_numpy(passes),
                          torch.from_numpy(spp),
                          torch.from_numpy(pix.astype(np.int64)))
    vals = []
    for _ in range(10):
        v, s = tsmp.get_dimension(kind, s)
        vals.append(v)
    assert_bits(torch.stack(vals), want[0], kind)
    np.testing.assert_array_equal(s.curr_prime.numpy(),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(s.pcg_hi.numpy(),
                                  np.asarray(want[2]).astype(np.int64))
    np.testing.assert_array_equal(s.pcg_lo.numpy(),
                                  np.asarray(want[3]).astype(np.int64))


def test_select_state_keeps_untouched_fields():
    s = tsmp.init_sampler(tsmp.RANDOM, torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.int32),
                          torch.arange(4))
    _, s2 = tsmp.get_dimension(tsmp.RANDOM, s)
    sel = tsmp.select_state(torch.tensor([True, False, True, False]), s2, s)
    assert sel.rnd_offset is s.rnd_offset
    assert torch.equal(sel.pcg_lo[1::2], s.pcg_lo[1::2])
    assert torch.equal(sel.pcg_lo[0::2], s2.pcg_lo[0::2])


def test_camera_primaries_bitexact():
    """Primary rays of the port's renderer against
    WavefrontRenderer._init_rays on assets/entry_scene.json."""
    from craytpu.scene.sceneloader import load_scene_from_file as jload
    from craytpu.scene.compile import compile_scene as jcompile
    from craytpu.models.wavefront_pt import WavefrontRenderer as JR
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer

    path = os.path.join(ASSETS, "entry_scene.json")
    ov = {"width": 48, "height": 32}
    jr = JR(jcompile(jload(path, ov)))
    tr = WavefrontRenderer(compile_scene(load_scene_from_file(path, ov),
                                         "cpu"))
    ys, xs = np.mgrid[0:32, 0:48]
    xs = xs.reshape(-1).astype(np.int32)
    ys = ys.reshape(-1).astype(np.int32)
    for p in (0, 3):
        jo, jd, js = jr._init_rays(jnp.asarray(xs), jnp.asarray(ys),
                                   jnp.int32(p), jnp.int32(4))
        to, td, ts = tr._init_rays(torch.from_numpy(xs),
                                   torch.from_numpy(ys), p, 4)
        assert_bits(to, jo, "origin")
        assert_bits(td, jd, "direction")
        np.testing.assert_array_equal(ts.pcg_lo.numpy(),
                                      np.asarray(js.pcg_lo).astype(np.int64))
