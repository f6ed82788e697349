"""The closest-hit walk (K2's plain version) and the hit-record resolve
(K1's plain version) against the JAX package, bit for bit. (The CUDA
kernels against these plain versions: tests/test_torch_kernels.py.)

Random rays as tests/test_flash2_interpret.py makes them; random winner
ids as tests/test_hitrec_kernel.py makes them, on in-repo scenes."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from craytpu.ops import hitrec as jhitrec
from craytpu.ops import hitrec_kernel as hk
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.ops import hitrec as thitrec
from craytpu_torch.ops import traverse as trv
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_torch_detmath import assert_bits

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
FLT_MAX = np.float32(3.4028235e38)


@pytest.fixture(scope="module", params=["entry_scene", "stress_instances"])
def scenes(request):
    path = os.path.join(ASSETS, f"{request.param}.json")
    ov = {"width": 32, "height": 24}
    return jcompile(jload(path, ov)), compile_scene(
        load_scene_from_file(path, ov), "cpu")


def rays(node_bounds, B, seed):
    """Origins around the scene bounds, random unit directions."""
    rng = np.random.default_rng(seed)
    bb = np.asarray(node_bounds[0])
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    span = hi - lo
    o = rng.uniform(lo - 0.3 * span, hi + 0.3 * span,
                    (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_closest_hit_plain_matches_simt_walk(scenes):
    """Hit, prim, inst and t bit-equal to craytpu's SIMT traversal."""
    from craytpu.ops.hitrec import cscene_traverse
    jcs, tcs = scenes
    o, d = rays(jcs.geom.node_bounds, 768, 3)
    jh = jax.jit(lambda g, o, d: cscene_traverse(jcs)(g, o, d))(
        jcs.geom, jnp.asarray(o), jnp.asarray(d))
    limit = torch.full((o.shape[0],), float(FLT_MAX))
    th = trv.closest_hit(tcs.geom, torch.from_numpy(o), torch.from_numpy(d),
                         limit, tcs.tlas_end, tcs.stack_depth)
    j_inst = np.asarray(jh.inst)
    assert (j_inst >= 0).mean() > 0.05  # the rays do hit the scene
    np.testing.assert_array_equal(th.inst.numpy(), j_inst)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    assert_bits(th.t, jh.t, "t")


def test_dead_lanes_never_hit(scenes):
    _, tcs = scenes
    o, d = rays(tcs.geom.node_bounds.numpy(), 256, 5)
    alive = np.arange(256) % 3 != 0
    limit = torch.where(torch.from_numpy(alive), float(FLT_MAX), 0.0)
    full = trv.closest_hit(tcs.geom, torch.from_numpy(o),
                           torch.from_numpy(d),
                           torch.full((256,), float(FLT_MAX)),
                           tcs.tlas_end, tcs.stack_depth)
    h = trv.closest_hit(tcs.geom, torch.from_numpy(o), torch.from_numpy(d),
                        limit, tcs.tlas_end, tcs.stack_depth)
    assert (full.inst.numpy()[~alive] >= 0).any()  # they would have hit
    assert (h.inst.numpy()[~alive] == -1).all()
    assert (h.prim.numpy()[~alive] == -1).all()
    assert (h.t.numpy()[~alive] == FLT_MAX).all()
    np.testing.assert_array_equal(h.inst.numpy()[alive],
                                  full.inst.numpy()[alive])
    assert_bits(h.t.numpy()[alive], full.t.numpy()[alive], "t")


def winners(jcs, seed):
    """hk.BLK random rays and winner ids, valid and degenerate alike."""
    dm = jcs.dense_meta
    B = hk.BLK
    rng = np.random.default_rng(seed)
    o, d = rays(jcs.geom.node_bounds, B, seed)
    P = dm["tri_wide"].shape[0]
    I = dm["inst_wide"].shape[0]
    prim = rng.integers(-1, P, B, dtype=np.int32)
    inst = rng.integers(-1, I, B, dtype=np.int32)
    t_k = rng.uniform(0, 20, B).astype(np.float32)
    return o, d, t_k, prim, inst


def test_hitrec_plain_matches_jax_hitrec_and_pallas_kernel(scenes):
    """K1's plain version against craytpu's make_hitrec_fn and its Pallas
    kernel (interpret mode): t, u, v, p_w, n_w, mesh uv bit-equal."""
    jcs, tcs = scenes
    dm = jcs.dense_meta
    o, d, t_k, prim, inst = winners(jcs, 99)
    xla = jhitrec.make_hitrec_fn(dm["tri_wide"], dm["inst_wide"],
                                 dm["sphere_uv"], diff=False)
    jo = jax.jit(lambda *a: xla(jcs.geom, *a))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_k),
        jnp.asarray(prim), jnp.asarray(inst))
    kernel = hk.build_hitrec_kernel(dm["sphere_uv"], interpret=True)
    tw = jnp.asarray(dm["tri_wide"])[np.maximum(prim, 0)]
    iw = jnp.asarray(dm["inst_wide"])[np.maximum(inst, 0)]
    ko = np.asarray(jax.jit(kernel)(
        tw.T, iw.T, jnp.asarray(o).T, jnp.asarray(d).T,
        jnp.asarray(t_k)[None], jnp.asarray((prim < 0).astype(np.int32))[None],
        jnp.asarray((inst >= 0).astype(np.int32))[None])).T

    args = [torch.from_numpy(x) for x in (o, d, t_k, prim, inst)]
    rec = thitrec.hitrec_record(tcs.tri_wide, tcs.inst_wide, *args,
                                tcs.sphere_uv)
    # the whole 16-float record against the Pallas kernel's rows
    assert_bits(rec, ko, "record vs Pallas kernel")
    is_hit, p_w, n_w, uv, mat, t, u, v = thitrec.make_hitrec_fn(
        tcs.tri_wide, tcs.inst_wide, tcs.sphere_uv)(*args)
    np.testing.assert_array_equal(is_hit.numpy(), np.asarray(jo[0]))
    for name, got, want in (("p_w", p_w, jo[1]), ("n_w", n_w, jo[2]),
                            ("t", t, jo[5]), ("u", u, jo[6]),
                            ("v", v, jo[7])):
        assert_bits(got, want, name)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jo[4]))
    mesh = prim >= 0
    assert_bits(uv.numpy()[mesh], np.asarray(jo[3])[mesh], "mesh uv")
