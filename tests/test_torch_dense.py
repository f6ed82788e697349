"""The dense search (CRAYTPU_TRAVERSAL=dense; K3's plain version,
craytpu_torch/ops/dense_isect.py) against the JAX package's dense search
(craytpu/ops/dense_isect.py) and against the port's BVH walk, on the CPU.
(K3 against its plain version on the card: tests/test_torch_kernels.py.)

Bars, those of tests/test_dense_isect.py:
  - the coefficient table is the JAX package's, bit for bit;
  - searches: hit/miss identical on every ray, the winning instance equal
    on more than 0.999 of the rays and the triangle equal wherever the
    instance is. The two searches round differently (a bilinear form
    against Möller–Trumbore; the JAX package moves rays into instance
    space by einsum and sums by matmul), so a ray that grazes an edge or
    a tie may pick another winner;
  - records (K1's plain version) of the dense winners bit-equal to the
    walk's wherever the winner is the same; against the JAX package's
    dense record, which rounds its instance-space ray by einsum: t within
    rtol 1e-5, u and v within rtol 1e-4, atol 1e-5;
  - renders: against the port's walk render at the JAX package's bar
    (equal on more than 0.98 of the values, max |d| < 1e-5), against the
    JAX package's dense render at the golden thresholds (sin/cos differ
    in the last bits between XLA and PyTorch); a diff_geometry gradient
    equal to the walk's within rtol 2e-4, atol 1e-6.

The JAX package's dense calls are jitted and tiny (32x24 scenes, at most
4,096 rays): its search compiles one scan per mesh instance, 64 on
stress_instances."""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.ops.dense_isect import make_dense_traverse_fn
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_file as jload
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import hitrec as hr
from craytpu_torch.ops import traverse as trv
from craytpu_torch.scene.compile import compile_scene, scene_from_arrays
from craytpu_torch.scene.sceneloader import (load_scene_from_buf,
                                              load_scene_from_file)
from craytpu_torch.utils import golden
from tests.test_torch_detmath import assert_bits
from tests.test_torch_scene import jax_arrays
from tests.test_vertex_grad import FLAT_SCENE

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
FLT_MAX = np.float32(3.4028235e38)
TB = dx.TRI_BLOCK
# rays a search: the plain dense search on stress_instances tests 64 x
# 1,984 triangles a ray
N_RAYS = {"entry_scene": 4096, "stress_instances": 1024}


@pytest.fixture(scope="module", params=["entry_scene", "stress_instances"])
def scenes(request):
    path = os.path.join(ASSETS, f"{request.param}.json")
    ov = {"width": 32, "height": 24}
    return (request.param, jcompile(jload(path, ov)),
            compile_scene(load_scene_from_file(path, ov), "cpu"))


def rays(tcs, B, seed):
    """Origins around the scene bounds; half the directions random, half
    toward a random point of the bounds (so that many rays hit)."""
    rng = np.random.default_rng(seed)
    bb = tcs.geom.node_bounds[0].numpy()
    lo, hi = bb[[0, 2, 4]], bb[[1, 3, 5]]
    span = hi - lo
    o = rng.uniform(lo - 0.3 * span, hi + 0.3 * span,
                    (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    aim = rng.uniform(lo, hi, (B // 2, 3)).astype(np.float32) - o[:B // 2]
    d[:B // 2] = aim
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def searched(scenes):
    """The same rays through the JAX package's dense search, the port's
    dense search and the port's walk, and the port's records of both."""
    name, jcs, tcs = scenes
    o, d = rays(tcs, N_RAYS[name], 17)
    jh = jax.jit(lambda g, o, d: make_dense_traverse_fn(jcs.dense_meta)(
        g, o, d))(jcs.geom, jnp.asarray(o), jnp.asarray(d))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    limit = torch.full((o.shape[0],), float(FLT_MAX))
    dense = dx.dense_hit(tcs.geom, to, td, limit, tcs.dense)
    walk = trv.closest_hit(tcs.geom, to, td, limit, tcs.tlas_end,
                           tcs.stack_depth)

    def record(h):
        return hr.hitrec_record(tcs.tri_wide, tcs.inst_wide, to, td, h.t,
                                h.prim, h.inst, tcs.sphere_uv)
    return dict(jax=jh, dense=dense, walk=walk, rec_dense=record(dense),
                rec_walk=record(walk))


def scatter(rows: np.ndarray) -> np.ndarray:
    """(n, 16) table rows -> the JAX package's (nb, 10, 4*TB) blocks."""
    n = rows.shape[0]
    nb = max((n + TB - 1) // TB, 1)
    W = np.zeros((nb * TB, 4, 10), np.float32)
    W[:n, 0, 0:3] = rows[:, 0:3]
    W[:n, 1, 0:3] = rows[:, 3:6]
    W[:n, 1, 6:9] = rows[:, 6:9]
    W[:n, 2, 0:3] = rows[:, 9:12]
    W[:n, 2, 6:9] = rows[:, 12:15]
    W[:n, 3, 3:6] = -rows[:, 0:3]
    W[:n, 3, 9] = rows[:, 15]
    return W.reshape(nb, TB, 4, 10).transpose(0, 3, 2, 1).reshape(
        nb, 10, 4 * TB)


def test_coefficients_match_jax_package(scenes):
    """build_tri_coeffs and the (P, 16) table, scattered back, equal the
    JAX package's blocks bit for bit; each mesh's rows and the instance
    order are the JAX package's; a scene built from the JAX package's
    arrays (as a cluster worker gets it) builds the same table."""
    _, jcs, tcs = scenes
    dm = jcs.dense_meta
    tp = tcs.geom.tri_packed.numpy()
    table = tcs.dense.table.numpy()
    rows = dx.mesh_rows(tcs.geom)
    n_checked = 0
    for mi, W in enumerate(dm["mesh_W"]):
        if W is None:
            assert rows[mi][1] == 0
            continue
        base, n = rows[mi]
        assert base == dm["mesh_base"][mi]
        assert_bits(dx.build_tri_coeffs(tp[base:base + n]), np.asarray(W),
                    f"mesh {mi} coefficients")
        assert_bits(scatter(table[base:base + n]), np.asarray(W),
                    f"mesh {mi} table")
        n_checked += 1
    assert n_checked > 0
    assert [(i, k, o) for i, (k, _, _, o) in
            enumerate(tcs.dense.plan.tolist())] \
        == [tuple(x) for x in dm["inst_order"]]
    arrays = scene_from_arrays(jax_arrays(jcs), "cpu").dense
    assert_bits(arrays.table, table, "table from the JAX package's arrays")
    assert torch.equal(arrays.plan, tcs.dense.plan)


def test_dense_matches_jax_dense_and_walk(searched):
    """Winners against the JAX package's dense search and against the
    port's walk: hit/miss identical, instance equal on > 0.999 of the
    rays, triangle equal wherever the instance is."""
    dense = searched["dense"]
    inst = dense.inst.numpy()
    for name, other in (("jax dense", searched["jax"]),
                        ("walk", searched["walk"])):
        o_inst = np.asarray(other.inst)
        np.testing.assert_array_equal(inst >= 0, o_inst >= 0, name)
        agree = inst == o_inst
        assert agree.mean() > 0.999, (name, agree.mean())
        np.testing.assert_array_equal(dense.prim.numpy()[agree],
                                      np.asarray(other.prim)[agree], name)
    hits = inst >= 0
    assert hits.mean() > 0.1  # the rays do hit the scene
    assert (dense.prim.numpy()[hits] >= 0).any()  # triangles among them


def test_dense_records_match_walk_and_jax_dense(searched):
    """K1's records of the dense winners: bit-equal to the walk's where
    the winner is the same; t, u, v against the JAX package's dense
    record at its tolerances."""
    dense, walk, jh = searched["dense"], searched["walk"], searched["jax"]
    same = (dense.inst == walk.inst) & (dense.prim == walk.prim)
    assert same.float().mean() > 0.999
    assert_bits(searched["rec_dense"][same], searched["rec_walk"][same],
                "records")
    rec = searched["rec_dense"].numpy()
    hit = (same.numpy() & (dense.inst.numpy() >= 0)
           & (dense.inst.numpy() == np.asarray(jh.inst))
           & (dense.prim.numpy() == np.asarray(jh.prim)))
    assert hit.sum() > 50
    np.testing.assert_allclose(rec[hit, 0], np.asarray(jh.t)[hit], rtol=1e-5)
    np.testing.assert_allclose(rec[hit, 1], np.asarray(jh.u)[hit],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rec[hit, 2], np.asarray(jh.v)[hit],
                               rtol=1e-4, atol=1e-5)


def test_dense_dead_lanes_never_hit(scenes):
    """A lane with limit 0 misses (t FLT_MAX, ids -1); the live lanes'
    winners are the full search's."""
    _, _, tcs = scenes
    o, d = (torch.from_numpy(x) for x in rays(tcs, 256, 5))
    alive = torch.arange(256) % 3 != 0
    full = dx.dense_hit(tcs.geom, o, d, torch.full((256,), float(FLT_MAX)),
                        tcs.dense)
    h = dx.dense_hit(tcs.geom, o, d,
                     torch.where(alive, float(FLT_MAX), 0.0), tcs.dense)
    assert (full.inst[~alive] >= 0).any()  # they would have hit
    assert (h.inst[~alive] == -1).all() and (h.prim[~alive] == -1).all()
    assert (h.t[~alive] == float(FLT_MAX)).all()
    assert torch.equal(h.inst[alive], full.inst[alive])
    assert torch.equal(h.prim[alive], full.prim[alive])
    assert_bits(h.t[alive], full.t[alive], "t")


@pytest.fixture(scope="module")
def entry():
    path = os.path.join(ASSETS, "entry_scene.json")
    ov = {"width": 32, "height": 24}
    return jcompile(jload(path, ov)), compile_scene(
        load_scene_from_file(path, ov), "cpu")


def test_dense_render_matches_walk_and_jax_dense(entry, monkeypatch):
    """A 32x24 render under CRAYTPU_TRAVERSAL=dense against the port's
    walk render and the JAX package's dense render."""
    jcs, tcs = entry
    monkeypatch.delenv("CRAYTPU_TRAVERSAL", raising=False)
    walk = WavefrontRenderer(tcs, bounces=4)
    assert walk.traversal_mode == "auto" and walk.traversal == "walk"
    fb_w = walk.render(spp=2)
    monkeypatch.setenv("CRAYTPU_TRAVERSAL", "dense")
    r = WavefrontRenderer(tcs, bounces=4)
    assert r.traversal_mode == "dense" and r.isect.traversal == "dense"
    n = hr.hitrec_record.launches
    fb_d = r.render(spp=2)
    diff = np.abs(fb_d - fb_w)
    assert (diff == 0).mean() > 0.98
    assert diff.max() < 1e-5
    jr = JaxRenderer(jcs, bounces=4)
    assert jr.traversal_mode == "dense"
    want = jr.render(spp=2)
    ok, within, mean_abs = golden.compare_u8(golden.srgb_u8(fb_d),
                                             golden.srgb_u8(want))
    assert ok, (within, mean_abs)
    assert hr.hitrec_record.launches == n  # the plain versions, on the CPU


def test_dense_geometry_gradient_matches_walk(monkeypatch):
    """make_trace_fn(diff_geometry=True) under dense on
    tests/test_vertex_grad.py's flat cube: the image and the gradients
    into tri_packed and the material colors equal the walk's within rtol
    2e-4, atol 1e-6."""
    cs = compile_scene(load_scene_from_buf(json.dumps(FLAT_SCENE),
                                           ASSETS + "/"), "cpu")
    ys, xs = np.mgrid[20:44, 30:60]
    xs = torch.from_numpy(xs.reshape(-1).astype(np.int32))
    ys = torch.from_numpy(ys.reshape(-1).astype(np.int32))
    out = {}
    for mode in ("auto", "dense"):
        monkeypatch.setenv("CRAYTPU_TRAVERSAL", mode)
        trace = WavefrontRenderer(cs, bounces=2).make_trace_fn(
            2, diff_geometry=True)
        tp = cs.geom.tri_packed.clone().requires_grad_()
        colors = cs.params.colors.clone().requires_grad_()
        img = trace(replace(cs.params, colors=colors), tp, xs, ys, 0, 1)
        img[..., :3].mean().backward()
        out[mode] = (img.detach(), tp.grad, colors.grad)
    assert float(out["auto"][1].abs().max()) > 0  # a vertex gradient
    for got, want in zip(out["dense"], out["auto"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6)


def test_unknown_traversal_raises(entry, monkeypatch):
    _, tcs = entry
    monkeypatch.setenv("CRAYTPU_TRAVERSAL", "bvh")
    with pytest.raises(ValueError, match="CRAYTPU_TRAVERSAL"):
        WavefrontRenderer(tcs)
    with pytest.raises(ValueError, match="traversal"):
        hr.Isect(tcs, traversal="dense2")
