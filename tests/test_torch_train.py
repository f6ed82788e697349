"""The port's inverse-rendering train step (craytpu_torch/parallel/
shard.py) on the CPU, against craytpu's parallel/shard.py on a CPU mesh of
2 devices (sample 2 x rays 1; tests/conftest.py gives 8 host devices),
with n_sample=2 on the port's side.

Tolerances: on tests/test_torch_grad.py's mirror scene (no sin/cos
reaches the image) render, loss and every gradient table within
rtol=1e-5, atol=1e-7; one material Adam step's loss within rtol=1e-5 and
its updated tables within atol=1e-6 wherever craytpu's gradient exceeds
1e-3 of its table's largest (Adam's first step moves every other entry
by about +-lr, with the sign of a gradient that is noise there). The
geometry step runs on a 16x12 cut of tests/test_edge_occluder.py's scene
under a gradient background: diffuse, so sin/cos reach it; loss within
rtol=1e-3, tri_packed gradient within a relative L2 error of 2e-2.
craytpu's gradients are read from its Adam state (mu = 0.1 g after one
step), the port's likewise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytpu.models.wavefront_pt import WavefrontRenderer as JaxRenderer
from craytpu.parallel import shard as jshard
from craytpu.scene.compile import compile_scene as jcompile
from craytpu.scene.sceneloader import load_scene_from_buf as jload_buf
from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.parallel import shard
from craytpu_torch.scene.compile import scene_from_arrays
from tests.test_torch_edge import Pair, write_scene
from tests.test_torch_grad import (MIRROR_SCENE, grads, grid, leaf_params,
                                   rel_l2)
from tests.test_torch_scene import jax_arrays

torch.set_num_threads(2)

DEPTH = 2
N_SAMPLE = 2


def table_dict(params) -> dict:
    """ShadeParams (either package's) -> {table name: numpy array}."""
    if hasattr(params, "_asdict"):
        return {k: np.asarray(v) for k, v in params._asdict().items()}
    return {k: v.detach().numpy() for k, v in vars(params).items()}


@pytest.fixture(scope="module")
def mirror():
    """The mirror scene in both packages, a (sample 2 x rays 1) mesh, its
    pixels and a seeded target."""
    jcs = jcompile(jload_buf(json.dumps(MIRROR_SCENE)))
    jr = JaxRenderer(jcs, bounces=DEPTH)
    cs = scene_from_arrays(jax_arrays(jcs), "cpu")
    r = WavefrontRenderer(cs, bounces=DEPTH)
    mesh = jshard.make_mesh(2, n_sample=N_SAMPLE)
    assert dict(mesh.shape) == {jshard.SAMPLE_AXIS: 2, jshard.RAY_AXIS: 1}
    xs, ys = grid(cs.camera.width, cs.camera.height)
    target = np.random.default_rng(17).uniform(
        0.0, 1.0, (xs.shape[0], 3)).astype(np.float32)
    return jcs, jr, cs, r, mesh, xs, ys, target


def test_render_loss_grads_equal_craytpu(mirror):
    jcs, jr, cs, r, mesh, xs, ys, target = mirror
    jxs, jys = jnp.asarray(xs), jnp.asarray(ys)
    want_img = np.asarray(jax.jit(jshard.make_sharded_render_fn(
        jr, mesh, DEPTH))(jcs.params, jxs, jys, jnp.int32(1)))
    jloss = jshard.make_loss_fn(jr, mesh, DEPTH)
    want_loss, jg = jax.jit(jax.value_and_grad(jloss))(
        jcs.params, jxs, jys, jnp.asarray(target), jnp.int32(1))

    txs, tys = torch.from_numpy(xs), torch.from_numpy(ys)
    with torch.no_grad():
        img = shard.make_sharded_render_fn(r, N_SAMPLE, DEPTH)(
            cs.params, txs, tys, 1)
    p = leaf_params(cs.params)
    loss = shard.make_loss_fn(r, N_SAMPLE, DEPTH)(
        p, txs, tys, torch.from_numpy(target), 1)
    loss.backward()
    assert np.abs(want_img).max() > 0
    np.testing.assert_allclose(img.numpy(), want_img, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5,
                               atol=1e-7)
    got = grads(p)
    for k, v in table_dict(jg).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert np.abs(got["colors"]).max() > 0


def test_material_step_equals_craytpu(mirror):
    jcs, jr, cs, r, mesh, xs, ys, target = mirror
    lr = 1e-2
    jstep, jinit = jshard.make_train_step(jr, mesh, DEPTH, learning_rate=lr)
    jtheta, jstate, jloss = jstep(jcs.params, jinit(jcs.params),
                                  jnp.asarray(xs), jnp.asarray(ys),
                                  jnp.asarray(target), jnp.int32(0))
    step, init = shard.make_train_step(r, N_SAMPLE, DEPTH, learning_rate=lr)
    theta, state, loss = step(cs.params, init(cs.params), torch.from_numpy(xs),
                              torch.from_numpy(ys), torch.from_numpy(target),
                              0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.count == 1 and int(jstate[0].count) == 1
    want = table_dict(jtheta)
    got = table_dict(theta)
    jmu = table_dict(jstate[0].mu)
    moved = 0
    for k, w in want.items():
        g = np.abs(jmu[k]) / 0.1
        if g.max() == 0:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[k][sel], w[sel], rtol=0, atol=1e-6,
                                   err_msg=k)
        moved += int((w != table_dict(jcs.params)[k]).sum())
    assert moved > 0


@pytest.fixture(scope="module")
def occluder(tmp_path_factory):
    return Pair(*write_scene(tmp_path_factory.mktemp("train_occ"), "occ"))


def test_geometry_step_near_craytpu(occluder):
    p = occluder
    W, H = p.cs.camera.width, p.cs.camera.height
    xs, ys = grid(W, H)
    mesh = jshard.make_mesh(2, n_sample=N_SAMPLE)
    jxs, jys = jnp.asarray(xs), jnp.asarray(ys)
    target = np.asarray(jax.jit(jshard.make_sharded_render_fn(
        p.jr, mesh, DEPTH))(p.jcs.params, jxs, jys, jnp.int32(7)))[..., :3] \
        * 0.8
    lr = 5e-3
    jstep, jinit = jshard.make_train_step(
        p.jr, mesh, DEPTH, learning_rate=lr, geometry=True, scene=p.jscene,
        edge_samples=8)
    jtheta0 = (p.jcs.params, p.jcs.geom.tri_packed)
    _, jstate, jloss = jstep(jtheta0, jinit(jtheta0), jxs, jys,
                             jnp.asarray(target), jnp.int32(0))

    step, init = shard.make_train_step(
        p.r, N_SAMPLE, DEPTH, learning_rate=lr, geometry=True,
        scene=p.scene, edge_samples=8)
    tp0 = p.cs.geom.tri_packed
    theta, state, loss = step((p.cs.params, tp0), init((p.cs.params, tp0)),
                              torch.from_numpy(xs), torch.from_numpy(ys),
                              torch.from_numpy(target), 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    want_g = np.asarray(jstate[0].mu[1])
    got_g = state.mu[1].numpy()
    assert np.abs(want_g[2]).max() > 0 and np.isfinite(got_g).all()
    assert rel_l2(got_g, want_g) <= 2e-2
    tp1 = theta[1].numpy()
    assert np.isfinite(tp1).all()
    assert all(np.isfinite(v).all() for v in table_dict(theta[0]).values())
    # the occluder (the last triangle) moved
    assert np.abs(tp1[2, :9] - tp0[2, :9].numpy()).max() > 0


def test_geometry_needs_scene(mirror):
    _, jr, _, r, mesh = mirror[:5]
    with pytest.raises(ValueError):
        jshard.make_train_step(jr, mesh, DEPTH, geometry=True)
    with pytest.raises(ValueError):
        shard.make_train_step(r, N_SAMPLE, DEPTH, geometry=True)


def test_pad_to():
    for n in (0, 1, 7, 8, 9, 1000):
        for m in (1, 2, 8, 96):
            assert shard.pad_to(n, m) == jshard.pad_to(n, m)
            assert shard.pad_to(n, m) % m == 0 and 0 <= \
                shard.pad_to(n, m) - n < m
