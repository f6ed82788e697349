"""The port's train step over a (sample, rays) mesh of ranks
(craytpu_torch/parallel/shard.py with make_mesh, over torch.distributed)
and its entry points (craytpu_torch/entry.py) on the CPU, against
craytpu's make_train_step on sub-meshes of the 8 virtual CPU devices of
tests/conftest.py and against __graft_entry__.py.

The port's ranks are gloo groups started with dist.spawn_local (one
thread of torch each; bodies in tests/torch_dist_ranks.py, which imports
neither jax nor craytpu), on tests/test_torch_grad.py's mirror scene (no
sin/cos reaches the image) and a seeded target. craytpu's steps run here
meanwhile.

Tolerances (tests/test_torch_train.py's): loss, image and every gradient
table within rtol=1e-5, atol=1e-7; the updated tables within atol=1e-6
wherever craytpu's gradient exceeds 1e-3 of its table's largest (Adam's
first step moves every other entry by about +-lr, with the sign of a
gradient that is noise there); every rank holds the same tables bit for
bit. entry()'s trace against craytpu's on assets/entry_scene.json, whose
diffuse bounces call sin/cos (their last bits differ between XLA and
PyTorch), within rtol=2e-5, atol=2e-6."""

import json
import threading

import numpy as np
import pytest

from craytpu_torch.parallel import dist
from tests import torch_dist_ranks as ranks

DEPTH = 2
LR = 1e-2
# mesh -> (ranks, n_sample); craytpu's step runs on the 2x2 mesh, the
# port's 1x2 step is held to the port's one-card step of the same rays
MESHES = {"2x2": (4, 2), "1x2": (2, 1)}


def table_dict(params) -> dict:
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def jax_step(text, xs, ys, target, n, n_sample) -> dict:
    """craytpu's step and mesh render on make_mesh(n, n_sample)."""
    import jax
    import jax.numpy as jnp
    from craytpu.models.wavefront_pt import WavefrontRenderer
    from craytpu.parallel import shard as jshard
    from craytpu.scene.compile import compile_scene
    from craytpu.scene.sceneloader import load_scene_from_buf
    jcs = compile_scene(load_scene_from_buf(text))
    jr = WavefrontRenderer(jcs, bounces=DEPTH)
    mesh = jshard.make_mesh(n, n_sample=n_sample)
    step, init = jshard.make_train_step(jr, mesh, DEPTH, learning_rate=LR)
    args = (jnp.asarray(xs), jnp.asarray(ys))
    theta, state, loss = step(jcs.params, init(jcs.params), *args,
                              jnp.asarray(target), jnp.int32(0))
    img = jax.jit(jshard.make_sharded_render_fn(jr, mesh, DEPTH))(
        jcs.params, *args, jnp.int32(0))
    return {"mesh": dict(mesh.shape), "loss": float(loss),
            "theta": table_dict(theta), "theta0": table_dict(jcs.params),
            "grads": {k: v / 0.1 for k, v in
                      table_dict(state[0].mu).items()},
            "img": np.asarray(img)}


def one_card_step(text, xs, ys, target) -> dict:
    """The port's step on one card with n_sample=1 (the 1x2 mesh's
    estimator) and its render, as jax_step reports craytpu's."""
    import torch
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.parallel import shard
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    cs = compile_scene(load_scene_from_buf(text), "cpu")
    r = WavefrontRenderer(cs, bounces=DEPTH)
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    step, init = shard.make_train_step(r, 1, DEPTH, learning_rate=LR)
    theta, state, loss = step(cs.params, init(cs.params), xs, ys,
                              torch.from_numpy(target), 0)
    img = shard.make_sharded_render_fn(r, 1, DEPTH)(cs.params, xs, ys, 0)
    tables = lambda p: {k: v.detach().numpy()  # noqa: E731
                        for k, v in vars(p).items()}
    return {"mesh": {"sample": 1, "rays": 2}, "loss": float(loss),
            "theta": tables(theta), "theta0": tables(cs.params),
            "grads": {k: v / 0.1 for k, v in tables(state.mu).items()},
            "img": img.detach().numpy()}


@pytest.fixture(scope="module")
def steps():
    """The port's step on each mesh of MESHES and dryrun_multichip(2)
    (groups in threads); craytpu's step on the 2x2 mesh and the port's
    one-card step (n_sample=1) here meanwhile."""
    from craytpu_torch.entry import dryrun_multichip
    from tests.test_torch_grad import MIRROR_SCENE, grid
    text = json.dumps(MIRROR_SCENE)
    W, H = MIRROR_SCENE["renderer"]["width"], MIRROR_SCENE["renderer"][
        "height"]
    xs, ys = grid(W, H)
    target = np.random.default_rng(17).uniform(
        0.0, 1.0, (xs.shape[0], 3)).astype(np.float32)
    out: dict = {"port": {}, "jax": {}}

    def port(name, n, n_sample):
        out["port"][name] = dist.spawn_local(
            n, ranks.train_step, text, xs, ys, target, n_sample, DEPTH, LR,
            device="cpu", threads=1, timeout_s=300,
            collective_timeout_s=200)

    def dryrun():
        out["dryrun"] = dryrun_multichip(2, device="cpu")
    threads = [threading.Thread(target=port, args=(k, *v), daemon=True)
               for k, v in MESHES.items()]
    threads.append(threading.Thread(target=dryrun, daemon=True))
    for t in threads:
        t.start()
    out["jax"]["2x2"] = jax_step(text, xs, ys, target, *MESHES["2x2"])
    out["one_card"] = one_card_step(text, xs, ys, target)
    for t in threads:
        t.join(timeout=300)
    assert set(out["port"]) == set(MESHES) and "dryrun" in out
    return out


def test_mesh_train_step_equals_craytpu(steps):
    check_step(steps["port"]["2x2"][0], steps["jax"]["2x2"])


def test_ray_split_step_equals_one_card_step(steps):
    check_step(steps["port"]["1x2"][0], steps["one_card"])


def check_step(got, w):
    theta0 = w["theta0"]
    assert got["mesh"] == w["mesh"]
    np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["value"], w["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["img"], w["img"], rtol=1e-5, atol=1e-7)
    moved = 0
    for k, wt in w["theta"].items():
        np.testing.assert_allclose(got["grads"][k], w["grads"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        g = np.abs(w["grads"][k])
        if g.max() == 0:
            np.testing.assert_array_equal(got["theta"][k], wt, err_msg=k)
            continue
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(got["theta"][k][sel], wt[sel], rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += int((wt != theta0[k]).sum())
    assert moved > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_takes_the_same_step(steps, mesh):
    port = steps["port"][mesh]
    assert len({r["digest"] for r in port}) == 1
    assert len({r["loss"] for r in port}) == 1


def test_entry_matches_graft_entry():
    import jax
    import __graft_entry__ as g
    from craytpu_torch.entry import entry
    fn, args = entry(device="cpu")
    got = fn(*args).numpy()
    jfn, jargs = g.entry()
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(jargs[2]))
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape == (256, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_dryrun_multichip(steps):
    out = steps["dryrun"]
    assert out["mesh"] == {"sample": 1, "rays": 2}
    assert np.isfinite(out["loss"]) and out["moved"] > 0
