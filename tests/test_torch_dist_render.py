"""The port's multi-rank renderer (craytpu_torch/parallel/pool_shard.py
over torch.distributed) on the CPU, against craytpu's ShardedPoolRenderer
on sub-meshes of the 8 virtual CPU devices of tests/conftest.py.

The port's ranks are gloo groups started with dist.spawn_local (one
thread of torch each); their bodies are in tests/torch_dist_ranks.py,
which imports neither jax nor craytpu. A 2-rank and a 3-rank group and
the multi-rank CLI run while craytpu's side runs here, on
assets/entry_scene.json at 16x16 with 8x8 tiles, a pool of 128 lanes a
rank (so refills and uneven shares happen: spp 3 over 2 ranks, spp 4
over 3) and one bounce a step (CRAYTPU_POOL_K=1, so paths are in flight
at an interrupt).

Tolerances: a group's frame against craytpu's sharded frame, and a
resumed frame against the uninterrupted one, rtol 2e-5, atol 2e-6
(tests/test_pool_shard.py:35: the same per-(pixel, pass) streams summed
in another order); every rank holds the same frame bit for bit; the
multi-rank CLI's PNG against the single-process CLI's within the golden
thresholds of craytpu/utils/golden.py:26-27."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from craytpu_torch.parallel import dist
from tests import torch_dist_ranks as ranks

RTOL, ATOL = 2e-5, 2e-6
OVERRIDES = {"width": 16, "height": 16, "tileWidth": 8, "tileHeight": 8}
TILE_RAYS = 128
TILE = 1
REPO = ranks.REPO
CLI_ARGS = [ranks.ENTRY, "-s", "2", "-d", "16x12"]


def cli_process(cwd, rank=None, world=None, port=None):
    """`python -m craytpu_torch CLI_ARGS` on the CPU in `cwd`: alone, or
    as one rank of a group configured through the CRAYTPU_* variables."""
    env = dict(os.environ, CRAYTPU_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    if rank is not None:
        env.update(CRAYTPU_COORDINATOR=f"127.0.0.1:{port}",
                   CRAYTPU_NUM_PROCESSES=str(world),
                   CRAYTPU_PROCESS_ID=str(rank))
    return subprocess.Popen(
        [sys.executable, "-m", "craytpu_torch"] + CLI_ARGS, cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def in_thread(fn, *args, **kw):
    """Run fn in a thread; .result() joins it and returns or raises."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - raised in result()
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()

    class Handle:
        @staticmethod
        def result():
            t.join(timeout=300)
            if "err" in box:
                raise box["err"]
            return box["out"]
    return Handle


def jax_renders(D: int, inbox=None):
    """craytpu's ShardedPoolRenderer on D of the virtual devices: its
    frames, and with an inbox its renderer and the interrupt checkpoint
    it also puts there (for the port's group)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from craytpu.parallel.pool_shard import ShardedPoolRenderer
    from craytpu.scene.compile import compile_scene
    from craytpu.scene.sceneloader import load_scene_from_file
    r = ShardedPoolRenderer(
        compile_scene(load_scene_from_file(ranks.ENTRY, OVERRIDES)),
        tile_rays=TILE_RAYS,
        mesh=Mesh(np.asarray(jax.devices()[:D]), ("pool",)))
    out = {}
    if inbox is not None:
        ck = r.render_persistent(spp=4, interrupt=ranks.interrupt_at(3))
        out["ckpt"] = (np.asarray(ck[1]), np.asarray(ck[2]), ck[3])
        inbox.put(out["ckpt"])
        out["renderer"] = r
    for spp in (4, 3):
        out[f"persistent{spp}"] = np.asarray(r.render_persistent(spp=spp))
    acc = jnp.zeros((r.height, r.width, 4), jnp.float32)
    for p in range(2):
        acc = r.render_pass(acc, p, 4)
    out["pass"] = np.asarray(acc)
    out["ids"] = np.asarray(r.render_ids(ranks.tile_ranges(r, TILE, 4), 4))
    return out


def jax_side(inbox, outbox):
    """craytpu's D=2 and D=3 renders (in two threads, so that their
    compiles overlap); its D=2 interrupt checkpoint goes to the port's
    group through `inbox`, and the port's checkpoint from `outbox`
    resumes on craytpu D=2."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CRAYTPU_POOL_K", "1")
        d3 = in_thread(jax_renders, 3)
        d2 = jax_renders(2, inbox)
        out = {(2, k): v for k, v in d2.items()}
        out.update({(3, k): v for k, v in d3.result().items()})
        out["ckpt"] = d2["ckpt"]
        fs, pend, rg = outbox.get(timeout=120)
        out["from_port"] = np.asarray(d2["renderer"].render_persistent(
            spp=4, resume={"final_sum": fs, "pending": pend, "ranges": rg}))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything at once: the CLI processes and the port's groups start
    first, craytpu's side runs here meanwhile, then the port's single
    rank resumes the group's checkpoint."""
    import torch
    import torch.multiprocessing as mp
    cli_dir = {k: tmp_path_factory.mktemp(f"cli_{k}") for k in ("1", "2")}
    port = dist.free_port()
    clis = [cli_process(cli_dir["1"])] + [
        cli_process(cli_dir["2"], i, 2, port) for i in range(2)]
    ctx = mp.get_context("spawn")
    inbox, outbox = ctx.Queue(), ctx.Queue()
    kw = dict(device="cpu", threads=1, timeout_s=300,
              collective_timeout_s=200)
    g2 = in_thread(dist.spawn_local, 2, ranks.render_group, OVERRIDES,
                   TILE_RAYS, (4, 3), TILE, inbox, outbox, **kw)
    g3 = in_thread(dist.spawn_local, 3, ranks.render_group, OVERRIDES,
                   TILE_RAYS, (4, 3), TILE, **kw)
    g1 = in_thread(dist.spawn_local, 1, ranks.single_rank_class, **kw)
    try:
        jx = jax_side(inbox, outbox)
        out = {"jax": jx, 2: g2.result(), 3: g3.result(),
               "one_rank_class": g1.result()[0]}
    finally:
        logs = []
        for p in clis:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    out["cli"] = [(p.returncode, log) for p, log in zip(clis, logs)]
    out["cli_dir"] = cli_dir
    # the group's checkpoint resumed on one rank: the single-card port
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    torch.set_num_threads(2)
    fs, pend, rg = out[2][0]["ckpt"]
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("CRAYTPU_POOL_K", "1")
        single = WavefrontRenderer(
            compile_scene(load_scene_from_file(ranks.ENTRY, OVERRIDES),
                          "cpu"), tile_rays=TILE_RAYS)
        out["port1_resumed"] = single.render_persistent(
            spp=4, resume={"final_sum": fs, "pending": pend, "ranges": rg})
    return out


def test_make_renderer_picks_by_group_size(world):
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    r = make_renderer(compile_scene(load_scene_from_file(
        ranks.ENTRY, {"width": 8, "height": 8}), "cpu"))
    assert type(r) is WavefrontRenderer           # no process group
    assert world["one_rank_class"] == "WavefrontRenderer"
    for D in (2, 3):
        r0 = world[D][0]
        assert r0["class"] == "ShardedPoolRenderer" and r0["D"] == D
        # the ranks are processes of the port alone
        assert not any(r["jax_loaded"] for r in world[D])
        # every rank renders on the one CPU: one device
        assert r0["n_cards"] == 1


@pytest.mark.parametrize("D", [2, 3])
def test_every_rank_holds_the_same_frames(world, D):
    digests = [r["digests"] for r in world[D]]
    assert len(digests[0]) >= 4
    assert all(d == digests[0] for d in digests[1:])


@pytest.mark.parametrize("what", ["persistent4", "persistent3", "pass",
                                  "ids"])
@pytest.mark.parametrize("D", [2, 3])
def test_group_matches_craytpu(world, D, what):
    got, want = world[D][0][what], world["jax"][D, what]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("crossing", ["port2_to_port1", "port2_to_craytpu2",
                                      "craytpu2_to_port2"])
def test_checkpoint_resumes_across_ranks_and_packages(world, crossing):
    """An interrupt at the 3rd poll of a 2-rank (2-device) render resumes
    to the uninterrupted frame on another rank count or in the other
    package."""
    port, jx = world[2][0], world["jax"]
    src = jx["ckpt"] if crossing.startswith("craytpu") else port["ckpt"]
    fs, pend, ranges = src
    npix = 16 * 16
    assert len(pend) > 0 and ranges                 # genuinely mid-flight
    assert 0 < sum(b - a for a, b in ranges) < 4 * npix
    got, want = {
        "port2_to_port1": (world["port1_resumed"], port["persistent4"]),
        "port2_to_craytpu2": (jx["from_port"], jx[2, "persistent4"]),
        "craytpu2_to_port2": (port["resumed"], port["persistent4"]),
    }[crossing]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_multi_rank_cli_writes_one_png(world):
    from craytpu_torch.io.png import read_png_rgb
    from craytpu_torch.utils import golden
    for rc, log in world["cli"]:
        assert rc == 0, log[-3000:]
    pngs = {k: sorted(os.listdir(d / "output"))
            for k, d in world["cli_dir"].items()}
    assert pngs["2"] == ["entry_0000.png"], pngs
    got = read_png_rgb(str(world["cli_dir"]["2"] / "output" /
                           "entry_0000.png"))
    want = read_png_rgb(str(world["cli_dir"]["1"] / "output" /
                            "entry_0000.png"))
    assert got.shape == want.shape == (12, 16, 3)
    ok, within, mean_abs = golden.compare_u8(got, want)
    assert ok, (within, mean_abs)
