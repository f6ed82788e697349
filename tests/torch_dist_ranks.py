"""Rank bodies of the port's multi-rank CPU tests
(tests/test_torch_dist_*.py). Each function runs on every rank of a gloo
group started by craytpu_torch.parallel.dist.spawn_local and returns a
picklable result. This module imports neither jax nor craytpu: the ranks
are processes of the port alone."""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = os.path.join(REPO, "assets", "entry_scene.json")


def digest(a) -> str:
    """A hash of an array's bytes: equal frames on every rank."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def interrupt_at(n):
    """An interrupt callable that fires at its n-th poll."""
    polls = []

    def interrupt():
        polls.append(1)
        return len(polls) >= n
    return interrupt


def tile_ranges(r, k: int, spp: int):
    """The queue-id ranges of tile k of the renderer's schedule, one a
    pass (parallel/cluster.py::_tile_gid_ranges)."""
    from craytpu_torch.runtime.tile import pixel_order
    p = r.cscene.prefs
    npix = r.width * r.height
    _, _, _, offsets = pixel_order(r.width, r.height, p.tile_width,
                                   p.tile_height, p.tile_order)
    off, end = int(offsets[k]), int(offsets[k + 1])
    return [[q * npix + off, q * npix + end] for q in range(spp)]


def render_group(overrides: dict, tile_rays: int, spp_list, tile: int,
                 inbox=None, outbox=None) -> dict:
    """The group's renders of assets/entry_scene.json: make_renderer's
    class; with an outbox, an interrupt at the 3rd poll (k=1) whose
    checkpoint rank 0 puts on it first; render_persistent at each spp of
    spp_list; two passes of render_pass; render_ids of one tile; with an
    inbox, a resume from the checkpoint that arrives there. Returns
    every frame (rank 0) and every frame's digest (all ranks)."""
    import torch
    from craytpu_torch.parallel import dist
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    os.environ["CRAYTPU_POOL_K"] = "1"
    cs = compile_scene(load_scene_from_file(ENTRY, overrides), "cpu")
    r = make_renderer(cs, tile_rays=tile_rays)
    out: dict = {"class": type(r).__name__, "D": getattr(r, "D", 1),
                 "n_cards": getattr(r, "n_cards", None)}
    if outbox is not None:
        ck = r.render_persistent(spp=4, interrupt=interrupt_at(3))
        if dist.rank() == 0:
            outbox.put(ck[1:])
        out["ckpt"] = ck[1:]
    for spp in spp_list:
        out[f"persistent{spp}"] = r.render_persistent(spp=spp)
    acc = torch.zeros((r.height, r.width, 4))
    for p in range(2):
        acc = r.render_pass(acc, p, 4)
    out["pass"] = acc.numpy()
    out["ids"] = r.render_ids(tile_ranges(r, tile, 4), 4)
    if inbox is not None:
        ck = dist.broadcast_object(
            inbox.get(timeout=120) if dist.rank() == 0 else None)
        out["resumed"] = r.render_persistent(
            spp=4, resume={"final_sum": ck[0], "pending": ck[1],
                           "ranges": ck[2]})
    out["jax_loaded"] = "jax" in sys.modules
    out["digests"] = {k: digest(v) for k, v in out.items()
                      if isinstance(v, np.ndarray)}
    if "ckpt" in out:
        out["digests"]["ckpt"] = digest(out["ckpt"][0]) + digest(
            np.sort(out["ckpt"][1]))
    if dist.rank() != 0:
        out = {k: out[k] for k in ("digests", "class", "jax_loaded")}
    return out


def pool_quantum_group(overrides: dict, tile_rays: int, spp: int) -> dict:
    """The group's persistent frame of assets/entry_scene.json (k=1)
    under CRAYTPU_TRACE: the frame (rank 0), and every rank's pool width
    B, refill quantum and frame record."""
    from craytpu_torch.models.wavefront_pt import _next_pow2
    from craytpu_torch.parallel import dist
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    os.environ["CRAYTPU_POOL_K"] = "1"
    os.environ["CRAYTPU_TRACE"] = "1"
    cs = compile_scene(load_scene_from_file(ENTRY, overrides), "cpu")
    r = make_renderer(cs, tile_rays=tile_rays)
    frame = r.render_persistent(spp=spp)
    B = min(r.tile_rays, _next_pow2(r.width * r.height))
    return {"frame": frame if dist.rank() == 0 else None, "B": B,
            "Q": r.refill_quantum(B), "stats": r.trace.last,
            "class": type(r).__name__}


def single_rank_class() -> str:
    """make_renderer's class in a group of one rank."""
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    cs = compile_scene(load_scene_from_file(
        ENTRY, {"width": 8, "height": 8}), "cpu")
    return type(make_renderer(cs)).__name__


def train_step(scene_json: str, xs, ys, target, n_sample: int, depth: int,
               lr: float) -> dict:
    """One material train step on make_mesh(world, n_sample) and the
    mesh render of the batch: loss, updated tables, gradients (Adam's mu
    / 0.1 after one step) and image, as numpy."""
    import torch
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.parallel import shard
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    cs = compile_scene(load_scene_from_buf(scene_json), "cpu")
    r = WavefrontRenderer(cs, bounces=depth)
    mesh = shard.make_mesh(n_sample=n_sample)
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    step, init = shard.make_train_step(r, mesh, depth, learning_rate=lr)
    theta, state, loss = step(cs.params, init(cs.params), xs, ys,
                              torch.from_numpy(target), 0)
    img = shard.make_sharded_render_fn(r, mesh, depth)(cs.params, xs, ys, 0)
    value = shard.make_loss_fn(r, mesh, depth)(
        cs.params, xs, ys, torch.from_numpy(target), 0)
    tables = {k: v.numpy() for k, v in vars(theta).items()}
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "loss": float(loss), "value": float(value), "theta": tables,
            "grads": {k: v.numpy() / 0.1 for k, v in vars(state.mu).items()},
            "img": img.numpy(),
            "digest": digest(np.concatenate([v.ravel()
                                             for v in tables.values()]))}


def cluster_worker(port: int, device: str = "cpu") -> int:
    """A port worker as a group of ranks: rank 0 listens on `port` for
    one master session; the others follow its jobs."""
    from craytpu_torch.parallel import cluster
    return cluster.start_worker(port=port, max_sessions=1, device=device)


def cluster_master(scene_json: str, spp: int) -> dict:
    """A port master as a group of ranks with no workers: rank 0 renders
    every tile through render_clustered, the others follow; the frame
    (rank 0) and the renderer's class."""
    from craytpu_torch.parallel import cluster, dist
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    scene = load_scene_from_buf(scene_json)
    r = make_renderer(compile_scene(scene, "cpu"))
    out = {"class": type(r).__name__, "devices":
           cluster._local_device_count(r)}
    if dist.rank() == 0:
        out["frame"] = cluster.render_clustered(scene, r, [], spp=spp)
    else:
        cluster.follow_jobs(r)
    return out
