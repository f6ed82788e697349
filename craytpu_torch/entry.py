"""Entry points of the port (the JAX package's __graft_entry__.py):

entry()             -> (fn, example_args): the forward wavefront trace of
                       the path-tracing integrator, 256 rays to depth 6,
                       over assets/entry_scene.json (two-level BVH,
                       spheres and mesh instances, diffuse, metal and
                       emissive materials, a gradient background).
dryrun_multichip(n) -> n ranks (parallel/dist.py::spawn_local), a (sample,
                       rays) mesh over them (make_mesh(n)), and ONE full
                       train step (trace -> image loss -> gradients of
                       every ShadeParams table summed over the group ->
                       Adam) on 16 rays a ray shard.

Both run on the CUDA card unless the caller passes device="cpu".
"""

from __future__ import annotations

import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCENE = os.path.join(_REPO, "assets", "entry_scene.json")


def _load_renderer(bounces: int, device=None):
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    return WavefrontRenderer(compile_scene(load_scene_from_file(_SCENE),
                                           device), bounces=bounces)


def _rays(r, n: int):
    """n pixel coordinates drawn from seed 0, as the JAX package draws
    them (numpy int32)."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, r.width, n, dtype=np.int32),
            rng.integers(0, r.height, n, dtype=np.int32))


def entry(device=None):
    """Forward step: trace a 256-ray wavefront to depth 6 (incl. one
    Russian-roulette bounce). fn(params, xs, ys) -> (256, 4) radiance of
    pass 0 of 4."""
    import torch
    r = _load_renderer(6, device)
    trace = r.make_trace_fn()

    def fn(params, xs, ys):
        return trace(params, xs, ys, 0, 4)

    xs, ys = _rays(r, 256)
    dev = r.device
    return fn, (r.cscene.params, torch.from_numpy(xs).to(dev),
                torch.from_numpy(ys).to(dev))


def _dryrun_rank(n_devices: int, device) -> dict:
    """One rank of dryrun_multichip: the step on make_mesh(n_devices)."""
    import torch
    from craytpu_torch.parallel import shard
    mesh = shard.make_mesh(n_devices)
    r = _load_renderer(5, device)
    step, opt_init = shard.make_train_step(r, mesh, depth=5)
    xs, ys = _rays(r, mesh.size(1) * 16)   # 16 rays a ray shard
    dev = r.device
    xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    target = torch.zeros((xs.shape[0], 3), device=dev)
    params = r.cscene.params
    new, _, loss = step(params, opt_init(params), xs, ys, target, 0)
    moved = float((new.colors - params.colors).abs().max())
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "loss": float(loss), "moved": moved}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """n_devices ranks (sharing the cards there are) and one train step
    over their mesh; asserts a finite loss, the same on every rank, and a
    non-zero update of the material colors. Returns rank 0's summary."""
    from craytpu_torch.parallel.dist import spawn_local
    outs = spawn_local(n_devices, _dryrun_rank, n_devices, device,
                       device=device)
    loss = outs[0]["loss"]
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert all(o["loss"] == loss for o in outs), \
        f"ranks disagree on the loss: {[o['loss'] for o in outs]}"
    moved = outs[0]["moved"]
    assert moved > 0.0, "train step produced a zero update"
    print(f"dryrun_multichip({n_devices}): mesh={outs[0]['mesh']} "
          f"loss={loss:.6f} max|dcolor|={moved:.2e} OK")
    return outs[0]
