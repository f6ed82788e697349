"""One side of an A/B comparison of K3, the dense closest-hit kernel, on
one card: its time at chip_smoke.py's shapes, its cull's work, the lanes
where it differs from its plain version on rays that graze the planes of
its triangles, its registers, and the dense persistent frame against the
walk's.

    PYTHONPATH=CHECKOUT python3 scripts/dense_ab.py [--frames N]

craytpu_torch is imported from CHECKOUT (first on sys.path; this
checkout's package when PYTHONPATH is unset), the inputs, timers and
counters from this checkout's chip_smoke.py and tests/torch_dense_rays.py,
so two commits are measured by one implementation. Run the sides in turns
on one card (parent, change, change, parent). Prints:

  - ptxas's registers, stack, spills and SASS count of the kernel, exact
    and fast;
  - K3's ms a launch (CUDA events, queued behind a device spin) on
    chip_smoke's 2^16 mixed rays (seed 20260) and on the 1080p frame's
    first 2^20-lane primary batch (pass 0 of 4);
  - the cull's counters (chip_smoke.dense_cull_counts) at 2^16 and on
    every 16th block of 256 lanes of the primary batch (x16);
  - on chip_smoke's grazing batches (stress_highpoly and the tilted
    floor), the lanes where K3's winner differs from dense_hit_plain's
    (both on the card) and K3's ms;
  - paths/s of N persistent 1080p frames (stress_highpoly, 2 spp) under
    CRAYTPU_TRAVERSAL=dense and of the walk, in turns (dense, walk, walk,
    dense, ...).

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)  # after PYTHONPATH: CHECKOUT's package comes first


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def graze_diff(torch, c, cs, batch, what, tag) -> None:
    """Lanes of a grazing batch where K3 and its plain version differ."""
    from craytpu_torch.ops import dense_isect as dx
    o, d, limit = (x.cuda() for x in batch)
    got = dx.dense_hit(cs.geom, o, d, limit, cs.dense)
    want = dx.dense_hit_plain(cs.geom, cs.dense, o, d, limit)
    bad = ((got.inst != want.inst) | (got.prim != want.prim)
           | (got.t.view(torch.int32) != want.t.view(torch.int32)))
    ms = c.cuda_ms(lambda: dx.dense_hit(cs.geom, o, d, limit, cs.dense), 3)
    print(f"{tag} grazing rays of {what}: {int(bad.sum())} of {o.shape[0]} "
          f"lanes differ from the plain version; "
          f"{int((want.inst >= 0).sum())} plain hits; K3 {ms:.3f} ms",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import craytpu_torch
    from craytpu_torch.ops import cuda_build
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils.torchsetup import setup_torch
    c = chip_smoke()
    setup_torch()
    cuda_build.build_all(("dense_hit",), (False, True))
    tag = os.path.dirname(os.path.dirname(os.path.abspath(
        craytpu_torch.__file__)))
    for fast in (False, True):
        for line in cuda_build.usage_lines(("dense_hit",), fast):
            print(f"{tag} {line}", flush=True)
    host = c.load("stress_highpoly", {"width": c.W, "height": c.H,
                                      "samples": 2})
    cs_cpu, cs = compile_scene(host, "cpu"), compile_scene(host, "cuda")
    rays = [x.cuda() for x in c.mixed_rays(cs_cpu,
                                           np.random.default_rng(20260))]
    prim = c.primary_batch(cs)
    for name, r in (("2^16 mixed rays", rays), ("2^20 primary batch", prim)):
        q = [c.cuda_ms(lambda: dx.dense_hit(cs.geom, *r, cs.dense), 3)
             for _ in range(2)]
        print(f"{tag} K3 {name}: {q[0]:.3f} {q[1]:.3f} ms", flush=True)
    z = c.dense_cull_counts(torch, cs.geom, cs.dense, *rays)
    print(f"{tag} K3 cull at 2^16: {c.fmt_cull(z)}", flush=True)
    T = prim[0].shape[0]
    sub = torch.nonzero((torch.arange(T, device="cuda") // 256) % 16
                        == 0)[:, 0]
    z = c.dense_cull_counts(torch, cs.geom, cs.dense,
                            *(x[sub] for x in prim))
    print(f"{tag} K3 cull on the primary batch (every 16th block; shares "
          f"as counted): {c.fmt_cull(z)}", flush=True)
    del rays, prim
    graze_diff(torch, c, cs, c.graze_batch(cs_cpu, 20261), "stress_highpoly",
               tag)
    from tests.torch_dense_rays import floor_scene
    floor_cpu = floor_scene(pathlib.Path(tempfile.mkdtemp()))
    floor = floor_scene(pathlib.Path(tempfile.mkdtemp()), "cuda")
    graze_diff(torch, c, floor, c.graze_batch(floor_cpu, 20262, floor=True),
               "the tilted floor", tag)
    walk = make_renderer(cs)
    os.environ["CRAYTPU_TRAVERSAL"] = "dense"
    dense = make_renderer(cs)
    dense.render_persistent(1, fetch=False)          # warm-up
    walk.render_persistent(1, fetch=False)
    rates = {"dense": [], "walk": []}
    for k in range(a.frames):
        for kind in (("dense", "walk") if k % 2 == 0 else ("walk", "dense")):
            r = dense if kind == "dense" else walk
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_persistent(2, fetch=False)
            torch.cuda.synchronize()
            rates[kind].append(c.W * c.H * 2 / (time.perf_counter() - t0))
    print(f"{tag} persistent 1080p frames, 2 spp, paths/s in turns: dense "
          f"{' '.join(f'{x:.0f}' for x in rates['dense'])}, walk "
          f"{' '.join(f'{x:.0f}' for x in rates['walk'])}; dense/walk "
          f"{np.median(rates['dense']) / np.median(rates['walk']):.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
