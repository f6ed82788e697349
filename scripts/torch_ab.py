"""One side of an A/B comparison of the PyTorch/CUDA port on one card: the
two kernels' device time at chip_smoke.py's fixed shapes, their wrappers'
host time per call, and paths/s of the main path.

    PYTHONPATH=CHECKOUT python3 scripts/torch_ab.py [--frames N]

craytpu_torch is imported from CHECKOUT (first on sys.path; this
checkout's package when PYTHONPATH is unset), and the inputs, timers and
frame measurement from this checkout's chip_smoke.py, so two commits are
measured by one implementation. Run the sides in turns on one card
(parent, change, change, parent) and compare like with like. Prints:

  - K2 on chip_smoke's 2^16 rays (seed 20260) and on the 1080p frame's
    first 2^20-lane primary batch, K1 on 2^20 random winner ids: ms a
    launch by CUDA events, launches queued behind a device spin
    ("queued") and back to back without it ("direct");
  - each wrapper's host time a call (perf_counter over 400 calls on a
    128-lane batch, so the card idles between the tiny kernels);
  - paths/s and peak device memory of N frames of the main path
    (chip_smoke.timed_frame: stress_highpoly, 1920x1080, 4 spp).

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
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


def host_us(fn, calls: int = 400) -> float:
    """Host microseconds a call of fn, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import craytpu_torch
    from craytpu_torch.ops import cuda_build
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.utils.torchsetup import setup_torch
    cs_mod = chip_smoke()
    setup_torch()
    cuda_build.build_all()
    tag = os.path.dirname(os.path.dirname(os.path.abspath(
        craytpu_torch.__file__)))
    host = cs_mod.load("stress_highpoly", {"width": cs_mod.W,
                                           "height": cs_mod.H})
    cs_cpu, cs = compile_scene(host, "cpu"), compile_scene(host, "cuda")
    # the K2 wrapper takes the scene's layout where the checkout has one
    extra = (cs.layout,) if hasattr(type(cs), "layout") else ()

    def k2(o, d, lim):
        return trv.closest_hit(cs.geom, o, d, lim, cs.tlas_end,
                               cs.stack_depth, *extra)

    def k1(args):
        return hr.hitrec_record(cs.tri_wide, cs.inst_wide, *args, True)

    rng = np.random.default_rng(20260)
    rays = [x.cuda() for x in cs_mod.mixed_rays(cs_cpu, rng, 1 << 16)]
    prim_b = cs_mod.primary_batch(cs)
    ids = [x.cuda() for x in cs_mod.winner_ids(cs_cpu, rng, 1 << 20)]
    cases = [("K2 2^16 rays", lambda: k2(*rays), 20),
             ("K2 2^20 primary", lambda: k2(*prim_b), 10),
             ("K1 2^20 ids", lambda: k1(ids), 20)]
    for name, fn, reps in cases:
        q = [cs_mod.cuda_ms(fn, reps) for _ in range(2)]
        d = [cs_mod.cuda_ms(fn, reps, spin=False) for _ in range(2)]
        print(f"{tag} {name}: queued {q[0]:.4f} {q[1]:.4f} ms, direct "
              f"{d[0]:.4f} {d[1]:.4f} ms", flush=True)
    small = [x[:128].contiguous() for x in rays]
    small_ids = [x[:128].contiguous() for x in ids]
    print(f"{tag} host a call: closest_hit "
          f"{host_us(lambda: k2(*small)):.1f} us, hitrec_record "
          f"{host_us(lambda: k1(small_ids)):.1f} us", flush=True)
    r = cs_mod.main_path_renderer(torch)
    for f in range(a.frames):
        paths_s, peak = cs_mod.timed_frame(torch, r)
        print(f"{tag} frame {f}: {paths_s:.0f} paths/s, peak "
              f"{peak / 2**30:.3f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
