"""The reference's seconds on the card for many paths: its BVH walk
(reference/walk.py) re-tracing `--paths` distinct pixels drawn from the
seed, one pass each, at the cell's size and bounces, beside its
every-triangle search (trace.closest_hit) on the first `--every` of
them, and whether the two agree bit for bit there. One JSON line a
workload. The benchmark's runs never run it.

    python3 portbench/walk_seconds.py --workload <cell> [<cell> ...] \\
        --seed <n> [--paths 1048576] [--every 4096]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def seconds(cell, seed: int, paths: int, every: int) -> dict:
    import torch
    from portbench import scenes
    from portbench.reference import scene as rs
    from portbench.reference import trace as rt
    from portbench.reference import walk
    text = scenes.scene_text(cell.config, cell.traffic)
    tab, tables_s = _timed(lambda: rs.build(
        text, scenes.check_assets(cell.config, cell.root), "cuda"))
    xs, ys = scenes.check_pixels(json.loads(text), paths, seed)
    x = torch.tensor(xs, device="cuda")
    y = torch.tensor(ys, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    w, tree_s = _timed(lambda: walk.Walk(tab))
    runs = [_timed(lambda: rt.render_pixels(tab, x, y, 0, 1, block=paths,
                                            search=w)) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    got = runs[0][0][:every]
    ref, every_s = _timed(lambda: rt.render_pixels(tab, x[:every],
                                                   y[:every], 0, 1))
    return {"workload": cell.name, "paths": paths,
            "bounces": tab.bounces, "size": [tab.width, tab.height],
            "tables_s": tables_s, "trees_s": tree_s,
            "walk_s": [r[1] for r in runs], "walk_peak_bytes": peak,
            "every_paths": every, "every_triangle_s": every_s,
            "bit_equal": bool(torch.equal(ref.view(torch.int32),
                                          got.view(torch.int32))),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--paths", type=int, default=1 << 20)
    ap.add_argument("--every", type=int, default=4096)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import manifest
    if not torch.cuda.is_available():
        print("walk_seconds: no CUDA card", file=sys.stderr)
        return 3
    for name in args.workload:
        print(json.dumps(seconds(manifest.Cell(name, ROOT), args.seed,
                                 args.paths, args.every)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
