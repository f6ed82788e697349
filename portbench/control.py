"""The check's control: the reference in the program's place, with each
lane's ray, throughput and radiance stored in bfloat16 between bounces
(the nearest precision below the float32 the scenes are rendered in; a
pool stored in bfloat16 is the step that would tempt a change that saves
bandwidth). It reads the numbers the check compares, for each seed, at
the cell's own size and on the cell's checked pixels, and prints one
JSON line per seed. The benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(x):
    import torch
    return x.to(torch.bfloat16).to(torch.float32)


def readings(cell, seed: int, device: str, store=bf16) -> dict:
    """The check's numbers of `store`'s control against the reference, on
    the passes of the seed's first request."""
    import numpy as np
    import torch
    from portbench import check as chk
    from portbench import scenes
    from portbench.reference import scene as rs
    from portbench.reference import trace as rt
    adir = scenes.check_assets(cell.config, cell.root)
    sc = scenes.scene(cell.config, cell.traffic)
    text = json.dumps(sc)
    xs, ys = scenes.check_pixels(sc, int(cell.traffic["check_pixels"]),
                                 seed)
    tab = rs.build(text, adir, device)
    x = torch.tensor(xs, device=device)
    y = torch.tensor(ys, device=device)
    drv = cell.driver()
    n, _ = drv.chunks(cell.traffic)
    first = drv.first_chunk(cell.traffic, seed) * n
    ref = drv.combine(rt.render_pixels(tab, x, y, first, n),
                      tab.spp).cpu().numpy()
    got = drv.combine(rt.render_pixels(tab, x, y, first, n, store=store),
                      tab.spp).cpu().numpy()
    frame = np.zeros((tab.height, tab.width, 4), np.float32)
    frame[ys, xs] = got
    return chk.gaps(frame, ref, xs, ys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import manifest
    cell = manifest.Cell(args.workload, ROOT)
    for seed in args.seeds:
        r = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "bfloat16 state", **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
