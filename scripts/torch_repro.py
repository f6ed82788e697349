"""Is the port's 1080p frame bit-reproducible on the card?

    python3 scripts/torch_repro.py

On stress_highpoly at 1920x1080, 4 spp (chip_smoke.py's main-path
frame), prints:

  - three persistent frames of one renderer: how many values of the
    second and third differ from the first, bit for bit;
  - for each index_add_ into the frame's radiance sum during the third
    frame (one persistent flush each): the ids added, how many of them
    repeat an id of the same call (two passes of one pixel), and how many
    of those repeats carry a non-zero radiance (their float adds then
    happen in the atomics' order);
  - two per-pass frames: values that differ;
  - under CRAYTPU_DEBUG=1 (a host sync a bounce): a per-pass and a
    persistent frame, their wall seconds, and the values that differ
    from the frames without it.

Needs one CUDA card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from craytpu_torch.ops import cuda_build  # noqa: E402
from craytpu_torch.parallel.pool_shard import make_renderer  # noqa: E402
from craytpu_torch.scene.compile import compile_scene  # noqa: E402
from craytpu_torch.utils.torchsetup import setup_torch  # noqa: E402


def differ(a: np.ndarray, b: np.ndarray) -> int:
    return int((a.view(np.uint32) != b.view(np.uint32)).sum())


def main() -> int:
    if not torch.cuda.is_available():
        c.fail("no CUDA device")
    print(c.card_line(), flush=True)
    setup_torch()
    cuda_build.build_all()
    cs = compile_scene(c.load("stress_highpoly", {
        "width": c.W, "height": c.H, "samples": c.SPP}))
    ren = make_renderer(cs)
    npix = c.W * c.H

    adds = []
    index_add_ = torch.Tensor.index_add_

    def counted(self, dim, index, src, *a, **k):
        if self.shape[0] == npix:
            nz = (src != 0).any(1)
            adds.append((index.numel(),
                         index.numel() - torch.unique(index).numel(),
                         int(nz.sum()) - torch.unique(index[nz]).numel()))
        return index_add_(self, dim, index, src, *a, **k)

    frames = [ren.render_persistent(c.SPP) for _ in range(2)]
    torch.Tensor.index_add_ = counted
    try:
        frames.append(ren.render_persistent(c.SPP))
    finally:
        torch.Tensor.index_add_ = index_add_
    for i in (1, 2):
        print(f"persistent frame 0 vs {i}: {differ(frames[0], frames[i])} "
              f"of {frames[0].size} differ, max |d| "
              f"{np.abs(frames[0] - frames[i]).max():.3e}", flush=True)
    print("index_add_ calls into the frame (ids, repeated ids, repeated "
          "ids with a non-zero radiance), those with repeats: "
          f"{[x for x in adds if x[1] or x[2]]} of {len(adds)} calls",
          flush=True)
    per_pass = [ren.render(c.SPP) for _ in range(2)]
    print(f"per-pass frame 0 vs 1: {differ(*per_pass)} differ", flush=True)

    os.environ["CRAYTPU_DEBUG"] = "1"
    dbg = make_renderer(cs)
    t0 = time.perf_counter()
    fd = dbg.render(c.SPP)
    pp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = dbg.render_persistent(c.SPP)
    pers_s = time.perf_counter() - t0
    print(f"per-pass debug vs plain: {differ(per_pass[0], fd)} differ "
          f"({pp_s:.2f} s); persistent debug {pers_s:.2f} s, vs plain max "
          f"|d| {np.abs(fp - frames[0]).max():.3e}, "
          f"{differ(fp, frames[0])} differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
