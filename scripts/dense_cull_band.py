"""What K3's cull keeps, and what its plane test costs (csrc/dense_hit.cu's
header derives both tests).

For each group (32 rows) and superblock (256 rows) of the dense layout of
a scene's first mesh it prints the spread of the triangles' normals
(the cone [c, S] each box carries: S >= max |n_k - c|, each n_k's sign
turned toward the box's first normal), the triangles' shapes mu = |n| /
L^2 and the boxes' margin factors F; then, on a batch of rays, the share
of (ray, box) pairs that the box test keeps (`dense_isect.box_keep`):
the slab test alone, the plane test alone, and both (what the kernel
runs), each ray at the final best of the walk (`traverse_plain`, the
least best the kernel's running best can reach: its votes hold at least
these boxes). Also the direction-only cone test for comparison: a ray
of unit direction d lies within THETA of some plane of the box only if
|d.c| < S + THETA.

    python3 scripts/dense_cull_band.py [scene.json] [--rays primary|mixed]
        [--lanes N] [--every K]

--rays primary: the 1080p frame's first 2^20-lane primary batch (pass 0
of 4, tile order), every K-th lane (--every, default 16: 65,536
lanes); mixed: chip_smoke.py's 2^16 mixed rays (seed 20260, as its phase
2; --lanes sets their count). Runs on the CPU: a few seconds for the
cones, about a minute for 2^16 rays on assets/stress_highpoly.json.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from craytpu_torch.ops import dense_isect as dx  # noqa: E402
from craytpu_torch.ops import traverse as trv  # noqa: E402
from craytpu_torch.scene.compile import compile_scene  # noqa: E402
from craytpu_torch.scene.device import INST_SPHERE  # noqa: E402
from craytpu_torch.scene.sceneloader import load_scene_from_file  # noqa: E402

RAY_CHUNK = 256


def cones(cs, d) -> None:
    """The normal spread, shapes and margin factors of the first mesh's
    boxes; the direction-only cone test's keep rate for directions d."""
    dn = cs.dense
    tri = cs.geom.tri_packed.double().numpy()
    _, first, n, _ = next(p for p in dn.plan.tolist()
                          if p[0] != INST_SPHERE and p[2])
    mu = dx.tri_shape(tri[dn.leaf_ids[first:first + n].long().numpy()])
    print(f"{n} triangles; shape mu = |n| / L^2 quantiles (0, 1, 10, 50%): "
          f"{np.quantile(mu, [0, 0.01, 0.1, 0.5]).round(4).tolist()}")
    for name, boxes in (("group", dn.group_box), ("superblock", dn.block_box),
                        ("root", dn.root_box)):
        b = boxes.double().numpy()
        F, c, S = b[:, 7], b[:, 8:11], b[:, 11]
        keep = np.abs(d @ c.T) < S[None, :] + dx.THETA
        print(f"{name} boxes ({F.size}): F > 1 in {100 * (F > 1).mean():.1f}"
              f"%, median {np.median(F):.3f}, max {F.max():.3f}; cone S "
              f"quantiles (50, 90, 99%) "
              f"{np.quantile(S, [0.5, 0.9, 0.99]).round(3).tolist()}; the "
              f"direction-only cone test keeps {100 * keep.mean():.1f}% of "
              f"(direction, box) pairs")


def keep_rates(cs, o, d, limit) -> None:
    """Shares of (live ray, box) pairs each test keeps, for every mesh
    instance's groups and superblocks, at the walk's final best."""
    import torch
    g = cs.geom
    hit = trv.traverse_plain(g, o, d, limit, cs.tlas_end, cs.stack_depth)
    live = limit > 0.0
    best = hit.t
    dn = cs.dense
    index = dn.mesh_index.tolist()
    tot = {k: np.zeros(3) for k in ("group", "superblock")}
    pairs = {k: 0 for k in tot}
    for i, (kind, first, n, obj) in enumerate(dn.plan.tolist()):
        if kind == INST_SPHERE or n == 0:
            continue
        oi, di = trv.object_ray(g.inst_Ainv[i], g.inst_offset[i], o, d)
        sb0, g0 = index[obj]
        ng = -(-n // dx.GROUP)
        nb = -(-ng // dx.SUPER)
        for name, boxes in (("group", dn.group_box[g0:g0 + ng]),
                            ("superblock", dn.block_box[sb0:sb0 + nb])):
            for r in range(0, o.shape[0], RAY_CHUNK):
                sl = slice(r, r + RAY_CHUNK)
                lv = live[sl]
                if not lv.any():
                    continue
                cr = dx.cull_ray(oi[sl][lv], di[sl][lv])
                slab = dx.slab_keep(boxes, oi[sl][lv], cr, best[sl][lv])
                both = slab | dx.plane_keep(boxes, oi[sl][lv], cr)
                tot[name] += [float(slab.sum()), float((both & ~slab).sum()),
                              float(both.sum())]
                pairs[name] += both.numel()
    for name in tot:
        s, p, b = 100 * tot[name] / max(pairs[name], 1)
        print(f"  {name}s: slab test keeps {s:.3f}%, the plane test "
              f"{p:.3f}% more, both {b:.3f}% of {pairs[name]:.4e} (live "
              f"ray, box) pairs")


def main(argv=None) -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?",
                    default=os.path.join(REPO, "assets",
                                         "stress_highpoly.json"))
    ap.add_argument("--rays", choices=("primary", "mixed", "none"),
                    default="none")
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--every", type=int, default=16)
    ap.add_argument("--dirs", type=int, default=2000)
    a = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    print(os.path.basename(a.scene))
    size = ({"width": 32, "height": 24} if a.rays == "none"
            else {"width": 1920, "height": 1080})
    cs = compile_scene(load_scene_from_file(a.scene, size), "cpu")
    d = np.random.default_rng(0).normal(size=(a.dirs, 3))
    cones(cs, d / np.linalg.norm(d, axis=1, keepdims=True))
    if a.rays == "none":
        return
    import chip_smoke
    if a.rays == "primary":
        o, dd, limit = chip_smoke.primary_batch(cs)
        o, dd, limit = o[::a.every], dd[::a.every], limit[::a.every]
        what = f"primary batch, every {a.every}th lane"
    else:
        o, dd, limit = chip_smoke.mixed_rays(
            cs, np.random.default_rng(20260), a.lanes)
        what = "mixed rays (seed 20260)"
    print(f"{what}: {o.shape[0]} lanes, {int((limit > 0).sum())} live")
    keep_rates(cs, o, dd, limit)


if __name__ == "__main__":
    main()
