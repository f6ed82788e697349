"""How much K3's cull would lose if it also kept every box that a ray
may lie within THETA of a triangle's plane in (the part of the cull's
guarantee that the kernel leaves out, csrc/dense_hit.cu's header).

For each group (32 rows) and superblock (256 rows) of the dense layout of
a scene's first mesh it takes the triangles' unit normals, their mean
direction c and their spread sigma = max |n_k - c| (each n_k's sign
turned toward the box's first normal: the test needs only the plane);
a ray of unit
direction d lies within THETA of some triangle's plane only if |d.c| <
sigma + THETA, so a box would have to be kept for it then (the
normal-cone test, before any bound on where the ray runs; a ray that
misses the mesh has no such bound). Prints the spread's quantiles, the
triangles' shapes mu = |n| / L^2, the boxes' margin factors F (the part
of the gap the kernel closes: see box_factor), and the share of
(direction, box) pairs that the test keeps for random directions.

    python3 scripts/dense_cull_band.py [scene.json] [--dirs N]

Runs on the CPU (the scene is compiled on the CPU; a few seconds for
assets/stress_highpoly.json).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from craytpu_torch.ops import dense_isect as dx  # noqa: E402
from craytpu_torch.scene.compile import compile_scene  # noqa: E402
from craytpu_torch.scene.device import INST_SPHERE  # noqa: E402
from craytpu_torch.scene.sceneloader import load_scene_from_file  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?",
                    default=os.path.join(REPO, "assets",
                                         "stress_highpoly.json"))
    ap.add_argument("--dirs", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    cs = compile_scene(load_scene_from_file(a.scene, {"width": 32,
                                                      "height": 24}), "cpu")
    dn = cs.dense
    tri = cs.geom.tri_packed.double().numpy()
    _, first, n, _ = next(p for p in dn.plan.tolist()
                          if p[0] != INST_SPHERE and p[2])
    t = tri[dn.leaf_ids[first:first + n].long().numpy()]
    nrm = np.cross(-t[:, 3:6], t[:, 6:9])
    nh = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    mu = dx.tri_shape(t)
    rng = np.random.default_rng(a.seed)
    d = rng.normal(size=(a.dirs, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    print(f"{os.path.basename(a.scene)}: {n} triangles; shape mu = |n| / "
          f"L^2 quantiles (0, 1, 10, 50%): "
          f"{np.quantile(mu, [0, 0.01, 0.1, 0.5]).round(4).tolist()}")
    for name, boxes in (("group", dn.group_box), ("superblock", dn.block_box),
                        ("root", dn.root_box)):
        F = boxes[:, 7].double().numpy()
        print(f"{name} boxes ({F.size}): margin factor F > 1 in "
              f"{100 * (F > 1).mean():.1f}%, median {np.median(F):.3f}, "
              f"max {F.max():.3f}")
    for name, size in (("group", dx.GROUP), ("superblock", dx.TILE)):
        at = np.arange(0, n, size)
        box = np.repeat(np.arange(at.size), np.diff(np.append(at, n)))
        sh = nh * np.where(np.einsum("ij,ij->i", nh, nh[at][box]) < 0.0,
                           -1.0, 1.0)[:, None]
        c = np.add.reduceat(sh, at, axis=0)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        sigma = np.maximum.reduceat(np.linalg.norm(sh - c[box], axis=1), at)
        keep = np.abs(d @ c.T) < sigma[None, :] + dx.THETA
        print(f"{name}s ({at.size}): normal spread sigma quantiles (50, 90, "
              f"99%): {np.quantile(sigma, [0.5, 0.9, 0.99]).round(3).tolist()}"
              f"; kept by the normal-cone test for {a.dirs} random "
              f"directions: {100 * keep.mean():.1f}% of (direction, box) "
              f"pairs")


if __name__ == "__main__":
    main()
