"""K3's cull on rays that graze a triangle's plane (craytpu_torch/ops/
dense_isect.py: `slab_keep`, `plane_keep`, `dense_cull_plain`), on the
CPU. (K3 itself on the same rays against its plain version on the card:
tests/test_torch_kernels.py.)

Bars, on every ray set: the leaf-order search (`dense_cull_plain`'s hit)
equals dense_hit_plain bit for bit, and no pair that the plain test
accepts at or below the ray's final best lies in a root, superblock or
group box that the cull skips. The rays (tests/torch_dense_rays.py::
graze_rays) run at 0 (in the plane, built in float64, then rounded),
1e-8, 1e-6, 1e-4 and 1e-3 rad and up to THETA off the plane of a
triangle: through it, and beside it (in its plane, off its group's box),
from origins 0.2-3 and 50-400 units away; on a tilted floor whose
vertices lie on no float grid, on stress_highpoly's slivers, and in the
plane of the tie scene's flat grid. A ray in the floor's plane, beside
the floor, is hit by rounding alone: its det, u*det, v*det and t*det are
all rounding errors, and only the plane test keeps those boxes.

Mutation cases (monkeypatched inside the test only), each of which must
find a skipped accepted pair: the plane test off, on rays in the
floor's plane; the box margin at 0 (the widening kept) with the plane
test off, on a small floor far from its mesh's origin (its coefficients'
roundings are large beside its boxes). With the plane test on, no ray
built here reaches the box margin or the margin factor F: the plane test
keeps every box within about its own size of a line that may lie in one
of its planes, and the rounding errors these rays meet stay inside
that.
"""

import os

import numpy as np
import pytest
import torch

from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.compile import compile_scene
from craytpu_torch.scene.sceneloader import load_scene_from_file
from tests.test_torch_dense_cull import FLT_MAX, check_cull
from tests.torch_dense_rays import (FLAT_INSTANCES, FLAT_X, FLAT_Z,
                                    GRAZE_ANGLES, floor_basis,
                                    floor_edge_rays, floor_scene, graze_rays,
                                    tie_scene)

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
NEAR, FAR = (0.2, 3.0), (50.0, 400.0)
# the small floor far from its mesh's origin (the margin mutation)
FAR_FLOOR = dict(n=16, size=0.005, center=(1500.0, -900.0, 600.0))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {
        "floor": floor_scene(tmp_path_factory.mktemp("floor")),
        "highpoly": compile_scene(load_scene_from_file(
            os.path.join(ASSETS, "stress_highpoly.json"),
            {"width": 32, "height": 24}), "cpu"),
    }


def misses(cs, o, d):
    """(accepted, skipped): the pairs dense_hit_plain's test accepts at or
    below each ray's final best, and how many of them lie in a box the
    cull model (`dense_cull_plain`, with whatever the caller patched)
    skips; both searches see every lane live."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    limit = torch.full((o.shape[0],), FLT_MAX)
    dn = cs.dense
    want = dx.dense_hit_plain(cs.geom, dn, o, d, limit)
    _, culls = dx.dense_cull_plain(cs.geom, dn, o, d, limit)
    accepted = skipped = 0
    for c in culls:
        i = c["inst"]
        _, first, n, _ = dn.plan[i].tolist()
        oi, di = trv.object_ray(cs.geom.inst_Ainv[i], cs.geom.inst_offset[i],
                                o, d)
        t, valid = dx.pair_tests(dn.leaf_table[first:first + n], oi, di,
                                 vm.vcross(di, oi))
        r, row = torch.nonzero(valid & (t <= want.t[:, None]), as_tuple=True)
        g = row // dx.GROUP
        kept = c["root"][r] & c["block"][r, g // dx.SUPER] & c["group"][r, g]
        accepted += r.numel()
        skipped += int((~kept).sum())
    return accepted, skipped


@pytest.mark.parametrize("where", ["through", "beside"])
@pytest.mark.parametrize("dist", ["near", "far"])
@pytest.mark.parametrize("name", ["floor", "highpoly"])
def test_cull_keeps_every_accepted_pair_on_grazing_rays(scenes, name, where,
                                                        dist):
    """Rays at 0 to THETA off a triangle's plane (the floor's triangles;
    stress_highpoly's 2% slivers), through it or beside it, from near and
    far: the leaf-order search equals dense_hit_plain bit for bit and no
    accepted pair is skipped (check_cull; every 9th lane dead)."""
    cs = scenes[name]
    seed = {"floor": 200, "highpoly": 210}[name] + 2 * (where == "beside") \
        + (dist == "far")
    rng = np.random.default_rng(seed)
    B = 192 if name == "floor" else 32
    o, d = graze_rays(cs, rng, B, where, NEAR if dist == "near" else FAR,
                      share=1.0 if name == "floor" else 0.02)
    want, accepted = check_cull(cs, o, d)
    if where == "through" and dist == "near":
        assert accepted > B // 4 and (want.prim >= 0).float().mean() > 0.3


def test_rays_in_the_floors_plane_hit_by_rounding(scenes):
    """Rays in the tilted floor's plane, beside the floor (outside every
    box, the line along the floor's edge): the plain test accepts pairs
    by rounding alone, the slab test skips every box that holds them,
    and the plane test keeps them all."""
    cs = scenes["floor"]
    o, d = floor_edge_rays(np.random.default_rng(220), 128, NEAR)
    accepted, skipped = misses(cs, o, d)
    assert accepted > 50 and skipped == 0
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    want = dx.dense_hit_plain(cs.geom, cs.dense, ot, dt,
                              torch.full((128,), FLT_MAX))
    assert (want.prim >= 0).sum() > 32
    cr = dx.cull_ray(ot, dt)
    assert not dx.slab_keep(cs.dense.group_box, ot, cr, want.t).any()
    check_cull(cs, o, d, torch.full((128,), FLT_MAX))


def test_cull_keeps_every_accepted_pair_in_the_flat_grids_plane(tmp_path):
    """The tie scene's flat grid (exact integer vertices, two instances
    one cell apart): rays in its plane z = FLAT_Z and at GRAZE_ANGLES off
    it, across the grid and beside it; both searches agree and no
    accepted pair is skipped."""
    cs = tie_scene(tmp_path)
    rng = np.random.default_rng(230)
    B = 240
    o, d = np.zeros((B, 3)), np.zeros((B, 3))
    for r in range(B):
        ang = rng.uniform(0, 2 * np.pi)
        a = np.array([np.cos(ang), np.sin(ang), 0.0])
        if r % 2:   # beside: off the grid on y, along x
            q = np.array([FLAT_X + rng.uniform(0, 5), rng.choice([-1, 1])
                          * rng.uniform(2.2, 3.0), FLAT_Z])
            a = np.array([rng.choice([-1.0, 1.0]), 0.0, 0.0])
        else:
            q = np.array([FLAT_X + rng.uniform(0.2, 4.8),
                          rng.uniform(-1.8, 1.8), FLAT_Z])
        beta = GRAZE_ANGLES[r % len(GRAZE_ANGLES)] * rng.choice([-1, 1])
        d[r] = np.cos(beta) * a + np.sin(beta) * np.array([0.0, 0.0, 1.0])
        o[r] = q - rng.uniform(*NEAR) * d[r]
    want, _ = check_cull(cs, o.astype(np.float32), d.astype(np.float32))
    assert set(want.inst.tolist()) & set(FLAT_INSTANCES)


def test_mutation_plane_test_off(scenes, monkeypatch):
    """With the plane test off (the slab test alone), rays in the floor's
    plane beside it lose accepted pairs."""
    monkeypatch.setattr(dx, "plane_keep",
                        lambda box, o, cr: torch.zeros(
                            (o.shape[0], box.shape[0]), dtype=torch.bool))
    o, d = floor_edge_rays(np.random.default_rng(220), 128, NEAR)
    accepted, skipped = misses(scenes["floor"], o, d)
    assert skipped > 0


def far_floor_rays(cs, rng, B):
    """B rays at THETA-0.1 rad off the far floor's plane (every pair the
    slab test's margins cover), through points
    0.5 group extents outside a random group box's face, from 0.2-3
    units back."""
    nh, _, _ = floor_basis()
    gbox = cs.dense.group_box.double().numpy()
    o, d = np.zeros((B, 3)), np.zeros((B, 3))
    for r in range(B):
        gb = gbox[rng.integers(gbox.shape[0])]
        lo, hi = gb[0:3], gb[4:7]
        q = rng.uniform(lo, hi)
        ax, side = rng.integers(3), rng.integers(2)
        q[ax] = (hi[ax] + 0.5 * (hi - lo).max() * rng.uniform()) if side \
            else (lo[ax] - 0.5 * (hi - lo).max() * rng.uniform())
        a = rng.normal(size=3)
        a -= (a @ nh) * nh
        a /= np.linalg.norm(a)
        beta = rng.uniform(dx.THETA, 0.1) * rng.choice([-1.0, 1.0])
        d[r] = np.cos(beta) * a + np.sin(beta) * nh
        o[r] = q - rng.uniform(*NEAR) * d[r]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("margin", ["kept", "zero"])
def test_mutation_box_margin_zero(tmp_path, monkeypatch, margin):
    """The slab test alone (the plane test off) on a small floor 1,500
    units from its mesh's origin, on rays THETA-0.1 rad off its plane
    through points just outside its group boxes: with MARGIN_BOX it
    skips no accepted pair; with MARGIN_BOX = 0 (the widening kept) it
    does."""
    cs = floor_scene(tmp_path, **FAR_FLOOR)
    monkeypatch.setattr(dx, "plane_keep",
                        lambda box, o, cr: torch.zeros(
                            (o.shape[0], box.shape[0]), dtype=torch.bool))
    if margin == "zero":
        monkeypatch.setattr(dx, "MARGIN_BOX", 0.0)
    o, d = far_floor_rays(cs, np.random.default_rng(240), 2048)
    accepted, skipped = misses(cs, o, d)
    assert accepted > 200
    assert (skipped > 0) == (margin == "zero")
