"""The reference's BVH walk against its every-triangle search on the CPU:
the same (t, prim, inst) on every lane of every bounce of the tiny cells'
paths, on rays aimed at shared vertices and edges, where triangles tie,
and on instances listed twice, where instances tie; the walk's trees."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.reference import fp
from portbench.reference import scene as rs
from portbench.reference import trace as rt
from portbench.reference import walk
from portbench_tiny import tiny_cell

CELLS = ["highpoly_render", "instances_render"]


def _tables(cell: str, **cut):
    c = tiny_cell(cell, **cut)
    text = scenes.scene_text(c.config, c.traffic)
    tab = rs.build(text, scenes.check_assets(c.config, c.root), "cpu")
    return c, text, tab


def _same(a, b) -> torch.Tensor:
    """Lanes where two searches' (t, prim, inst) agree, t bit for bit."""
    return (a[0].view(torch.int32) == b[0].view(torch.int32)) & (
        a[1] == b[1]) & (a[2] == b[2])


@pytest.mark.parametrize("cell", CELLS)
def test_walk_equals_closest_hit_every_bounce(cell):
    torch.set_num_threads(2)
    c, text, tab = _tables(cell)
    w = walk.Walk(tab)
    xs, ys = scenes.check_pixels(json.loads(text),
                                 int(c.traffic["check_pixels"]), 2 ** 31 + 9)
    x, y = torch.tensor(xs), torch.tensor(ys)
    lanes, off = [], []

    def both(tab, o, d):
        a = rt.closest_hit(tab, o, d)
        lanes.append(o.shape[0])
        off.append(int((~_same(a, w(tab, o, d))).sum()))
        return a
    ref = rt.render_pixels(tab, x, y, search=both)
    got = rt.render_pixels(tab, x, y, block=1 << 16, search=w)
    # every pass of every pixel, bounce after bounce (most paths leave
    # for the sky within three)
    assert len(lanes) >= 3 and sum(lanes) > 250
    assert off == [0] * len(off)
    assert torch.equal(ref.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("cell", CELLS)
def test_ties_at_shared_vertices_and_edges(cell):
    """Rays from the mesh's centre and from the camera's place at the
    first instance's vertices and edge midpoints: some find two rows at
    the same t, and the walk takes the lowest, as closest_hit does."""
    torch.set_num_threads(2)
    _, _, tab = _tables(cell)
    w = walk.Walk(tab)
    ii = next(i for i, e in enumerate(tab.instances) if e[0] == "mesh")
    _, obj, A, Ainv, off = tab.instances[ii]
    rows = tab.meshes[obj][0]
    r = rows.numpy().astype(np.float64)
    pick = np.random.default_rng(5).choice(len(r), 48, replace=False)
    v0 = r[pick, 0:3]
    v1, v2 = v0 - r[pick, 3:6], v0 + r[pick, 6:9]
    targets = np.concatenate([v0, v1, (v0 + v1) / 2, (v0 + v2) / 2])
    M = A.numpy().astype(np.float64)
    lo, hi = w.trees[obj].box
    ties = 0
    for start in (M[:, :3] @ ((lo + hi) / 2) + M[:, 3],
                  np.array([0.0, 2.0, -6.0])):
        aim = targets @ M[:, :3].T + M[:, 3] - start
        o = torch.tensor(np.broadcast_to(start, aim.shape),
                         dtype=torch.float32)
        d = torch.tensor(aim / np.linalg.norm(aim, axis=1, keepdims=True),
                         dtype=torch.float32)
        a = rt.closest_hit(tab, o, d)
        assert bool(_same(a, w(tab, o, d)).all())
        o_s, d_s = rt.object_ray(Ainv, off, o, d)
        for k in range(0, len(o), 32):
            hit, t, _, _ = rt.tri_test(rows[None], o_s[k:k + 32, None],
                                       d_s[k:k + 32, None])
            won = (a[2][k:k + 32] == ii)[:, None]
            ties += int(((hit & won & (t == a[0][k:k + 32, None])).sum(1)
                         >= 2).sum())
    assert ties >= 8


@pytest.mark.parametrize("cell", CELLS)
def test_ties_across_instances(cell):
    """Every instance listed twice, in the same place, and rays from the
    camera's place at each one's centre: a mesh's second copy never
    takes a lane from its first (strict <), a sphere's second copy always
    does (<=)."""
    torch.set_num_threads(2)
    _, _, tab = _tables(cell)
    n = len(tab.instances)
    twice = dataclasses.replace(tab, instances=tab.instances * 2)
    w = walk.Walk(twice)
    start = np.array([0.0, 2.0, -6.0])
    jitter = np.random.default_rng(7).normal(0.0, 0.05, (4, 3))
    aim = np.concatenate([e[2][:, 3].numpy() + jitter - start
                          for e in tab.instances])
    o = torch.tensor(np.broadcast_to(start, aim.shape), dtype=torch.float32)
    d = torch.tensor(aim / np.linalg.norm(aim, axis=1, keepdims=True),
                     dtype=torch.float32)
    a = rt.closest_hit(twice, o, d)
    assert bool(_same(a, w(twice, o, d)).all())
    kind = np.array([e[0] for e in twice.instances])
    won = a[2][a[2] >= 0].numpy()
    assert (kind[won] == "mesh").any() and (kind[won] == "sphere").any()
    assert (won[kind[won] == "mesh"] < n).all()
    assert (won[kind[won] == "sphere"] >= n).all()


@pytest.mark.parametrize("cell", CELLS)
def test_trees_hold_every_triangle_in_padded_boxes(cell):
    _, _, tab = _tables(cell)
    for tree, mesh in zip(walk.Walk(tab).trees, tab.meshes):
        rows = mesh[0].numpy().astype(np.float64)
        slots = tree.rows.numpy()
        real = slots[slots >= 0]
        assert np.array_equal(np.sort(real), np.arange(len(rows)))
        lo, hi = tree.lo.numpy(), tree.hi.numpy()
        # each triangle's corners inside its leaf's box, strictly
        leaf = tree.first_leaf + np.nonzero(slots >= 0)[0] // walk.LEAF
        v0 = rows[real, 0:3]
        for v in (v0, v0 - rows[real, 3:6], v0 + rows[real, 6:9]):
            assert (lo[leaf] < v).all() and (v < hi[leaf]).all()
        # each parent's box holds its children's
        kids = np.arange(1, len(lo))
        parent = (kids - 1) // walk.FAN
        full = ~np.isnan(lo[kids, 0])
        assert (lo[parent[full]] <= lo[kids[full]]).all()
        assert (hi[kids[full]] <= hi[parent[full]]).all()


def test_enters_cull_only_boxes_out_of_reach():
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                      [1.0, 0.0, 0.0]])
    lo = torch.tensor([2.0, -1.0, -1.0]).expand(4, 3)
    hi = torch.tensor([3.0, 1.0, 1.0]).expand(4, 3)
    best = torch.tensor([fp.FLT_MAX, fp.FLT_MAX, fp.FLT_MAX, 1.5])
    got = walk._enters(lo, hi, o, walk._inverse(d), best)
    # ahead; behind; parallel to the x slabs outside them; beyond best
    assert got.tolist() == [True, False, False, False]
    nan = torch.full((4, 3), float("nan"))
    assert not walk._enters(nan, nan, o, walk._inverse(d), best).any()
