"""A plain BVH walk: the reference's closest hit, found through a box tree
of each mesh instead of by testing every triangle.

Per mesh, a tree of its own, built with numpy from the reference's
tables (scene.Tables) alone: the triangles sorted along a Morton curve
of their centroids, leaves of LEAF consecutive triangles, and an
implicit tree of fan-out FAN over the leaves (node i's children are
FAN * i + 1 .. FAN * i + FAN), each box the union of its children's.
Every box is padded by PAD of its mesh's diagonal, far more than the
rounding of tri_test and of the slab test, so that no triangle that
tri_test accepts is culled.

The walk is lane-parallel and breadth-first, in plain torch: per mesh
instance, the lanes whose world ray enters the instance's padded world
box; their object rays (trace.object_ray); a frontier of (lane, node)
pairs that descends one level a step, keeping the children whose box
the ray enters before the lane's best t so far; at the leaves, each
pair's triangles tested with trace.tri_test. Spheres take
trace.sphere_test. Instances go in tab.instances order with
closest_hit's comparisons: a mesh takes a lane where its nearest hit is
strictly nearer than the best so far, the lowest row winning among
equal t inside the mesh; a sphere where its hit is no farther. So the
walk's (t, prim, inst) equals closest_hit's on every lane, ties
included: a box is left out only when the ray cannot reach a triangle
inside it before the lane's best, and such a triangle could not have
been taken.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fp
from portbench.reference.scene import Tables
from portbench.reference.trace import object_ray, sphere_test, tri_test

LEAF = 4
FAN = 8
PAD = 2.0 ** -10
# (lane, node) or (lane, triangle) pairs tested in one go
PAIRS = 1 << 22
# a direction component below this is taken as TINY for the slab test
TINY = 1e-30


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points already scaled to [0, 1]^3."""
    q = np.clip((c * 1023.0).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + 2 - axis)
    return code


def _pad(lo: np.ndarray, hi: np.ndarray, pad: float):
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


class MeshTree:
    """The box tree of one mesh's triangle rows (T, 12) [v0 e1 e2 n].

    lo, hi: (nodes, 3) float32 boxes in heap order, NaN where a node
    holds no triangle (a NaN box is entered by no ray); depth: the
    levels under the root; rows: (leaves * LEAF,) the mesh row in each
    leaf slot, -1 where empty; box: the mesh's box (lo, hi), unpadded,
    float64."""

    def __init__(self, rows: torch.Tensor):
        dev = rows.device
        r = rows.cpu().numpy().astype(np.float64)
        v0 = r[:, 0:3]
        tri = np.stack([v0, v0 - r[:, 3:6], v0 + r[:, 6:9]], 1)
        t_lo, t_hi = tri.min(1), tri.max(1)
        lo, hi = t_lo.min(0), t_hi.max(0)
        self.box = (lo, hi)
        pad = PAD * float(np.linalg.norm(hi - lo)) + 1e-30
        cen = (t_lo + t_hi) * 0.5
        order = np.argsort(_morton((cen - lo) / np.maximum(hi - lo, 1e-30)),
                           kind="stable")
        T = len(order)
        leaves = max(1, -(-T // LEAF))
        depth = 0
        while FAN ** depth < leaves:
            depth += 1
        slots = np.full(FAN ** depth * LEAF, -1, np.int64)
        slots[:T] = order
        self.depth = depth
        self.rows = torch.tensor(slots, device=dev)
        # leaf boxes, then each level up as the union of its children
        s_lo = np.full((len(slots), 3), np.nan)
        s_hi = np.full((len(slots), 3), np.nan)
        s_lo[:T], s_hi[:T] = t_lo[order], t_hi[order]
        level_lo = np.fmin.reduce(s_lo.reshape(-1, LEAF, 3), axis=1)
        level_hi = np.fmax.reduce(s_hi.reshape(-1, LEAF, 3), axis=1)
        los, his = [level_lo], [level_hi]
        for _ in range(depth):
            level_lo = np.fmin.reduce(level_lo.reshape(-1, FAN, 3), axis=1)
            level_hi = np.fmax.reduce(level_hi.reshape(-1, FAN, 3), axis=1)
            los.append(level_lo)
            his.append(level_hi)
        self.lo, self.hi = (torch.tensor(x, device=dev) for x in _pad(
            np.concatenate(los[::-1]), np.concatenate(his[::-1]), pad))
        self.first_leaf = (FAN ** depth - 1) // (FAN - 1)


def _enters(lo, hi, o, inv, best):
    """Whether each ray (o, 1 / d) enters the box [lo, hi] at some t in
    [0, best]; a NaN box is entered by none."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (near <= far) & (far >= 0.0) & (near <= best)


def _inverse(d):
    return 1.0 / torch.where(d.abs() < TINY, TINY, d)


def _chunks(n: int, size: int):
    """[a, b) ranges of at most `size` over n; one empty range for n = 0."""
    for a in range(0, max(n, 1), size):
        yield a, min(n, a + size)


def _descend(tree: MeshTree, o, inv, best):
    """The (lane, leaf) pairs whose leaf box each lane's ray enters before
    its best t, one level of the tree a step."""
    dev = o.device
    lane = torch.arange(o.shape[0], device=dev)
    node = torch.zeros_like(lane)
    keep = _enters(tree.lo[node], tree.hi[node], o, inv, best)
    lane, node = lane[keep], node[keep]
    kids = torch.arange(1, FAN + 1, device=dev)
    for _ in range(tree.depth):
        lanes, nodes = [], []
        for a, b in _chunks(lane.shape[0], PAIRS // FAN):
            ln = lane[a:b].repeat_interleave(FAN)
            nd = (node[a:b, None] * FAN + kids).reshape(-1)
            keep = _enters(tree.lo[nd], tree.hi[nd], o[ln], inv[ln],
                           best[ln])
            lanes.append(ln[keep])
            nodes.append(nd[keep])
        lane, node = torch.cat(lanes), torch.cat(nodes)
    return lane, node - tree.first_leaf


def _mesh_hit(tree: MeshTree, rows, o, d, best):
    """Each lane's nearest triangle strictly nearer than `best`, the
    lowest row among equal t: (has, t, row)."""
    n, dev = o.shape[0], o.device
    lane, leaf = _descend(tree, o, _inverse(d), best)
    slots = torch.arange(LEAF, device=dev)
    hl, ht, hr = [], [], []
    for a, b in _chunks(lane.shape[0], PAIRS // LEAF):
        ln = lane[a:b].repeat_interleave(LEAF)
        row = tree.rows[(leaf[a:b, None] * LEAF + slots).reshape(-1)]
        real = row >= 0
        ln, row = ln[real], row[real]
        hit, t, _, _ = tri_test(rows[row], o[ln], d[ln])
        take = hit & (t < best[ln])
        hl.append(ln[take])
        ht.append(t[take])
        hr.append(row[take])
    lane, t, row = torch.cat(hl), torch.cat(ht), torch.cat(hr)
    t_min = torch.full((n,), float("inf"), device=dev)
    t_min.scatter_reduce_(0, lane, t, "amin")
    at_min = t == t_min[lane]
    none = rows.shape[0]
    r_min = torch.full((n,), none, dtype=torch.int64, device=dev)
    r_min.scatter_reduce_(0, lane[at_min], row[at_min], "amin")
    # the winner's own t (of two equal zeros, its sign)
    win = at_min & (row == r_min[lane])
    t_out = torch.full((n,), fp.FLT_MAX, device=dev)
    t_out[lane[win]] = t[win]
    return r_min < none, t_out, r_min


class Walk:
    """The search of trace.trace through each mesh's box tree: call it as
    closest_hit, walk(tab, o, d) -> (t, prim, inst)."""

    def __init__(self, tab: Tables):
        dev = tab.diffuse.device
        self.trees = [MeshTree(m[0]) for m in tab.meshes]
        # each mesh instance's padded world box: its mesh box's corners
        # through A
        self.world = {}
        for ii, (kind, obj, A, _, _) in enumerate(tab.instances):
            if kind != "mesh":
                continue
            lo, hi = self.trees[obj].box
            corners = np.array([[(hi if k >> a & 1 else lo)[a]
                                 for a in range(3)] for k in range(8)])
            M = A.cpu().numpy().astype(np.float64)
            w = corners @ M[:, :3].T + M[:, 3]
            w_lo, w_hi = w.min(0), w.max(0)
            pad = PAD * float(np.linalg.norm(w_hi - w_lo)) + 1e-30
            self.world[ii] = tuple(torch.tensor(x, device=dev)
                                   for x in _pad(w_lo, w_hi, pad))

    def __call__(self, tab: Tables, o, d):
        B = o.shape[0]
        best = torch.full((B,), fp.FLT_MAX, device=o.device)
        prim = torch.full((B,), -1, dtype=torch.int64, device=o.device)
        inst = torch.full((B,), -1, dtype=torch.int64, device=o.device)
        inv = _inverse(d)
        for ii, (kind, obj, _, Ainv, off) in enumerate(tab.instances):
            if kind == "sphere":
                o_s, d_s = object_ray(Ainv, off, o, d)
                hit, t = sphere_test(tab.spheres[obj][0], o_s, d_s, best)
                best = torch.where(hit, t, best)
                prim = torch.where(hit, -1, prim)
                inst = torch.where(hit, ii, inst)
                continue
            # a world ray at t is the object ray at t - off
            lo, hi = self.world[ii]
            lanes = torch.nonzero(_enters(lo, hi, o, inv, best + off)
                                  ).squeeze(1)
            if lanes.numel() == 0:
                continue
            o_s, d_s = object_ray(Ainv, off, o[lanes], d[lanes])
            has, t, row = _mesh_hit(self.trees[obj], tab.meshes[obj][0],
                                    o_s, d_s, best[lanes])
            lanes = lanes[has]
            best[lanes] = t[has]
            prim[lanes] = row[has]
            inst[lanes] = ii
        return best, prim, inst
