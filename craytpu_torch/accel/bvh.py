"""Binned-SAH BVH builder (host side), exact replica of accelerators/bvh.c.

Wald-style binned SAH: 32 bins x 3 axes, right-to-left cost sweep, strict
less-than axis selection, leaf cutoff primCount < 2 or depth >= 64,
approximate-median fallback for oversized leaves (> 16 prims), Hoare-style
in-place partition, children bboxes accumulated from bins, preorder node
allocation. Identical inputs produce the identical node array and primitive
ordering as the C builder, so traversal visits prims in the same order.

Generic over primitives via (bboxes, centers), used for both triangle
(bottom-level) and instance (top-level) hierarchies like
buildBvhGeneric (bvh.c:245-287). A C++ fast path lives in
craytpu/native/bvh_builder.cpp behind the same interface.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32

MAX_BVH_DEPTH = 64
MAX_LEAF_SIZE = 16
TRAVERSAL_COST = F(1.5)
BIN_COUNT = 32
FLT_MAX = np.finfo(np.float32).max


@dataclass
class BVH:
    # bounds layout per node: minx, maxx, miny, maxy, minz, maxz (bvh.c:38)
    bounds: np.ndarray        # (n, 6) f32
    child: np.ndarray         # (n,) i32: inner → left child id; leaf → prim row
    count: np.ndarray         # (n,) i32: 0 inner, >0 leaf prim count
    prim_indices: np.ndarray  # (count,) i32

    @property
    def node_count(self) -> int:
        return self.bounds.shape[0]

    def max_depth(self) -> int:
        if self.node_count == 0:
            return 0
        depth = np.zeros(self.node_count, np.int32)
        best = 1
        stack = [(0, 1)]
        while stack:
            n, d = stack.pop()
            best = max(best, d)
            if self.count[n] == 0:
                c = int(self.child[n])
                stack.append((c, d + 1))
                stack.append((c + 1, d + 1))
        return best

    def root_bbox(self):
        b = self.bounds[0]
        return b[[0, 2, 4]].copy(), b[[1, 3, 5]].copy()


def _half_area(bmin, bmax):
    # empty bins are (FLT_MAX, -FLT_MAX) like emptyBBox; the C code happily
    # overflows these to inf in float math, so silence numpy's warnings
    with np.errstate(over="ignore", invalid="ignore"):
        e = (bmax - bmin).astype(F)
        return F(e[0] * (e[1] + e[2]) + e[1] * e[2])


def _bin_indices(coords, cmin, cmax):
    """computeBinIndex (bvh.c:87-93) vectorized over a prim range."""
    with np.errstate(divide="ignore", invalid="ignore"):
        center_to_bin = F(BIN_COUNT) / (cmax - cmin)
        fidx = ((coords - cmin) * center_to_bin).astype(F)
    fidx = np.nan_to_num(fidx, nan=0.0, posinf=F(BIN_COUNT), neginf=0.0)
    idx = np.where(fidx < 0, 0, fidx).astype(np.int64)
    return np.minimum(idx, BIN_COUNT - 1).astype(np.int32)


def _partition(prim, bins, split):
    """Hoare two-pointer partition (bvh.c:95-130), emulated exactly.

    prim/bins are views over the node's range; returns (new_prim, nless).
    """
    less = bins < split
    nless = int(less.sum())
    if nless == 0 or nless == len(prim):
        return prim.copy(), nless
    L = prim[:nless].copy()
    R = prim[nless:].copy()
    lg = ~less[:nless]          # ge slots in the left region (l-to-r order)
    rl = less[nless:]           # less slots in the right region
    fill_left = R[rl][::-1]     # right-side less elems, right-to-left
    fill_right = L[lg]          # left-side ge elems, left-to-right
    L[lg] = fill_left
    slots = np.nonzero(rl)[0][::-1]
    R[slots] = fill_right
    return np.concatenate([L, R]), nless


def build_bvh(bboxes_min: np.ndarray, bboxes_max: np.ndarray,
              centers: np.ndarray) -> BVH:
    """buildBvhGeneric (bvh.c:245-287). Dispatches to the native C++
    builder when available; both paths produce the identical tree."""
    n = int(centers.shape[0])
    if n < 1:
        return BVH(np.zeros((0, 6), F), np.zeros(0, np.int32),
                   np.zeros(0, np.int32), np.zeros(0, np.int32))

    bboxes_min = bboxes_min.astype(F)
    bboxes_max = bboxes_max.astype(F)
    centers = centers.astype(F)

    from craytpu_torch import native
    fn = native.bvh_builder()
    if fn is not None:
        import ctypes
        bounds = np.zeros((2 * n - 1, 6), F)
        child = np.zeros(2 * n - 1, np.int32)
        count = np.zeros(2 * n - 1, np.int32)
        prim = np.zeros(n, np.int32)
        lo = np.ascontiguousarray(bboxes_min)
        hi = np.ascontiguousarray(bboxes_max)
        ce = np.ascontiguousarray(centers)

        def p_f32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        def p_i32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        nc = fn(p_f32(lo), p_f32(hi), p_f32(ce), np.int32(n),
                p_f32(bounds), p_i32(child), p_i32(count), p_i32(prim))
        return BVH(bounds[:nc].copy(), child[:nc].copy(),
                   count[:nc].copy(), prim)

    max_nodes = 2 * n - 1
    bounds = np.zeros((max_nodes, 6), F)
    child = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    prim = np.arange(n, dtype=np.int32)

    root_min = bboxes_min.min(axis=0)
    root_max = bboxes_max.max(axis=0)
    bounds[0] = [root_min[0], root_max[0], root_min[1], root_max[1],
                 root_min[2], root_max[2]]
    state = {"node_count": 1}

    def make_leaf(node, begin, cnt):
        child[node] = begin
        count[node] = cnt

    def build(node, begin, end, depth):
        prim_count = end - begin
        if depth >= MAX_BVH_DEPTH or prim_count < 2:
            make_leaf(node, begin, prim_count)
            return

        ids = prim[begin:end]
        c_lo = bboxes_min[ids]
        c_hi = bboxes_max[ids]

        min_cost = [FLT_MAX, FLT_MAX, FLT_MAX]
        min_bin = [1, 1, 1]
        bin_cache = {}
        for axis in range(3):
            nmin = bounds[node][axis * 2]
            nmax = bounds[node][axis * 2 + 1]
            bidx = _bin_indices(centers[ids][:, axis], nmin, nmax)
            bin_cache[axis] = bidx
            bc = np.bincount(bidx, minlength=BIN_COUNT)
            # per-bin bboxes
            bmin = np.full((BIN_COUNT, 3), FLT_MAX, F)
            bmax = np.full((BIN_COUNT, 3), -FLT_MAX, F)
            np.minimum.at(bmin, bidx, c_lo)
            np.maximum.at(bmax, bidx, c_hi)
            bin_cache[(axis, "bb")] = (bmin, bmax, bc)
            # right-to-left sweep (bvh.c:170-177)
            cost_r = np.zeros(BIN_COUNT, F)
            cur_min = np.full(3, FLT_MAX, F)
            cur_max = np.full(3, -FLT_MAX, F)
            cur_cnt = 0
            for i in range(BIN_COUNT - 1, 0, -1):
                cur_cnt += int(bc[i])
                cur_min = np.minimum(cur_min, bmin[i])
                cur_max = np.maximum(cur_max, bmax[i])
                with np.errstate(invalid="ignore"):
                    cost_r[i] = F(cur_cnt) * _half_area(cur_min, cur_max)
            # left-to-right sweep (bvh.c:180-191)
            cur_min = np.full(3, FLT_MAX, F)
            cur_max = np.full(3, -FLT_MAX, F)
            cur_cnt = 0
            for i in range(BIN_COUNT - 1):
                cur_cnt += int(bc[i])
                cur_min = np.minimum(cur_min, bmin[i])
                cur_max = np.maximum(cur_max, bmax[i])
                with np.errstate(invalid="ignore"):
                    cost = F(F(cur_cnt) * _half_area(cur_min, cur_max)
                             + cost_r[i + 1])
                if cost < min_cost[axis]:
                    min_bin[axis] = i + 1
                    min_cost[axis] = cost

        min_axis = 0
        if min_cost[1] < min_cost[0]:
            min_axis = 1
        if min_cost[2] < min_cost[min_axis]:
            min_axis = 2

        node_area = _half_area(bounds[node][[0, 2, 4]], bounds[node][[1, 3, 5]])
        leaf_cost = F(node_area * (F(prim_count) - TRAVERSAL_COST))
        if min_cost[min_axis] > leaf_cost:
            if prim_count > MAX_LEAF_SIZE:
                # approximate median fallback (bvh.c:204-211)
                bc = bin_cache[(min_axis, "bb")][2]
                accum = 0
                best_approx = prim_count
                for i in range(BIN_COUNT - 1):
                    accum += int(bc[i])
                    approx = abs(prim_count // 2 - accum)
                    if approx < best_approx:
                        best_approx = approx
                        min_bin[min_axis] = i + 1
            else:
                make_leaf(node, begin, prim_count)
                return

        new_sub, nless = _partition(prim[begin:end], bin_cache[min_axis],
                                    min_bin[min_axis])
        begin_right = begin + nless
        if begin_right > begin:
            prim[begin:end] = new_sub
            left = state["node_count"]
            right = left + 1
            state["node_count"] += 2
            bmin, bmax, bc = bin_cache[(min_axis, "bb")]
            split = min_bin[min_axis]
            occupied_l = bc[:split] > 0
            occupied_r = bc[split:] > 0
            lmin = bmin[:split][occupied_l].min(axis=0) if occupied_l.any() \
                else np.full(3, FLT_MAX, F)
            lmax = bmax[:split][occupied_l].max(axis=0) if occupied_l.any() \
                else np.full(3, -FLT_MAX, F)
            rmin = bmin[split:][occupied_r].min(axis=0) if occupied_r.any() \
                else np.full(3, FLT_MAX, F)
            rmax = bmax[split:][occupied_r].max(axis=0) if occupied_r.any() \
                else np.full(3, -FLT_MAX, F)
            bounds[left] = [lmin[0], lmax[0], lmin[1], lmax[1], lmin[2], lmax[2]]
            bounds[right] = [rmin[0], rmax[0], rmin[1], rmax[1], rmin[2], rmax[2]]
            child[node] = left
            count[node] = 0
            build(left, begin, begin_right, depth + 1)
            build(right, begin_right, end, depth + 1)
        else:
            make_leaf(node, begin, prim_count)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(0, 0, n, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    nc = state["node_count"]
    return BVH(bounds[:nc].copy(), child[:nc].copy(), count[:nc].copy(), prim)


def tri_bboxes_centers(vertices: np.ndarray, tri_vidx: np.ndarray):
    """getPolyBBoxAndCenter (bvh.c:289-297)."""
    v0 = vertices[tri_vidx[:, 0]].astype(F)
    v1 = vertices[tri_vidx[:, 1]].astype(F)
    v2 = vertices[tri_vidx[:, 2]].astype(F)
    bmin = np.minimum(v0, np.minimum(v1, v2))
    bmax = np.maximum(v0, np.maximum(v1, v2))
    # getMidPoint: ((v0 + v1) + v2) / 3
    centers = ((v0 + v1) + v2) * F(1.0 / 3.0)
    return bmin, bmax, centers


RAY_OFFSET_MULTIPLIER = F(1e-4)  # includes.h:17


def ray_offset(bmin, bmax) -> float:
    """rayOffset (bbox.h:43-45): multiplier x bbox diagonal."""
    e = (bmax - bmin).astype(F)
    return F(RAY_OFFSET_MULTIPLIER * np.sqrt(np.dot(e, e)))
