"""Primitive intersection ops, batched over the leading lane axis.

  - Möller-Trumbore triangle test   datatypes/poly.c:17-53
  - sphere quadratic test           datatypes/sphere.c:20-50
  - AABB slab test                  accelerators/bvh.c:326-352

Comparisons keep the reference's NaN-ordering semantics: C writes
`x > y ? x : y` (picks y when x is NaN), which maps to
torch.where(x > y, x, y) — NOT torch.maximum (NaN-propagating). The CUDA
closest-hit kernel (csrc/closest_hit.cu) repeats these formulas op for op.
"""

from __future__ import annotations

import torch

from craytpu_torch.ops import vecmath as vm

FLT_MAX = 3.4028234663852886e38  # f32 max, exact in float32


def tri_intersect(tri_row, origin, direction, best_t):
    """Möller-Trumbore against packed triangle rows (B, 12) = v0,e1,e2,n.

    e1 = v0 - v1, e2 = v2 - v0, n = cross(e1, e2), exactly as poly.c:20-22.
    Returns (hit, t, u, v). hit requires t >= 0 and t < best_t.
    """
    v0 = tri_row[..., 0:3]
    e1 = tri_row[..., 3:6]
    e2 = tri_row[..., 6:9]
    n = tri_row[..., 9:12]
    c = v0 - origin
    r = vm.vcross(direction, c)
    inv_det = vm.exact_div(torch.ones_like(best_t), vm.vdot(n, direction))
    u = vm.vdot(r, e2) * inv_det
    v = vm.vdot(r, e1) * inv_det
    uv_ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    t = vm.vdot(n, c) * inv_det
    hit = uv_ok & (t >= 0.0) & (t < best_t)
    return hit, t, u, v


def sphere_intersect(radius, origin, direction, best_t):
    """Quadratic solve (sphere.c:20-50), object-space ray, sphere at origin.

    Keeps the reference's quirks: roots divided by 2 (not 2A), closest-root
    pick, 1e-5 near cutoff, and <=best acceptance. Returns (hit, t).
    C = fnma(r, r, o.o) and disc = fms(B, B, (4A)*C) are single-rounding
    fmas, as in the reference binary's contracted build.
    """
    A = vm.vdot(direction, direction)
    B = 2.0 * vm.vdot(direction, origin)
    C = vm.fma_raw(-radius, radius, vm.vdot(origin, origin))
    disc = vm.fma_raw(B, B, -((4.0 * A) * C))
    has_roots = disc >= 0.0
    sq = vm.exact_sqrt(torch.where(disc < 0.0, 0.0, disc))
    t0 = (-B + sq) / 2.0
    t1 = (-B - sq) / 2.0
    t0 = torch.where((t0 > t1) & (t1 > 0.0), t1, t0)
    hit = has_roots & (t0 >= 1e-5) & (t0 <= best_t)
    return hit, t0


def node_intersect(bounds6, inv_dir, scaled_start, octant, max_dist):
    """Slab test (bvh.c:326-352). bounds6 = (B, 6) minx,maxx,miny,maxy,...

    octant is bool (B, 3), True for a negative direction component;
    returns (hit, t_entry)."""
    def pick(axis):
        lo = bounds6[..., axis * 2]
        hi = bounds6[..., axis * 2 + 1]
        neg = octant[..., axis]
        near = torch.where(neg, hi, lo)
        far = torch.where(neg, lo, hi)
        # two roundings each, never an fma (the kernel builds -fmad=false)
        t_near = near * inv_dir[..., axis] + scaled_start[..., axis]
        t_far = far * inv_dir[..., axis] + scaled_start[..., axis]
        return t_near, t_far

    t_min_x, t_max_x = pick(0)
    t_min_y, t_max_y = pick(1)
    t_min_z, t_max_z = pick(2)
    # NaN-safe compare order (bvh.c:340-346)
    t_min = torch.where(t_min_x > t_min_y, t_min_x, t_min_y)
    t_max = torch.where(t_max_x < t_max_y, t_max_x, t_max_y)
    t_min = torch.where(t_min > t_min_z, t_min, t_min_z)
    t_max = torch.where(t_max < t_max_z, t_max, t_max_z)
    t_min = torch.where(t_min > 0.0, t_min, 0.0)
    t_max = torch.where(t_max < max_dist, t_max, max_dist)
    return t_min <= t_max, t_min


def ray_octant_invdir(direction):
    """Precompute traversal constants (bvh.c:370-376)."""
    inv_dir = vm.exact_div(torch.ones_like(direction), direction)
    return inv_dir, torch.signbit(direction)
