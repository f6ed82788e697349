"""The reference path tracer: the radiance of chosen (pixel, pass) paths.

A straightforward, lane-parallel version of c-ray's path tracer
(renderer/pathtrace.c) over the tables of `scene.build`: the camera ray
with its tent-filter jitter, the closest hit by testing every triangle
and sphere (closest_hit; walk.py finds the same hits through box trees
of its own, for many paths), the hit record, the gradient sky on a
miss, the legacy emission on a hit, the material's mix(transparent,
diffuse, alpha) graph (c-ray's appendAlpha around a lambertian lobe), and
Russian roulette from depth 4. Each path's radiance is summed bounce by
bounce in c-ray's order. The arithmetic is fp.py's, so a path that the
timed path traces over the same winners rounds alike.
"""

from __future__ import annotations

import torch

from portbench.reference import fp
from portbench.reference.scene import Tables

# (ray, triangle) pairs the search holds in memory at once
PAIRS = 1 << 23


def camera_rays(tab: Tables, xs, ys, s: fp.Stream):
    c = tab.camera
    d1, s = fp.next_float(s)
    d2, s = fp.next_float(s)
    px = xs.to(torch.float32) - c["half_w"] + fp.triangle_distribution(d1) \
        + 0.5
    py = ys.to(torch.float32) - c["half_h"] + fp.triangle_distribution(d2) \
        + 0.5
    pix_v = c["forward"] + fp.fma_raw(c["pix_x"], px[:, None],
                                      c["pix_y"] * py[:, None])
    d = fp.vnormalize(pix_v)
    return fp.mat34_point(c["A"], torch.zeros_like(d)), \
        fp.mat33_vec(c["A"], d), s


def object_ray(Ainv, offset: float, o, d):
    o_t = fp.mat34_point(Ainv, o)
    d_t = fp.mat33_vec(Ainv, d)
    return fp.fma_raw(d_t, torch.full_like(d_t[:, :1], offset), o_t), d_t


def tri_test(rows, o, d):
    """Moller-Trumbore (poly.c:17-53) of rays (..., 3) against triangle
    rows (..., 12) [v0 e1 e2 n], broadcast: (hit, t, u, v)."""
    v0, e1, e2, n = (rows[..., 3 * k:3 * k + 3] for k in range(4))
    c = v0 - o
    r = fp.vcross(d, c)
    dn = fp.vdot(n, d)
    inv_det = fp.exact_div(torch.ones_like(dn), dn)
    u = fp.vdot(r, e2) * inv_det
    v = fp.vdot(r, e1) * inv_det
    t = fp.vdot(n, c) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) \
        & (t < fp.FLT_MAX)
    return hit, t, u, v


def sphere_test(radius: float, o, d, best):
    A = fp.vdot(d, d)
    B = 2.0 * fp.vdot(d, o)
    C = fp.fma_raw(torch.full_like(A, -radius), torch.full_like(A, radius),
                   fp.vdot(o, o))
    disc = fp.fma_raw(B, B, -((4.0 * A) * C))
    sq = fp.exact_sqrt(torch.where(disc < 0.0, 0.0, disc))
    t0 = (-B + sq) / 2.0
    t1 = (-B - sq) / 2.0
    t0 = torch.where((t0 > t1) & (t1 > 0.0), t1, t0)
    return (disc >= 0.0) & (t0 >= 1e-5) & (t0 <= best), t0


def closest_hit(tab: Tables, o, d):
    """(t, prim, inst) of each ray: the nearest triangle (prim its row in
    its mesh) or sphere (prim -1); inst -1 on a miss."""
    B = o.shape[0]
    best = torch.full((B,), fp.FLT_MAX, device=o.device)
    prim = torch.full((B,), -1, dtype=torch.int64, device=o.device)
    inst = torch.full((B,), -1, dtype=torch.int64, device=o.device)
    for ii, (kind, obj, _, Ainv, off) in enumerate(tab.instances):
        o_s, d_s = object_ray(Ainv, off, o, d)
        if kind == "sphere":
            hit, t = sphere_test(tab.spheres[obj][0], o_s, d_s, best)
            best = torch.where(hit, t, best)
            prim = torch.where(hit, -1, prim)
            inst = torch.where(hit, ii, inst)
            continue
        rows = tab.meshes[obj][0]
        R = max(1, PAIRS // rows.shape[0])
        for a in range(0, B, R):
            hit, t, _, _ = tri_test(rows[None], o_s[a:a + R, None],
                                    d_s[a:a + R, None])
            t = torch.where(hit, t, fp.FLT_MAX)
            t_min, arg = torch.min(t, dim=1)
            take = torch.any(hit, dim=1) & (t_min < best[a:a + R])
            best[a:a + R] = torch.where(take, t_min, best[a:a + R])
            prim[a:a + R] = torch.where(take, arg, prim[a:a + R])
            inst[a:a + R] = torch.where(take, ii, inst[a:a + R])
    return best, prim, inst


def hit_record(tab: Tables, o, d, prim, inst):
    """(p_w, n_w, material id) of hit lanes (c-ray's hit record:
    instance.c:45-60 and :169-185, poly.c:37-48)."""
    B = o.shape[0]
    dev = o.device
    p_w = torch.empty((B, 3), device=dev)
    n_w = torch.empty((B, 3), device=dev)
    mat = torch.empty((B,), dtype=torch.int64, device=dev)
    for ii, (kind, obj, A, Ainv, off) in enumerate(tab.instances):
        lanes = torch.nonzero(inst == ii).squeeze(1)
        if lanes.numel() == 0:
            continue
        o_s, d_s = object_ray(Ainv, off, o[lanes], d[lanes])
        if kind == "sphere":
            radius, m = tab.spheres[obj]
            big = torch.full((lanes.numel(),), fp.FLT_MAX, device=dev)
            _, t = sphere_test(radius, o_s, d_s, big)
            p_obj = fp.along_ray(o_s, d_s, t)
            ln = fp.vlength(p_obj)
            n_obj = fp.exact_div(p_obj, torch.where(ln == 0, 1.0, ln)[:, None])
            n_w[lanes] = fp.mat33_vec_T(Ainv, n_obj)
            mat[lanes] = m
        else:
            rows, shade, has_n, tri_mat = tab.meshes[obj]
            pr = prim[lanes]
            row = rows[pr]
            _, t, u, v = tri_test(row, o_s, d_s)
            p_obj = fp.along_ray(o_s, d_s, t)
            sh = shade[pr]
            w = 1.0 - u - v
            n_s = fp.fma_raw(sh[:, 0:3], w[:, None],
                             fp.fma_raw(sh[:, 3:6], u[:, None],
                                        sh[:, 6:9] * v[:, None]))
            n_obj = torch.where(has_n[pr][:, None], n_s, row[:, 9:12])
            n = fp.mat33_vec_T(Ainv, n_obj)
            ln = fp.vlength(n)
            n_w[lanes] = fp.exact_div(n, torch.where(ln == 0, 1.0, ln)[:, None])
            mat[lanes] = tri_mat[pr]
        p_w[lanes] = fp.mat34_point(A, p_obj)
    return p_w, n_w, mat


def sky(tab: Tables, d):
    """The gradient background (background.c with a gradient node)."""
    t = 0.5 * (fp.vnormalize(d)[:, 1] + 1.0)
    t = t[:, None]
    return tab.sky_down * (1.0 - t) + tab.sky_up * t


def trace(tab: Tables, xs, ys, passes, spp: int, store=None,
          search=closest_hit):
    """The radiance (N, 4) of the path of each (xs, ys, pass), N lanes,
    over tab.bounces bounces. The stream of each is seeded from its pixel
    and pass with spp passes in all. store, if given, is applied to each
    lane's ray, throughput and radiance as a bounce leaves them (the
    control stores them in a lower precision). search(tab, o, d) finds
    each ray's (t, prim, inst): closest_hit, or walk.Walk(tab), which
    finds the same."""
    dev = xs.device
    N = xs.shape[0]
    pix = ys.to(torch.int64) * tab.width + xs.to(torch.int64)
    s = fp.seed_streams(pix, passes, spp)
    o, d, s = camera_rays(tab, xs, ys, s)
    weight = torch.ones((N, 4), device=dev)
    final = torch.zeros((N, 4), device=dev)
    lanes = torch.arange(N, device=dev)
    for depth in range(tab.bounces):
        if lanes.numel() == 0:
            break
        t, prim, inst = search(tab, o, d)
        hit = inst >= 0
        # a miss takes the sky and ends
        miss = torch.nonzero(~hit).squeeze(1)
        if miss.numel():
            m = lanes[miss]
            final[m] = final[m] + weight[miss] * sky(tab, d[miss])
        keep = torch.nonzero(hit).squeeze(1)
        lanes, o, d = lanes[keep], o[keep], d[keep]
        weight, s = weight[keep], s.index(keep)
        prim, inst = prim[keep], inst[keep]
        if lanes.numel() == 0:
            break
        p_w, n_w, mat = hit_record(tab, o, d, prim, inst)
        final[lanes] = final[lanes] + weight * tab.emission[mat]
        # mix(transparent(white), diffuse(color), alpha(color))
        dim, s = fp.next_float(s)
        rand, s_diff = fp.random_on_unit_sphere(s)
        color = tab.diffuse[mat]
        transparent = dim > color[:, 3]
        out = torch.where(transparent[:, None], d,
                          fp.vnormalize(n_w + rand))
        att = torch.where(transparent[:, None], torch.ones_like(color),
                          color)
        s = s.where(transparent, s_diff)
        # Russian roulette from depth 4 (pathtrace.c:50-57)
        maxc = torch.maximum(att[:, 0], torch.maximum(att[:, 1], att[:, 2]))
        if depth >= 4:
            rr_dim, s = fp.next_float(s)
            prob = maxc
            survive = ~(rr_dim > prob)
        else:
            prob = torch.ones_like(maxc)
            survive = torch.ones_like(transparent)
        coef = fp.exact_div(torch.ones_like(prob),
                            torch.clamp_min(prob, 1e-30))[:, None]
        weight = (att * weight) * coef
        keep = torch.nonzero(survive).squeeze(1)
        lanes, o, d = lanes[keep], p_w[keep], out[keep]
        weight, s = weight[keep], s.index(keep)
        if store is not None:
            o, d, weight = store(o), store(d), store(weight)
            final = store(final)
    return final


def render_pixels(tab: Tables, xs, ys, first: int = 0, n: int | None = None,
                  block: int = 4096, store=None, search=closest_hit):
    """The radiance of passes first .. first + n - 1 (all tab.spp passes
    by default) of each pixel, (P, n, 4), traced in blocks of `block`
    paths; each stream is seeded with the render's tab.spp passes."""
    P = xs.shape[0]
    n = tab.spp - first if n is None else n
    px = xs.repeat_interleave(n)
    py = ys.repeat_interleave(n)
    pa = (first + torch.arange(n, device=xs.device)).repeat(P)
    out = torch.cat([trace(tab, px[a:a + block], py[a:a + block],
                           pa[a:a + block], tab.spp, store, search)
                     for a in range(0, P * n, block)])
    return out.reshape(P, n, 4)
