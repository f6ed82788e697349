"""Edge-aware visibility gradients (boundary sampling): the port of the
JAX package's ops/edge_grad.py.

The differentiable trace detaches the closest-hit search, so
d(image)/d(vertex) is ZERO across silhouettes: moving a triangle edge
across a pixel changes the image discontinuously and the interior
(detached-sampling) estimator cannot see it. This module adds the missing
BOUNDARY term of the derivative.

Math: the pixel value is a filtered screen integral
I(p) = ∫ k(u - p) L(u; θ) du with the tent filter k the camera's jitter
implies (triangle distribution on [-1,1] per axis, camera.c:50-56). When
geometry θ moves, radiance jumps across the silhouette curve u_e(t; θ)
and Reynolds' transport theorem gives the extra term

  dI(p)/dθ = ∮_sil k(u_e - p) [L⁻ - L⁺](u_e) (V·n̂) ‖du_e/dt‖ dt,

V = ∂u_e/∂θ the screen velocity of the edge point, n̂ the screen normal
of the curve, L∓ the radiance limits on the two sides.

Estimator (primary visibility; make_edge_grad2_fn extends it one bounce
deeper, silhouettes past depth 2 stay detached): silhouette edges are
classified per camera (boundary edges, or sign(n₁·v) ≠ sign(n₂·v)),
stratified points on each edge are projected to the screen, both sides are
shaded with offset rays (detached, common random numbers), and the term
enters autograd as a Function whose forward value is exactly zero: its
backward differentiates the single factor u·n̂ (n̂ detached), so the
cotangent picks up precisely V·n̂.

A side ray's sampler stream is a function of its pixel alone, and each
ray is traced independently of the others in its batch, so only the
samples that contribute (silhouette samples in front of the camera) have
their side rays traced, in chunks (_side_diff); the others contribute
zero either way.
"""

from __future__ import annotations

import numpy as np
import torch

from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import shading
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.ops.hitrec import Isect
from craytpu_torch.scene.device import INST_MESH

# side rays traced per trace_rays call
SIDE_CHUNK = 1 << 20
# (pixel, edge, sample) triples the secondary estimator builds at once
SECONDARY_CHUNK = 1 << 22

# running totals over the boundary backward passes of this process:
# backward calls, edge samples (pixels x edges x samples for the secondary
# term), samples that contribute, side rays traced. chip_smoke.py reads and
# resets them, as it does the kernels' launch counters.
STATS = {"backward": 0, "samples": 0, "silhouette": 0, "side_rays": 0}


def build_edges(scene):
    """Host-side mesh edge table over all mesh instances.

    Returns dict of np arrays (E rows):
      tri_a:  global triangle id whose row encodes the edge's endpoints
      slot_a, slot_b: endpoint slots in tri_a (0=v0, 1=v1, 2=v2)
      tri_b:  adjacent triangle id (-1 for boundary edges)
      inst:   instance id
    """
    tri_base = []
    pos = 0
    for mesh in scene.meshes:
        tri_base.append(pos)
        pos += mesh.tri_vidx.shape[0] if mesh.tri_vidx is not None else 0

    rows = {"tri_a": [], "slot_a": [], "slot_b": [], "tri_b": [],
            "inst": []}
    for ii, inst in enumerate(scene.instances):
        if inst.kind != INST_MESH:
            continue
        mesh = scene.meshes[inst.obj_index]
        if mesh.tri_vidx is None or mesh.tri_vidx.shape[0] == 0:
            continue
        base = tri_base[inst.obj_index]
        edges: dict = {}
        for lt, tri in enumerate(mesh.tri_vidx):
            for sa, sb in ((0, 1), (1, 2), (2, 0)):
                key = (min(tri[sa], tri[sb]), max(tri[sa], tri[sb]))
                if key in edges:
                    edges[key] = (edges[key][0], edges[key][1],
                                  edges[key][2], base + lt)
                else:
                    edges[key] = (base + lt, sa, sb, -1)
        for (ta, sa, sb, tb) in edges.values():
            rows["tri_a"].append(ta)
            rows["slot_a"].append(sa)
            rows["slot_b"].append(sb)
            rows["tri_b"].append(tb)
            rows["inst"].append(ii)
    return {k: np.asarray(v, np.int32) for k, v in rows.items()}


def _slot_point(row, slot):
    """tri_packed row (..., 12) + slot -> vertex (poly.c packing:
    v0, e1=v0-v1, e2=v2-v0)."""
    v0 = row[..., 0:3]
    v1 = v0 - row[..., 3:6]
    v2 = row[..., 6:9] + v0
    s = slot[..., None]
    return torch.where(s == 0, v0, torch.where(s == 1, v1, v2))


def _norm(x):
    """|x| over the last axis as sqrt(sum(x * x)) (no overflow scaling),
    as jnp.linalg.norm."""
    return vm.ieee_sqrt((x * x).sum(-1))


class _Edges:
    """The edge table on the scene's device, and the edges' world
    endpoints from a tri_packed."""

    def __init__(self, cscene, scene):
        dev = cscene.device
        e = build_edges(scene)
        self.E = int(e["tri_a"].shape[0])
        t = {k: torch.as_tensor(v, device=dev).long() for k, v in e.items()}
        self.tri_a, self.slot_a, self.slot_b = (t["tri_a"], t["slot_a"],
                                                t["slot_b"])
        self.tri_b = t["tri_b"]
        self.A = cscene.geom.inst_A[t["inst"]]          # (E, 3, 4)
        self.Ainv = cscene.geom.inst_Ainv[t["inst"]]

    def world_pts(self, tri_packed):
        rowA = tri_packed[self.tri_a]                   # (E, 12)
        xa = _slot_point(rowA, self.slot_a)
        xb = _slot_point(rowA, self.slot_b)
        A = self.A
        Xa = torch.einsum("eij,ej->ei", A[:, :, :3], xa) + A[:, :, 3]
        Xb = torch.einsum("eij,ej->ei", A[:, :, :3], xb) + A[:, :, 3]
        return Xa, Xb

    def face_normals(self, tri_packed):
        """World face normals (Ainv^T n_mesh) of both sides of each edge
        (the second is tri_a's own for a boundary edge)."""
        Ai = self.Ainv[:, :, :3]
        na = torch.einsum("eji,ej->ei", Ai, tri_packed[self.tri_a][:, 9:12])
        nb = torch.einsum("eji,ej->ei", Ai,
                          tri_packed[self.tri_b.clamp_min(0)][:, 9:12])
        return na, nb


def _side_diff(trace_rays, params, kind, pass_idx: int, spp: int, rays, pix,
               keep):
    """L(minus side) - L(plus side), (N, 4), of the samples where keep
    (N,) is set, zero elsewhere. rays(idx) -> (o, d) of the 2n side rays
    of samples idx (their minus sides, then their plus sides); pix (N,) is
    each sample's pixel, which seeds both its rays' sampler streams.
    Traced detached, in batches of at most SIDE_CHUNK rays."""
    N = keep.shape[0]
    out = torch.zeros(N, 4, device=keep.device)
    idx_all = torch.nonzero(keep).squeeze(1)
    n = int(idx_all.shape[0])
    STATS["silhouette"] += n
    STATS["side_rays"] += 2 * n
    step = SIDE_CHUNK // 2
    for c in range(0, n, step):
        idx = idx_all[c:c + step]
        o, d = rays(idx)
        p2 = torch.cat([pix[idx], pix[idx]])
        full = torch.full(p2.shape, pass_idx, dtype=torch.int32,
                          device=p2.device)
        s = smp.init_sampler(kind, full, torch.full_like(full, spp), p2)
        L = trace_rays(params, o.contiguous(), d.contiguous(), s)
        m = idx.shape[0]
        out[idx] = L[:m] - L[m:]
    return out


class _Boundary(torch.autograd.Function):
    """Zero forward; the backward hands the image cotangent to the
    estimator's d_tri(tri_packed, params, pass_idx, spp, gbar)."""

    @staticmethod
    def forward(ctx, tri_packed, d_tri, npix, params, pass_idx, spp):
        ctx.save_for_backward(tri_packed)
        ctx.d_tri = d_tri
        ctx.args = (params, pass_idx, spp)
        return tri_packed.new_zeros(npix, 4)

    @staticmethod
    def backward(ctx, gbar):
        (tri_packed,) = ctx.saved_tensors
        params, pass_idx, spp = ctx.args
        STATS["backward"] += 1
        g = ctx.d_tri(tri_packed.detach(), params, pass_idx, spp, gbar)
        return g, None, None, None, None, None


def _boundary_fn(d_tri, npix):
    """boundary(params, tri_packed, pass_idx, spp) -> (npix, 4) zeros whose
    gradient reaches tri_packed through d_tri; pass_idx and spp are ints.
    The ShadeParams tables take no gradient from it."""
    def boundary(params, tri_packed, pass_idx: int, spp: int):
        return _Boundary.apply(tri_packed, d_tri, npix, params,
                               int(pass_idx), int(spp))
    return boundary


def _zero_fn(npix):
    def zero(params, tri_packed, pass_idx, spp):
        return tri_packed.new_zeros(npix, 4)
    return zero


def make_edge_grad_fn(cscene, scene, renderer, depth: int,
                      samples_per_edge: int = 32, delta: float = 0.5):
    """boundary(params, tri_packed, pass_idx, spp) -> (H*W, 4).

    Forward value is exactly zero; the gradient w.r.t. tri_packed carries
    the silhouette boundary term for the FULL FRAME in raster order (row
    y, then x: trace over xs=tile(arange(W)), ys=repeat(arange(H))). The
    side rays run through renderer.trace_rays_fn(depth) on the scene's
    compile-time geometry."""
    cam = cscene.camera
    W, H = cam.width, cam.height
    dev = cscene.device
    edges = _Edges(cscene, scene)
    E = edges.E
    if E == 0:
        return _zero_fn(H * W)

    A_cam = np.asarray(cam.A, np.float64)
    A4 = np.eye(4)
    A4[:3, :4] = A_cam[:3, :4]
    Ainv_cam = torch.tensor(np.linalg.inv(A4)[:3, :4].astype(np.float32),
                            device=dev)
    cam_pos = torch.tensor(A_cam[:3, 3].astype(np.float32), device=dev)
    R_cam = torch.tensor(A_cam[:3, :3].astype(np.float32), device=dev)
    sx_inv = float(np.float32(W / cam.sensor_x))   # screen px per unit tan
    sy_inv = float(np.float32(H / cam.sensor_y))
    sx = float(np.float32(cam.sensor_x / W))
    sy = float(np.float32(cam.sensor_y / H))
    cx = float(np.float32(W / 2 - 0.5))
    cy = float(np.float32(H / 2 - 0.5))

    trace_rays = renderer.trace_rays_fn(depth)
    kind = renderer.kind
    S = samples_per_edge
    ts = torch.tensor(((np.arange(S) + 0.5) / S).astype(np.float32),
                      device=dev)
    A3, At = Ainv_cam[:, :3], Ainv_cam[:, 3]

    def project(X):
        """World point -> (u, v) pixel coords + camera z."""
        Xc = torch.einsum("ij,...j->...i", A3, X) + At
        z = Xc[..., 2]
        zs = torch.where(z.abs() < 1e-8, 1e-8, z)
        u = Xc[..., 0] / zs * sx_inv + cx
        v = Xc[..., 1] / zs * sy_inv + cy
        return torch.stack([u, v], dim=-1), z

    def project_tangent(X, T):
        """The forward-mode derivative of project(X)[0] along T (the JAX
        package's jax.jvp, with its rule for a quotient:
        dx / y + (-dy * x) / y^2)."""
        Xc = torch.einsum("ij,...j->...i", A3, X) + At
        dXc = torch.einsum("ij,...j->...i", A3, T)
        small = Xc[..., 2].abs() < 1e-8
        zs = torch.where(small, 1e-8, Xc[..., 2])
        dzs = torch.where(small, 0.0, dXc[..., 2])
        inv2 = 1.0 / (zs * zs)
        du = (dXc[..., 0] / zs + (-dzs * Xc[..., 0]) * inv2) * sx_inv
        dv = (dXc[..., 1] / zs + (-dzs * Xc[..., 1]) * inv2) * sy_inv
        return torch.stack([du, dv], dim=-1)

    def ray_at(uv):
        """Screen pixel coords -> world camera ray (pinhole)."""
        dx = (uv[..., 0] - cx) * sx
        dy = (uv[..., 1] - cy) * sy
        d_c = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
        d_c = d_c / _norm(d_c)[..., None]
        d_w = torch.einsum("ij,...j->...i", R_cam, d_c)
        return cam_pos.expand(d_w.shape), d_w

    def sil_mask(tri_packed, Xa, Xb):
        """Silhouette classification (detached): boundary edges, or
        adjacent faces facing opposite sides of the view ray."""
        na, nb = edges.face_normals(tri_packed)
        mid = 0.5 * (Xa + Xb) - cam_pos
        da = (na * mid).sum(-1)
        db = (nb * mid).sum(-1)
        return (edges.tri_b < 0) | (da * db < 0)

    def scalar(tri_packed, params, pass_idx, spp, gbar):
        """Scalar surrogate h whose gradient w.r.t. tri_packed is the
        boundary term contracted with the cotangent gbar (H*W, 4)."""
        Xa, Xb = edges.world_pts(tri_packed)
        sil = sil_mask(tri_packed.detach(), Xa.detach(), Xb.detach())

        X = (Xa[:, None, :] * (1 - ts)[None, :, None]
             + Xb[:, None, :] * ts[None, :, None])          # (E, S, 3)
        uv, z = project(X)                                  # (E, S, 2)
        uv_d = uv.detach()
        z_d = z.detach()

        # screen tangent along the edge direction (detached)
        X_d = X.detach()
        tang = project_tangent(X_d, (Xb - Xa).detach()[:, None, :]
                               .expand(X_d.shape))          # (E, S, 2)
        speed = _norm(tang)
        n_hat = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)
        n_hat = n_hat / speed.clamp_min(1e-12)[..., None]

        # side radiances with common random numbers (detached), traced
        # for the samples that contribute
        uv_m = (uv_d - delta * n_hat).reshape(-1, 2)
        uv_p = (uv_d + delta * n_hat).reshape(-1, 2)
        px = torch.clamp(torch.round(uv_d[..., 0]), 0, W - 1).long()
        py = torch.clamp(torch.round(uv_d[..., 1]), 0, H - 1).long()
        pix = (py * W + px).reshape(-1)
        valid = sil[:, None] & (z_d > 1e-6)

        def rays(idx):
            return ray_at(torch.cat([uv_m[idx], uv_p[idx]]))
        with torch.no_grad():
            Ldiff = _side_diff(trace_rays, params, kind, pass_idx, spp, rays,
                               pix, valid.reshape(-1)).reshape(E, S, 4)

        # accumulate over the tent filter's 3x3 pixel support
        un_dot = (uv * n_hat).sum(-1)                       # DIFFERENTIABLE
        h = uv.new_zeros(())
        # floor, clamped so that the int cast is defined; a clamped sample
        # lies off screen and every tap of it is out of bounds
        p0x = torch.clamp(torch.floor(uv_d[..., 0]), -2, W + 1).long()
        p0y = torch.clamp(torch.floor(uv_d[..., 1]), -2, H + 1).long()
        for ddx in (-1, 0, 1):
            for ddy in (-1, 0, 1):
                qx = p0x + ddx
                qy = p0y + ddy
                wx = torch.clamp_min(1.0 - (uv_d[..., 0] - qx.float()).abs(),
                                     0.0)
                wy = torch.clamp_min(1.0 - (uv_d[..., 1] - qy.float()).abs(),
                                     0.0)
                inb = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
                gpix = gbar[torch.clamp(qy * W + qx, 0, H * W - 1)]
                coup = (Ldiff * gpix).sum(-1)
                term = (torch.where(valid & inb, wx * wy * coup * speed, 0.0)
                        * un_dot)
                h = h + term.sum() / S
        return h

    def d_tri(tri_packed, params, pass_idx, spp, gbar):
        STATS["samples"] += E * S
        with torch.enable_grad():
            tp = tri_packed.requires_grad_()
            (g,) = torch.autograd.grad(scalar(tp, params, pass_idx, spp,
                                              gbar), tp)
        return g

    return _boundary_fn(d_tri, H * W)


def make_edge_grad2_fn(cscene, scene, renderer, depth: int,
                       samples_per_edge: int = 8, delta: float = 1e-2):
    """boundary2(params, tri_packed, pass_idx, spp) -> (H*W, 4).

    ONE-BOUNCE-DEEP silhouette boundary term: the derivative the primary
    estimator misses when geometry moves a silhouette seen FROM a shading
    point rather than from the camera (e.g. an out-of-frame occluder
    whose edge sweeps across the hemisphere a diffuse receiver integrates
    over).

    Math: the secondary contribution of a diffuse primary vertex P is the
    hemisphere integral I2(P) = (rho/pi) * int cos(w,n) L(w) dw. Under
    geometry motion, L jumps across the DIRECTION-SPHERE silhouette curve
    w_e(t) = normalize(X_e(t) - P) (X_e on a mesh edge that is a
    silhouette w.r.t. P) and Reynolds gives

      dI2/dth = (rho/pi) oint cos(w_e,n) [L- - L+](w_e)
                (V . n_hat) ||dw_e/dt|| dt,

    with n_hat the in-sphere normal of the curve (normalize(cross(w,
    dw/dt))) and V = dw_e/dth. The same zero-forward Function as the
    primary estimator carries it: everything is detached except the
    single differentiable factor w . n_hat (n_hat detached).

    Scope: diffuse primary vertices only; the receiver's own motion is
    detached (only the edge mesh's velocity enters V); O(pixels x E x S)
    side rays a pass, built for validation-scale scenes, in chunks of at
    most SECONDARY_CHUNK (pixel, edge, sample) triples. The primary
    vertices come from the pass's own camera rays; their search runs on
    the scene's compile-time geometry, their records on tri_packed.
    Silhouettes at depth >= 3 remain detached.
    """
    cam = cscene.camera
    W, H = cam.width, cam.height
    dev = cscene.device
    edges = _Edges(cscene, scene)
    E = edges.E
    color_irs = cscene.diffuse_color_ir or {}
    if E == 0 or not color_irs:
        return _zero_fn(H * W)

    kind = renderer.kind
    trace_rays = renderer.trace_rays_fn(max(depth - 1, 1))
    albedo_fns = {gi: shading.compile_color(ir, cscene.reg)
                  for gi, ir in color_irs.items()}
    mat_graph = cscene.mat_graph

    S = samples_per_edge
    ts = torch.tensor(((np.arange(S) + 0.5) / S).astype(np.float32),
                      device=dev)
    B = H * W
    xs_r = torch.arange(W, dtype=torch.int32, device=dev).repeat(H)
    ys_r = torch.arange(H, dtype=torch.int32,
                        device=dev).repeat_interleave(W)
    pix = ys_r.long() * W + xs_r.long()

    def primary(tri_packed, params, pass_idx, spp):
        """Diffuse primary vertices of the pass: (diffuse, P, n_w,
        albedo), all detached. Same sampler streams as the rendered
        pass. A lane whose ray misses gets the shading record's stand-ins
        (P = 0, n = +z): its record is NaN, which the JAX package lets
        into every edge's gradient (0 * NaN in the backward)."""
        o, d, _ = renderer._init_rays(xs_r, ys_r, pass_idx, spp)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        is_hit, P, n_w, uv, mat_id, hit_t = Isect(
            cscene, tri_packed, renderer.traversal)(
            cscene.geom, o, d, alive)
        gid = mat_graph[mat_id.long()]
        dmask = torch.zeros(B, dtype=torch.bool, device=dev)
        for gi in albedo_fns:
            dmask = dmask | (gid == gi)
        diffuse = is_hit & dmask
        ih = is_hit[..., None]
        rec = shading.HitRec(
            incident=d, normal=torch.where(ih, n_w, n_w.new_tensor(
                [0.0, 0.0, 1.0])),
            uv=torch.where(ih, uv, 0.0), hit_point=torch.where(ih, P, 0.0),
            distance=torch.where(is_hit, hit_t, 1.0),
            emission=o.new_zeros(B, 4), ior=o.new_ones(B),
            mat_id=mat_id, active=diffuse)
        albedo = o.new_zeros(B, 4)
        for gi, fn in albedo_fns.items():
            m = (gid == gi) & diffuse
            albedo = torch.where(m[:, None], fn(params, rec), albedo)
        return diffuse, rec.hit_point, rec.normal, albedo

    def scalar(X, Xa, Xb, na, nb, b0, b1, prim, params, pass_idx, spp,
               gbar):
        """The surrogate h of the primary pixels [b0, b1): its gradient
        w.r.t. the edge sample points X (E, S, 3) is theirs of the
        boundary term contracted with gbar."""
        diffuse, P, n_w, albedo = (t[b0:b1] for t in prim)
        Bc = b1 - b0
        pix_c = pix[b0:b1]
        # directions from every primary vertex to every edge sample
        V = X[None, :, :, :] - P[:, None, None, :]          # (Bc, E, S, 3)
        Vd = V.detach()
        r = _norm(Vd)
        r_s = r.clamp_min(1e-6)[..., None]
        omega = V / r_s                                     # DIFFERENTIABLE
        om_d = omega.detach()

        # silhouette classification per (P, edge), detached
        da = (na[None, :, None, :] * Vd).sum(-1)
        db = (nb[None, :, None, :] * Vd).sum(-1)
        sil = (edges.tri_b < 0)[None, :, None] | (da * db < 0)  # (Bc, E, S)

        # curve tangent on the direction sphere: d omega/dt =
        # (I - ww^T) dX/dt / r (detached)
        dX = (Xb - Xa)[None, :, None, :]                    # (1, E, 1, 3)
        tang = (dX - om_d * (om_d * dX).sum(-1, keepdim=True)) / r_s
        speed = _norm(tang)                                 # (Bc, E, S)
        n_hat = torch.linalg.cross(
            om_d, tang / speed.clamp_min(1e-12)[..., None], dim=-1)

        cosw = (om_d * n_w[:, None, None, :]).sum(-1)
        valid = (diffuse[:, None, None] & sil & (r > 1e-5) & (cosw > 0.0))

        # side radiances with common random numbers (detached): rays from
        # P in w -/+ delta*n_hat, depth-1 budget, for the samples that
        # contribute
        om_m = vm.vnormalize(om_d - delta * n_hat).reshape(-1, 3)
        om_p = vm.vnormalize(om_d + delta * n_hat).reshape(-1, 3)
        per = E * S

        def rays(idx):
            o = P[idx // per]
            return (torch.cat([o, o]), torch.cat([om_m[idx], om_p[idx]]))
        pix2 = pix_c[:, None].expand(Bc, per).reshape(-1)
        with torch.no_grad():
            Ldiff = _side_diff(trace_rays, params, kind, pass_idx, spp, rays,
                               pix2, valid.reshape(-1)).reshape(Bc, E, S, 4)

        # weight: (rho/pi) cos+(w, n) * cotangent at the primary pixel
        fw = (cosw.clamp_min(0.0)[..., None] * albedo[:, None, None, :]
              * float(np.float32(1.0 / np.pi)))
        coup = (Ldiff * fw * gbar[pix_c][:, None, None, :]).sum(-1)
        un_dot = (omega * n_hat).sum(-1)                    # DIFFERENTIABLE
        return (torch.where(valid, coup * speed, 0.0) * un_dot).sum() / S

    def d_tri(tri_packed, params, pass_idx, spp, gbar):
        with torch.no_grad():
            prim = primary(tri_packed, params, pass_idx, spp)
            na, nb = edges.face_normals(tri_packed)
        step = max(1, SECONDARY_CHUNK // (E * S))
        STATS["samples"] += B * E * S
        with torch.enable_grad():
            tp = tri_packed.requires_grad_()
            Xa, Xb = edges.world_pts(tp)
            X = (Xa[:, None, :] * (1 - ts)[None, :, None]
                 + Xb[:, None, :] * ts[None, :, None])      # (E, S, 3)
            Xs = X.detach().requires_grad_()
            gX = torch.zeros_like(X)
            for b0 in range(0, B, step):
                h = scalar(Xs, Xa.detach(), Xb.detach(), na, nb, b0,
                           min(b0 + step, B), prim, params, pass_idx, spp,
                           gbar)
                gX = gX + torch.autograd.grad(h, Xs)[0]
            (g,) = torch.autograd.grad(X, tp, gX)
        return g

    return _boundary_fn(d_tri, H * W)
