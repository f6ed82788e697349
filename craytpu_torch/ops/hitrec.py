"""Hit-record resolution: winner ids -> shading-ready hit data (K1), and
the closest-hit + resolve pipeline the integrator calls (Isect).

The counterpart of the reference's hit-record population
(instance.c:45-60 spheres, instance.c:169-185 + poly.c:37-48 meshes). Per
lane it gathers two denormalized rows

  tri_wide  (P, 32) f32: [v0 e1 e2 n | n0 n1 n2 | uv0 uv1 uv2 | mat flags]
  inst_wide (I, 28) f32: [A(12) | Ainv(12) | rayOffset | sphere_mat | r]

and recomputes the winner's exact (t, u, v) with the same ops in the same
order as the closest-hit walk, so shading consumes bit-identical hit data.
The record is 16 floats per lane:

  [t, u, v, p_w(3), n_w(3), uv_mesh(2), n_obj_sphere(3), pad(2)]

`hitrec_record` is the dispatching wrapper: CPU tensors go to the plain
version (`hitrec_plain`), CUDA tensors to the hand-written kernel
(csrc/hitrec.cu), which replaces the JAX package's Pallas hit-record
kernel (craytpu/ops/hitrec_kernel.py::_kernel). The sphere-uv trig stays
outside the kernel, here in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from craytpu_torch.ops import cuda_build
from craytpu_torch.ops import intersect as isx
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.device import INST_SPHERE
from craytpu_torch.utils.torchsetup import debug_enabled

FLT_MAX = isx.FLT_MAX
N_OUT = 16


def build_wide_rows(tri_packed, tri_shade, tri_mf, inst_A, inst_Ainv,
                    inst_offset, inst_kind, inst_obj, sph_mat,
                    sph_radius=None):
    """Host-side construction of the denormalized rows (numpy)."""
    P = tri_packed.shape[0]
    tw = np.zeros((P, 32), np.float32)
    tw[:, 0:12] = tri_packed
    tw[:, 12:21] = tri_shade[:, 0:9]       # n0, n1, n2
    tw[:, 21:27] = tri_shade[:, 9:15]      # uv0, uv1, uv2
    tw[:, 27] = tri_mf[:, 0].astype(np.float32)   # mat (exact to 2^24)
    tw[:, 28] = tri_mf[:, 1].astype(np.float32)   # flags

    Imax = inst_A.shape[0]
    iw = np.zeros((Imax, 28), np.float32)
    iw[:, 0:12] = inst_A.reshape(Imax, -1)
    iw[:, 12:24] = inst_Ainv.reshape(Imax, -1)
    iw[:, 24] = inst_offset
    for i in range(Imax):
        if inst_kind[i] == INST_SPHERE:
            iw[i, 25] = float(sph_mat[inst_obj[i]])
            if sph_radius is not None:
                iw[i, 26] = float(sph_radius[inst_obj[i]])
    return tw, iw


def hitrec_plain(tri_wide, inst_wide, o_w, d_w, t_k, prim, inst,
                 sphere_uv: bool, tri_rows=None):
    """The plain version of K1: (B, 16) records for winner ids (prim,
    inst) of rays (o_w, d_w), t_k the search distance. tri_rows: each
    lane's (B, 12) triangle row [v0 e1 e2 n] in place of tri_wide's
    columns 0:12 (the vertex gradient differentiates the record with
    respect to it)."""
    B = o_w.shape[0]
    is_hit = inst >= 0
    iw = inst_wide[torch.clamp_min(inst, 0).long()]     # (B, 28)
    A = iw[:, 0:12].reshape(-1, 3, 4)
    Ainv = iw[:, 12:24].reshape(-1, 3, 4)
    o_s, d_s = trv.object_ray(Ainv, iw[:, 24], o_w, d_w)

    is_sphere = prim < 0
    tw = tri_wide[torch.clamp_min(prim, 0).long()]      # (B, 32)
    tri_row = tw[:, 0:12] if tri_rows is None else tri_rows
    big = torch.full((B,), FLT_MAX, dtype=torch.float32, device=o_w.device)
    # exact winner recompute (bit-identical to the walk's triangle test)
    _, t_x, u_x, v_x = isx.tri_intersect(tri_row, o_s, d_s, big)
    is_tri = is_hit & ~is_sphere
    _, t_s = isx.sphere_intersect(iw[:, 26], o_s, d_s, big)
    t = torch.where(is_tri, t_x, torch.where(is_sphere & is_hit, t_s, t_k))
    u = torch.where(is_tri, u_x, 0.0)
    v = torch.where(is_tri, v_x, 0.0)
    t = torch.where(is_hit, t, FLT_MAX)

    p_obj = vm.along_ray(o_s, d_s, t)  # alongRay fma rounding

    # --- sphere normal (instance.c:45-60) ---
    sph_len = torch.where(is_sphere, vm.vlength(p_obj), 1.0)
    n_sph = vm.exact_div(
        p_obj, torch.where(sph_len == 0, 1.0, sph_len)[..., None])

    # --- mesh normal / uv: poly.c:42-46 fma(n0, w, fma(n1, u, n2*v)) ---
    w = 1.0 - u - v
    n_smooth = vm.fma_raw(
        tw[:, 12:15], w[..., None],
        vm.fma_raw(tw[:, 15:18], u[..., None], tw[:, 18:21] * v[..., None]))
    flags = tw[:, 28].to(torch.int32)
    has_n = (flags & 1) == 1
    n_mesh = torch.where(has_n[..., None], n_smooth, tri_row[:, 9:12])
    uv_mesh = vm.fma_raw(
        tw[:, 21:23], w[..., None],
        vm.fma_raw(tw[:, 23:25], u[..., None], tw[:, 25:27] * v[..., None]))
    uv_ok = (flags & 2) == 2
    uv_mesh = torch.where(uv_ok[..., None], uv_mesh, -1.0)

    n_obj = torch.where(is_sphere[..., None], n_sph, n_mesh)
    # world normal: transformVectorWithTranspose(Ainv) == Ainv^T
    n_w = vm.mat33_vec_T(Ainv, n_obj)
    n_len = vm.vlength(n_w)
    n_w = torch.where(is_sphere[..., None], n_w,
                      vm.exact_div(n_w, torch.where(n_len == 0, 1.0,
                                                    n_len)[..., None]))
    p_w = vm.mat34_point(A, p_obj)
    z = torch.zeros_like(t)
    return torch.cat([
        torch.stack([t, u, v], dim=-1), p_w, n_w, uv_mesh,
        n_sph if sphere_uv else torch.zeros_like(n_sph),
        torch.stack([z, z], dim=-1)], dim=-1)


def hitrec_record(tri_wide, inst_wide, o_w, d_w, t_k, prim, inst,
                  sphere_uv: bool):
    """(B, 16) hit records. CPU tensors: the plain version. CUDA tensors:
    the K1 kernel, or an error."""
    if o_w.device.type == "cpu":
        return hitrec_plain(tri_wide, inst_wide, o_w, d_w, t_k, prim, inst,
                            sphere_uv)
    B = o_w.shape[0]
    check = cuda_build.check_tensor
    # the kernel reads the rows with 16-byte loads
    check(tri_wide, "tri_wide", torch.float32, (tri_wide.shape[0], 32),
          align=16)
    check(inst_wide, "inst_wide", torch.float32, (inst_wide.shape[0], 28),
          align=16)
    check(o_w, "o_w", torch.float32, (B, 3))
    check(d_w, "d_w", torch.float32, (B, 3))
    check(t_k, "t_k", torch.float32, (B,))
    check(prim, "prim", torch.int32, (B,))
    check(inst, "inst", torch.int32, (B,))
    out = torch.empty((B, N_OUT), dtype=torch.float32, device=o_w.device)
    if B == 0:
        return out
    fn = cuda_build.function("hitrec", "craytpu_hitrec", "pppppppiipp")
    cuda_build.launch(
        "hitrec", fn, tri_wide.data_ptr(), inst_wide.data_ptr(),
        o_w.data_ptr(), d_w.data_ptr(), t_k.data_ptr(), prim.data_ptr(),
        inst.data_ptr(), B, int(bool(sphere_uv)), out.data_ptr(),
        torch.cuda.current_stream(o_w.device).cuda_stream, size=B)
    hitrec_record.launches += 1
    return out


hitrec_record.launches = 0


_HALF_PI = float(np.float32(vm.PI) / np.float32(2.0))


def sphere_uv_from_normal(n):
    """getTexMapSphere (instance.c:33-43) from the object-space normal."""
    phi = torch.atan2(n[..., 2], n[..., 0])
    theta = torch.asin(torch.clamp(n[..., 1], -1.0, 1.0))
    sph_v = (theta + _HALF_PI) / vm.PI
    sph_u = 1.0 - (phi + vm.PI) / vm.TWO_PI
    return torch.stack([vm.wrap_min_max(sph_u, 0.0, 1.0),
                        vm.wrap_min_max(sph_v, 0.0, 1.0)], dim=-1)


def resolve(rec, tri_wide, inst_wide, prim, inst, sphere_uv: bool):
    """Records -> (is_hit, p_w, n_w, uv, mat_id, t, u, v)."""
    is_hit = inst >= 0
    is_sphere = prim < 0
    if sphere_uv:
        sph = sphere_uv_from_normal(rec[:, 11:14])
    else:
        # no sphere material in this scene reads uv — skip the trig
        sph = torch.zeros_like(rec[:, 9:11])
    uv = torch.where(is_sphere[..., None], sph, rec[:, 9:11])
    sph_mat = inst_wide[torch.clamp_min(inst, 0).long(), 25]
    mesh_mat = tri_wide[torch.clamp_min(prim, 0).long(), 27]
    mat_id = torch.where(is_sphere, sph_mat, mesh_mat).to(torch.int32)
    return (is_hit, rec[:, 3:6], rec[:, 6:9], uv,
            torch.where(is_hit, mat_id, 0), rec[:, 0], rec[:, 1], rec[:, 2])


def make_hitrec_fn(tri_wide, inst_wide, sphere_uv: bool):
    """hitrec(o_w, d_w, t_k, prim, inst) ->
    (is_hit, p_w, n_w, uv, mat_id, t, u, v)."""
    def hitrec(o_w, d_w, t_k, prim, inst):
        rec = hitrec_record(tri_wide, inst_wide, o_w, d_w, t_k, prim, inst,
                            sphere_uv)
        return resolve(rec, tri_wide, inst_wide, prim, inst, sphere_uv)
    return hitrec


class _RecordGrad(torch.autograd.Function):
    """Hit records whose gradient reaches the packed triangle rows: the
    port of make_hitrec_fn(diff=True) (craytpu/ops/hitrec.py:63-174).

    forward returns the record it is given (K1's on the card: bit-equal to
    the plain version). backward recomputes each lane's record with the
    plain ops, with tri_packed's row as the differentiated input, and
    scatters the row gradients into tri_packed. Only triangle winners take
    a gradient; the smooth normals and uvs stay on the static tri_wide, as
    in craytpu. The JAX package has no backward kernel, so none is
    written here."""

    @staticmethod
    def forward(ctx, tri_packed, rec, tri_wide, inst_wide, o_w, d_w, t_k,
                prim, inst, sphere_uv):
        ctx.save_for_backward(tri_packed, tri_wide, inst_wide, o_w, d_w, t_k,
                              prim, inst)
        ctx.sphere_uv = sphere_uv
        return rec.view_as(rec)

    @staticmethod
    def backward(ctx, g):
        tri_packed, tri_wide, inst_wide, o_w, d_w, t_k, prim, inst = \
            ctx.saved_tensors
        pr = torch.clamp_min(prim, 0).long()
        with torch.enable_grad():
            rows = tri_packed.detach()[pr].requires_grad_()
            rec = hitrec_plain(tri_wide, inst_wide, o_w, d_w, t_k, prim, inst,
                               ctx.sphere_uv, tri_rows=rows)
            (g_rows,) = torch.autograd.grad(rec, rows, g)
        # lanes whose winner is no triangle take none (their row 0 stand-in
        # may hold a non-finite intermediate)
        g_rows = torch.where(((inst >= 0) & (prim >= 0))[:, None], g_rows,
                             0.0)
        g_tp = torch.zeros_like(tri_packed).index_add_(0, pr, g_rows)
        return (g_tp,) + (None,) * 9


def check_ids(prim, inst, n_prim: int, n_inst: int, where: str) -> None:
    """Debug mode's index check (the JAX package's checkify index
    checks): raise unless every prim is in [-1, n_prim) and every inst
    in [-1, n_inst) (-1: no hit). Waits for the device."""
    bad = (prim < -1) | (prim >= n_prim) | (inst < -1) | (inst >= n_inst)
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0, 0])
        raise IndexError(
            f"{where}: {int(bad.sum())} lane(s) with an out-of-range id, "
            f"first lane {i}: prim {int(prim[i])} of {n_prim}, inst "
            f"{int(inst[i])} of {n_inst} (CRAYTPU_DEBUG)")


class Isect:
    """Closest hit (K2) then hit-record resolve (K1):
    isect(geom, o_w, d_w, alive) -> (is_hit, p_w, n_w, uv, mat_id, t).

    Each kernel's wrapper picks its plain version for CPU tensors. K2
    reads the scene's KernelLayout, built once per scene at the first
    launch on the card (a CPU run never builds it). Callers pass detached
    rays: the discrete search takes no gradient.

    tri_packed: the port of craytpu's make_isect_fn(diff=True), for
    vertex gradients. The search stays on the scene's own geometry (the
    detached-visibility estimator); the records' forward values come from
    K1 given tri_wide with its columns 0:12 replaced by tri_packed (rebuilt
    here, once), and their gradient reaches tri_packed (_RecordGrad).

    `search` and `resolve` split the call, so that a caller can keep
    search's detached results (K2's winners and K1's records) and resolve
    them again without launching either kernel.

    Under CRAYTPU_DEBUG (read when the Isect is built) both check that
    the winner ids they take are in range (check_ids)."""

    def __init__(self, cscene, tri_packed=None):
        self.cscene = cscene
        self.tri_packed = tri_packed
        self.debug = debug_enabled()
        self.tri_wide = cscene.tri_wide
        if tri_packed is not None:
            self.tri_wide = torch.cat([tri_packed.detach(),
                                       cscene.tri_wide[:, 12:]],
                                      1).contiguous()

    def search(self, geom, o_w, d_w, alive) -> tuple:
        """(t, prim, inst, record) of each ray: the kernels' outputs."""
        cs = self.cscene
        limit = torch.where(alive, FLT_MAX, 0.0)
        layout = cs.layout if o_w.device.type == "cuda" else None
        hit = trv.closest_hit(geom, o_w, d_w, limit, cs.tlas_end,
                              cs.stack_depth, layout)
        if self.debug:
            check_ids(hit.prim, hit.inst, self.tri_wide.shape[0],
                      cs.inst_wide.shape[0], "closest hit")
        rec = hitrec_record(self.tri_wide, cs.inst_wide, o_w, d_w, hit.t,
                            hit.prim, hit.inst, cs.sphere_uv)
        return hit.t, hit.prim, hit.inst, rec

    def resolve(self, found: tuple, o_w, d_w) -> tuple:
        t_k, prim, inst, rec = found
        cs = self.cscene
        if self.debug:
            check_ids(prim, inst, self.tri_wide.shape[0],
                      cs.inst_wide.shape[0], "hit record")
        tp = self.tri_packed
        if tp is not None and torch.is_grad_enabled() and tp.requires_grad:
            rec = _RecordGrad.apply(tp, rec, self.tri_wide, cs.inst_wide,
                                    o_w, d_w, t_k, prim, inst, cs.sphere_uv)
        return resolve(rec, self.tri_wide, cs.inst_wide, prim, inst,
                       cs.sphere_uv)[:6]

    def __call__(self, geom, o_w, d_w, alive):
        return self.resolve(self.search(geom, o_w, d_w, alive), o_w, d_w)
