"""Hit-record resolution: winner ids -> shading-ready hit data (K1), and
the closest-hit + resolve pipeline the integrator calls (make_isect_fn).

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
                 sphere_uv: bool):
    """The plain version of K1: (B, 16) records for winner ids (prim,
    inst) of rays (o_w, d_w), t_k the search distance."""
    B = o_w.shape[0]
    is_hit = inst >= 0
    iw = inst_wide[torch.clamp_min(inst, 0).long()]     # (B, 28)
    A = iw[:, 0:12].reshape(-1, 3, 4)
    Ainv = iw[:, 12:24].reshape(-1, 3, 4)
    o_s, d_s = trv.object_ray(Ainv, iw[:, 24], o_w, d_w)

    is_sphere = prim < 0
    tw = tri_wide[torch.clamp_min(prim, 0).long()]      # (B, 32)
    big = torch.full((B,), FLT_MAX, dtype=torch.float32, device=o_w.device)
    # exact winner recompute (bit-identical to the walk's triangle test)
    _, t_x, u_x, v_x = isx.tri_intersect(tw[:, 0:12], o_s, d_s, big)
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
    n_mesh = torch.where(has_n[..., None], n_smooth, tw[:, 9:12])
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


def make_isect_fn(cscene):
    """Closest hit (K2) then hit-record resolve (K1):
    isect(geom, o_w, d_w, alive) -> (is_hit, p_w, n_w, uv, mat_id, t).
    Each kernel's wrapper picks its plain version for CPU tensors. K2
    reads the scene's KernelLayout, built once per scene at the first
    launch on the card (a CPU run never builds it)."""
    hitrec = make_hitrec_fn(cscene.tri_wide, cscene.inst_wide,
                            cscene.sphere_uv)

    def isect(geom, o_w, d_w, alive):
        limit = torch.where(alive, FLT_MAX, 0.0)
        layout = cscene.layout if o_w.device.type == "cuda" else None
        hit = trv.closest_hit(geom, o_w, d_w, limit, cscene.tlas_end,
                              cscene.stack_depth, layout)
        return hitrec(o_w, d_w, hit.t, hit.prim, hit.inst)[:6]
    return isect
