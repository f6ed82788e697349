"""Closest hit over the two-level BVH: the K2 kernel and its plain version.

The reference traverses a top-level BVH over instances and recursively
enters per-mesh bottom-level BVHs (accelerators/bvh.c:354-496). Here both
levels live in one global node array and every ray walks a single stack
whose entries are (node, instance): TLAS entries carry instance -1
(world-space ray), BLAS entries carry the instance whose inverse transform
defines the traversal space (instance.c:169-185).

Visit order and tie rules (the contract the kernel and the plain version
share, bit for bit):
  - a BLAS leaf tests its triangles in order (strict t < best);
  - a TLAS leaf tests its sphere instances in order (t >= 1e-5 and
    t <= best) and pushes the BLAS roots of its mesh instances in order;
  - an inner node slab-tests both children against the current best,
    descends to the nearer hit child and pushes the farther;
  - a push is dropped when the stack holds `stack_depth` entries (if both
    children hit then, neither is visited);
  - the best distance starts at the ray's limit; a lane whose limit is
    not > 0 (a dead lane) misses at once.

`closest_hit` is the dispatching wrapper: tensors on the CPU go to the
plain version (`traverse_plain`), CUDA tensors to the hand-written kernel
(csrc/closest_hit.cu), which replaces the JAX package's Pallas flash2
search (craytpu/ops/flash2.py::_kernel).
"""

from __future__ import annotations

import torch

from craytpu_torch.ops import cuda_build
from craytpu_torch.ops import intersect as isx
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene.device import Geometry, Hit, INST_MESH, INST_SPHERE

FLT_MAX = isx.FLT_MAX
# the kernel's fixed per-thread stack (local memory); scenes that need a
# deeper one are refused by the wrapper
KERNEL_MAX_STACK = 160


def object_ray(Ainv, off, o_w, d_w):
    """Object-space ray from gathered instance rows, Ainv (B, 3, 4) and
    rayOffset (B,): the origin is advanced by rayOffset along the
    (untransformed-length) object-space direction (instance.c:171-174).
    The same op sequence as detm::space_ray in csrc/detmath.cuh."""
    o_t = vm.mat34_point(Ainv, o_w)
    d_t = vm.mat33_vec(Ainv, d_w)
    return vm.fma_raw(d_t, off[..., None], o_t), d_t  # fma, instance.c:174


def space_ray(geom: Geometry, inst, o_w, d_w):
    """Ray in the traversal space of `inst` (-1 = world), batched."""
    safe = torch.clamp_min(inst, 0).long()
    o_t, d_t = object_ray(geom.inst_Ainv[safe], geom.inst_offset[safe],
                          o_w, d_w)
    is_obj = (inst >= 0)[..., None]
    return torch.where(is_obj, o_t, o_w), torch.where(is_obj, d_t, d_w)


def new_counts() -> dict:
    return {"inner": 0, "tri": 0, "sphere": 0, "node_ids": [], "tri_ids": []}


def traverse_plain(geom: Geometry, o_w, d_w, limit, tlas_end: int,
                   stack_depth: int, counts: dict | None = None) -> Hit:
    """The plain version of K2: every walking lane advances one node per
    iteration (the batched stack walk of the JAX package's
    ops/traverse.py), over the subset of lanes still walking.

    `counts`, if given (from new_counts()), accumulates the work the walk
    did: inner-node visits ("inner", two slab tests each), triangle tests
    ("tri"), sphere tests ("sphere"), and the ids of the nodes it read
    ("node_ids") and of the triangles it tested ("tri_ids") — the
    data-dependent part of K2's bound."""
    B = o_w.shape[0]
    dev = o_w.device
    M = geom.node_bounds.shape[0]
    i64 = torch.int64
    node = torch.zeros(B, dtype=i64, device=dev)
    inst = torch.full((B,), -1, dtype=i64, device=dev)
    sp = torch.zeros(B, dtype=i64, device=dev)
    st_n = torch.zeros((B, stack_depth), dtype=i64, device=dev)
    st_i = torch.full((B, stack_depth), -1, dtype=i64, device=dev)
    best_t = limit.clone()
    best_prim = torch.full((B,), -1, dtype=i64, device=dev)
    best_inst = torch.full((B,), -1, dtype=i64, device=dev)
    node_count = geom.node_count.long()
    node_child = geom.node_child.long()
    prim_idx = geom.prim_idx.long()

    act = torch.nonzero(limit > 0.0).squeeze(1)
    while act.numel():
        n, ii = node[act], inst[act]
        if counts is not None:
            counts["node_ids"].append(n)
        ow, dw = o_w[act], d_w[act]
        o, d = space_ray(geom, ii, ow, dw)
        count = node_count[n]
        row = node_child[n]
        leaf = count > 0

        # ---- BLAS leaf: its triangles, in order ----
        sel = torch.nonzero(leaf & (n >= tlas_end)).squeeze(1)
        if sel.numel():
            lanes = act[sel]
            bt, bp, bi = best_t[lanes], best_prim[lanes], best_inst[lanes]
            cnt, r0 = count[sel], row[sel]
            for k in range(int(cnt.max())):
                valid = k < cnt
                pr = prim_idx[torch.where(valid, r0 + k, 0)]
                hit, t, _, _ = isx.tri_intersect(geom.tri_packed[pr],
                                                 o[sel], d[sel], bt)
                hit = hit & valid
                if counts is not None:
                    counts["tri"] += int(valid.sum())
                    counts["tri_ids"].append(pr[valid])
                bt = torch.where(hit, t, bt)
                bp = torch.where(hit, pr, bp)
                bi = torch.where(hit, ii[sel], bi)
            best_t[lanes], best_prim[lanes], best_inst[lanes] = bt, bp, bi

        # ---- TLAS leaf: spheres now, mesh roots pushed ----
        sel = torch.nonzero(leaf & (n < tlas_end)).squeeze(1)
        if sel.numel():
            lanes = act[sel]
            bt, bp, bi = best_t[lanes], best_prim[lanes], best_inst[lanes]
            p = sp[lanes]
            cnt, r0 = count[sel], row[sel]
            for k in range(int(cnt.max())):
                valid = k < cnt
                iid = prim_idx[torch.where(valid, r0 + k, 0)]
                kind = geom.inst_kind[iid]
                obj = geom.inst_obj[iid].long()
                is_sph = valid & (kind == INST_SPHERE)
                o_s, d_s = space_ray(geom, iid, ow[sel], dw[sel])
                radius = geom.sph_radius[torch.where(is_sph, obj, 0)]
                hit, t = isx.sphere_intersect(radius, o_s, d_s, bt)
                hit = hit & is_sph
                if counts is not None:
                    counts["sphere"] += int(is_sph.sum())
                bt = torch.where(hit, t, bt)
                bp = torch.where(hit, -1, bp)
                bi = torch.where(hit, iid, bi)
                is_mesh = valid & (kind == INST_MESH)
                root = geom.blas_root[torch.where(is_mesh, obj, 0)].long()
                push = is_mesh & (root >= 0) & (p < stack_depth)
                pl = lanes[push]
                st_n[pl, p[push]] = root[push]
                st_i[pl, p[push]] = iid[push]
                p = p + push.long()
            best_t[lanes], best_prim[lanes], best_inst[lanes] = bt, bp, bi
            sp[lanes] = p

        # ---- inner node: slab-test children, descend near, push far ----
        descend = torch.zeros_like(leaf)
        sel = torch.nonzero(~leaf).squeeze(1)
        if sel.numel():
            lanes = act[sel]
            inv_d, octant = isx.ray_octant_invdir(d[sel])
            sstart = -o[sel] * inv_d
            left = torch.clamp_max(row[sel], M - 1)
            right = torch.clamp_max(left + 1, M - 1)
            if counts is not None:
                counts["inner"] += sel.numel()
                counts["node_ids"] += [left, right]
            bt = best_t[lanes]
            hit_l, t_l = isx.node_intersect(geom.node_bounds[left], inv_d,
                                            sstart, octant, bt)
            hit_r, t_r = isx.node_intersect(geom.node_bounds[right], inv_d,
                                            sstart, octant, bt)
            both = hit_l & hit_r
            swap = both & (t_l > t_r)
            near = torch.where(swap, right, left)
            far = torch.where(swap, left, right)
            only = torch.where(hit_l, left, right)
            p = sp[lanes]
            both = both & (p < stack_depth)  # overflow-safe push
            st_n[lanes[both], p[both]] = far[both]
            st_i[lanes[both], p[both]] = ii[sel][both]
            sp[lanes] = p + both.long()
            dsc = both | (hit_l ^ hit_r)
            node[lanes[dsc]] = torch.where(both, near, only)[dsc]
            descend[sel] = dsc

        # ---- everything that did not descend pops, or finishes ----
        pop = act[~descend]
        p = sp[pop]
        can = p > 0
        pl, slot = pop[can], p[can] - 1
        node[pl] = st_n[pl, slot]
        inst[pl] = st_i[pl, slot]
        sp[pl] = slot
        done = torch.zeros_like(leaf)
        done[torch.nonzero(~descend).squeeze(1)[~can]] = True
        act = act[~done]

    dead = ~(limit > 0.0)
    return Hit(t=torch.where(dead, FLT_MAX, best_t),
               prim=torch.where(dead, -1, best_prim).to(torch.int32),
               inst=torch.where(dead, -1, best_inst).to(torch.int32))


def closest_hit(geom: Geometry, o_w, d_w, limit, tlas_end: int,
                stack_depth: int) -> Hit:
    """Closest hit of each ray (o_w, d_w (B, 3)) under its limit (B,).

    CPU tensors: the plain version. CUDA tensors: the K2 kernel, or an
    error. Returns Hit(t f32, prim i32 (-1 sphere), inst i32 (-1 miss))."""
    if o_w.device.type == "cpu":
        return traverse_plain(geom, o_w, d_w, limit, tlas_end, stack_depth)
    if stack_depth > KERNEL_MAX_STACK:
        raise ValueError(f"scene needs a {stack_depth}-entry stack; the "
                         f"closest-hit kernel holds {KERNEL_MAX_STACK}")
    B = o_w.shape[0]
    check = cuda_build.check_tensor
    check(o_w, "o_w", torch.float32, (B, 3))
    check(d_w, "d_w", torch.float32, (B, 3))
    check(limit, "limit", torch.float32, (B,))
    g = geom
    for name in ("node_bounds", "tri_packed", "inst_Ainv", "inst_offset",
                 "sph_radius"):
        check(getattr(g, name), name, torch.float32)
    for name in ("node_child", "node_count", "prim_idx", "inst_kind",
                 "inst_obj", "blas_root"):
        check(getattr(g, name), name, torch.int32)
    t = torch.empty(B, dtype=torch.float32, device=o_w.device)
    prim = torch.empty(B, dtype=torch.int32, device=o_w.device)
    inst = torch.empty(B, dtype=torch.int32, device=o_w.device)
    fn = cuda_build.function("closest_hit", "craytpu_closest_hit",
                            "pppi" + "p" * 11 + "iii" + "ppp" + "p")
    tables = (g.node_bounds, g.node_child, g.node_count, g.prim_idx,
              g.tri_packed, g.inst_Ainv, g.inst_kind, g.inst_obj,
              g.inst_offset, g.blas_root, g.sph_radius)
    cuda_build.launch(
        "closest_hit", fn, o_w.data_ptr(), d_w.data_ptr(), limit.data_ptr(),
        B, *(x.data_ptr() for x in tables), int(tlas_end),
        int(g.node_bounds.shape[0]), int(stack_depth), t.data_ptr(),
        prim.data_ptr(), inst.data_ptr(),
        torch.cuda.current_stream(o_w.device).cuda_stream)
    closest_hit.launches += 1
    return Hit(t=t, prim=prim, inst=inst)


closest_hit.launches = 0
