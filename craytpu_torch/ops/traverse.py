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
search (craytpu/ops/flash2.py::_kernel). The kernel reads the scene
through `KernelLayout` tables (`build_layout`), built once per scene from
`Geometry` alone (`CompiledScene.layout`).
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass
class KernelLayout:
    """K2's copy of the scene, laid out for 16-byte loads. Derived from
    `Geometry` alone; the walk it serves is traverse_plain's.

      node_rec (M, 16) f32: for inner node n (node_count <= 0), with
        left = min(node_child[n], M-1) and right = min(left+1, M-1):
        [node_bounds[left] (6), node_bounds[right] (6),
         node_child[left], node_count[left], node_child[right],
         node_count[right]] -- the last four are int32 bits. Leaf rows 0.
      tri_leaf (Q, 12) f32: tri_packed[prim_idx[q]] for every slot q of a
        BLAS leaf (node >= tlas_end), so a leaf's triangles are
        consecutive rows; 0 for TLAS slots (those hold instance ids).
    """
    node_rec: torch.Tensor
    tri_leaf: torch.Tensor


def build_layout(geom: Geometry, tlas_end: int) -> KernelLayout:
    """K2's tables, on the device of `geom`."""
    M = geom.node_bounds.shape[0]
    child = geom.node_child.long()
    count = geom.node_count.long()
    left = torch.clamp_max(child, M - 1)
    right = torch.clamp_max(left + 1, M - 1)
    rec = torch.cat([geom.node_bounds[left], geom.node_bounds[right]], 1)
    words = torch.stack([child[left], count[left], child[right],
                         count[right]], 1).to(torch.int32)
    rec = torch.cat([rec, words.view(torch.float32)], 1)
    rec = torch.where((count <= 0)[:, None], rec, 0.0).contiguous()

    blas_leaf = (count > 0) & (torch.arange(M, device=child.device)
                               >= tlas_end)
    rows, cnts = child[blas_leaf], count[blas_leaf]
    starts = torch.repeat_interleave(rows, cnts)
    first = torch.repeat_interleave(torch.cumsum(cnts, 0) - cnts, cnts)
    slots = starts + torch.arange(starts.shape[0], device=child.device) \
        - first
    tri_leaf = geom.tri_packed.new_zeros((geom.prim_idx.shape[0], 12))
    tri_leaf[slots] = geom.tri_packed[geom.prim_idx[slots].long()]
    return KernelLayout(node_rec=rec, tri_leaf=tri_leaf)


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
                stack_depth: int, layout: KernelLayout | None = None) -> Hit:
    """Closest hit of each ray (o_w, d_w (B, 3)) under its limit (B,).

    CPU tensors: the plain version (`layout` unused). CUDA tensors: the
    K2 kernel, which reads `layout` (build_layout(geom, tlas_end), built
    once per scene), or an error. Returns Hit(t f32, prim i32 (-1
    sphere), inst i32 (-1 miss))."""
    if o_w.device.type == "cpu":
        return traverse_plain(geom, o_w, d_w, limit, tlas_end, stack_depth)
    if stack_depth > KERNEL_MAX_STACK:
        raise ValueError(f"scene needs a {stack_depth}-entry stack; the "
                         f"closest-hit kernel holds {KERNEL_MAX_STACK}")
    if layout is None:
        raise ValueError("the closest-hit kernel needs the scene's "
                         "KernelLayout (build_layout)")
    B = o_w.shape[0]
    M, Q = geom.node_bounds.shape[0], geom.prim_idx.shape[0]
    check = cuda_build.check_tensor
    check(o_w, "o_w", torch.float32, (B, 3))
    check(d_w, "d_w", torch.float32, (B, 3))
    check(limit, "limit", torch.float32, (B,))
    check(layout.node_rec, "node_rec", torch.float32, (M, 16), align=16)
    check(layout.tri_leaf, "tri_leaf", torch.float32, (Q, 12), align=16)
    g = geom
    for name in ("inst_Ainv", "inst_offset", "sph_radius"):
        check(getattr(g, name), name, torch.float32)
    for name in ("node_child", "node_count", "prim_idx", "inst_kind",
                 "inst_obj", "blas_root"):
        check(getattr(g, name), name, torch.int32)
    dev = o_w.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    prim = torch.empty(B, dtype=torch.int32, device=dev)
    inst = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return Hit(t=t, prim=prim, inst=inst)
    fn = cuda_build.function("closest_hit", "craytpu_closest_hit",
                            "pppi" + "p" * 11 + "iii" + "ppp" + "p")
    tables = (layout.node_rec, layout.tri_leaf, g.node_child, g.node_count,
              g.prim_idx, g.inst_Ainv, g.inst_kind, g.inst_obj,
              g.inst_offset, g.blas_root, g.sph_radius)
    cuda_build.launch(
        "closest_hit", fn, o_w.data_ptr(), d_w.data_ptr(), limit.data_ptr(),
        B, *(x.data_ptr() for x in tables), int(tlas_end), M,
        int(stack_depth), t.data_ptr(), prim.data_ptr(), inst.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, size=B)
    closest_hit.launches += 1
    return Hit(t=t, prim=prim, inst=inst)


closest_hit.launches = 0
