"""SceneHost -> device tensors + compiled shading programs.

Flattens all per-mesh BVHs and the TLAS into unified global node arrays
(node ids: [0, tlas_end) = TLAS, then each BLAS block), packs triangles,
instances and spheres, builds the global material table, dedups material
node graphs (the hash-consing analogue), prepares the ShadeParams tables
and the denormalized hit-record rows (tri_wide, inst_wide) that the
hit-record kernel gathers from, and the light table next-event
estimation samples. The closest-hit kernels' own tables
(`CompiledScene.layout`, `CompiledScene.dense`) are built from the
geometry at first use.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import cached_property
from typing import Any

import numpy as np
import torch

from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import shading
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops.camera import CameraHost, make_camera_ray_fn
from craytpu_torch.ops.hitrec import build_wide_rows
from craytpu_torch.scene.device import (Geometry, LightTable, ShadeGeom,
                                        INST_MESH, INST_SPHERE)
from craytpu_torch.scene.types import Prefs, SceneHost
from craytpu_torch.utils import trace
from craytpu_torch.utils.torchsetup import resolve_device

F = np.float32
I = np.int32


@dataclass
class CompiledScene:
    geom: Geometry
    shade: ShadeGeom
    params: shading.ShadeParams
    mat_graph: torch.Tensor       # (K,) i32 material -> graph id
    graphs: list                  # unique bsdf IRs (static)
    bg_ir: Any
    reg: shading.Registry
    camera: CameraHost
    prefs: Prefs
    tlas_end: int
    stack_depth: int
    n_instances: int
    max_leaf_tris: int
    max_leaf_inst: int
    tri_wide: torch.Tensor        # (P, 32) f32 hit-record triangle rows
    inst_wide: torch.Tensor       # (I, 28) f32 hit-record instance rows
    sphere_uv: bool               # does any sphere material read uv?
    device: torch.device
    # next-event estimation (ops/nee.py): the emitters it samples (None if
    # none), the materials the table covers (K,) bool, the NEE-eligible
    # (opaque diffuse) materials (K,) bool, and graph id -> the color IR of
    # each diffuse graph (its albedo)
    lights: LightTable | None
    lights_mat_mask: torch.Tensor
    mat_nee: torch.Tensor
    diffuse_color_ir: dict

    @cached_property
    def layout(self) -> trv.KernelLayout:
        """The closest-hit kernel's tables, built from `geom` on the
        scene's device at first use, once per scene."""
        return trv.build_layout(self.geom, self.tlas_end)

    @cached_property
    def dense(self) -> dx.DenseLayout:
        """The dense search's tables (CRAYTPU_TRAVERSAL=dense): the
        (P, 16) coefficient rows, each mesh's row range and the instance
        order, built from `geom` on the scene's device at first use."""
        return dx.build_dense(self.geom, self.n_instances)

    def bsdf_fns(self, kind: str):
        return [shading.compile_bsdf(g, self.reg, kind) for g in self.graphs]

    def background_fn(self):
        return shading.compile_background(self.bg_ir, self.reg)

    def camera_fn(self, kind: str):
        return make_camera_ray_fn(self.camera, kind, self.device)


def _cross_fms(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """vecCross with the reference BINARY's rounding: the contracted
    build computes cross_i = fma(a_j, b_k, -(a_k*b_j)) — one f32-rounded
    product, one fused one. Emulated via f64 (product exact in f64; the
    final f64->f32 round matches a true fma except ~2^-29-probability
    double-rounding ties). Device-side analogue: vecmath.vcross."""
    def fms(x, y, c):
        return (x.astype(np.float64) * y.astype(np.float64)
                - c.astype(np.float64)).astype(F)
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    return np.stack([
        fms(ay, bz, (az * by).astype(F)),
        fms(az, bx, (ax * bz).astype(F)),
        fms(ax, by, (ay * bx).astype(F)),
    ], axis=1)


def _mat34(A: np.ndarray) -> np.ndarray:
    return A[:3, :4].astype(F)


_CONST_KINDS = ("const_color", "const_value", "const_vec")


def _skeleton(ir):
    """IR with constant-node VALUES stripped (structure key)."""
    if isinstance(ir, tuple):
        if len(ir) and ir[0] in _CONST_KINDS:
            return (ir[0],)
        return tuple(_skeleton(x) for x in ir)
    return ir


def _build_structures(irs: list, K: int, reg) -> tuple:
    """Group materials by graph structure; emit param-indirected IRs.

    Returns (structures, mat_graph (K,) i32). Singleton groups keep their
    concrete IR (no indirection cost)."""
    from craytpu_torch.scene.nodegraph import warning_bsdf
    irs = [ir if ir is not None else warning_bsdf() for ir in irs]
    groups: dict = {}
    for k, ir in enumerate(irs):
        groups.setdefault(_skeleton(ir), []).append(k)

    Kp = max(K, 1)
    param_kind = {"const_color": ("param_color", reg.color_idx),
                  "const_value": ("param_value", reg.value_idx),
                  "const_vec": ("param_vec", reg.vec_idx)}

    def xform(subs: list, members: list):
        head = subs[0]
        if isinstance(head, tuple):
            if len(head) and head[0] in _CONST_KINDS:
                pk, register = param_kind[head[0]]
                tbl = np.zeros(Kp, np.int32)
                for m_k, s in zip(members, subs):
                    tbl[m_k] = register(s[1])
                return (pk, tbl)
            return tuple(
                xform([s[i] for s in subs], members)
                if isinstance(head[i], tuple) else head[i]
                for i in range(len(head)))
        return head

    structures = []
    mat_graph = np.zeros(Kp, np.int32)
    for sk, members in groups.items():
        gi = len(structures)
        if len(members) == 1:
            structures.append(irs[members[0]])
        else:
            structures.append(xform([irs[k] for k in members], members))
        for m_k in members:
            mat_graph[m_k] = gi
    return structures, mat_graph


def _reads_uv(ir) -> bool:
    """Does a material graph read uv (checker/image nodes)?"""
    if isinstance(ir, tuple):
        if len(ir) and ir[0] in ("image", "checker"):
            return True
        return any(_reads_uv(x) for x in ir)
    return False


def _light_table(scene, materials, emission, sphere_mat_ids, inst_A,
                 sph_radius, tri_packed, tri_base, tri_mat):
    """The NEE light table (host numpy; craytpu/scene/compile.py:409-491):
    every world-space entity whose legacy material emission is non-zero,
    matching what pathtrace.c:44 adds along BSDF paths. Returns (arrays
    "lights.<field>" with L rows, lights_mat_mask (K,) bool)."""
    lt_kind, lt_mat, lt_p0, lt_e1, lt_e2, lt_n, lt_area = \
        [], [], [], [], [], [], []
    # materials whose emissive instance the table cannot sample (a
    # non-uniformly scaled sphere is an ellipsoid under the reference's
    # transformed-ray semantics; uniform-area sphere sampling would bias
    # it). ALL lights of such a material are dropped, and the integrator's
    # post-NEE emission suppression skips them via lights_mat_mask.
    excluded_mats: set = set()
    for i, inst in enumerate(scene.instances):
        A4 = inst_A[i]
        if inst.kind == INST_SPHERE:
            m = sphere_mat_ids[inst.obj_index]
            if np.any(emission[m][:3] != 0.0):
                M = np.asarray(A4[:, :3], np.float64)
                MtM = M.T @ M
                s2 = float(np.trace(MtM)) / 3.0
                if not np.allclose(MtM, s2 * np.eye(3),
                                   rtol=1e-4, atol=1e-6 * max(s2, 1.0)):
                    excluded_mats.add(int(m))
                    continue
                c = A4[:, 3]
                rw = float(sph_radius[inst.obj_index]
                           * np.linalg.norm(A4[:, 0]))
                lt_kind.append(1)
                lt_mat.append(m)
                lt_p0.append(c)
                lt_e1.append([rw, 0, 0])
                lt_e2.append([0, 0, 0])
                lt_n.append([0, 0, 1])
                lt_area.append(4.0 * np.pi * rw * rw)
        elif inst.kind == INST_MESH:
            mi = inst.obj_index
            n = scene.meshes[mi].tri_vidx.shape[0] if \
                scene.meshes[mi].tri_vidx is not None else 0
            if n == 0:
                continue
            t0 = tri_base[mi]
            tm = tri_mat[t0:t0 + n]
            em = np.any(emission[tm][:, :3] != 0.0, axis=1)
            if not em.any():
                continue
            rows = tri_packed[t0:t0 + n][em]
            v0 = rows[:, 0:3]
            v1 = v0 - rows[:, 3:6]
            v2 = rows[:, 6:9] + v0
            R, T = A4[:, :3], A4[:, 3]
            w0 = v0 @ R.T + T
            w1 = v1 @ R.T + T
            w2 = v2 @ R.T + T
            e1w = w1 - w0
            e2w = w2 - w0
            cr = np.cross(e1w, e2w)
            ar = 0.5 * np.linalg.norm(cr, axis=1)
            nrm = cr / np.maximum(np.linalg.norm(cr, axis=1,
                                                 keepdims=True), 1e-20)
            for j in range(rows.shape[0]):
                if ar[j] <= 0:
                    continue
                lt_kind.append(0)
                lt_mat.append(int(tm[em][j]))
                lt_p0.append(w0[j])
                lt_e1.append(e1w[j])
                lt_e2.append(e2w[j])
                lt_n.append(nrm[j])
                lt_area.append(float(ar[j]))
    keep = [j for j in range(len(lt_kind))
            if int(lt_mat[j]) not in excluded_mats]
    # the materials the table covers: the post-NEE emission suppression
    # must only suppress THESE; an emitter absent from the table gets its
    # direct light via BSDF paths instead
    lights_mat_mask = np.zeros(max(len(materials), 1), bool)
    for j in keep:
        lights_mat_mask[int(lt_mat[j])] = True

    def col(v, dtype, width=None):
        shape = (len(keep),) if width is None else (len(keep), width)
        return np.asarray([v[j] for j in keep], dtype).reshape(shape)

    lights = {"lights.kind": col(lt_kind, I), "lights.mat": col(lt_mat, I),
              "lights.p0": col(lt_p0, F, 3), "lights.e1": col(lt_e1, F, 3),
              "lights.e2": col(lt_e2, F, 3), "lights.n": col(lt_n, F, 3),
              "lights.area": col(lt_area, F)}
    return lights, lights_mat_mask


def _nee_unwrap(ir):
    """(color IR, opaque) of a NEE-eligible material graph: a plain diffuse
    lobe, or the loader's opaque alpha wrapper mix(transparent, diffuse,
    alpha(const a=1)) (nodegraph.append_alpha / material.c:58-65), whose
    transparent branch has probability 0 at a=1. (None, None) otherwise."""
    if not isinstance(ir, tuple) or not ir:
        return None, None
    if ir[0] == "diffuse":
        return ir[1], True
    if (ir[0] == "mix" and len(ir) == 4 and isinstance(ir[1], tuple)
            and ir[1] and ir[1][0] == "transparent"
            and isinstance(ir[2], tuple) and ir[2]
            and ir[2][0] == "diffuse"):
        fac = ir[3]
        opaque = (isinstance(fac, tuple) and len(fac) == 2
                  and fac[0] == "alpha"
                  and isinstance(fac[1], tuple)
                  and fac[1][0] == "const_color"
                  and float(fac[1][1][3]) == 1.0)
        return ir[2][1], opaque
    return None, None


@trace.setup("scene.compile")
def compile_scene(scene: SceneHost, device=None) -> CompiledScene:
    """Compile a loaded scene onto `device` (CUDA unless given)."""
    device = resolve_device(device)
    # ---- global material table: mesh materials (mesh order) then spheres
    materials = []
    mesh_mat_base = []
    for mesh in scene.meshes:
        mesh_mat_base.append(len(materials))
        materials.extend(mesh.materials)
    sphere_mat_ids = []
    for sph in scene.spheres:
        sphere_mat_ids.append(len(materials))
        materials.append(sph.material)

    emission = np.zeros((max(len(materials), 1), 4), F)
    ior = np.ones(max(len(materials), 1), F)
    for k, m in enumerate(materials):
        emission[k] = m.emission
        ior[k] = m.ior

    # ---- triangles (global order: mesh order)
    tri_base = []
    total_tris = sum(m.tri_vidx.shape[0] for m in scene.meshes)
    P = max(total_tris, 1)
    tri_packed = np.zeros((P, 12), F)
    tri_nidx = np.zeros((P, 3), I)
    tri_uvidx = np.zeros((P, 3), I)
    tri_has_n = np.zeros(P, bool)
    tri_uv_ok = np.zeros(P, bool)
    tri_mat = np.zeros(P, I)
    pos = 0
    verts = scene.vertices if scene.vertices is not None else np.zeros((1, 3), F)
    for mi, mesh in enumerate(scene.meshes):
        n = mesh.tri_vidx.shape[0]
        tri_base.append(pos)
        if n == 0:
            continue
        v0 = verts[mesh.tri_vidx[:, 0]].astype(F)
        v1 = verts[mesh.tri_vidx[:, 1]].astype(F)
        v2 = verts[mesh.tri_vidx[:, 2]].astype(F)
        e1 = v0 - v1  # poly.c:20
        e2 = v2 - v0  # poly.c:21
        nrm = _cross_fms(e1, e2)
        tri_packed[pos:pos + n] = np.concatenate([v0, e1, e2, nrm], axis=1)
        tri_nidx[pos:pos + n] = np.maximum(mesh.tri_nidx, 0)
        tri_uvidx[pos:pos + n] = np.maximum(mesh.tri_uvidx, 0)
        tri_has_n[pos:pos + n] = mesh.tri_has_n
        tri_uv_ok[pos:pos + n] = ((mesh.texcoord_count > 0)
                                  & (mesh.tri_uvidx[:, 0] != -1))
        tri_mat[pos:pos + n] = mesh_mat_base[mi] + mesh.tri_mat
        pos += n

    # ---- unified node arrays: TLAS first, then each BLAS
    tlas = scene.tlas
    node_blocks_b = [tlas.bounds]
    node_blocks_c = [tlas.child.copy()]
    node_blocks_n = [tlas.count.copy()]
    prim_blocks = [tlas.prim_indices.copy()]  # instance ids
    node_off = tlas.node_count
    prim_off = tlas.prim_indices.shape[0]
    blas_root = np.full(max(len(scene.meshes), 1), -1, I)
    max_blas_depth = 0
    for mi, mesh in enumerate(scene.meshes):
        b = mesh.bvh
        if b.node_count == 0:
            continue
        blas_root[mi] = node_off
        child = b.child.copy()
        inner = b.count == 0
        child[inner] += node_off
        child[~inner] += prim_off
        node_blocks_b.append(b.bounds)
        node_blocks_c.append(child)
        node_blocks_n.append(b.count)
        prim_blocks.append(b.prim_indices + tri_base[mi])
        node_off += b.node_count
        prim_off += b.prim_indices.shape[0]
        max_blas_depth = max(max_blas_depth, b.max_depth())

    node_bounds = np.concatenate(node_blocks_b) if node_off else \
        np.zeros((1, 6), F)
    node_child = np.concatenate(node_blocks_c).astype(I) if node_off else \
        np.zeros(1, I)
    node_count = np.concatenate(node_blocks_n).astype(I) if node_off else \
        np.zeros(1, I)
    prim_idx = (np.concatenate(prim_blocks).astype(I) if prim_off
                else np.zeros(1, I))

    # ---- instances
    n_inst = len(scene.instances)
    Imax = max(n_inst, 1)
    inst_A = np.zeros((Imax, 3, 4), F)
    inst_Ainv = np.zeros((Imax, 3, 4), F)
    inst_kind = np.zeros(Imax, I)
    inst_obj = np.zeros(Imax, I)
    inst_offset = np.zeros(Imax, F)
    inst_density = np.zeros(Imax, F)
    for i, inst in enumerate(scene.instances):
        inst_A[i] = _mat34(inst.transform.A)
        inst_Ainv[i] = _mat34(inst.transform.Ainv)
        inst_kind[i] = inst.kind
        inst_obj[i] = inst.obj_index
        inst_density[i] = inst.density
        if inst.kind == INST_MESH:
            inst_offset[i] = scene.meshes[inst.obj_index].ray_offset
        elif inst.kind == INST_SPHERE:
            inst_offset[i] = scene.spheres[inst.obj_index].ray_offset

    # ---- spheres
    S = max(len(scene.spheres), 1)
    sph_radius = np.full(S, 10.0, F)
    sph_mat = np.zeros(S, I)
    for si, sph in enumerate(scene.spheres):
        sph_radius[si] = sph.radius
        sph_mat[si] = sphere_mat_ids[si]

    normals = scene.normals if scene.normals is not None and \
        scene.normals.shape[0] else np.zeros((1, 3), F)
    uvs = scene.uvs if scene.uvs is not None and scene.uvs.shape[0] else \
        np.zeros((1, 2), F)
    nidx = np.minimum(tri_nidx, normals.shape[0] - 1)
    uvidx = np.minimum(tri_uvidx, uvs.shape[0] - 1)
    tri_shade = np.zeros((P, 16), F)
    tri_shade[:, 0:3] = normals[nidx[:, 0]]
    tri_shade[:, 3:6] = normals[nidx[:, 1]]
    tri_shade[:, 6:9] = normals[nidx[:, 2]]
    tri_shade[:, 9:11] = uvs[uvidx[:, 0]]
    tri_shade[:, 11:13] = uvs[uvidx[:, 1]]
    tri_shade[:, 13:15] = uvs[uvidx[:, 2]]
    tri_mf = np.zeros((P, 2), I)
    tri_mf[:, 0] = tri_mat
    tri_mf[:, 1] = tri_has_n.astype(I) | (tri_uv_ok.astype(I) << 1)

    reg = shading.Registry(scene.textures, device)
    # Structure-keyed graph dedup: materials whose bsdf graphs differ only
    # in constant values share ONE compiled structure that reads its
    # constants through mat_id-indexed tables (param_* nodes).
    graphs, mat_graph = _build_structures(
        [m.bsdf_ir for m in materials], len(materials), reg)
    # pre-register all remaining constants by compiling every graph once
    # (indices are deterministic; the real compile happens per sampler kind)
    from craytpu_torch.scene.nodegraph import background as bg_default
    bg_ir = scene.background_ir or bg_default()
    for g in graphs:
        shading.compile_bsdf(g, reg, "random")
    shading.compile_background(bg_ir, reg)
    params = reg.finalize(emission, ior)

    # Worst-case unified stack: every TLAS level can push a far node, every
    # mesh instance can be pending as a BLAS root, and the deepest BLAS path
    # pushes a far node per level. Overflowing pushes are dropped by the
    # walk, but size generously so that never happens in practice.
    n_mesh_inst = sum(1 for x in scene.instances if x.kind == INST_MESH)
    stack_depth = (tlas.max_depth() + max_blas_depth
                   + min(n_mesh_inst, 64) + 8)
    stack_depth = max(stack_depth, 8)

    # static leaf-size caps for the plain walk's masked prim loops
    max_leaf_inst = int(tlas.count.max()) if tlas.node_count else 1
    max_leaf_tris = 1
    for mesh in scene.meshes:
        if mesh.bvh.node_count:
            max_leaf_tris = max(max_leaf_tris, int(mesh.bvh.count.max()))

    sphere_uv = any(_reads_uv(scene.spheres[s].material.bsdf_ir)
                    for s in range(len(scene.spheres)))
    tri_wide, inst_wide = build_wide_rows(
        tri_packed, tri_shade, tri_mf, inst_A, inst_Ainv, inst_offset,
        inst_kind, inst_obj, sph_mat, sph_radius)

    lights, lights_mat_mask = _light_table(
        scene, materials, emission, sphere_mat_ids, inst_A, sph_radius,
        tri_packed, tri_base, tri_mat)
    mat_nee = np.zeros(max(len(materials), 1), bool)
    for k, m in enumerate(materials):
        _, opaque = _nee_unwrap(m.bsdf_ir)
        mat_nee[k] = bool(opaque) and not np.any(emission[k][:3] != 0.0)
    diffuse_color_ir = {}
    for gi, g in enumerate(graphs):
        cir, _ = _nee_unwrap(g)
        if cir is not None:
            diffuse_color_ir[gi] = cir

    arrays = {
        "geom.node_bounds": node_bounds, "geom.node_child": node_child,
        "geom.node_count": node_count, "geom.prim_idx": prim_idx,
        "geom.tri_packed": tri_packed, "geom.inst_A": inst_A,
        "geom.inst_Ainv": inst_Ainv, "geom.inst_kind": inst_kind,
        "geom.inst_obj": inst_obj, "geom.inst_offset": inst_offset,
        "geom.inst_density": inst_density, "geom.blas_root": blas_root,
        "geom.sph_radius": sph_radius,
        "shade.tri_shade": tri_shade, "shade.tri_mf": tri_mf,
        "shade.sph_mat": sph_mat,
        "mat_graph": mat_graph, "tri_wide": tri_wide, "inst_wide": inst_wide,
        "graphs": graphs, "bg_ir": bg_ir, "camera": scene.camera,
        "prefs": scene.prefs, "tlas_end": int(tlas.node_count),
        "stack_depth": int(stack_depth), "n_instances": n_inst,
        "max_leaf_tris": max_leaf_tris, "max_leaf_inst": max_leaf_inst,
        "sphere_uv": bool(sphere_uv), **lights,
        "lights_mat_mask": lights_mat_mask, "mat_nee": mat_nee,
        "diffuse_color_ir": diffuse_color_ir,
    }
    return _assemble(arrays, params, reg, device)


_STATIC = ("graphs", "bg_ir", "camera", "prefs", "tlas_end", "stack_depth",
           "n_instances", "max_leaf_tris", "max_leaf_inst", "sphere_uv",
           "diffuse_color_ir")


def _assemble(arrays: dict, params, reg, device) -> CompiledScene:
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    def group(cls, prefix):
        return cls(*(t(arrays[f"{prefix}.{f.name}"]) for f in fields(cls)))

    lights = group(LightTable, "lights")
    return CompiledScene(
        geom=group(Geometry, "geom"), shade=group(ShadeGeom, "shade"),
        params=params, mat_graph=t(arrays["mat_graph"]), reg=reg,
        tri_wide=t(arrays["tri_wide"]), inst_wide=t(arrays["inst_wide"]),
        device=device, lights=lights if lights.count else None,
        lights_mat_mask=t(arrays["lights_mat_mask"]),
        mat_nee=t(arrays["mat_nee"]), **{k: arrays[k] for k in _STATIC})


def scene_arrays(cs: CompiledScene) -> dict:
    """numpy copies of a compiled scene's tensors plus its static fields
    and registry keys: the input scene_from_arrays takes."""
    out = {f"geom.{k}": v for k, v in cs.geom.numpy().items()}
    out.update({f"shade.{k}": v for k, v in cs.shade.numpy().items()})
    lights = cs.lights.numpy() if cs.lights is not None else {
        f.name: np.zeros((0,) + ((3,) if f.name in ("p0", "e1", "e2", "n")
                                 else ()),
                         I if f.name in ("kind", "mat") else F)
        for f in fields(LightTable)}
    out.update({f"lights.{k}": v for k, v in lights.items()})
    out.update({f"params.{f.name}": getattr(cs.params, f.name).cpu().numpy()
                for f in fields(cs.params)})
    out.update(mat_graph=cs.mat_graph.cpu().numpy(),
               lights_mat_mask=cs.lights_mat_mask.cpu().numpy(),
               mat_nee=cs.mat_nee.cpu().numpy(),
               tri_wide=cs.tri_wide.cpu().numpy(),
               inst_wide=cs.inst_wide.cpu().numpy(), reg=cs.reg.keys())
    out.update({k: getattr(cs, k) for k in _STATIC})
    return out


def scene_from_arrays(arrays: dict, device=None) -> CompiledScene:
    """Build the port's compiled scene from numpy arrays and static fields,
    e.g. copies of another compile of the same scene (the JAX package's
    CompiledScene), so both packages run on identical data. Keys: as
    scene_arrays returns them ("geom.<field>", "shade.<field>",
    "params.<field>", "lights.<field>" (zero rows when the scene has no
    light), mat_graph, tri_wide, inst_wide, lights_mat_mask, mat_nee, the
    static fields, and "reg": the registry's constant keys in slot
    order)."""
    device = resolve_device(device)
    k = arrays["reg"]
    reg = shading.Registry.from_keys(k["colors"], k["values"], k["vecs"],
                                     k["tex_meta"], device)
    params = shading.ShadeParams(*(
        torch.as_tensor(np.array(arrays[f"params.{f.name}"]), device=device)
        for f in fields(shading.ShadeParams)))
    return _assemble(arrays, params, reg, device)
