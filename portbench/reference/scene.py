"""The reference's scene: a c-ray JSON buffer and its OBJ/MTL files ->
the tables the reference traces against.

Worked out again from the buffer alone, with c-ray's host arithmetic
(float32 numpy, frozen here from the port's host code): transform
composites and their adjoint inverses (datatypes/transforms.c), triangle
rows v0, e1 = v0 - v1, e2 = v2 - v0 and the face normal with the
binary's fused cross product (poly.c:20-22), per-instance ray offsets
from the instanced mesh's bounding box (instance.c:222-230), the
material table (mesh materials in mesh order, then spheres), and the
camera (camera.c:22-42). No BVH: walk.py builds its own from these
tables.

Covered: lambertian and emissive legacy materials (OBJ/MTL `Kd`, `Ke`;
sphere `color`, `intensity`), triangle and quad faces with or without
vertex normals, translate / rotateX / rotateY / rotateZ / scale /
scaleUniform transforms, a pinhole camera and a gradient sky. Anything
else raises NotImplementedError rather than being traced wrongly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

F = np.float32


# ---- transforms (row-major 4x4, float32) ------------------------------------

def _to_radians(deg):
    return F(F(deg) * F(np.pi)) / F(180.0)


def _det3(m):
    m = m.astype(F)
    return F(m[0, 0] * F(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
             - m[0, 1] * F(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
             + m[0, 2] * F(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))


def _det4(m):
    m = m.astype(F)

    def d2(a, b, c, d):
        return F(a * d - b * c)
    tl = m[0, 0] * (m[1, 1] * d2(m[2, 2], m[2, 3], m[3, 2], m[3, 3])
                    - m[1, 2] * d2(m[2, 1], m[2, 3], m[3, 1], m[3, 3])
                    + m[1, 3] * d2(m[2, 1], m[2, 2], m[3, 1], m[3, 2]))
    tr = m[0, 1] * (m[1, 0] * d2(m[2, 2], m[2, 3], m[3, 2], m[3, 3])
                    - m[1, 2] * d2(m[2, 0], m[2, 3], m[3, 0], m[3, 3])
                    + m[1, 3] * d2(m[2, 0], m[2, 2], m[3, 0], m[3, 2]))
    bl = m[0, 2] * (m[1, 0] * d2(m[2, 1], m[2, 3], m[3, 1], m[3, 3])
                    - m[1, 1] * d2(m[2, 0], m[2, 3], m[3, 0], m[3, 3])
                    + m[1, 3] * d2(m[2, 0], m[2, 1], m[3, 0], m[3, 1]))
    br = m[0, 3] * (m[1, 0] * d2(m[2, 1], m[2, 2], m[3, 1], m[3, 2])
                    - m[1, 1] * d2(m[2, 0], m[2, 2], m[3, 0], m[3, 2])
                    + m[1, 2] * d2(m[2, 0], m[2, 1], m[3, 0], m[3, 1]))
    return F(tl - tr + bl - br)


def _inverse(A):
    A = A.astype(F)
    det = _det4(A)
    if det <= 0.0:
        raise ValueError("transform has no inverse (det <= 0)")
    cof = np.zeros((4, 4), F)
    for i in range(4):
        for j in range(4):
            minor = np.delete(np.delete(A, i, axis=0), j, axis=1)
            cof[i, j] = (F(1.0) if (i + j) % 2 == 0 else F(-1.0)) \
                * _det3(minor)
    return (cof / det).astype(F).T.copy()


def _one_transform(t: dict):
    """(kind, 4x4 matrix) of one JSON transform."""
    kind = t["type"]
    A = np.eye(4, dtype=F)
    if kind in ("rotateX", "rotateY", "rotateZ"):
        rad = _to_radians(t["degrees"]) if "degrees" in t else t["radians"]
        c, s = F(np.cos(F(rad))), F(np.sin(F(rad)))
        i, j = {"rotateX": (1, 2), "rotateY": (2, 0),
                "rotateZ": (0, 1)}[kind]
        A[i, i], A[j, j] = c, c
        A[i, j], A[j, i] = -s, s
        return "rotate", A
    if kind == "translate":
        A[:3, 3] = [F(t.get(k, 0.0)) for k in ("x", "y", "z")]
        return "translate", A
    if kind in ("scale", "scaleUniform"):
        v = ([t["scale"]] * 3 if kind == "scaleUniform"
             else [t.get(k, 1.0) for k in ("x", "y", "z")])
        for i in range(3):
            A[i, i] = F(v[i])
        return "scale", A
    raise NotImplementedError(f"transform {kind!r}")


def composite(transforms) -> np.ndarray:
    """parseTransformComposite: every translate, then every rotation,
    then every scale, each group in listed order."""
    parts = [_one_transform(t) for t in transforms or []]
    A = np.eye(4, dtype=F)
    for group in ("translate", "rotate", "scale"):
        for kind, M in parts:
            if kind == group:
                A = (A.astype(F) @ M.astype(F)).astype(F)
    return A


def _bbox(bmin, bmax, A):
    """transformBBox: the absolute-matrix box of a transformed box."""
    absA = np.abs(A[:3, :3]).astype(F)
    center = ((bmin + bmax) * F(0.5)).astype(F)
    half = ((bmax - bmin) * F(0.5)).astype(F)
    new_half = (absA @ half).astype(F)
    new_center = (A[:3, :3] @ center + A[:3, 3]).astype(F)
    return (new_center - new_half).astype(F), (new_center + new_half).astype(F)


def _ray_offset(bmin, bmax):
    e = (bmax - bmin).astype(F)
    return F(F(1e-4) * np.sqrt(np.dot(e, e)))


# ---- OBJ / MTL ---------------------------------------------------------------

def _color(values, alpha=1.0):
    v = [float(x) for x in values]
    return tuple(v[:3]) + (float(v[3]) if len(v) > 3 else alpha,)


def _read_mtl(path: str) -> list:
    mats = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            if toks[0] == "newmtl":
                mats.append({"name": toks[1] if len(toks) > 1 else "",
                             "diffuse": (0.0, 0.0, 0.0, 0.0),
                             "emission": (0.0, 0.0, 0.0, 0.0)})
            elif toks[0] == "Kd" and mats:
                mats[-1]["diffuse"] = _color(toks[1:4])
            elif toks[0] == "Ke" and mats:
                mats[-1]["emission"] = _color(toks[1:4])
            elif toks[0] in ("map_Kd", "map_Ns", "norm") or (
                    toks[0] == "illum" and int(toks[1]) in (5, 7)):
                raise NotImplementedError(f"MTL statement {toks[0]!r}")
    return mats


def _fix(total: int, i: int) -> int:
    return -1 if i == 0 else (total + i if i < 0 else i - 1)


def read_obj(path: str) -> dict:
    """One OBJ file: its vertices, normals and triangles (quads split as
    c-ray splits them), with each triangle's material index."""
    verts, norms, faces, mats = [], [], [], []
    n_uv = 0
    cur = 0
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            key = toks[0]
            if key == "v":
                verts.append(toks[1:4])
            elif key == "vn":
                norms.append(toks[1:4])
            elif key == "vt":
                n_uv += 1
            elif key == "f":
                c = []
                for tok in toks[1:]:
                    p = tok.split("/")
                    c.append((int(p[0]) if p[0] else 0,
                              int(p[2]) if len(p) > 2 and p[2] else 0))
                if len(c) > 4:
                    raise NotImplementedError("n-gon face")
                faces.append((c[0], c[1], c[2], cur))
                if len(c) == 4:
                    faces.append((c[0], c[2], c[3], cur))
            elif key == "mtllib":
                mats = _read_mtl(os.path.join(os.path.dirname(path), toks[1]))
            elif key == "usemtl":
                cur = next((i for i, m in enumerate(mats)
                            if m["name"] == toks[1]), 0)
    nv, nn = len(verts), len(norms)
    vidx = np.array([[_fix(nv, c[0]) for c in fc[:3]] for fc in faces],
                    np.int64).reshape(-1, 3)
    nidx = np.array([[_fix(nn, c[1]) for c in fc[:3]] for fc in faces],
                    np.int64).reshape(-1, 3)
    return {"v": np.array(verts, np.float64).astype(F).reshape(nv, 3),
            "n": np.array(norms, np.float64).astype(F).reshape(nn, 3),
            "vidx": vidx, "nidx": nidx,
            "mat": np.array([fc[3] for fc in faces], np.int64),
            "materials": mats or [{"diffuse": (1.0, 0.0, 0.5, 1.0),
                                   "emission": (0.0, 0.0, 0.0, 0.0)}]}


def _cross_fms(a, b):
    """c-ray's fused cross product on the host (through float64)."""
    def fms(x, y, c):
        return (x.astype(np.float64) * y.astype(np.float64)
                - c.astype(np.float64)).astype(F)
    return np.stack([fms(a[:, 1], b[:, 2], (a[:, 2] * b[:, 1]).astype(F)),
                     fms(a[:, 2], b[:, 0], (a[:, 0] * b[:, 2]).astype(F)),
                     fms(a[:, 0], b[:, 1], (a[:, 1] * b[:, 0]).astype(F))],
                    axis=1)


# ---- the scene ---------------------------------------------------------------

@dataclass
class Tables:
    """What the reference traces against, on one device.

    meshes: per mesh (tri_row (T, 12) [v0 e1 e2 n], shade (T, 9) vertex
    normals, has_n (T,) bool, mat (T,) i64 global material ids).
    instances: per instance (kind "mesh" | "sphere", object index, A and
    Ainv (3, 4), ray offset). spheres: (radius, material id).
    Materials: diffuse (K, 4), emission (K, 4)."""
    meshes: list
    instances: list
    spheres: list
    diffuse: torch.Tensor
    emission: torch.Tensor
    sky_down: torch.Tensor
    sky_up: torch.Tensor
    width: int
    height: int
    spp: int
    bounces: int
    camera: dict


def _camera(cam: dict, width: int, height: int, device) -> dict:
    fov = float(cam.get("FOV", 80.0))
    if cam.get("fstops", 0.0):
        raise NotImplementedError("thin-lens camera")
    A = composite(cam.get("transforms"))
    aspect = F(width) / F(height)
    fov_rad = F(F(fov) * F(np.pi)) / F(180.0)
    sensor_x = F(2.0) * F(np.tan(fov_rad / F(2.0)))
    sensor_y = F(sensor_x / aspect)
    t = torch.tensor
    return {"A": t(A[:3, :4], device=device),
            "pix_x": t([1.0, 0.0, 0.0], device=device)
            * float(F(sensor_x) / F(width)),
            "pix_y": t([0.0, 1.0, 0.0], device=device)
            * float(F(sensor_y) / F(height)),
            "forward": t([0.0, 0.0, 1.0], device=device),
            "half_w": float(F(width * 0.5)), "half_h": float(F(height * 0.5))}


def build(scene_text: str, asset_dir: str, device) -> Tables:
    data = json.loads(scene_text)
    r = data["renderer"]
    width, height = int(r["width"]), int(r["height"])
    spp, bounces = max(1, int(r["samples"])), int(r["bounces"])
    sc = data["scene"]
    amb = sc["ambientColor"]
    if "offset" in amb or "hdr" in amb:
        raise NotImplementedError("ambientColor offset or hdr")
    diffuse, emission = [], []
    meshes, mesh_inst, sphere_defs = [], [], []
    if len(sc.get("meshes", [])) > 1:
        # c-ray indexes normals over every mesh's; one mesh is covered
        raise NotImplementedError("more than one mesh")
    for m in sc.get("meshes", []):
        if m.get("bsdf", "lambertian") != "lambertian" or "material" in m:
            raise NotImplementedError("mesh bsdf other than lambertian")
        obj = read_obj(os.path.join(asset_dir, m["fileName"]))
        base = len(diffuse)
        for mat in obj["materials"]:
            diffuse.append(mat["diffuse"])
            emission.append(mat["emission"])
        meshes.append(obj)
        mesh_inst.append([composite(i.get("transforms"))
                          for i in m.get("instances", [])])
        obj["mat_base"] = base
    for p in sc.get("primitives", []):
        if p["type"] != "sphere" or "material" in p:
            raise NotImplementedError("primitive other than a legacy sphere")
        col = _color([p["color"][k] for k in "rgb"], p["color"].get("a", 1.0))
        if p["bsdf"] == "emissive":
            s = float(p.get("intensity", 1.0))
            diffuse_c, emission_c = (0.5, 0.5, 0.5, 1.0), tuple(
                s * c for c in col)
        elif p["bsdf"] == "lambertian":
            diffuse_c, emission_c = col, (0.0, 0.0, 0.0, 0.0)
        else:
            raise NotImplementedError(f"sphere bsdf {p['bsdf']!r}")
        sphere_defs.append((p, diffuse_c, emission_c))
    # spheres' materials follow every mesh material
    spheres = []
    for p, dc, ec in sphere_defs:
        spheres.append((float(F(p["radius"])), len(diffuse)))
        diffuse.append(dc)
        emission.append(ec)

    dev = torch.device(device)
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    mesh_tabs = []
    for obj in meshes:
        v = obj["v"]
        v0, v1, v2 = (v[obj["vidx"][:, j]] for j in range(3))
        e1, e2 = v0 - v1, v2 - v0
        rows = np.concatenate([v0, e1, e2, _cross_fms(e1, e2)], 1)
        has_n = obj["nidx"][:, 0] != -1
        nrm = obj["n"] if len(obj["n"]) else np.zeros((1, 3), F)
        shade = np.concatenate(
            [nrm[np.clip(obj["nidx"][:, j], 0, len(nrm) - 1)]
             for j in range(3)], 1)
        used = v[obj["vidx"].reshape(-1)]
        obj["box"] = (used.min(0).astype(F), used.max(0).astype(F))
        mesh_tabs.append((t(rows.astype(F)), t(shade.astype(F)), t(has_n),
                          t(obj["mat_base"] + obj["mat"])))
    # a mesh's (or sphere's) ray offset is the last instance's, as the
    # accelerator build leaves it
    instances = []
    mesh_off = {}
    for mi, As in enumerate(mesh_inst):
        for A in As:
            mesh_off[mi] = _ray_offset(*_bbox(*meshes[mi]["box"], A))
    sph_inst, sph_off = [], {}
    for si, (p, _, _) in enumerate(sphere_defs):
        rad = F(p["radius"])
        for inst in p.get("instances", []):
            A = composite(inst.get("transforms"))
            sph_inst.append((si, A))
            sph_off[si] = _ray_offset(*_bbox(np.array([-rad] * 3, F),
                                             np.array([rad] * 3, F), A))
    # c-ray's instance order: primitives are parsed before meshes
    for si, A in sph_inst:
        instances.append(("sphere", si, t(A[:3, :4]),
                          t(_inverse(A)[:3, :4]), float(sph_off[si])))
    for mi, As in enumerate(mesh_inst):
        for A in As:
            instances.append(("mesh", mi, t(A[:3, :4]),
                              t(_inverse(A)[:3, :4]), float(mesh_off[mi])))
    sky = {k: t(np.asarray(_color([amb[k][c] for c in "rgb"],
                                  amb[k].get("a", 1.0)), F))
           for k in ("down", "up")}
    return Tables(meshes=mesh_tabs, instances=instances, spheres=spheres,
                  diffuse=t(np.asarray(diffuse, F)),
                  emission=t(np.asarray(emission, F)),
                  sky_down=sky["down"], sky_up=sky["up"], width=width,
                  height=height, spp=spp, bounces=bounces,
                  camera=_camera(data.get("camera", {}), width, height, dev))
