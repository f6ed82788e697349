"""Wavefront OBJ loader (host).

Mirrors utils/loaders/formats/wavefront/wavefront.c: single mesh per file,
v/vt/vn/f statements, quads fanned into two triangles ((1,2,3),(1,3,4)),
0/negative/1-based index fixup, usemtl/mtllib handling, and appending to the
GLOBAL SoA vertex buffers with per-mesh base offsets (vertexbuffer.c). Bug
compatibility preserved: a face with no normal index still gets
has_normals=True when earlier meshes contributed normals (global base > 0,
wavefront.c:120-126 + poly hasNormals check).
"""

from __future__ import annotations

import os

import numpy as np

from craytpu_torch.scene import mtl as mtl_mod
from craytpu_torch.scene.types import MeshHost, warning_material
from craytpu_torch.utils import logging

F = np.float32


class GlobalBuffers:
    """The process-global g_vertices/g_normals/g_textureCoords analogue."""

    def __init__(self):
        self.vertices: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.vertex_count = 0
        self.normal_count = 0
        self.uv_count = 0

    def arrays(self):
        v = (np.concatenate(self.vertices) if self.vertices
             else np.zeros((0, 3), F))
        n = (np.concatenate(self.normals) if self.normals
             else np.zeros((0, 3), F))
        t = (np.concatenate(self.uvs) if self.uvs else np.zeros((0, 2), F))
        return v.astype(F), n.astype(F), t.astype(F)


def _fix_index(total: int, old: int) -> int:
    """fixIndex (wavefront.c:110-118)."""
    if old == 0:
        return -1
    if old < 0:
        return total + old
    return old - 1


def _parse_face_token(tok: str):
    """v[/vt[/vn]] -> (v, vt, vn) raw ints (0 = missing, like atoi(""))."""
    parts = tok.split("/")
    v = int(parts[0]) if parts[0] else 0
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, vt, vn


def parse_wavefront(file_path: str, buffers: GlobalBuffers,
                    texture_loader=None) -> MeshHost:
    """parseWavefront (wavefront.c:128-269). Returns a single MeshHost."""
    from craytpu_torch.utils.fileio import load_file
    text = load_file(file_path, text=True)
    asset_path = os.path.dirname(file_path)
    if asset_path:
        asset_path += "/"

    verts, uvs, norms = [], [], []
    faces = []  # (3 x (v, vt, vn), material_index)
    materials = None
    current_material = 0
    name = ""

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        key = toks[0]
        if key in ("o", "g"):
            name = toks[1] if len(toks) > 1 else name
        elif key == "v":
            verts.append((float(toks[1]), float(toks[2]), float(toks[3])))
        elif key == "vt":
            uvs.append((float(toks[1]), float(toks[2])))
        elif key == "vn":
            norms.append((float(toks[1]), float(toks[2]), float(toks[3])))
        elif key == "f":
            corners = [_parse_face_token(t) for t in toks[1:]]
            if len(corners) > 4:
                raise AssertionError(
                    f"ngon in {file_path}; reference asserts on these too "
                    "(wavefront.c:90)")
            tris = [corners[:3]]
            if len(corners) == 4:
                tris.append([corners[0], corners[2], corners[3]])
            for tri in tris:
                faces.append((tri, current_material))
        elif key == "usemtl":
            current_material = 0
            if materials:
                for i, m in enumerate(materials):
                    if m.name == toks[1]:
                        current_material = i
                        break
        elif key == "mtllib":
            mtl_path = asset_path + toks[1]
            materials = mtl_mod.parse_mtl(mtl_path, texture_loader)
        else:
            logging.debug("Unknown OBJ statement %r in %s", key, file_path)

    file_vertices = len(verts)
    file_uvs = len(uvs)
    file_normals = len(norms)
    vbase = buffers.vertex_count
    nbase = buffers.normal_count
    tbase = buffers.uv_count

    P = len(faces)
    tri_vidx = np.zeros((P, 3), np.int32)
    tri_nidx = np.zeros((P, 3), np.int32)
    tri_uvidx = np.zeros((P, 3), np.int32)
    tri_mat = np.zeros(P, np.int32)
    tri_has_n = np.zeros(P, bool)
    for p, (tri, mat_idx) in enumerate(faces):
        for j, (v, vt, vn) in enumerate(tri):
            # fixIndices (wavefront.c:120-126): global base + local fixup
            tri_vidx[p, j] = vbase + _fix_index(file_vertices, v)
            tri_uvidx[p, j] = tbase + _fix_index(file_uvs, vt)
            tri_nidx[p, j] = nbase + _fix_index(file_normals, vn)
        tri_mat[p] = mat_idx
        tri_has_n[p] = tri_nidx[p, 0] != -1

    buffers.vertices.append(np.asarray(verts, F).reshape(file_vertices, 3))
    buffers.normals.append(np.asarray(norms, F).reshape(file_normals, 3))
    buffers.uvs.append(np.asarray(uvs, F).reshape(file_uvs, 2))
    buffers.vertex_count += file_vertices
    buffers.normal_count += file_normals
    buffers.uv_count += file_uvs

    if materials is None:
        materials = [warning_material()]  # wavefront.c:246-252

    return MeshHost(name=name or os.path.basename(file_path),
                    tri_vidx=tri_vidx, tri_nidx=tri_nidx,
                    tri_uvidx=tri_uvidx, tri_mat=tri_mat, tri_has_n=tri_has_n,
                    materials=materials, texcoord_count=file_uvs)
