"""Device-side scene representation: dataclasses of tensors.

This is the GPU analogue of the reference's pointer-based world
(datatypes/scene.h:14-39 + vertexbuffer globals + per-mesh BVHs): every
per-mesh BVH and the top-level BVH are flattened into single global node
arrays; triangles are packed rows; instances are transform pairs + object
references. Shapes use the suffix convention
  M = total BVH nodes (TLAS first, then each BLAS)
  Q = total prim-index slots, P = triangles, I = instances,
  S = spheres, N = normals, T = texcoords, K = materials.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

# instance kinds (instance.c constructors)
INST_MESH = 0
INST_SPHERE = 1
INST_MESH_VOLUME = 2
INST_SPHERE_VOLUME = 3


class _Tensors:
    """Field-wise helpers shared by the tensor dataclasses."""

    def to(self, device) -> "_Tensors":
        return type(self)(*(getattr(self, f.name).to(device)
                            for f in fields(self)))

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in fields(self)}


@dataclass
class Geometry(_Tensors):
    """Everything the closest-hit walk needs."""
    node_bounds: torch.Tensor   # (M, 6) f32: minx,maxx,miny,maxy,minz,maxz
    node_child: torch.Tensor    # (M,) i32: inner -> global left-child node
    #                                      id; leaf -> row into prim_idx
    node_count: torch.Tensor    # (M,) i32: 0 inner, >0 leaf prim count
    prim_idx: torch.Tensor      # (Q,) i32: TLAS leaf -> instance id;
    #                                      BLAS leaf -> global triangle id
    tri_packed: torch.Tensor    # (P, 12) f32: v0, e1=v0-v1, e2=v2-v0, n
    inst_A: torch.Tensor        # (I, 3, 4) f32 object->world
    inst_Ainv: torch.Tensor     # (I, 3, 4) f32 world->object
    inst_kind: torch.Tensor     # (I,) i32 INST_*
    inst_obj: torch.Tensor      # (I,) i32 mesh or sphere index
    inst_offset: torch.Tensor   # (I,) f32 rayOffset (bbox.h:43-45)
    inst_density: torch.Tensor  # (I,) f32 volume density (0 for solids)
    blas_root: torch.Tensor     # (num_meshes,) i32 global root (-1 empty)
    sph_radius: torch.Tensor    # (S,) f32


@dataclass
class ShadeGeom(_Tensors):
    """Per-triangle shading data, denormalized into one row per triangle:
      tri_shade: [n0(3), n1(3), n2(3), uv0(2), uv1(2), uv2(2), pad]
      tri_mf:    [material id, flags]  flags bit0=has_n, bit1=uv_ok
    """
    tri_shade: torch.Tensor     # (P, 16) f32
    tri_mf: torch.Tensor        # (P, 2) i32
    sph_mat: torch.Tensor       # (S,) i32 global material id


@dataclass
class Hit:
    """Closest-hit result (per ray)."""
    t: torch.Tensor     # f32; distance from the winning instance's
    #                     offset origin (reference parametrization)
    prim: torch.Tensor  # i32 global triangle id, or -1 for sphere hits
    inst: torch.Tensor  # i32 instance id, -1 = miss


@dataclass
class LightTable(_Tensors):
    """World-space emitters that next-event estimation samples
    (ops/nee.py): L = number of entities."""
    kind: torch.Tensor   # (L,) i32: 0 triangle, 1 sphere
    mat: torch.Tensor    # (L,) i32 global material id
    p0: torch.Tensor     # (L, 3) f32: triangle v0 or sphere centre
    e1: torch.Tensor     # (L, 3) f32: triangle v1 - v0, or [radius, 0, 0]
    e2: torch.Tensor     # (L, 3) f32: triangle v2 - v0
    n: torch.Tensor      # (L, 3) f32 triangle unit normal
    area: torch.Tensor   # (L,) f32

    @property
    def count(self) -> int:
        return int(self.kind.shape[0])
