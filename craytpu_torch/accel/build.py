"""Scene acceleration-structure construction (host).

computeAccels + computeTopLevelBvh (datatypes/scene.c:50-88): per-mesh
bottom-level BVHs over local triangle order, then instance world bboxes /
centers (instance.c getBBoxAndCenter fns) feeding the top-level BVH. Ray
offsets are per-OBJECT and overwritten by each instance in build order, so
the last instance of an object wins — bug-compatible with
instance.c:222-230 where mesh->rayOffset is shared state.
"""

from __future__ import annotations

import numpy as np

from craytpu_torch.accel import bvh as bvh_mod
from craytpu_torch.scene import transform as tf
from craytpu_torch.scene.device import INST_MESH, INST_SPHERE
from craytpu_torch.scene.types import SceneHost
from craytpu_torch.utils import logging, trace

F = np.float32


@trace.setup("bvh.build")
def build_accels(scene: SceneHost) -> None:
    # bottom-level BVHs (one per mesh; reference builds these in parallel
    # threads, scene.c:50-78 — host build here, replicated to devices later)
    for mesh in scene.meshes:
        bmin, bmax, centers = bvh_mod.tri_bboxes_centers(
            scene.vertices, mesh.tri_vidx)
        mesh.bvh = bvh_mod.build_bvh(bmin, bmax, centers)

    # instance bboxes/centers + per-object ray offsets
    n_inst = len(scene.instances)
    inst_min = np.zeros((n_inst, 3), F)
    inst_max = np.zeros((n_inst, 3), F)
    centers = np.zeros((n_inst, 3), F)
    for i, inst in enumerate(scene.instances):
        A = inst.transform.A
        if inst.kind == INST_MESH:
            mesh = scene.meshes[inst.obj_index]
            rmin, rmax = mesh.bvh.root_bbox()
            bmin, bmax = tf.transform_bbox(rmin, rmax, A)
            centers[i] = (bmin + bmax) * F(0.5)
            mesh.ray_offset = bvh_mod.ray_offset(bmin, bmax)
        elif inst.kind == INST_SPHERE:
            sph = scene.spheres[inst.obj_index]
            centers[i] = tf.transform_point(np.zeros(3, F), A)
            r = F(sph.radius)
            bmin, bmax = tf.transform_bbox(
                np.array([-r, -r, -r], F), np.array([r, r, r], F), A)
            sph.ray_offset = bvh_mod.ray_offset(bmin, bmax)
        else:
            raise NotImplementedError("volume instances not yet wired")
        inst_min[i] = bmin
        inst_max[i] = bmax

    scene.tlas = bvh_mod.build_bvh(inst_min, inst_max, centers)

    n_polys = sum(m.tri_vidx.shape[0] for m in scene.meshes)
    logging.info(
        "Scene loaded: %d vertices, %d normals, %d texcoords, %d polys, "
        "%d spheres, %d meshes, %d instances",
        scene.vertices.shape[0], scene.normals.shape[0], scene.uvs.shape[0],
        n_polys, len(scene.spheres), len(scene.meshes), n_inst)
