"""Host-side scene data model.

Mirrors the reference's world/mesh/sphere/instance/material/prefs structures
(datatypes/scene.h, mesh.h, sphere.h, instance.h, material.h:62-83,
renderer.h prefs) as plain Python dataclasses over numpy arrays. This is the
intermediate form between the loaders and the device compile step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from craytpu_torch.scene.transform import Transform

# bsdfType enum (material.h:52-60); zero-init means emission like the C code
BSDF_EMISSION = 0
BSDF_LAMBERTIAN = 1
BSDF_GLASS = 2
BSDF_PLASTIC = 3
BSDF_METAL = 4
BSDF_TRANSLUCENT = 5
BSDF_TRANSPARENT = 6


@dataclass
class MaterialHost:
    """struct material (material.h:62-83). Colors are RGBA float32 tuples."""
    name: str = ""
    texture: Optional[int] = None       # texture id into SceneHost.textures
    normal_map: Optional[int] = None    # loaded but never shaded (mtl parity)
    specular_map: Optional[int] = None
    ambient: tuple = (0.0, 0.0, 0.0, 0.0)
    diffuse: tuple = (0.0, 0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0, 0.0)
    illum: int = 0
    shinyness: float = 0.0
    reflectivity: float = 0.0
    roughness: float = 0.0
    refractivity: float = 0.0
    ior: float = 0.0
    transparency: float = 0.0
    sharpness: float = 0.0
    glossiness: float = 0.0
    type: int = BSDF_EMISSION
    bsdf_ir: Any = None  # nodegraph IR assigned by assign_bsdf or JSON graph


def default_material() -> MaterialHost:
    """defaultMaterial (material.c:30-37)."""
    return MaterialHost(diffuse=(0.5, 0.5, 0.5, 1.0), reflectivity=1.0,
                        type=BSDF_LAMBERTIAN, ior=1.0)


def warning_material() -> MaterialHost:
    """warningMaterial (material.c:40-45)."""
    return MaterialHost(type=BSDF_LAMBERTIAN, diffuse=(1.0, 0.0, 0.5, 1.0))


@dataclass
class MeshHost:
    """struct mesh (mesh.h): triangle ranges over the global SoA buffers."""
    name: str = ""
    tri_vidx: np.ndarray = None    # (P, 3) int32, GLOBAL vertex indices
    tri_nidx: np.ndarray = None    # (P, 3) int32, global normal indices
    tri_uvidx: np.ndarray = None   # (P, 3) int32, global texcoord indices
    tri_mat: np.ndarray = None     # (P,) int32, index into materials
    tri_has_n: np.ndarray = None   # (P,) bool (poly.hasNormals)
    materials: list = field(default_factory=list)
    texcoord_count: int = 0        # this mesh's own vt count
    bvh: Any = None                # accel.bvh.BVH over local triangle order
    ray_offset: float = 0.0        # set during TLAS build (instance.c:222-230)


@dataclass
class SphereHost:
    """struct sphere (sphere.h)."""
    radius: float = 10.0
    material: MaterialHost = field(default_factory=default_material)
    ray_offset: float = 0.0


@dataclass
class InstanceHost:
    kind: int = 0              # device.INST_* codes
    obj_index: int = 0         # mesh or sphere index
    transform: Transform = field(default_factory=Transform)
    density: float = 0.0       # volumes only


@dataclass
class Prefs:
    """struct prefs defaults (sceneloader.c:190-209)."""
    threads: int = 0
    from_system: bool = True
    sample_count: int = 25
    bounces: int = 20
    tile_width: int = 32
    tile_height: int = 32
    tile_order: str = "fromMiddle"
    antialiasing: bool = True
    img_file_path: str = "./"
    img_file_name: str = "rendered"
    img_count: int = 0
    image_width: int = 1280
    image_height: int = 800
    img_type: str = "png"
    enabled: bool = False       # display
    fullscreen: bool = False
    borderless: bool = False
    scale: float = 1.0
    asset_path: str = ""


@dataclass
class SceneHost:
    prefs: Prefs = field(default_factory=Prefs)
    camera: Any = None             # ops.camera.CameraHost
    background_ir: Any = None      # background bsdf IR
    vertices: np.ndarray = None    # (V, 3) f32 global SoA (vertexbuffer.c)
    normals: np.ndarray = None     # (N, 3) f32
    uvs: np.ndarray = None         # (T, 2) f32
    meshes: list = field(default_factory=list)
    spheres: list = field(default_factory=list)
    instances: list = field(default_factory=list)
    textures: list = field(default_factory=list)  # np arrays (H, W, C) f32
    texture_paths: dict = field(default_factory=dict)
    tlas: Any = None
