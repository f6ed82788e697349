"""JSON scene loader (host). Mirrors utils/loaders/sceneloader.c.

Full scene parse: renderer prefs (+ CLI override precedence CLI > JSON >
defaults, sceneloader.c:425-467), display block, camera (FOV clamp, thin-lens
fstops, transform list), ambientColor (gradient | HDR env | default gray),
sphere primitives, meshes with instances and material node graphs. JSON key
lookups are case-insensitive like cJSON_GetObjectItem.
"""

from __future__ import annotations

import json
import os

import numpy as np

from craytpu_torch.ops.camera import CameraHost
from craytpu_torch.scene import nodegraph as ng
from craytpu_torch.scene import transform as tf
from craytpu_torch.scene import wavefront
from craytpu_torch.scene.textureload import load_texture
from craytpu_torch.scene.types import (InstanceHost, MaterialHost, Prefs, SceneHost,
                                 SphereHost, default_material,
                                 BSDF_EMISSION, BSDF_GLASS, BSDF_LAMBERTIAN,
                                 BSDF_METAL, BSDF_PLASTIC)
from craytpu_torch.scene.device import INST_MESH, INST_SPHERE
from craytpu_torch.utils import logging, trace


def _get(obj, key):
    """Case-insensitive key lookup (cJSON_GetObjectItem semantics)."""
    if not isinstance(obj, dict):
        return None
    if key in obj:
        return obj[key]
    kl = key.lower()
    for k, v in obj.items():
        if k.lower() == kl:
            return v
    return None


def _is_num(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def parse_transform(data: dict) -> tf.Transform:
    """parseTransform (sceneloader.c:78-188)."""
    ttype = _get(data, "type")
    if not isinstance(ttype, str):
        logging.warning("Failed to parse transform! No type found")
        return tf.translate(0.0, 0.0, 0.0)
    degrees = _get(data, "degrees")
    radians = _get(data, "radians")
    scale = _get(data, "scale")
    default = 1.0 if ttype == "scale" else 0.0
    x = _get(data, "X")
    y = _get(data, "Y")
    z = _get(data, "Z")
    xv = x if _is_num(x) else default
    yv = y if _is_num(y) else default
    zv = z if _is_num(z) else default
    has_coord = any(_is_num(c) for c in (x, y, z))

    if ttype == "rotateX":
        if _is_num(degrees):
            return tf.rotate_x(tf.to_radians(degrees))
        if _is_num(radians):
            return tf.rotate_x(radians)
    elif ttype == "rotateY":
        if _is_num(degrees):
            return tf.rotate_y(tf.to_radians(degrees))
        if _is_num(radians):
            return tf.rotate_y(radians)
    elif ttype == "rotateZ":
        if _is_num(degrees):
            return tf.rotate_z(tf.to_radians(degrees))
        if _is_num(radians):
            return tf.rotate_z(radians)
    elif ttype == "translate":
        if has_coord:
            return tf.translate(xv, yv, zv)
    elif ttype == "scale":
        if has_coord:
            return tf.scale(xv, yv, zv)
    elif ttype == "scaleUniform":
        if _is_num(scale):
            return tf.scale_uniform(scale)
    else:
        logging.warning("Found an invalid transform %r", ttype)
    logging.warning("Transform %r missing required values", ttype)
    return tf.translate(0.0, 0.0, 0.0)


def parse_transform_composite(transforms) -> tf.Transform:
    if not transforms:
        return tf.Transform()
    return tf.compose([parse_transform(t) for t in transforms])


def parse_prefs(data, overrides: dict | None = None) -> Prefs:
    """parsePrefs (sceneloader.c:211-470) incl. CLI override layer."""
    p = Prefs()
    overrides = overrides or {}
    if data:
        threads = _get(data, "threads")
        if _is_num(threads) and threads > 0:
            p.threads = int(threads)
            p.from_system = False
        samples = _get(data, "samples")
        if _is_num(samples):
            p.sample_count = max(1, int(samples))
        bounces = _get(data, "bounces")
        if _is_num(bounces):
            p.bounces = int(bounces) if bounces >= 0 else 1
        aa = _get(data, "antialiasing")
        if isinstance(aa, bool):
            p.antialiasing = aa
        tw = _get(data, "tileWidth")
        if _is_num(tw):
            p.tile_width = max(1, int(tw))
        th = _get(data, "tileHeight")
        if _is_num(th):
            p.tile_height = max(1, int(th))
        order = _get(data, "tileOrder")
        if isinstance(order, str):
            p.tile_order = order if order in (
                "random", "topToBottom", "fromMiddle", "toMiddle") else "normal"
        fp = _get(data, "outputFilePath")
        if isinstance(fp, str):
            p.img_file_path = fp
        fn = _get(data, "outputFileName")
        if isinstance(fn, str):
            p.img_file_name = fn
        cnt = _get(data, "count")
        if _is_num(cnt):
            p.img_count = max(0, int(cnt))
        w = _get(data, "width")
        if _is_num(w):
            p.image_width = int(w) if w >= 0 else 640
        h = _get(data, "height")
        if _is_num(h):
            p.image_height = int(h) if h >= 0 else 400
        ft = _get(data, "fileType")
        if isinstance(ft, str):
            p.img_type = "bmp" if ft == "bmp" else "png"

    if "threads" in overrides:
        p.threads = int(overrides["threads"])
        p.from_system = False
    if "samples" in overrides:
        p.sample_count = int(overrides["samples"])
    if "dims" in overrides:
        p.image_width, p.image_height = overrides["dims"]
    if "width" in overrides:
        p.image_width = int(overrides["width"])
    if "height" in overrides:
        p.image_height = int(overrides["height"])
    if "tiledims" in overrides:
        p.tile_width, p.tile_height = overrides["tiledims"]
    if "tileWidth" in overrides:
        p.tile_width = int(overrides["tileWidth"])
    if "tileHeight" in overrides:
        p.tile_height = int(overrides["tileHeight"])
    return p


def parse_display(p: Prefs, data) -> None:
    if data is None:
        p.enabled = True
        return
    en = _get(data, "enabled")
    p.enabled = bool(en) if isinstance(en, bool) else False
    fs = _get(data, "isFullscreen")
    p.fullscreen = bool(fs) if isinstance(fs, bool) else False
    bl = _get(data, "isBorderless")
    p.borderless = bool(bl) if isinstance(bl, bool) else False
    ws = _get(data, "windowScale")
    p.scale = float(ws) if _is_num(ws) and ws >= 0 else 1.0


def parse_camera(data, width, height) -> CameraHost:
    """parseCamera (sceneloader.c:547-626)."""
    fov, focal, fstops = 80.0, 10.0, 0.0
    composite = tf.Transform()
    if data:
        f = _get(data, "FOV")
        if _is_num(f):
            fov = 180.0 if f > 180.0 else (f if f >= 0.0 else 80.0)
        fd = _get(data, "focalDistance")
        if _is_num(fd):
            focal = fd if fd >= 0.0 else 0.0
        ap = _get(data, "fstops")
        if _is_num(ap):
            fstops = ap if ap >= 0.0 else 0.0
        tr = _get(data, "transforms")
        if isinstance(tr, list):
            composite = parse_transform_composite(tr)
    return CameraHost(width, height, fov, focal, fstops, composite.A)


def parse_color(data):
    """parseColor (sceneloader.c:629-689): array | {r,g,b,a} | blackbody."""
    if isinstance(data, list):
        def g(i, d):
            return float(data[i]) if len(data) > i and _is_num(data[i]) else d
        return (g(0, 0.0), g(1, 0.0), g(2, 0.0), g(3, 1.0))
    assert isinstance(data, dict)
    kelvin = _get(data, "blackbody")
    if _is_num(kelvin):
        return ng.color_for_kelvin(float(kelvin))
    r = _get(data, "r")
    g = _get(data, "g")
    b = _get(data, "b")
    a = _get(data, "a")
    return (float(r) if _is_num(r) else 0.0,
            float(g) if _is_num(g) else 0.0,
            float(b) if _is_num(b) else 0.0,
            float(a) if _is_num(a) else 1.0)


class _Loader:
    def __init__(self, asset_path: str):
        self.scene = SceneHost()
        self.scene.prefs.asset_path = asset_path
        self.buffers = wavefront.GlobalBuffers()

    # -- texture registry ---------------------------------------------------
    def texture_id(self, path: str):
        """Load a texture once and return its index (or None)."""
        key = path.strip()
        if key in self.scene.texture_paths:
            return self.scene.texture_paths[key]
        tex = load_texture(key)
        if tex is None and self.scene.prefs.asset_path:
            tex = load_texture(self.scene.prefs.asset_path + key)
        if tex is None and self.scene.prefs.asset_path:
            # the reference resolves JSON texture paths from its CWD (the
            # c-ray repo root, e.g. "input/shapes/grid.png"); our analogue
            # of that root is the asset dir's parent
            parent = os.path.dirname(
                self.scene.prefs.asset_path.rstrip("/"))
            tex = load_texture(os.path.join(parent, key))
        if tex is None:
            self.scene.texture_paths[key] = None
            return None
        self.scene.textures.append(tex)
        tid = len(self.scene.textures) - 1
        self.scene.texture_paths[key] = tid
        return tid

    # -- node graphs (sceneloader.c:765-875) --------------------------------
    def parse_value_node(self, node):
        if node is None:
            return None
        if _is_num(node):
            return ng.const_value(float(node))
        return ng.grayscale(self.parse_texture_node(node))

    def parse_texture_node(self, node):
        if node is None:
            return None
        if isinstance(node, list):
            return ng.const_color(parse_color(node))
        if isinstance(node, str):
            tid = self.texture_id(node)
            return ng.image(tid, 0) if tid is not None else None
        assert isinstance(node, dict)
        options = ng.SRGB_TRANSFORM
        srgb = _get(node, "transform")
        if srgb is not None and srgb is not True:
            options &= ~ng.SRGB_TRANSFORM
        lerp = _get(node, "lerp")
        if lerp is not True:
            options |= ng.NO_BILINEAR
        if _get(node, "r") is not None:
            return ng.const_color(parse_color(node))
        ntype = _get(node, "type")
        if isinstance(ntype, str):
            if ntype == "checkerboard":
                size = _get(node, "size")
                assert _is_num(size)
                return ng.checker(None, None, self.parse_value_node(size))
            if ntype == "blackbody":
                degrees = _get(node, "degrees")
                assert _is_num(degrees)
                return ng.blackbody_color(float(degrees))
        path = _get(node, "path")
        if isinstance(path, str):
            tid = self.texture_id(path)
            if tid is not None:
                return ng.image(tid, options)
            # image node with a NULL texture evals to warningMaterial's
            # pink diffuse (textures/image.c:32, material.c:40-45)
            return ng.const_color((1.0, 0.0, 0.5, 1.0))
        logging.warning("Failed to parse textureNode, using obnoxious pink: "
                        "%r", node)
        return ng.unknown_texture()

    def parse_node(self, node):
        """parseNode (sceneloader.c:837-875): bsdf graphs."""
        if node is None:
            return None
        ntype = _get(node, "type")
        if not isinstance(ntype, str):
            logging.warning("No type provided for node.")
            return ng.warning_bsdf()
        color = _get(node, "color")
        roughness = _get(node, "roughness")
        strength = _get(node, "strength")
        a = self.parse_node(_get(node, "A"))
        b = self.parse_node(_get(node, "B"))
        if ntype == "diffuse":
            return ng.diffuse(self.parse_texture_node(color))
        if ntype == "metal":
            return ng.metal(self.parse_texture_node(color),
                            self.parse_value_node(roughness))
        if ntype == "glass":
            ior = _get(node, "IOR")
            return ng.glass(self.parse_texture_node(color),
                            self.parse_value_node(roughness),
                            self.parse_value_node(ior))
        if ntype == "plastic":
            return ng.plastic(self.parse_texture_node(color))
        if ntype == "mix":
            return ng.mix(a, b, self.parse_value_node(_get(node, "factor")))
        if ntype == "add":
            return ng.add(a, b)
        if ntype == "transparent":
            return ng.transparent(self.parse_texture_node(color))
        if ntype == "emissive":
            return ng.emissive(self.parse_texture_node(color),
                               self.parse_value_node(strength))
        logging.warning("Failed to parse node %r, using obnoxious pink",
                        ntype)
        return ng.warning_bsdf()

    # -- scene objects -------------------------------------------------------
    def parse_ambient_color(self, data):
        """parseAmbientColor (sceneloader.c:681-714)."""
        offset_v = None
        if data is not None:
            off = _get(data, "offset")
            if _is_num(off):
                offset_v = ng.const_value(float(tf.to_radians(off)) / 4.0)
            hdr = _get(data, "hdr")
            if isinstance(hdr, str):
                tid = self.texture_id(self.scene.prefs.asset_path + hdr)
                if tid is not None:
                    self.scene.background_ir = ng.background(
                        ng.image(tid, 0), None, offset_v)
                    return
            down = _get(data, "down")
            up = _get(data, "up")
            if down is not None and up is not None:
                self.scene.background_ir = ng.background(
                    ng.gradient(parse_color(down), parse_color(up)),
                    None, offset_v)
                return
        self.scene.background_ir = ng.background(None, None, offset_v)

    def parse_sphere(self, data):
        """parseSphere (sceneloader.c:1008-1101)."""
        sph = SphereHost(material=default_material())
        mat = sph.material
        bsdf = _get(data, "bsdf")
        if isinstance(bsdf, str):
            mapping = {"lambertian": BSDF_LAMBERTIAN, "metal": BSDF_METAL,
                       "glass": BSDF_GLASS, "plastic": BSDF_PLASTIC,
                       "emissive": BSDF_EMISSION}
            if bsdf in mapping:
                mat.type = mapping[bsdf]
        else:
            logging.warning("Sphere BSDF not found, defaulting to lambertian.")
        color = _get(data, "color")
        if color is not None:
            if mat.type == BSDF_EMISSION:
                mat.emission = parse_color(color)
            else:
                mat.ambient = parse_color(color)
                mat.diffuse = parse_color(color)
        else:
            logging.warning("No color specified for sphere")
        intensity = _get(data, "intensity")
        if _is_num(intensity) and mat.type == BSDF_EMISSION:
            mat.emission = tuple(float(intensity) * c for c in mat.emission)
        rough = _get(data, "roughness")
        mat.roughness = float(rough) if _is_num(rough) else 0.0
        ior = _get(data, "IOR")
        mat.ior = float(ior) if _is_num(ior) else 1.0
        radius = _get(data, "radius")
        if _is_num(radius):
            sph.radius = float(radius)
        else:
            sph.radius = 10.0
            logging.warning("No radius specified for sphere, setting to 10")
        self.scene.spheres.append(sph)
        sph_index = len(self.scene.spheres) - 1
        instances = _get(data, "instances")
        if isinstance(instances, list):
            for inst in instances:
                t = parse_transform_composite(_get(inst, "transforms"))
                self.scene.instances.append(
                    InstanceHost(INST_SPHERE, sph_index, t))
        graph = _get(data, "material")
        if graph is not None:
            mat.bsdf_ir = self.parse_node(graph)
        else:
            ng.assign_bsdf(mat)

    def parse_mesh(self, data):
        """parseMesh (sceneloader.c:878-974)."""
        file_name = _get(data, "fileName")
        bsdf = _get(data, "bsdf")
        intensity = _get(data, "intensity")
        roughness = _get(data, "roughness")
        type_map = {"metal": BSDF_METAL, "glass": BSDF_GLASS,
                    "plastic": BSDF_PLASTIC, "emissive": BSDF_EMISSION}
        mtype = BSDF_LAMBERTIAN
        if isinstance(bsdf, str):
            mtype = type_map.get(bsdf, BSDF_LAMBERTIAN)
        else:
            logging.warning("Invalid bsdf while parsing mesh")
        if not isinstance(file_name, str):
            return
        full_path = self.scene.prefs.asset_path + file_name
        try:
            mesh = wavefront.parse_wavefront(full_path, self.buffers,
                                             texture_loader=self.texture_id)
        except OSError:
            logging.warning("Failed to load mesh %r", full_path)
            return
        self.scene.meshes.append(mesh)
        mesh_index = len(self.scene.meshes) - 1

        instances = _get(data, "instances")
        if isinstance(instances, list):
            for inst in instances:
                t = parse_transform_composite(_get(inst, "transforms"))
                self.scene.instances.append(
                    InstanceHost(INST_MESH, mesh_index, t))

        graphs = _get(data, "material")
        if graphs is not None:
            if isinstance(graphs, list):
                assert len(graphs) <= len(mesh.materials)
                for i, g in enumerate(graphs):
                    mesh.materials[i].bsdf_ir = self.parse_node(g)
            else:
                node = self.parse_node(graphs)
                for m in mesh.materials:
                    m.bsdf_ir = node
        else:
            # legacy typing fallback (sceneloader.c:946-971)
            for m in mesh.materials:
                m.type = mtype
                if mtype == BSDF_EMISSION and intensity is not None:
                    m.emission = tuple(float(intensity) * c
                                       for c in m.diffuse)
                if mtype == BSDF_GLASS:
                    ior = _get(data, "IOR")
                    if _is_num(ior):
                        m.ior = float(ior)
                elif mtype == BSDF_PLASTIC:
                    m.ior = 1.45
                if _is_num(roughness):
                    m.roughness = float(roughness)
                ng.assign_bsdf(m)


@trace.setup("scene.load")
def load_scene_from_buf(text: str, asset_path: str = "",
                        overrides: dict | None = None) -> SceneHost:
    """crLoadSceneFromBuf -> loadScene -> parseJSON (scene.c:111-213)."""
    data = json.loads(text)
    ld = _Loader(asset_path)
    scene = ld.scene
    scene.prefs = parse_prefs(_get(data, "renderer"), overrides)
    scene.prefs.asset_path = asset_path
    parse_display(scene.prefs, _get(data, "display"))
    scene.camera = parse_camera(_get(data, "camera"), scene.prefs.image_width,
                                scene.prefs.image_height)
    sc = _get(data, "scene")
    ld.parse_ambient_color(_get(sc, "ambientColor") if sc else None)
    prims = _get(sc, "primitives") if sc else None
    if isinstance(prims, list):
        for prim in prims:
            ptype = _get(prim, "type")
            if ptype == "sphere":
                ld.parse_sphere(prim)
            else:
                logging.warning("Unknown primitive type %r", ptype)
    meshes = _get(sc, "meshes") if sc else None
    if isinstance(meshes, list):
        for m in meshes:
            ld.parse_mesh(m)

    scene.vertices, scene.normals, scene.uvs = ld.buffers.arrays()

    from craytpu_torch.accel.build import build_accels
    build_accels(scene)
    return scene


def load_scene_from_file(path: str, overrides: dict | None = None) -> SceneHost:
    from craytpu_torch.utils.fileio import load_file
    text = load_file(path, text=True)
    asset_path = os.path.dirname(os.path.abspath(path)) + "/"
    return load_scene_from_buf(text, asset_path, overrides)
