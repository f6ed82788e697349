"""Wavefront MTL loader (host). Mirrors mtlloader.c:39-123.

Statements: newmtl, Ka, Kd, Ks, Ke, illum, Ns, d, r, sharpness, Ni, map_Kd,
norm, map_Ns. Textures are loaded eagerly via the provided texture_loader
callback (returns a texture id). `norm` normal maps are loaded but never
sampled during shading — that matches the reference (material.c:117 frees
them unused).
"""

from __future__ import annotations

import os

from craytpu_torch.scene.types import MaterialHost
from craytpu_torch.utils import logging


def _color(toks):
    return (float(toks[1]), float(toks[2]), float(toks[3]), 1.0)


def parse_mtl(file_path: str, texture_loader=None) -> list[MaterialHost]:
    try:
        from craytpu_torch.utils.fileio import load_file
        text = load_file(file_path, text=True)
    except OSError:
        logging.warning("MTL not found: %s", file_path)
        return []
    asset_path = os.path.dirname(file_path)
    if asset_path:
        asset_path += "/"

    materials: list[MaterialHost] = []
    cur: MaterialHost | None = None

    def load_tex(rel, srgb_ldr):
        if texture_loader is None:
            return None
        return texture_loader(asset_path + rel)

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        key = toks[0]
        if key == "newmtl":
            cur = MaterialHost(name=toks[1] if len(toks) > 1 else "")
            materials.append(cur)
        elif cur is None:
            continue
        elif key == "Ka":
            cur.ambient = _color(toks)
        elif key == "Kd":
            cur.diffuse = _color(toks)
        elif key == "Ks":
            cur.specular = _color(toks)
        elif key == "Ke":
            cur.emission = _color(toks)
        elif key == "illum":
            cur.illum = int(toks[1])
        elif key == "Ns":
            cur.shinyness = float(toks[1])
        elif key == "d":
            cur.transparency = float(toks[1])
        elif key == "r":
            cur.reflectivity = float(toks[1])
        elif key == "sharpness":
            cur.glossiness = float(toks[1])
        elif key == "Ni":
            cur.ior = float(toks[1])
        elif key == "map_Kd":
            cur.texture = load_tex(toks[1], True)
        elif key == "norm":
            cur.normal_map = load_tex(toks[1], True)
        elif key == "map_Ns":
            cur.specular_map = load_tex(toks[1], True)
        else:
            logging.debug("Unknown MTL statement %r in %s", key, file_path)
    return materials
