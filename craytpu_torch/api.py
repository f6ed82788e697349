"""Public API — the `crXxx` surface of the reference (src/c-ray.h:1-104)
as a Renderer object.

The reference drives a process-global renderer; we keep an explicit object
but mirror its operations: load scene (file/buf), getter/setter pairs for
samples / bounces / tile dims / image dims / output path, start renderer,
write image. The renderer runs on `device` (CUDA unless the caller passes
"cpu").
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from craytpu_torch.utils import logging
from craytpu_torch.version import __version__, REFERENCE_VERSION


@dataclass
class Renderer:
    scene: object = None          # SceneHost
    compiled: object = None       # CompiledScene
    framebuffer: Optional[np.ndarray] = None
    render_time_ms: float = 0.0
    overrides: dict = field(default_factory=dict)
    interactive: bool = False
    device: Optional[str] = None  # None = CUDA

    # ---- prefs get/set (c-ray.c:170-268) ----
    def sample_count(self):
        return self.scene.prefs.sample_count

    def set_sample_count(self, n: int):
        self.scene.prefs.sample_count = max(1, int(n))

    def bounces(self):
        return self.scene.prefs.bounces

    def set_bounces(self, n: int):
        self.scene.prefs.bounces = int(n)

    def tile_dims(self):
        return self.scene.prefs.tile_width, self.scene.prefs.tile_height

    def set_tile_dims(self, w: int, h: int):
        self.scene.prefs.tile_width = int(w)
        self.scene.prefs.tile_height = int(h)

    def image_dims(self):
        return self.scene.prefs.image_width, self.scene.prefs.image_height

    def set_image_dims(self, w: int, h: int):
        self.scene.prefs.image_width = int(w)
        self.scene.prefs.image_height = int(h)

    def set_output_path(self, path: str):
        self.scene.prefs.img_file_path = path

    def output_path(self):
        return self.scene.prefs.img_file_path

    def set_asset_path(self, path: str):
        self.scene.prefs.asset_path = path

    # ---- scene loading (c-ray.c:129-160) ----
    def load_scene_from_file(self, path: str) -> bool:
        from craytpu_torch.scene.sceneloader import load_scene_from_file
        try:
            self.scene = load_scene_from_file(path, self.overrides)
        except FileNotFoundError:
            logging.warning("Scene file not found: %s", path)
            return False
        return True

    def load_scene_from_buf(self, buf: str, asset_path: str = "") -> bool:
        from craytpu_torch.scene.sceneloader import load_scene_from_buf
        self.scene = load_scene_from_buf(buf, asset_path, self.overrides)
        return True

    # ---- rendering (c-ray.c:270-283) ----
    def start_renderer(self, progress=None):
        from craytpu_torch.scene.compile import compile_scene
        from craytpu_torch.models import wavefront_pt
        from craytpu_torch.ops import sampler as smp
        t0 = time.perf_counter()
        self.compiled = compile_scene(self.scene, self.device)
        kind = smp.HALTON if self.interactive else smp.RANDOM
        self.framebuffer = wavefront_pt.render(self.compiled, kind=kind,
                                               progress=progress)
        self.render_time_ms = (time.perf_counter() - t0) * 1e3
        logging.info("Finished render in %s",
                     logging.smart_time(self.render_time_ms))

    def current_image(self) -> Optional[np.ndarray]:
        return self.framebuffer

    # ---- output (c-ray.c:85-111) ----
    def write_image(self) -> str:
        p = self.scene.prefs
        os.makedirs(p.img_file_path or ".", exist_ok=True)
        # filename pattern %s%s_%04d (encoders/encoder.c:22-26)
        base = f"{p.img_file_path}{p.img_file_name}_{p.img_count:04d}"
        meta = {
            "CRay version": REFERENCE_VERSION,
            "craytpu_torch version": __version__,
            "Image rendertime": logging.smart_time(self.render_time_ms),
            "Samples per pixel": str(p.sample_count),
            "Bounces": str(p.bounces),
        }
        if p.img_type == "bmp":
            from craytpu_torch.io.png import write_bmp
            path = base + ".bmp"
            write_bmp(path, self.framebuffer)
        else:
            from craytpu_torch.io.png import write_png
            path = base + ".png"
            write_png(path, self.framebuffer, meta)
        logging.info("Wrote %s", path)
        return path
