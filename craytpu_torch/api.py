"""Public API — the `crXxx` surface of the reference (src/c-ray.h:1-104)
as a Renderer object plus module-level functions for drop-in parity.

The reference drives a process-global renderer; we keep an explicit object
but mirror every operation: initialize, load scene (file/buf), getter/setter
pairs for thread count / samples / bounces / tile dims / image dims /
output path, start renderer, abort, write image. Worker mode is the CLI's
`--worker` (parallel/cluster.py::start_worker). The renderer runs on
`device` (CUDA unless the caller passes "cpu").

In a group of ranks (initialize() joins it when CRAYTPU_COORDINATOR or
torchrun's variables configure one; parallel/dist.py) every rank loads
and compiles the scene and renders its share of each pass; rank 0 alone
writes the image and decides an abort.
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
    _aborted: bool = False

    # ---- prefs get/set (c-ray.c:170-268) ----
    def thread_count(self):
        return self.scene.prefs.threads if self.scene else 0

    def set_thread_count(self, n: int, from_system: bool = False):
        """Stored in the prefs only: the wavefront renderer is
        card-parallel, not thread-parallel."""
        self.scene.prefs.threads = n
        self.scene.prefs.from_system = from_system

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
        from craytpu_torch.parallel import dist
        t0 = time.perf_counter()
        self._aborted = False
        self.compiled = compile_scene(self.scene, self.device)
        kind = smp.HALTON if self.interactive else smp.RANDOM
        if dist.multi_rank():
            # each pass split over the group; rank 0's abort for all
            from craytpu_torch.parallel.pool_shard import make_renderer
            self.framebuffer = make_renderer(self.compiled, kind=kind).render(
                progress=progress,
                stop=lambda: bool(dist.broadcast_object(self._aborted)))
        else:
            self.framebuffer = wavefront_pt.render(
                self.compiled, kind=kind, progress=progress,
                stop=lambda: self._aborted)
        self.render_time_ms = (time.perf_counter() - t0) * 1e3
        logging.info("Finished render in %s",
                     logging.smart_time(self.render_time_ms))

    def current_image(self) -> Optional[np.ndarray]:
        return self.framebuffer

    def abort(self):
        """crRendererAbort: start_renderer ends after the pass under way
        (from a progress callback or another thread); the framebuffer is
        the mean of the passes done."""
        self._aborted = True

    # ---- output (c-ray.c:85-111) ----
    def write_image(self) -> str:
        """Write the framebuffer (rank 0 of a group only); returns the
        path."""
        from craytpu_torch.parallel import dist
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
        path = base + (".bmp" if p.img_type == "bmp" else ".png")
        if dist.rank() != 0:
            return path
        if p.img_type == "bmp":
            from craytpu_torch.io.png import write_bmp
            write_bmp(path, self.framebuffer)
        else:
            from craytpu_torch.io.png import write_png
            write_png(path, self.framebuffer, meta)
        logging.info("Wrote %s", path)
        return path


def initialize() -> Renderer:
    """crInitialize + crInitRenderer; joins the process group first when
    one is configured (parallel/dist.py::init_distributed)."""
    from craytpu_torch.parallel import dist
    dist.init_distributed()
    return Renderer()


def get_version() -> str:
    return REFERENCE_VERSION
