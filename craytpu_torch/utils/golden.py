"""Golden-image parity helpers: the float framebuffer against the C
oracle's 8-bit sRGB PNGs (goldens/<name>_<W>_<SPP>.png).

The C oracle (renderer.c:297-300 + colorToSRGB + setPixel clamp) writes
8-bit sRGB rows top-down. Thresholds allow float accumulation-order
differences but fail on any real shading/traversal change. The goldens
decode with the standard-library PNG reader (io/png.py), so no PIL is
needed.
"""

from __future__ import annotations

import os

import numpy as np

from craytpu_torch.io.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the full corpus with 80x50/4spp goldens (9 reference scenes + 2
# synthetic stress scenes with C-oracle goldens)
SCENES = ["scene", "hdr", "refraction", "glowmetal", "uvsphere",
          "alphanode", "fence", "venus", "statues",
          "stress_highpoly", "stress_instances"]

# minimum fraction of subpixels within 1 8-bit LSB of the oracle
MIN_WITHIN_1LSB = 0.985
MAX_MEAN_ABS = 1.0


def scene_path(name: str, corpus: str | None = None) -> str:
    """A corpus scene's JSON: the stress scenes from assets/, the others
    from `corpus`, the directory of the C reference's input scenes, which
    the caller names (the repository does not hold them)."""
    if name.startswith("stress_"):
        return os.path.join(REPO, "assets", f"{name}.json")
    if corpus is None:
        raise FileNotFoundError(
            f"{name}: not a stress scene under assets/; pass the C "
            f"reference's input directory as `corpus`")
    return os.path.join(corpus, f"{name}.json")


def srgb_u8(fb: np.ndarray) -> np.ndarray:
    """float framebuffer (H,W,4, y-up) -> 8-bit sRGB rows top-down."""
    rgb = fb[..., :3]
    srgb = np.where(rgb > 0.0031308,
                    1.055 * np.power(np.maximum(rgb, 1e-12), 1 / 2.4)
                    - 0.055,
                    12.92 * rgb)
    u8 = np.minimum(np.maximum(srgb * 255.0 + 0.5, 0.0),
                    255.0).astype(np.uint8)
    return u8[::-1]


def compare_u8(ours: np.ndarray, golden: np.ndarray):
    """(ok, within_1lsb_fraction, mean_abs) of two 8-bit images."""
    d = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    within = float((d <= 1).mean())
    mean_abs = float(d.mean())
    ok = within >= MIN_WITHIN_1LSB and mean_abs <= MAX_MEAN_ABS
    return ok, within, mean_abs


def compare(fb: np.ndarray, name: str, w: int = 80, h: int = 50,
            spp: int = 4):
    """Compare a float framebuffer against goldens/<name>_<w>_<spp>.png.

    Returns (ok, within_1lsb_fraction, mean_abs) — ok is None if no
    golden exists for the scene at this size."""
    path = os.path.join(REPO, "goldens", f"{name}_{w}_{spp}.png")
    if not os.path.exists(path):
        return None, 0.0, 0.0
    return compare_u8(srgb_u8(np.asarray(fb)), read_png_rgb(path))


def render_and_compare(name: str, w: int = 80, h: int = 50, spp: int = 4,
                       device=None, corpus: str | None = None):
    """Render one corpus scene with the port's per-pass WavefrontRenderer
    on `device` (the card unless the caller asks for the CPU) and compare
    it with its golden: (ok, within_1lsb_fraction, mean_abs), as
    compare. `corpus`: as scene_path."""
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer
    from craytpu_torch.scene.compile import compile_scene
    from craytpu_torch.scene.sceneloader import load_scene_from_file
    scene = load_scene_from_file(
        scene_path(name, corpus), {"width": w, "height": h, "samples": spp})
    fb = WavefrontRenderer(compile_scene(scene, device)).render(spp=spp)
    return compare(fb, name, w, h, spp)
