"""Texture loading (host). Replaces stb_image (textureloader.c:51-87).

LDR images (PNG/JPG/BMP/...) decode via PIL to float32 byte/255 values
(without PIL they raise ImportError instead of loading as missing);
.hdr decodes via craytpu.io.hdr. Data layout matches the reference's texture
buffer: row 0 is the image top (stb order); fetch-time y-flip happens in
ops/texture.py exactly like texture.c:33-64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from craytpu_torch.utils import logging

F = np.float32


@dataclass
class TextureHost:
    data: np.ndarray      # (H, W, C) float32, row 0 = top
    channels: int
    is_float: bool        # float_p (HDR) vs char_p origin
    path: str = ""

    @property
    def width(self):
        return self.data.shape[1]

    @property
    def height(self):
        return self.data.shape[0]


def _pil_image(path: str):
    """PIL's Image module. Decoding LDR textures needs PIL; a machine
    without it cannot load them, so raise instead of warning."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"texture {path!r} is an LDR image and decoding it needs PIL, "
            "which is not installed") from e
    return Image


def load_texture(path: str) -> TextureHost | None:
    path = path.strip()
    try:
        if path.lower().endswith(".hdr"):
            from craytpu_torch.io.hdr import read_hdr
            arr = read_hdr(path)
            return TextureHost(arr.astype(F), arr.shape[2], True, path)
        Image = _pil_image(path)
        from craytpu_torch.utils.fileio import open_file
        img = Image.open(open_file(path))
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = arr.astype(F) / F(255.0)
        return TextureHost(arr, arr.shape[2], False, path)
    except ImportError:
        raise
    except Exception as e:  # mirror stb failure -> warning + NULL
        logging.warning("Failed to decode texture %r: %s", path, e)
        return None
