"""Texture sampling device ops over one (R, 4) RGBA texel-row buffer.

All scene textures are concatenated into one float32 table of RGBA rows
(channel layouts are normalized at registration: 1-channel -> (r,r,r,1),
3-channel -> (r,g,b,1)); each image node is compiled with static
(row_offset, width, height, channels) metadata, and one bilinear fetch is
four row gathers.

Fetch semantics mirror datatypes/image/texture.c:33-85: y-flipped storage
(row 0 = top, fetch y=0 = bottom), wrap-around indexing, and the
reference's bilinear filter with trunc-toward-zero int casts. LDR byte
textures were pre-divided by 255 at load, identical to the fetch-time
division in textureGetPixelInternal.
"""

from __future__ import annotations

import numpy as np
import torch

from craytpu_torch.ops import vecmath as vm


def pack_rgba_rows(data: np.ndarray) -> np.ndarray:
    """(H, W, C) float texture -> (H*W, 4) RGBA rows (texture.c channel
    semantics baked in)."""
    h, w, c = data.shape
    rows = data.reshape(h * w, c).astype(np.float32)
    out = np.ones((h * w, 4), np.float32)
    if c == 1:
        out[:, 0] = out[:, 1] = out[:, 2] = rows[:, 0]
    elif c == 2:
        out[:, 0] = out[:, 1] = out[:, 2] = rows[:, 0]
        out[:, 3] = rows[:, 1]
    else:
        out[:, :min(c, 4)] = rows[:, :4]
    return out


def _fetch_internal(texels, meta, xi, yi, active=None):
    """textureGetPixelInternal (texture.c:33-64). xi, yi int32 tensors.
    Lanes outside `active` (whose result the caller discards) read the
    texture's first row instead."""
    offset, w, h, _ = meta
    x = torch.remainder(xi, w)
    y = torch.remainder(yi, h)
    row = offset + x + (h - 1 - y) * w
    if active is not None:
        row = torch.where(active, row, offset)
    return vm.take_rows(texels, row)


def fetch_nearest(texels, meta, x, y, active=None):
    """Unfiltered path: float pixel coords, size_t-cast truncation."""
    return _fetch_internal(texels, meta, x.to(torch.int32),
                           y.to(torch.int32), active=active)


def fetch_bilinear(texels, meta, u, v, active=None):
    """Filtered path (texture.c:67-80): u,v in [0,1] texture coords."""
    _, w, h, _ = meta
    x = u * float(w)
    y = v * float(h)
    xc = x - 0.5
    yc = y - 0.5
    xi = xc.to(torch.int32)  # trunc toward zero, like (int) cast
    yi = yc.to(torch.int32)
    tl = _fetch_internal(texels, meta, xi, yi, active=active)
    tr = _fetch_internal(texels, meta, xi + 1, yi, active=active)
    bl = _fetch_internal(texels, meta, xi, yi + 1, active=active)
    br = _fetch_internal(texels, meta, xi + 1, yi + 1, active=active)
    fx = (xc - xi.to(torch.float32))[..., None]
    fy = (yc - yi.to(torch.float32))[..., None]
    top = tl * (1.0 - fx) + tr * fx
    bot = bl * (1.0 - fx) + br * fx
    return top * (1.0 - fy) + bot * fy
