"""Color device ops: RGBA as (..., 4) float32 tensors.

Mirrors datatypes/color.h (sRGB decode, HSP grayscale, lerp).
"""

from __future__ import annotations

import torch


def color_coef(coef, c):
    """colorCoef: scales ALL four channels including alpha (color.h:46-48)."""
    return c * coef[..., None]


def color_lerp(a, b, t):
    """a*(1-t) + b*t as separate roundings (never torch.lerp)."""
    t = t[..., None]
    return a * (1.0 - t) + b * t


def srgb_to_linear(channel):
    return torch.where(channel <= 0.04045,
                       channel / 12.92,
                       torch.pow((channel + 0.055) / 1.055, 2.4))


def color_from_srgb(c):
    return torch.cat([srgb_to_linear(c[..., :3]), c[..., 3:]], dim=-1)


def grayscale_hsp(c):
    """HSP luminance (color.h:41-44); returns scalar brightness."""
    return torch.sqrt(0.299 * (c[..., 0] * c[..., 0])
                      + 0.587 * (c[..., 1] * c[..., 1])
                      + 0.114 * (c[..., 2] * c[..., 2]))
