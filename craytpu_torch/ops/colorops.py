"""Color device ops: RGBA as (..., 4) float32 tensors.

Mirrors datatypes/color.h (sRGB transfer functions, HSP grayscale,
lerp).
"""

from __future__ import annotations

import torch

from craytpu_torch.ops import vecmath as vm


def rgba(r, g, b, a=1.0, device=None):
    """One RGBA color as a (4,) f32 tensor."""
    return torch.tensor([r, g, b, a], dtype=torch.float32, device=device)


def color_coef(coef, c):
    """colorCoef: scales ALL four channels including alpha (color.h:46-48)."""
    return c * coef[..., None]


def color_mul(a, b):
    return a * b


def color_add(a, b):
    return a + b


def color_lerp(a, b, t):
    """a*(1-t) + b*t as separate roundings (never torch.lerp)."""
    t = t[..., None]
    return a * (1.0 - t) + b * t


def linear_to_srgb(channel):
    """The sRGB encode (color.h): 12.92 x below 0.0031308, else
    1.055 x^(1/2.4) - 0.055 with the JAX package's f32 exponent."""
    return torch.where(channel <= 0.0031308,
                       12.92 * channel,
                       1.055 * torch.pow(torch.clamp_min(channel, 0.0),
                                         0.4166666667) - 0.055)


def srgb_to_linear(channel):
    return torch.where(channel <= 0.04045,
                       channel / 12.92,
                       torch.pow((channel + 0.055) / 1.055, 2.4))


def color_to_srgb(c):
    return torch.cat([linear_to_srgb(c[..., :3]), c[..., 3:]], dim=-1)


def color_from_srgb(c):
    return torch.cat([srgb_to_linear(c[..., :3]), c[..., 3:]], dim=-1)


def grayscale_hsp(c):
    """HSP luminance (color.h:41-44); returns scalar brightness."""
    return vm.ieee_sqrt(0.299 * (c[..., 0] * c[..., 0])
                        + 0.587 * (c[..., 1] * c[..., 1])
                        + 0.114 * (c[..., 2] * c[..., 2]))
