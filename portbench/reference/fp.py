"""The reference's float layer, sample streams and vector helpers.

Plain PyTorch, frozen here from the port's plain forms, op for op, so that
on the same device the reference rounds every value as the timed path
rounds it: Dekker/Veltkamp exact products and Knuth 2Sum sums at the
sites where c-ray's binary contracts to an fma, correctly rounded
division and square root, and PCG32 sample streams seeded per (pixel,
pass) exactly as c-ray seeds them (samplers/sampler.c:41-43). Only what
the benchmark's scene classes use is here: the RANDOM sampler, the
vector ops of the camera, the triangle and sphere tests, the hit record,
the diffuse lobe and the gradient sky. Nothing is imported from the
program; the reference has no fast-math form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PI = float(np.float32(3.14159265358979323846))
TWO_PI = float(np.float32(2.0) * np.float32(PI))
FLT_MAX = 3.4028234663852886e38
M32 = 0xFFFFFFFF
_SPLIT = 4097.0


# ---- exact float primitives ------------------------------------------------

def two_prod(x, y):
    p = x * y
    c = _SPLIT * x
    hx = c - (c - x)
    lx = x - hx
    c2 = _SPLIT * y
    hy = c2 - (c2 - y)
    ly = y - hy
    e = ((hx * hy - p) + hx * ly + lx * hy) + ly * lx
    return p, e


def exact_div(a, b):
    q = a / b
    p, e = two_prod(q, b)
    r = (a - p) - e
    corr = r / b
    return torch.where(torch.isfinite(corr), q + corr, q)


def exact_sqrt(x):
    s = torch.sqrt(x)
    p, e = two_prod(s, s)
    r = (x - p) - e
    corr = r / (s + s)
    return torch.where(torch.isfinite(corr), s + corr, s)


def split(x):
    c = _SPLIT * x
    h = c - (c - x)
    return h, x - h


def fma_pre(a, ha, la, b, hb, lb, c):
    p = a * b
    e = ((ha * hb - p) + ha * lb + la * hb) + lb * la
    s = p + c
    z = s - p
    t = (p - (s - z)) + (c - z)
    return s + (t + e)


def fma_raw(a, b, c):
    ha, la = split(a)
    hb, lb = split(b)
    return fma_pre(a, ha, la, b, hb, lb, c)


def det_fma(a, b, c):
    p, e = two_prod(a, b)
    s = p + c
    z = s - p
    t = (p - (s - z)) + (c - z)
    corr = t + e
    return torch.where(torch.isfinite(corr), s + corr, a * b + c)


# ---- vectors (..., 3) -------------------------------------------------------

def vdot(a, b):
    return fma_raw(a[..., 2], b[..., 2],
                   fma_raw(a[..., 0], b[..., 0], a[..., 1] * b[..., 1]))


def vcross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    hax, lax = split(ax)
    hay, lay = split(ay)
    haz, laz = split(az)
    hbx, lbx = split(bx)
    hby, lby = split(by)
    hbz, lbz = split(bz)
    return torch.stack([
        fma_pre(ay, hay, lay, bz, hbz, lbz, -(az * by)),
        fma_pre(az, haz, laz, bx, hbx, lbx, -(ax * bz)),
        fma_pre(ax, hax, lax, by, hby, lby, -(ay * bx)),
    ], dim=-1)


def vlength(a):
    return exact_sqrt(vdot(a, a))


def vnormalize(a):
    return exact_div(a, vlength(a)[..., None])


def _rows(A, v, point: bool, transpose: bool):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    hx, lx = split(x)
    hz, lz = split(z)
    out = []
    for i in range(3):
        if transpose:
            m0, m1, m2 = A[..., 0, i], A[..., 1, i], A[..., 2, i]
        else:
            m0, m1, m2 = A[..., i, 0], A[..., i, 1], A[..., i, 2]
        h0, l0 = split(m0)
        h2, l2 = split(m2)
        inner = fma_pre(x, hx, lx, m0, h0, l0, y * m1)
        r = fma_pre(z, hz, lz, m2, h2, l2, inner)
        out.append(r + A[..., i, 3] if point else r)
    return torch.stack(out, dim=-1)


def mat34_point(A, p):
    """A (..., 3, 4) applied to the point p, c-ray's transformPoint."""
    return _rows(A, p, True, False)


def mat33_vec(A, v):
    return _rows(A, v, False, False)


def mat33_vec_T(A, v):
    return _rows(A, v, False, True)


def along_ray(start, direction, t):
    return det_fma(direction, t[..., None], start)


def triangle_distribution(v):
    """The tent filter's reshaping of a uniform sample (camera.c:50-56)."""
    orig = v * 2.0 - 1.0
    out = exact_div(orig, exact_sqrt(torch.abs(orig)))
    out = torch.clamp(out, -1.0, 1.0)
    sign = torch.where(orig >= 0.0, 1.0, -1.0)
    out = out - sign
    return torch.where(orig == 0.0, -1.0, out)


# ---- PCG32 on (hi, lo) int64 halves -------------------------------------------

def _mullo32(a, b):
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _mul32_hi_lo(a, b):
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    a0b0, a1b0, a0b1, a1b1 = a0 * b0, a1 * b0, a0 * b1, a1 * b1
    carry = ((a0b0 >> 16) + (a1b0 & 0xFFFF) + (a0b1 & 0xFFFF)) >> 16
    lo = (a0b0 + ((a1b0 + a0b1) << 16)) & M32
    hi = (a1b1 + (a1b0 >> 16) + (a0b1 >> 16) + carry) & M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = (al + bl) & M32
    hi = (ah + bh + (lo < al).to(torch.int64)) & M32
    return hi, lo


def _mul64(ah, al, bh, bl):
    p_hi, p_lo = _mul32_hi_lo(al, bl)
    return (p_hi + _mullo32(al, bh) + _mullo32(ah, bl)) & M32, p_lo


def _shr64(ah, al, n: int):
    return ah >> n, (al >> n) | ((ah << (32 - n)) & M32)


def _hash64(xh, xl):
    for shift, mh, ml in ((30, 0xBF58476D, 0x1CE4E5B9),
                          (27, 0x94D049BB, 0x133111EB)):
        h, l = _shr64(xh, xl, shift)
        xh, xl = xh ^ h, xl ^ l
        xh, xl = _mul64(xh, xl, torch.full_like(xh, mh),
                        torch.full_like(xl, ml))
    h, l = _shr64(xh, xl, 31)
    return xh ^ h, xl ^ l


_MUL_HI, _MUL_LO = 0x5851F42D, 0x4C957F2D


@dataclass
class Stream:
    """The PCG32 state of each lane, as (hi, lo) halves in [0, 2^32)."""
    hi: torch.Tensor
    lo: torch.Tensor

    def where(self, cond, other: "Stream") -> "Stream":
        return Stream(torch.where(cond, self.hi, other.hi),
                      torch.where(cond, self.lo, other.lo))

    def index(self, i) -> "Stream":
        return Stream(self.hi[i], self.lo[i])


def seed_streams(pixel_index, pass_idx, max_passes: int) -> Stream:
    """pcg32_srandom_r(hash64(pixel * maxPasses + pass), 0)."""
    pix = pixel_index.to(torch.int64) & M32
    mp = torch.full_like(pix, max_passes)
    seed_lo = (_mullo32(pix, mp) + (pass_idx.to(torch.int64) & M32)) & M32
    sh, sl = _hash64(torch.zeros_like(seed_lo), seed_lo)
    zero, one = torch.zeros_like(sh), torch.ones_like(sl)
    sh, sl = _add64(sh, sl, zero, one)
    sh, sl = _mul64(sh, sl, torch.full_like(sh, _MUL_HI),
                    torch.full_like(sl, _MUL_LO))
    return Stream(*_add64(sh, sl, zero, one))


def next_float(s: Stream):
    """One pcg32_random_r draw as u32 * 2^-32 (samplers/random.c:16-21).
    Returns (value, advanced stream)."""
    oh, ol = s.hi, s.lo
    nh, nl = _mul64(oh, ol, torch.full_like(oh, _MUL_HI),
                    torch.full_like(ol, _MUL_LO))
    nh, nl = _add64(nh, nl, torch.zeros_like(nh), torch.ones_like(nl))
    sh, sl = _shr64(oh, ol, 18)
    _, xs = _shr64(oh ^ sh, ol ^ sl, 27)
    rot = oh >> 27
    out = (xs >> rot) | ((xs << ((32 - rot) & 31)) & M32)
    return out.to(torch.float32) * (1.0 / 4294967296.0), Stream(nh, nl)


def random_on_unit_sphere(s: Stream):
    """randomOnUnitSphere (vector.h:243-249): two draws."""
    sx, s = next_float(s)
    sy, s = next_float(s)
    a = sx * TWO_PI
    r = 2.0 * exact_sqrt(torch.clamp_min(sy * (1.0 - sy), 0.0))
    z = fma_raw(torch.full_like(sy, -2.0), sy, torch.ones_like(sy))
    return torch.stack([torch.cos(a) * r, torch.sin(a) * r, z], dim=-1), s
