"""Vector math device ops (float3 as (..., 3) tensors), batched.

Semantics mirror datatypes/vector.h. Sampler-consuming helpers thread the
SamplerState explicitly and consume dimensions in exactly the reference's
order.

Deterministic float primitives. The reference binary is built with
-march=native and gcc's default -ffp-contract=fast, so its float chains
are full of fused multiply-adds; matching its images needs the SAME
single-rounding contractions at the same sites, and correctly rounded
div and sqrt everywhere. These are written literally as Dekker/Veltkamp
exact products and Knuth 2Sum sums, from elementwise mul/add/sub/div/sqrt
only. Eager PyTorch runs one op per kernel and never contracts, so the
same op sequence gives the same bits as the JAX package's forms. Never
use `@`, einsum, addcmul, addmm or lerp for geometry: they may contract
or reorder. The CUDA kernels (csrc/detmath.cuh) repeat these sequences
with __fmul_rn/__fadd_rn/__fsub_rn.

CRAYTPU_FASTMATH=1 (profiling only, as in the JAX package,
craytpu/ops/vecmath.py:43-48): every deterministic primitive falls to its
plain form (a / b, sqrt(x), a * b + c in two roundings), so that the
price of the exact layer can be measured; the kernels are then built
with the same fallbacks (csrc/detmath.cuh, cuda_build's fast variant).
Its images are NOT golden-exact. The flag is read once, at import, into
`_FASTMATH`, which the primitives test at call time.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from craytpu_torch.ops import sampler as smp

PI = float(np.float32(3.14159265358979323846))  # includes.h PI (f32)
TWO_PI = float(np.float32(2.0) * np.float32(PI))

_SPLIT = 4097.0  # 2^12 + 1: Dekker split point for f32 (24-bit).

# CRAYTPU_FASTMATH=1: the plain forms (module docstring)
_FASTMATH = os.environ.get("CRAYTPU_FASTMATH", "") == "1"


def _two_prod(x, y):
    """Exact product: returns (p, e) with p + e == x*y exactly
    (Dekker/Veltkamp; valid while 4097*x and x*y stay finite)."""
    p = x * y
    c = _SPLIT * x
    hx = c - (c - x)
    lx = x - hx
    c2 = _SPLIT * y
    hy = c2 - (c2 - y)
    ly = y - hy
    e = ((hx * hy - p) + hx * ly + lx * hy) + ly * lx
    return p, e


def _exact_div(a, b):
    if _FASTMATH:
        return a / b
    q = a / b
    p, e = _two_prod(q, b)
    r = (a - p) - e
    corr = r / b
    return torch.where(torch.isfinite(corr), q + corr, q)


def _ieee_sqrt(x):
    """sqrt(x) correctly rounded, as IEEE's and the kernels' __fsqrt_rn:
    torch.sqrt on the card. PyTorch's vectorised float sqrt on the CPU
    can be 1 ulp off, so there it goes through float64, whose correctly
    rounded root rounds to the correctly rounded float one."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _exact_sqrt(x):
    if _FASTMATH:
        return _ieee_sqrt(x)
    s = torch.sqrt(x)
    p, e = _two_prod(s, s)
    r = (x - p) - e
    corr = r / (s + s)
    return torch.where(torch.isfinite(corr), s + corr, s)


def _split(x):
    """Veltkamp split: x == h + l with h, l each <=12 mantissa bits."""
    c = _SPLIT * x
    h = c - (c - x)
    return h, x - h


def _fma_pre(a, ha, la, b, hb, lb, c):
    """fma(a, b, c) with the operands' splits precomputed. UNGUARDED:
    callers must have scene-scale (finite, |x| < ~8e34) operands."""
    if _FASTMATH:
        return a * b + c
    p = a * b
    e = ((ha * hb - p) + ha * lb + la * hb) + lb * la
    s = p + c
    z = s - p
    t = (p - (s - z)) + (c - z)
    return s + (t + e)


def _fma_raw(a, b, c):
    ha, la = _split(a)
    hb, lb = _split(b)
    return _fma_pre(a, ha, la, b, hb, lb, c)


def _det_fma(a, b, c):
    if _FASTMATH:
        return a * b + c
    p, e = _two_prod(a, b)
    s = p + c
    z = s - p
    t = (p - (s - z)) + (c - z)
    corr = t + e
    return torch.where(torch.isfinite(corr), s + corr, a * b + c)


# ---- plain-math derivative rules of the four primitives above (the JAX
# package's custom JVPs, craytpu/ops/vecmath.py:186-212, transposed). The
# exact forward forms exist for bit parity; their derivatives need no such
# exactness, and autograd through the Dekker/2Sum bodies would give other
# gradients and NaNs from the masked fallbacks. The Function is taken only
# when grad mode is on and an input requires grad, so the forward render
# pays no extra host time per call. ----

def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


# constant tensors by (values, device, dtype): made at their first use,
# then shared, so that no call copies a constant from the host (a copy
# that a CUDA graph could not capture)
_CONSTS: dict = {}


def const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor of `values` (a number or a tuple of numbers) on
    `device`, made once. Callers must not write to it."""
    key = (values, torch.device(device), dtype)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTS[key]


def _tensors(*xs):
    """Python scalars as f32 tensors beside the first tensor operand."""
    ref = next(x for x in xs if torch.is_tensor(x))
    return tuple(x if torch.is_tensor(x) else const(float(x), ref.device)
                 for x in xs)


def _grads(ctx, gs):
    """Each gradient reduced to its input's broadcast shape (ctx.shapes),
    None for an input that takes none."""
    return tuple(g.sum_to_size(shape) if need else None
                 for need, shape, g in zip(ctx.needs_input_grad, ctx.shapes,
                                           gs))


class _ExactDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        q = _exact_div(a, b)
        ctx.save_for_backward(b, q)
        ctx.shapes = (a.shape, b.shape)
        return q

    @staticmethod
    def backward(ctx, g):
        b, q = ctx.saved_tensors
        ga = g / b
        return _grads(ctx, (ga, q * -ga))


class _ExactSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _exact_sqrt(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g / (s + s)


class _IeeeSqrt(torch.autograd.Function):
    """JAX's sqrt rule, g * (0.5 / ans), in the input's dtype (autograd
    through the float64 root would take the backward in float64)."""
    @staticmethod
    def forward(ctx, x):
        s = _ieee_sqrt(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s.new_tensor(0.5) / s)


class _Fma(torch.autograd.Function):
    """fma_raw (det=False) or det_fma (det=True); d/d(a, b, c) =
    (b, a, 1)."""
    @staticmethod
    def forward(ctx, a, b, c, det):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return _det_fma(a, b, c) if det else _fma_raw(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _grads(ctx, (g * b, a * g, g)) + (None,)


def exact_div(a, b):
    """Correctly-rounded f32 division, bit-identical on every device.

    One exact-residual Newton step over the hardware divide: q = a/b,
    r = a - q*b computed exactly via _two_prod, then q + r/b. Falls back
    to the raw q when the correction is non-finite (b == 0, infs, or
    Dekker-split overflow at |x| > ~8e34). NaN lanes stay NaN.
    Derivative: (g/b, -g*q/b). Under CRAYTPU_FASTMATH=1 (profiling
    only, not golden-exact): a / b."""
    if _wants_grad(a, b):
        return _ExactDiv.apply(*_tensors(a, b))
    return _exact_div(a, b)


def exact_sqrt(x):
    """Correctly-rounded f32 sqrt: s = sqrt(x), r = x - s*s exact, then
    s + r/(2s). s==0 / inf / NaN fall back to the plain result.
    Derivative: g/(s+s). Under CRAYTPU_FASTMATH=1 (profiling only, not
    golden-exact): sqrt(x)."""
    if _wants_grad(x):
        return _ExactSqrt.apply(x)
    return _exact_sqrt(x)


def ieee_sqrt(x):
    """sqrt(x) correctly rounded on every device (`_ieee_sqrt`), where the
    JAX package calls jnp.sqrt, whose XLA root is correctly rounded;
    the same under CRAYTPU_FASTMATH=1. Derivative: g * (0.5 / sqrt(x)),
    JAX's rule, rounded as JAX rounds it."""
    if _wants_grad(x):
        return _IeeeSqrt.apply(x)
    return _ieee_sqrt(x)


def fma_raw(a, b, c):
    """Unguarded det_fma for bounded intermediates (see _fma_pre).
    Derivative: (g*b, a*g, g). Under CRAYTPU_FASTMATH=1 (profiling
    only, not golden-exact): a * b + c, two roundings."""
    if _wants_grad(a, b, c):
        return _Fma.apply(*_tensors(a, b, c), False)
    return _fma_raw(a, b, c)


def det_fma(a, b, c):
    """Software fused multiply-add: exact product via _two_prod, exact sum
    via Knuth 2Sum, one final rounding. (The final s + (t + e) can double-
    round in rare boundary cases, exactly as in the JAX package, so the
    CUDA kernels must not replace it with a hardware fma.) Non-finite
    corrections fall back to the plain two-rounding chain.
    Derivative: (g*b, a*g, g). Under CRAYTPU_FASTMATH=1 (profiling
    only, not golden-exact): a * b + c, two roundings."""
    if _wants_grad(a, b, c):
        return _Fma.apply(*_tensors(a, b, c), True)
    return _det_fma(a, b, c)


# tables of at most this many rows take their gathers' gradient as a
# one-hot matrix product (the JAX package's K <= 64 rule)
_ONE_HOT_ROWS = 64


class _TakeRows(torch.autograd.Function):
    """table[idx] whose backward avoids the sort-based scatter of
    autograd's index backward, which serialises the duplicates of an
    index: a million lanes that read a few material rows take it tens of
    ms a call on the card. Small tables sum the gradient by a one-hot
    matrix product, large ones by index_add_."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        idx = idx.reshape(-1).long()
        K = ctx.table_shape[0]
        g2 = g.reshape(idx.shape[0], -1)
        if K <= _ONE_HOT_ROWS:
            oh = (idx[:, None] == torch.arange(K, device=idx.device))
            gt = oh.to(g2.dtype).t() @ g2
        else:
            gt = g2.new_zeros(K, g2.shape[1]).index_add_(0, idx, g2)
        return gt.reshape(ctx.table_shape), None


def take_rows(table, idx):
    """table[idx] for a parameter table (materials, colors, texels) and
    per-lane row ids; see _TakeRows."""
    if _wants_grad(table):
        return _TakeRows.apply(table, idx)
    return table[idx]


def dot3_cray(ax, ay, az, bx, by, bz):
    """vecDot exactly as the reference BINARY computes it:
    fma(az, bz, fma(ax, bx, ay*by)). Unguarded (scene-scale operands)."""
    return fma_raw(az, bz, fma_raw(ax, bx, ay * by))


def vdot(a, b):
    return dot3_cray(a[..., 0], a[..., 1], a[..., 2],
                     b[..., 0], b[..., 1], b[..., 2])


def vcross(a, b):
    """Reference-binary rounding: cross_i = fma(a_j, b_k, -(a_k * b_j))."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    hax, lax = _split(ax)
    hay, lay = _split(ay)
    haz, laz = _split(az)
    hbx, lbx = _split(bx)
    hby, lby = _split(by)
    hbz, lbz = _split(bz)
    return torch.stack([
        _fma_pre(ay, hay, lay, bz, hbz, lbz, -(az * by)),
        _fma_pre(az, haz, laz, bx, hbx, lbx, -(ax * bz)),
        _fma_pre(ax, hax, lax, by, hby, lby, -(ay * bx)),
    ], dim=-1)


def vlength(a):
    return exact_sqrt(vdot(a, a))


def vnormalize(a):
    # vector.h:173-176 divides by length (no epsilon guard)
    return exact_div(a, vlength(a)[..., None])


def vreflect(incident, n):
    """vecReflect (vector.h:211-213): reflect_i = fma(-N_i, 2dot, I_i)."""
    dot2 = (vdot(n, incident) * 2.0)[..., None]
    return fma_raw(-n, dot2, incident)


def refract(in_dir, normal, ni_over_nt):
    """refract (vector.h:252-266). Returns (ok, refracted); 1 - dt*dt,
    1 - nn*inner, uv - N*dt and C - N*sq contract to fnmas."""
    uv = vnormalize(in_dir)
    dt = vdot(uv, normal)
    inner = fma_raw(-dt, dt, torch.ones_like(dt))
    nn = ni_over_nt * ni_over_nt
    discriminant = fma_raw(-nn, inner, torch.ones_like(dt))
    ok = discriminant > 0.0
    safe_disc = torch.clamp_min(discriminant, 0.0)
    B = fma_raw(-normal, dt[..., None], uv)
    C = B * ni_over_nt[..., None]
    refracted = fma_raw(-normal, exact_sqrt(safe_disc)[..., None], C)
    return ok, refracted


def schlick(cosine, ior):
    """schlick (vector.h:268-272) with powf(x, 5) as a multiply chain."""
    r0 = exact_div(1.0 - ior, 1.0 + ior)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def random_on_unit_sphere(kind: str, s: smp.SamplerState):
    """randomOnUnitSphere (vector.h:243-249). Consumes 2 dims."""
    sx, s = smp.get_dimension(kind, s)
    sy, s = smp.get_dimension(kind, s)
    a = sx * TWO_PI
    t = torch.clamp_min(sy * (1.0 - sy), 0.0)
    r = 2.0 * exact_sqrt(t)
    # z = 1 - 2*sy contracts to fnma in the reference binary
    return torch.stack([torch.cos(a) * r, torch.sin(a) * r,
                        fma_raw(torch.full_like(sy, -2.0), sy,
                                torch.ones_like(sy))], dim=-1), s


def random_coord_on_unit_disc(kind: str, s: smp.SamplerState):
    """randomCoordOnUnitDisc (vector.h:194-198). Consumes 2 dims."""
    d1, s = smp.get_dimension(kind, s)
    r = exact_sqrt(d1)
    d2, s = smp.get_dimension(kind, s)
    theta = d2 * TWO_PI
    return r * torch.cos(theta), r * torch.sin(theta), s


def triangle_distribution(v):
    """Tent-filter reshaping of a uniform sample (camera.c:50-56)."""
    orig = v * 2.0 - 1.0
    out = exact_div(orig, exact_sqrt(torch.abs(orig)))
    out = torch.clamp(out, -1.0, 1.0)
    sign = torch.where(orig >= 0.0, 1.0, -1.0)
    out = out - sign
    return torch.where(orig == 0.0, -1.0, out)


def mat34_point(A, p):
    """Affine transform of a point: A (..., 3, 4) @ [p, 1], rounded like
    the reference binary's transformPoint:
    out_i = fma(z, Ai2, fma(x, Ai0, y*Ai1)) + Ai3."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    hx, lx = _split(x)
    hz, lz = _split(z)

    def row(i):
        m0, m2 = A[..., i, 0], A[..., i, 2]
        h0, l0 = _split(m0)
        h2, l2 = _split(m2)
        inner = _fma_pre(x, hx, lx, m0, h0, l0, y * A[..., i, 1])
        return _fma_pre(z, hz, lz, m2, h2, l2, inner) + A[..., i, 3]

    return torch.stack([row(0), row(1), row(2)], dim=-1)


def mat33_vec(A, v):
    """Linear transform by A's 3x3 part, transformVector rounding."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    hx, lx = _split(x)
    hz, lz = _split(z)

    def row(i):
        m0, m2 = A[..., i, 0], A[..., i, 2]
        h0, l0 = _split(m0)
        h2, l2 = _split(m2)
        inner = _fma_pre(x, hx, lx, m0, h0, l0, y * A[..., i, 1])
        return _fma_pre(z, hz, lz, m2, h2, l2, inner)

    return torch.stack([row(0), row(1), row(2)], dim=-1)


def mat33_vec_T(A, v):
    """(A^T) @ v — transformVectorWithTranspose, same rounding pattern."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    hx, lx = _split(x)
    hz, lz = _split(z)

    def col(i):
        m0, m2 = A[..., 0, i], A[..., 2, i]
        h0, l0 = _split(m0)
        h2, l2 = _split(m2)
        inner = _fma_pre(x, hx, lx, m0, h0, l0, y * A[..., 1, i])
        return _fma_pre(z, hz, lz, m2, h2, l2, inner)

    return torch.stack([col(0), col(1), col(2)], dim=-1)


def fmod_floor(x, y):
    """jnp.mod for floats: C fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def wrap_min_max(x, lo: float, hi: float):
    """wrapMinMax (vector.h:215-221)."""
    rng = torch.full_like(x, hi - lo)
    return lo + fmod_floor(rng + fmod_floor(x - lo, rng), rng)


def along_ray(start, direction, t):
    """alongRay (lightray.h): start + dir*t contracts to an fma."""
    return det_fma(direction, t[..., None], start)
