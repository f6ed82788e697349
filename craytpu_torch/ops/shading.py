"""Material node-graph -> batched PyTorch shading program compiler.

The reference evaluates materials by chasing function-pointer node DAGs per
hit (nodes/*). Here each unique bsdf graph compiles once, at scene-compile
time, into a batched function

    sample(params, rec, state) -> (out_dir (B,3), color (B,4), state)

evaluated per wavefront with per-lane masks. Every node constant lives in
the ShadeParams tables.

Sampler-dimension consumption matches the reference exactly, including
conditional consumption (metal/glass fuzz only when roughness > 0; mix picks
one side): both paths run on the SAME pre-branch state and the taken path's
post-state is selected per lane — precisely the semantics of the C code's
shared sequential stream.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from craytpu_torch.ops import colorops as co
from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import texture as tex
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.scene import nodegraph as ng


@dataclass
class ShadeParams:
    """Material parameter tables."""
    colors: torch.Tensor    # (C, 4)
    values: torch.Tensor    # (V,)
    vecs: torch.Tensor      # (W, 3)
    texels: torch.Tensor    # (R, 4) RGBA texel rows (all textures packed)
    emission: torch.Tensor  # (K, 4) legacy material emission
    ior: torch.Tensor       # (K,) legacy material IOR


@dataclass
class HitRec:
    """hitRecord fields visible to shading (datatypes/hitrecord.h), each
    with a leading batch dimension."""
    incident: torch.Tensor   # (B, 3) ray direction (unnormalized, as in C)
    normal: torch.Tensor     # (B, 3) surface normal (world)
    uv: torch.Tensor         # (B, 2)
    hit_point: torch.Tensor  # (B, 3)
    distance: torch.Tensor   # (B,)
    emission: torch.Tensor   # (B, 4) legacy material emission for this hit
    ior: torch.Tensor        # (B,) legacy material IOR
    mat_id: torch.Tensor     # (B,) i32 global material id (param nodes)
    # (B,) bool or None: lanes whose result this graph evaluation keeps;
    # texture nodes route the others' reads to one row
    active: torch.Tensor | None = None


def dummy_rec(incident):
    B = incident.shape[0]
    z3 = torch.zeros_like(incident)
    z = incident.new_zeros(B)
    return HitRec(incident, z3, incident.new_zeros(B, 2), z3, z,
                  incident.new_zeros(B, 4), incident.new_ones(B),
                  torch.zeros(B, dtype=torch.int32, device=incident.device))


def select_sample(pred, a, b):
    """Per-lane select between two (out, color, state) samples."""
    return (torch.where(pred[..., None], a[0], b[0]),
            torch.where(pred[..., None], a[1], b[1]),
            smp.select_state(pred, a[2], b[2]))


class Registry:
    """Assigns parameter-table slots to IR constants (dedup = hash-consing).
    Tables and the compiled graphs' index tensors live on `device`."""

    def __init__(self, textures, device):
        self.device = device
        self._colors = []
        self._cmap = {}
        self._values = []
        self._vmap = {}
        self._vecs = []
        self._vecmap = {}
        self.tex_meta = []
        self._tex_bufs = []
        offset = 0  # in RGBA rows
        for t in textures:
            h, w, c = t.data.shape
            self.tex_meta.append((offset, w, h, c))
            self._tex_bufs.append(tex.pack_rgba_rows(t.data))
            offset += h * w

    @classmethod
    def from_keys(cls, colors, values, vecs, tex_meta, device):
        """A registry whose slots are already assigned: the constant keys
        in slot order and the texture metadata (as another compile left
        them)."""
        reg = cls([], device)
        for c in colors:
            reg.color_idx(c)
        for v in values:
            reg.value_idx(v)
        for v in vecs:
            reg.vec_idx(v)
        reg.tex_meta = [tuple(int(x) for x in m) for m in tex_meta]
        return reg

    def keys(self) -> dict:
        return {"colors": list(self._colors), "values": list(self._values),
                "vecs": list(self._vecs), "tex_meta": list(self.tex_meta)}

    def tensor(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def color_idx(self, rgba):
        key = tuple(float(x) for x in rgba)
        if key not in self._cmap:
            self._cmap[key] = len(self._colors)
            self._colors.append(key)
        return self._cmap[key]

    def value_idx(self, x):
        key = float(x)
        if key not in self._vmap:
            self._vmap[key] = len(self._values)
            self._values.append(key)
        return self._vmap[key]

    def vec_idx(self, v):
        key = tuple(float(x) for x in v)
        if key not in self._vecmap:
            self._vecmap[key] = len(self._vecs)
            self._vecs.append(key)
        return self._vecmap[key]

    def finalize(self, emission, ior) -> ShadeParams:
        f32 = np.float32
        texels = (np.concatenate(self._tex_bufs) if self._tex_bufs
                  else np.zeros((1, 4), f32))
        return ShadeParams(
            colors=self.tensor(np.asarray(self._colors, f32).reshape(-1, 4)
                               if self._colors else np.zeros((1, 4), f32)),
            values=self.tensor(np.asarray(self._values, f32)
                               if self._values else np.zeros(1, f32)),
            vecs=self.tensor(np.asarray(self._vecs, f32).reshape(-1, 3)
                             if self._vecs else np.zeros((1, 3), f32)),
            texels=self.tensor(texels.astype(f32)),
            emission=self.tensor(np.asarray(emission, f32)),
            ior=self.tensor(np.asarray(ior, f32)),
        )


def _batch(rec: HitRec) -> int:
    return rec.distance.shape[0]


def _zeros(rec):
    return torch.zeros_like(rec.distance)


# --------------------------------------------------------------------------
# color / value / vector node compilers
# --------------------------------------------------------------------------

def compile_color(ir, reg: Registry):
    kind = ir[0]
    if kind == "param_color":
        # per-material indirection: structurally identical graphs compile
        # once and read their constants through mat_id
        tbl = reg.tensor(ir[1]).long()
        return lambda p, rec: vm.take_rows(p.colors, tbl[rec.mat_id.long()])
    if kind == "const_color":
        idx = reg.color_idx(ir[1])
        return lambda p, rec: p.colors[idx].expand(_batch(rec), 4)
    if kind == "image":
        tex_id, options = ir[1], ir[2]
        meta = reg.tex_meta[tex_id]
        no_bilinear = bool(options & ng.NO_BILINEAR)
        srgb = bool(options & ng.SRGB_TRANSFORM)

        def image_fn(p, rec):
            u = rec.uv[..., 0]
            v = rec.uv[..., 1]
            if no_bilinear:
                out = tex.fetch_nearest(p.texels, meta, u * float(meta[1]),
                                        v * float(meta[2]),
                                        active=rec.active)
            else:
                out = tex.fetch_bilinear(p.texels, meta, u, v,
                                         active=rec.active)
            if srgb:
                out = co.color_from_srgb(out)
            return out
        return image_fn
    if kind == "checker":
        a_fn = compile_color(ir[1], reg)
        b_fn = compile_color(ir[2], reg)
        s_fn = compile_value(ir[3], reg)

        def checker_fn(p, rec):
            coef = s_fn(p, rec)
            mapped = (torch.sin(coef * rec.uv[..., 0])
                      * torch.sin(coef * rec.uv[..., 1]))
            world = (torch.sin(coef * rec.hit_point[..., 0])
                     * torch.sin(coef * rec.hit_point[..., 1])
                     * torch.sin(coef * rec.hit_point[..., 2]))
            sines = torch.where(rec.uv[..., 0] >= 0.0, mapped, world)
            return torch.where((sines < 0.0)[..., None],
                               a_fn(p, rec), b_fn(p, rec))
        return checker_fn
    if kind == "gradient":
        d_idx = reg.color_idx(ir[1])
        u_idx = reg.color_idx(ir[2])

        def gradient_fn(p, rec):
            unit = vm.vnormalize(rec.incident)
            t = 0.5 * (unit[..., 1] + 1.0)
            return co.color_lerp(p.colors[d_idx], p.colors[u_idx], t)
        return gradient_fn
    if kind == "combine":
        v_fn = compile_value(ir[1], reg)

        def combine_fn(p, rec):
            v = v_fn(p, rec)
            return torch.stack([v, v, v, torch.ones_like(v)], dim=-1)
        return combine_fn
    if kind == "combine_rgb":
        r_fn = compile_value(ir[1], reg)
        g_fn = compile_value(ir[2], reg)
        b_fn = compile_value(ir[3], reg)

        def combine_rgb_fn(p, rec):
            return torch.stack([r_fn(p, rec), g_fn(p, rec), b_fn(p, rec),
                                torch.ones_like(rec.distance)], dim=-1)
        return combine_rgb_fn
    if kind == "vec_to_color":
        vec_fn = compile_vector(ir[1], reg)

        def v2c(p, rec):
            v, _ = vec_fn(p, rec)
            return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        return v2c
    raise ValueError(f"unknown color node {kind!r}")


def compile_value(ir, reg: Registry):
    kind = ir[0]
    if kind == "param_value":
        tbl = reg.tensor(ir[1]).long()
        return lambda p, rec: vm.take_rows(p.values, tbl[rec.mat_id.long()])
    if kind == "const_value":
        idx = reg.value_idx(ir[1])
        return lambda p, rec: p.values[idx].expand(_batch(rec))
    if kind == "grayscale":
        c_fn = compile_color(ir[1], reg)
        return lambda p, rec: co.grayscale_hsp(c_fn(p, rec))
    if kind == "alpha":
        c_fn = compile_color(ir[1], reg)
        return lambda p, rec: c_fn(p, rec)[..., 3]
    if kind == "raylength":
        return lambda p, rec: rec.distance
    if kind == "fresnel":
        ior_fn = compile_value(ir[1], reg)

        def fresnel_fn(p, rec):
            ior = ior_fn(p, rec)
            d = vm.vdot(rec.incident, rec.normal)
            ln = vm.vlength(rec.incident)
            cosine = torch.where(d > 0.0, ior * d / ln, -(d / ln))
            return vm.schlick(cosine, ior)
        return fresnel_fn
    if kind == "math":
        a_fn = compile_value(ir[1], reg)
        b_fn = compile_value(ir[2], reg)
        op = _MATH_IMPL[ir[3]]
        return lambda p, rec: op(a_fn(p, rec), b_fn(p, rec))
    if kind == "vec_to_value":
        vec_fn = compile_vector(ir[1], reg)
        return lambda p, rec: vec_fn(p, rec)[1]
    raise ValueError(f"unknown value node {kind!r}")


_TO_RAD = float(np.float32(vm.PI) / np.float32(180.0))
_TO_DEG = float(np.float32(180.0) / np.float32(vm.PI))

_MATH_IMPL = {
    "Add": lambda a, b: a + b,
    "Subtract": lambda a, b: a - b,
    "Multiply": lambda a, b: a * b,
    "Divide": lambda a, b: a / b,
    "Power": lambda a, b: torch.pow(a, b),
    "Log": lambda a, b: torch.log10(a),
    "SquareRoot": lambda a, b: vm.ieee_sqrt(a),
    "Absolute": lambda a, b: torch.abs(a),
    "Min": lambda a, b: torch.minimum(a, b),
    "Max": lambda a, b: torch.maximum(a, b),
    "Sine": lambda a, b: torch.sin(a),
    "Cosine": lambda a, b: torch.cos(a),
    "Tangent": lambda a, b: torch.tan(a),
    "ToRadians": lambda a, b: a * _TO_RAD,
    "ToDegrees": lambda a, b: a * _TO_DEG,
}


def compile_vector(ir, reg: Registry):
    """Vector nodes return (vec (B, 3), f (B,)) like struct vectorValue."""
    kind = ir[0]
    if kind == "param_vec":
        tbl = reg.tensor(ir[1]).long()
        return lambda p, rec: (vm.take_rows(p.vecs, tbl[rec.mat_id.long()]),
                               _zeros(rec))
    if kind == "const_vec":
        idx = reg.vec_idx(ir[1])
        return lambda p, rec: (p.vecs[idx].expand(_batch(rec), 3),
                               _zeros(rec))
    if kind == "normal":
        return lambda p, rec: (rec.normal, _zeros(rec))
    if kind == "vec_math":
        a_fn = compile_vector(ir[1], reg)
        b_fn = compile_vector(ir[2], reg)
        op = ir[3]

        def vecmath_fn(p, rec):
            a, _ = a_fn(p, rec)
            b, _ = b_fn(p, rec)
            zero = _zeros(rec)
            z3 = torch.zeros_like(a)
            if op == "VecAdd":
                return a + b, zero
            if op == "VecSubtract":
                return a - b, zero
            if op == "VecMultiply":
                return a * b, zero
            if op == "VecAverage":
                return (a + b) * 0.5, zero
            if op == "VecDot":
                return z3, vm.vdot(a, b)
            if op == "VecCross":
                return vm.vcross(a, b), zero
            if op == "VecNormalize":
                return vm.vnormalize(a), zero
            if op == "VecReflect":
                return vm.vreflect(a, b), zero
            if op == "VecLength":
                return z3, vm.vlength(a)
            if op == "VecAbs":
                return torch.abs(a), zero
            raise ValueError(op)
        return vecmath_fn
    raise ValueError(f"unknown vector node {kind!r}")


# --------------------------------------------------------------------------
# bsdf compilers (batched, mask-select branching)
# --------------------------------------------------------------------------

def _fuzz(fz, rough, d):
    return vm.fma_raw(fz, rough[..., None], d)


def compile_bsdf(ir, reg: Registry, kind: str):
    """Returns sample(params, rec, state) -> (out (B,3), color (B,4), state).

    Branch semantics: both sides evaluate from the same pre-branch sampler
    state; the taken side's post-state is selected per lane (identical to
    the C sequential stream)."""
    node = ir[0]

    if node == "diffuse":
        color_fn = compile_color(ir[1], reg)

        def diffuse_sample(p, rec, s):
            rand, s = vm.random_on_unit_sphere(kind, s)
            out = vm.vnormalize(rec.normal + rand)
            return out, color_fn(p, rec), s
        return diffuse_sample

    if node == "metal":
        color_fn = compile_color(ir[1], reg)
        rough_fn = compile_value(ir[2], reg)

        def metal_sample(p, rec, s):
            refl = vm.vreflect(vm.vnormalize(rec.incident), rec.normal)
            rough = rough_fn(p, rec)
            fz, s_adv = vm.random_on_unit_sphere(kind, s)
            fuzzy = rough > 0.0
            out = torch.where(fuzzy[..., None], _fuzz(fz, rough, refl), refl)
            s = smp.select_state(fuzzy, s_adv, s)
            return out, color_fn(p, rec), s
        return metal_sample

    if node == "glass":
        color_fn = compile_color(ir[1], reg)
        rough_fn = compile_value(ir[2], reg)
        ior_fn = compile_value(ir[3], reg)

        def glass_sample(p, rec, s):
            ior = ior_fn(p, rec)
            refl = vm.vreflect(rec.incident, rec.normal)
            d = vm.vdot(rec.incident, rec.normal)
            ln = vm.vlength(rec.incident)
            entering = d > 0.0
            outward = torch.where(entering[..., None], -rec.normal,
                                  rec.normal)
            ni_over_nt = torch.where(entering, ior,
                                     vm.exact_div(torch.ones_like(ior), ior))
            cosine = torch.where(entering, vm.exact_div(ior * d, ln),
                                 -vm.exact_div(d, ln))
            ok, refr = vm.refract(rec.incident, outward, ni_over_nt)
            refl_prob = torch.where(ok, vm.schlick(cosine, ior), 1.0)
            rough = rough_fn(p, rec)
            fz, s_adv = vm.random_on_unit_sphere(kind, s)
            fuzzy = rough > 0.0
            refl = torch.where(fuzzy[..., None], _fuzz(fz, rough, refl), refl)
            refr = torch.where(fuzzy[..., None], _fuzz(fz, rough, refr), refr)
            s = smp.select_state(fuzzy, s_adv, s)
            dim, s = smp.get_dimension(kind, s)
            out = torch.where((dim < refl_prob)[..., None], refl, refr)
            return out, color_fn(p, rec), s
        return glass_sample

    if node == "plastic":
        color_fn = compile_color(ir[1], reg)
        # plastic's roughness is a constant-black COLOR node (plastic.c:92)
        # and the nested diffuse shares the color node.
        rough_color_fn = compile_color(ng.const_color(ng.BLACK), reg)
        inner_diffuse = compile_bsdf(("diffuse", ir[1]), reg, kind)

        def plastic_sample(p, rec, s):
            d = vm.vdot(rec.incident, rec.normal)
            ln = vm.vlength(rec.incident)
            entering = d > 0.0
            outward = torch.where(entering[..., None], -rec.normal,
                                  rec.normal)
            ni_over_nt = torch.where(entering, rec.ior,
                                     vm.exact_div(torch.ones_like(rec.ior),
                                                  rec.ior))
            cosine = torch.where(entering, vm.exact_div(rec.ior * d, ln),
                                 -vm.exact_div(d, ln))
            ok, _ = vm.refract(rec.incident, outward, ni_over_nt)
            refl_prob = torch.where(ok, vm.schlick(cosine, rec.ior), 1.0)
            dim, s = smp.get_dimension(kind, s)
            take_shiny = dim < refl_prob
            # sampleShiny (plastic.c:42-55)
            refl = vm.vreflect(rec.incident, rec.normal)
            rough = rough_color_fn(p, rec)[..., 0]
            fz, s_fuzz = vm.random_on_unit_sphere(kind, s)
            fuzzy = rough > 0.0
            shiny_out = torch.where(fuzzy[..., None], _fuzz(fz, rough, refl),
                                    refl)
            s_shiny = smp.select_state(fuzzy, s_fuzz, s)
            shiny_col = rec.distance.new_ones(_batch(rec), 4)
            diff = inner_diffuse(p, rec, s)
            return select_sample(take_shiny, (shiny_out, shiny_col, s_shiny),
                                 diff)
        return plastic_sample

    if node == "emissive":
        color_fn = compile_color(ir[1], reg)
        strength_fn = compile_value(ir[2], reg)

        def emissive_sample(p, rec, s):
            rand, s = vm.random_on_unit_sphere(kind, s)
            out = vm.vnormalize(rec.normal + rand)
            c = co.color_coef(strength_fn(p, rec), color_fn(p, rec))
            return out, c, s
        return emissive_sample

    if node == "mix":
        a_fn = compile_bsdf(ir[1], reg, kind)
        b_fn = compile_bsdf(ir[2], reg, kind)
        factor_fn = compile_value(ir[3], reg)

        def mix_sample(p, rec, s):
            lerp = factor_fn(p, rec)
            dim, s = smp.get_dimension(kind, s)
            return select_sample(dim > lerp, a_fn(p, rec, s),
                                 b_fn(p, rec, s))
        return mix_sample

    if node == "add":
        a_fn = compile_bsdf(ir[1], reg, kind)
        b_fn = compile_bsdf(ir[2], reg, kind)

        def add_sample(p, rec, s):
            out_a, col_a, s = a_fn(p, rec, s)
            out_b, col_b, s = b_fn(p, rec, s)
            return out_a + out_b, col_a + col_b, s
        return add_sample

    if node == "transparent":
        color_fn = compile_color(ir[1], reg)

        def transparent_sample(p, rec, s):
            return rec.incident, color_fn(p, rec), s
        return transparent_sample

    if node == "isotropic":
        color_fn = compile_color(ir[1], reg)

        def isotropic_sample(p, rec, s):
            rand, s = vm.random_on_unit_sphere(kind, s)
            return vm.vnormalize(rand), color_fn(p, rec), s
        return isotropic_sample

    if node == "background":
        raise ValueError("background graphs compile via compile_background")

    raise ValueError(f"unknown bsdf node {node!r}")


_HALF_PI = float(np.float32(vm.PI) / np.float32(2.0))


def compile_background(ir, reg: Registry):
    """background.c:39-66: equirect env lookup from the escaped ray dir.

    Returns bg(params, incident_dir (B, 3)) -> color (B, 4).
    Consumes no dims.
    """
    if ir[0] != "background":
        raise ValueError(f"not a background graph: {ir[0]!r}")
    color_fn = compile_color(ir[1], reg)
    strength_fn = compile_value(ir[2], reg)
    offset_fn = compile_value(ir[3], reg)

    def bg(p, incident):
        rec0 = dummy_rec(incident)
        ud = vm.vnormalize(incident)
        phi = (torch.atan2(ud[..., 2], ud[..., 0]) / 4.0
               + offset_fn(p, rec0))
        theta = torch.acos(torch.clamp(-ud[..., 1], -1.0, 1.0))
        u = theta / vm.PI
        v = phi / _HALF_PI
        u = vm.wrap_min_max(u, 0.0, 1.0)
        v = vm.wrap_min_max(v, 0.0, 1.0)
        rec = replace(rec0, uv=torch.stack([v, u], dim=-1))  # background.c:58
        return co.color_coef(strength_fn(p, rec), color_fn(p, rec))
    return bg
