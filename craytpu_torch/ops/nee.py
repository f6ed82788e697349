"""Next-event estimation (explicit light sampling): an optional integrator
mode, off by default (the port of craytpu/ops/nee.py).

The reference integrator is naive unidirectional path tracing
(pathtrace.c:32-60): emitters contribute only when a BSDF-sampled path
happens to hit them. With NEE, at every DIFFUSE vertex one emissive entity
is sampled explicitly (uniform over the light table x uniform over its
area), a shadow ray tests visibility, and the direct-lighting estimate

    L += throughput * (albedo/pi) * Le * cos_s * |cos_l| / d^2 * (n*area)

is accumulated. To stay unbiased without MIS, the legacy-emission add is
suppressed at hits whose PREVIOUS vertex was an NEE-handled diffuse
vertex (models/wavefront_pt.py::_step).

The light pick, the sampled point, the visibility result and all geometry
factors are detached (they are sampling decisions); gradients flow
through Le (params.emission) and the albedo color node. The shadow ray
goes through the step's own isect: K2 (or K3) then K1, with a limit of 0
on lanes that do not shoot. With NEE off nothing here runs and no sampler
dimension is consumed.
"""

from __future__ import annotations

import numpy as np
import torch

from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import shading
from craytpu_torch.ops import vecmath as vm

# the JAX package's f32 constants, rounded as it rounds them
_TWO_PI = float(np.float32(2.0 * 3.14159265))
_INV_PI = float(np.float32(1.0 / 3.14159265))


def make_nee_fn(cscene, kind: str):
    """nee(params, rec, s, is_hit, weight, isect) -> (delta (B, 4), s',
    is_nee_vertex (B,)), or None when the scene has no sampleable emitter
    or no diffuse material."""
    lights = cscene.lights
    if lights is None or not cscene.diffuse_color_ir:
        return None
    L = lights.count
    albedo_fns = {gi: shading.compile_color(ir, cscene.reg)
                  for gi, ir in cscene.diffuse_color_ir.items()}
    mat_graph, mat_nee = cscene.mat_graph, cscene.mat_nee

    def nee(params, rec, s, is_hit, weight, isect):
        mid = rec.mat_id.long()
        active = is_hit & mat_nee[mid]

        # 3 sampler dimensions, consumed only on NEE vertices
        d0, s1 = smp.get_dimension(kind, s)
        d1, s1 = smp.get_dimension(kind, s1)
        d2, s1 = smp.get_dimension(kind, s1)
        s = smp.select_state(active, s1, s)

        li = torch.clamp_max((d0 * float(L)).to(torch.int32), L - 1).long()
        p0, e1, e2 = lights.p0[li], lights.e1[li], lights.e2[li]

        # sample a point: triangle via sqrt warp; sphere via uniform area
        su = vm.ieee_sqrt(torch.clamp_min(d1, 0.0))
        b1 = 1.0 - su
        b2 = d2 * su
        p_tri = p0 + e1 * b1[:, None] + e2 * b2[:, None]
        z = 1.0 - 2.0 * d1
        r_xy = vm.ieee_sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = _TWO_PI * d2
        sph_dir = torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi),
                               z], dim=-1)
        p_sph = p0 + sph_dir * e1[:, 0:1]
        is_sph = (lights.kind[li] == 1)[:, None]
        p_l = torch.where(is_sph, p_sph, p_tri)
        n_light = torch.where(is_sph, sph_dir, lights.n[li])

        to_l = p_l - rec.hit_point
        dist2 = torch.clamp_min(vm.vdot(to_l, to_l), 1e-12)
        dist = vm.ieee_sqrt(dist2)
        wi = to_l / dist[:, None]
        cos_s = vm.vdot(rec.normal, wi)
        cos_l = torch.abs(vm.vdot(n_light, wi))
        shoot = active & (cos_s > 0.0)

        # shadow ray (detached; lanes that do not shoot get a limit of 0)
        eps = dist * 1e-4
        o_sh = rec.hit_point + wi * eps[:, None]
        sh = isect(cscene.geom, o_sh.detach(), wi.detach(), shoot)
        sh_hit, sh_t = sh[0], sh[5]
        visible = shoot & (~sh_hit | (sh_t >= dist * 0.999))

        # diffuse albedo: each diffuse graph's color node, masked per lane
        # (evaluated on every lane: a test for an empty mask would wait
        # for the device)
        gid = mat_graph[mid]
        albedo = torch.zeros_like(weight)
        for gi, fn in albedo_fns.items():
            m = (gid == gi) & active
            albedo = torch.where(m[:, None], fn(params, rec), albedo)

        Le = vm.take_rows(params.emission, lights.mat[li].long())
        geom_term = (torch.clamp_min(cos_s, 0.0) * cos_l / dist2
                     * lights.area[li] * float(L)).detach()
        delta = (weight * albedo * Le
                 * (geom_term * visible.to(weight.dtype))[:, None]
                 * _INV_PI)
        return delta, s, active

    return nee
