"""Wavefront Monte Carlo path tracer (the integrator), forward render.

The whole frame is one SoA wavefront of rays advancing bounce by bounce,
rendered in fixed-size ray batches ("tiles"). Each bounce: closest hit
(the K2 kernel) -> hit-record resolve (the K1 kernel) -> background and
emission -> node-graph shading -> Russian roulette. After every few
bounces the survivors are sorted by a Morton/octant key and packed into a
smaller power-of-four bucket; radiance scatter-adds back into the batch
buffer by original lane id.

Per-(pixel, pass) semantics match the reference exactly:
  - sampler re-seeded per (pixel, pass): Random/PCG32 in batch mode
    (renderer.c:281), Halton in interactive mode (renderer.c:206)
  - camera ray with tent-filter jitter + optional thin-lens DoF
  - iterative path: closest hit -> add weighted legacy emission ->
    bsdf sample (node graph) -> Russian roulette from depth 4
  - miss adds weighted background and terminates
  - running-average accumulation into a float framebuffer
    (renderer.c:287-294)
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import shading
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.ops.hitrec import make_isect_fn
from craytpu_torch.scene.compile import CompiledScene


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _spread3(x):
    """Space 7 bits out to every 3rd position (a Morton component)."""
    x = (x | (x << 8)) & 0x0100F00F
    x = (x | (x << 4)) & 0x10C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


class WavefrontRenderer:
    """Render pipeline for one compiled scene + sampler kind, on the
    scene's device."""

    def __init__(self, cscene: CompiledScene, kind: str = smp.RANDOM,
                 bounces: int | None = None):
        self.cscene = cscene
        self.kind = kind
        self.device = cscene.device
        self.width = cscene.camera.width
        self.height = cscene.camera.height
        self.max_depth = (bounces if bounces is not None
                          else cscene.prefs.bounces)
        # frames are traced in fixed-size ray batches: bounds live-ray
        # memory (2^20 lanes on the card, 2^18 on the CPU)
        npix = self.width * self.height
        default_rays = 1 << 20 if self.device.type == "cuda" else 1 << 18
        self.tile_rays = min(default_rays, _next_pow2(npix))
        self.cam_fn = cscene.camera_fn(kind)
        self.bg_fn = cscene.background_fn()
        self.bsdf_fns = cscene.bsdf_fns(kind)
        self.empty_scene = cscene.n_instances == 0
        self.isect = make_isect_fn(cscene)
        self._sched = None
        self._compact_consts = None

    # ------------------------------------------------------------------
    def _init_rays(self, xs, ys, pass_idx: int, spp: int):
        """Primary rays and fresh sampler states for pixel coords (the
        JAX package's _make_init_rays)."""
        B = xs.shape[0]
        pix_idx = ys.long() * self.width + xs.long()
        full = lambda v: torch.full((B,), v, dtype=torch.int32,  # noqa: E731
                                    device=xs.device)
        s = smp.init_sampler(self.kind, full(pass_idx), full(spp), pix_idx)
        return self.cam_fn(xs, ys, s)

    def _shade_all(self, params, rec, st, gid):
        """Evaluate every compiled graph on the wavefront and select by
        graph id per lane (the batched analogue of the per-hit node-DAG
        dispatch). Every graph runs on the pre-branch sampler state."""
        B = rec.distance.shape[0]
        out = rec.incident.new_zeros(B, 3)
        col = rec.incident.new_zeros(B, 4)
        s_sel = st
        for gi, fn in enumerate(self.bsdf_fns):
            m = gid == gi
            o_i, c_i, s_i = fn(params, replace(rec, active=m), st)
            out = torch.where(m[..., None], o_i, out)
            col = torch.where(m[..., None], c_i, col)
            s_sel = smp.select_state(m, s_i, s_sel)
        return out, col, s_sel

    def _step(self, o, d, weight, final, s, alive, rr_active):
        """One wavefront bounce (the JAX package's _make_step with
        rr_phase="dynamic", diff=False, nee=False). rr_active: per-lane
        Russian-roulette phase (path depth >= 4)."""
        cs = self.cscene
        params = cs.params
        kind = self.kind
        is_hit, p_w, n_w, uv, mat_id, hit_t = self.isect(cs.geom, o, d,
                                                         alive)
        is_hit = is_hit & alive

        # miss: final += weight * background, terminate (pathtrace.c:39-42)
        bg = self.bg_fn(params, d)
        take_bg = (alive & ~is_hit)[..., None]
        final = torch.where(take_bg, final + weight * bg, final)

        mid = mat_id.long()
        mat_emission = params.emission[mid]
        mat_ior = params.ior[mid]
        # sanitize non-hit lanes: their hit data is garbage (t=FLT_MAX)
        ih = is_hit[..., None]
        n_safe = torch.where(ih, n_w, n_w.new_tensor([0.0, 0.0, 1.0]))
        p_safe = torch.where(ih, p_w, 0.0)
        uv_safe = torch.where(ih, uv, 0.0)
        t_safe = torch.where(is_hit, hit_t, 1.0)
        rec = shading.HitRec(incident=d, normal=n_safe, uv=uv_safe,
                             hit_point=p_safe, distance=t_safe,
                             emission=mat_emission, ior=mat_ior,
                             mat_id=mat_id)
        # hit: final += weight * legacy emission (pathtrace.c:44)
        final = torch.where(ih, final + weight * mat_emission, final)

        # dead/missed lanes match no graph
        gid = torch.where(is_hit, cs.mat_graph[mid], -1)
        out, attenuation, s2 = self._shade_all(params, rec, s, gid)
        s = smp.select_state(is_hit, s2, s)

        maxc = torch.maximum(attenuation[..., 0],
                             torch.maximum(attenuation[..., 1],
                                           attenuation[..., 2]))
        # Russian roulette (pathtrace.c:50-55), gated per lane
        rr_dim, s3 = smp.get_dimension(kind, s)
        s = smp.select_state(is_hit & rr_active, s3, s)
        prob = torch.where(rr_active, maxc, 1.0)
        rr_break = is_hit & rr_active & (rr_dim > prob)

        survive = is_hit & ~rr_break
        # pathtrace.c:57: colorCoef(1/p, att*weight) — reciprocal then
        # multiply, NOT a division (different rounding)
        coef = vm.exact_div(torch.ones_like(prob),
                            torch.clamp_min(prob, 1e-30))[..., None]
        sv = survive[..., None]
        weight = torch.where(sv, (attenuation * weight) * coef, weight)
        o = torch.where(sv, p_w, o)
        d = torch.where(sv, out, d)
        return o, d, weight, final, s, survive

    def _multi_step(self, k, o, d, weight, s, alive, pdepth, final_full,
                    lane):
        """k bounces, then the radiance deltas scatter-add into the batch
        buffer by lane. pdepth is the per-lane path depth."""
        delta = torch.zeros_like(weight)
        for _ in range(k):
            # per-path bounce cap (prefs.bounces)
            alive = alive & (pdepth < self.max_depth)
            o, d, weight, delta, s, alive = self._step(
                o, d, weight, delta, s, alive, pdepth >= 4)
            pdepth = pdepth + 1
        final_full.index_add_(0, lane, delta)
        return o, d, weight, s, alive, pdepth, int(alive.sum())

    def _compact(self, o, d, weight, s, alive, lane, pdepth, Bn: int):
        """Sort the wavefront by a spatial key (dead lanes last, stable)
        and keep the first Bn lanes (the JAX package's _make_compact)."""
        if self._compact_consts is None:
            bb = self.cscene.geom.node_bounds[0].cpu().numpy()
            ext = np.maximum(bb[[1, 3, 5]] - bb[[0, 2, 4]], 1e-6)
            self._compact_consts = (
                torch.tensor(bb[[0, 2, 4]], device=self.device),
                torch.tensor((127.0 / ext).astype(np.float32),
                             device=self.device))
        lo, inv_ext = self._compact_consts
        # clamp to [0, 127] (and mask, so a NaN origin cannot escape the
        # live key range)
        q = torch.clamp((o - lo) * inv_ext, 0.0, 127.0).long() & 0x7F
        octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
                  + 4 * (d[:, 2] < 0).long())
        key = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
               | (_spread3(q[:, 2]) << 2)) | (octant << 21)
        key = torch.where(alive, key, 0xFFFFFFFF)
        order = torch.argsort(key, stable=True)[:Bn]
        return (o[order], d[order], weight[order], s.index(order),
                lane[order], pdepth[order])

    def trace_batch(self, xs, ys, pass_idx: int, spp: int):
        """Trace one pass for a flat batch of pixel coords -> (B, 4)."""
        B = xs.shape[0]
        o, d, s = self._init_rays(xs, ys, pass_idx, spp)
        if self.empty_scene or self.max_depth == 0:
            if self.max_depth == 0:
                return o.new_zeros(B, 4)
            return self.bg_fn(self.cscene.params, d)

        weight = o.new_ones(B, 4)
        final = o.new_zeros(B, 4)
        alive = torch.ones(B, dtype=torch.bool, device=o.device)
        lane = torch.arange(B, device=o.device)
        pdepth = torch.zeros(B, dtype=torch.int32, device=o.device)
        depth = 0
        while depth < self.max_depth:
            Bc = alive.shape[0]
            # more bounces between compactions as the wavefront shrinks
            k = 1 if Bc > 32768 else (4 if Bc > 4096 else 8)
            k = min(k, self.max_depth - depth)
            o, d, weight, s, alive, pdepth, n_alive = self._multi_step(
                k, o, d, weight, s, alive, pdepth, final, lane)
            depth += k
            if n_alive == 0:
                break
            # quarter-step buckets (Bc/4, Bc/16, ...)
            need = max(_next_pow2(n_alive), 1024)
            Bn = Bc
            while Bn // 4 >= need:
                Bn //= 4
            o, d, weight, s, lane, pdepth = self._compact(
                o, d, weight, s, alive, lane, pdepth, Bn)
            alive = torch.arange(Bn, device=o.device) < n_alive
        return final

    @property
    def _pixel_schedule(self):
        """Tile-ordered pixel permutation (xs, ys, flat_idx, T), padded to a
        whole number of fixed-size ray batches. Cached."""
        if self._sched is None:
            from craytpu_torch.runtime.tile import pixel_order
            p = self.cscene.prefs
            xs, ys, _, _ = pixel_order(self.width, self.height, p.tile_width,
                                       p.tile_height, p.tile_order)
            npix = self.width * self.height
            T = min(self.tile_rays, _next_pow2(npix))
            if npix % T:
                pad = T - npix % T
                xs = np.concatenate([xs, np.zeros(pad, np.int32)])
                ys = np.concatenate([ys, np.zeros(pad, np.int32)])
            flat = ys.astype(np.int64) * self.width + xs.astype(np.int64)
            dev = self.device
            self._sched = (torch.tensor(xs, device=dev),
                           torch.tensor(ys, device=dev),
                           torch.tensor(flat, device=dev), T)
        return self._sched

    def render_pass(self, accum, pass_idx: int, spp: int):
        H, W = self.height, self.width
        xs, ys, flat, T = self._pixel_schedule
        sample = accum.new_zeros(H * W, 4)
        for t0 in range(0, xs.shape[0], T):
            chunk = self.trace_batch(xs[t0:t0 + T], ys[t0:t0 + T],
                                     pass_idx, spp)
            # padded lanes re-trace pixel (0,0) with the same per-(pixel,
            # pass) stream, so their duplicate writes carry the same value
            sample[flat[t0:t0 + T]] = chunk
        n = accum.new_tensor(float(pass_idx + 1))
        return (accum * (n - 1.0) + sample.reshape(H, W, 4)) / n

    def render(self, spp: int | None = None, progress=None) -> np.ndarray:
        spp = spp if spp is not None else self.cscene.prefs.sample_count
        accum = torch.zeros((self.height, self.width, 4),
                            dtype=torch.float32, device=self.device)
        for p in range(spp):
            accum = self.render_pass(accum, p, spp)
            if progress is not None:
                progress(p + 1, spp, accum)
        return accum.cpu().numpy()


def render(cscene: CompiledScene, kind: str = smp.RANDOM,
           spp: int | None = None, bounces: int | None = None,
           progress=None) -> np.ndarray:
    """Full render. Returns the float accumulation buffer (H, W, 4), y-up
    like the reference's renderBuffer (row y=0 is the image BOTTOM; the PNG
    writer flips)."""
    return WavefrontRenderer(cscene, kind, bounces).render(spp, progress)
