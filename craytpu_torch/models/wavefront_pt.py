"""Wavefront Monte Carlo path tracer (the integrator), forward render.

Two ways through a frame, as in the JAX package:

  - render / render_pass (per pass): the frame is one SoA wavefront of
    rays advancing bounce by bounce, traced in fixed-size ray batches
    ("tiles"). Each bounce: closest hit (the K2 kernel) -> hit-record
    resolve (the K1 kernel) -> background and emission -> node-graph
    shading -> Russian roulette. After every few bounces the survivors
    are sorted by a Morton/octant key and packed into a smaller
    power-of-four bucket; radiance scatter-adds back into the batch
    buffer by original lane id.
  - render_persistent (the CLI's path): one persistent pool of tile_rays
    lanes. Dead lanes are replaced by fresh (pixel, pass) primaries from
    a queue over the whole frame and every pass, so every step runs the
    full pool across tile and pass boundaries. It can stop at an
    interrupt and resume from a checkpoint (runtime/checkpoint.py).

And the differentiable trace (make_trace_fn): a fixed-depth trace of one
pass whose image PyTorch's autograd differentiates with respect to the
material tables (ShadeParams) and, optionally, the packed triangle rows.
The closest-hit search stays detached (the detached-sampling estimator);
a compaction schedule (census_schedule) packs the live lanes as the
wavefront shrinks, and remat recomputes bounces in the backward pass
instead of keeping their residuals.

Next-event estimation (nee=True, ops/nee.py) runs in every path: the
per-lane "previous vertex was NEE-handled" flag rides in bit 16 of the
pool's path depth (depths are < 2^16).

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

import os
import sys
import time
from dataclasses import dataclass, fields, replace

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import shading
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.ops.hitrec import Isect
from craytpu_torch.ops.nee import make_nee_fn
from craytpu_torch.runtime.checkpoint import GidQueue
from craytpu_torch.scene.compile import CompiledScene
from craytpu_torch.utils.torchsetup import debug_enabled


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


def _spread3_10(x):
    """Space 10 bits out to every 3rd position (the pool's Morton
    component)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


@dataclass
class Pool:
    """Per-lane state of the persistent wavefront (B lanes)."""
    o: torch.Tensor        # (B, 3) f32 ray origin
    d: torch.Tensor        # (B, 3) f32 ray direction
    weight: torch.Tensor   # (B, 4) f32 path throughput
    s: smp.SamplerState
    alive: torch.Tensor    # (B,) bool
    lane: torch.Tensor     # (B,) i32 flat pixel id of the path
    lpass: torch.Tensor    # (B,) i32 pass of the path
    pdepth: torch.Tensor   # (B,) i32 path depth
    delta: torch.Tensor    # (B, 4) f32 radiance not yet flushed


def _set_tail(pool: Pool, start: int, fresh: Pool) -> None:
    """Overwrite lanes [start, B) of every pool tensor with `fresh`."""
    for f in fields(Pool):
        a, b = getattr(pool, f.name), getattr(fresh, f.name)
        if f.name == "s":
            for g in fields(a):
                getattr(a, g.name)[start:] = getattr(b, g.name)
        else:
            a[start:] = b


def _count_to_host(n: torch.Tensor):
    """Start copying a live count to the host without waiting for it: on
    CUDA into pinned memory behind an event. Read it with _count_value."""
    if n.device.type != "cuda":
        return n, None
    buf = torch.empty((), dtype=n.dtype, pin_memory=True)
    buf.copy_(n, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return buf, ev


def _count_value(handle) -> int:
    buf, ev = handle
    if ev is not None:
        ev.synchronize()
    return int(buf)


class _PoolStats:
    """CRAYTPU_POOL_STATS=1: the persistent loop's accounting (the JAX
    package's, wavefront_pt.py:1369-1390 and :1601-1620): pool steps,
    refills and shrinks, average occupancy and lane-bounces a path, and a
    histogram of dispatches by kind and width. Occupancy is the lagged
    live count, an upper bound. CRAYTPU_POOL_SYNC=1 (profiling only) adds
    each phase's wall time: the device is synchronised after every
    dispatch, and the time from before the dispatch to the end of the
    synchronisation counts, so the host's launch time is in it. The sync
    stops the pipelining, so a frame under it is not a speed figure."""

    def __init__(self, on: bool, sync: bool, device):
        self.on = on
        self.sync = on and sync
        self.device = device
        self.count = {"step": 0, "refill": 0, "shrink": 0}
        self.wall = {"step": 0.0, "refill": 0.0, "shrink": 0.0}
        self.hist: dict = {}
        self.occ_sum = 0
        self.lane_bounces = 0
        self.t_start = time.perf_counter()
        self._t0 = 0.0

    def start(self) -> None:
        """Before a dispatch."""
        if self.sync:
            self._t0 = time.perf_counter()

    def add(self, phase: str, key, n: int = 1, live: int = 0,
            k: int = 0) -> None:
        """After the dispatch of n `phase`s (step, refill or shrink); a
        step of k bounces over `live` lanes adds to occupancy. Under
        CRAYTPU_POOL_SYNC, synchronise and add its wall time."""
        if not self.on:
            return
        self.count[phase] += n
        self.hist[key] = self.hist.get(key, 0) + n
        self.occ_sum += live
        self.lane_bounces += live * k
        if not self.sync:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self.wall[phase] += dt
        skey = key + ("s",)
        self.hist[skey] = self.hist.get(skey, 0.0) + dt

    def report(self, B: int, total: int) -> dict:
        """Print the report to stderr; return it as a dict."""
        wall = time.perf_counter() - self.t_start
        n_steps = max(self.count["step"], 1)
        out = {"wall_s": wall, "steps": self.count["step"],
               "refills": self.count["refill"],
               "shrinks": self.count["shrink"],
               "occupancy": self.occ_sum / n_steps / B,
               "lane_bounces": self.lane_bounces,
               "bounces_per_path": self.lane_bounces / max(total, 1),
               "hist": dict(self.hist)}
        print(f"pool stats: {wall:.2f}s wall, {out['steps']} step "
              f"dispatches (avg occupancy {out['occupancy']:.2f}), "
              f"{out['refills']} refills, {out['shrinks']} shrinks, "
              f"{self.lane_bounces / 1e6:.1f}M lane-bounces "
              f"({out['bounces_per_path']:.2f}/path)", file=sys.stderr)
        if self.sync:
            out["phase_wall_s"] = dict(self.wall)
            print(f"  phase wall: step {self.wall['step']:.2f}s  refill "
                  f"{self.wall['refill']:.2f}s  shrink "
                  f"{self.wall['shrink']:.2f}s", file=sys.stderr)
        for hk in sorted(self.hist, key=str):
            v = self.hist[hk]
            print(f"  {hk}: " + (f"{v:.3f}s" if isinstance(v, float)
                                 else str(v)), file=sys.stderr)
        return out


class WavefrontRenderer:
    """Render pipeline for one compiled scene + sampler kind, on the
    scene's device."""

    # the drain runs as one loop of 8-bounce steps, checking for live
    # lanes once a step, once the pool is at most this wide
    DRAIN_DEV_MAX = 262144

    # sort="boundary" adds a sort point every this many bounces inside a
    # compaction segment (the JAX package's CRAYTPU_TRACE_SORT_EVERY
    # default)
    TRACE_SORT_EVERY = 3

    def __init__(self, cscene: CompiledScene, kind: str = smp.RANDOM,
                 bounces: int | None = None, tile_rays: int | None = None,
                 nee: bool = False):
        self.cscene = cscene
        self.kind = kind
        # next-event estimation in render, render_pass, trace_batch and
        # render_persistent (make_trace_fn takes its own flag)
        self.nee = bool(nee)
        self.nee_fn = make_nee_fn(cscene, kind)
        self.device = cscene.device
        self.width = cscene.camera.width
        self.height = cscene.camera.height
        self.max_depth = (bounces if bounces is not None
                          else cscene.prefs.bounces)
        # frames are traced in fixed-size ray batches (and the persistent
        # pool holds this many lanes): bounds live-ray memory (2^20 lanes
        # on the card, 2^18 on the CPU)
        npix = self.width * self.height
        default_rays = 1 << 20 if self.device.type == "cuda" else 1 << 18
        self.tile_rays = int(tile_rays
                             or os.environ.get("CRAYTPU_TILE_RAYS", 0)
                             or min(default_rays, _next_pow2(npix)))
        self.cam_fn = cscene.camera_fn(kind)
        self.bg_fn = cscene.background_fn()
        self.bsdf_fns = cscene.bsdf_fns(kind)
        self.empty_scene = cscene.n_instances == 0
        self.isect = Isect(cscene)
        # CRAYTPU_DEBUG: every bounce step checks its outputs (_check_finite)
        self._debug = debug_enabled()
        # the last render_persistent's accounting under CRAYTPU_POOL_STATS
        self.pool_stats = None
        self._sched = None
        self._sched_np = None
        self._sched_dev_t = None
        self._key_consts = {}

    # ------------------------------------------------------------------
    def _init_rays(self, xs, ys, pass_idx, spp: int):
        """Primary rays and fresh sampler states for pixel coords (the
        JAX package's _make_init_rays). pass_idx: an int, or a (B,)
        tensor of one pass per lane."""
        B = xs.shape[0]
        pix_idx = ys.long() * self.width + xs.long()
        full = lambda v: torch.full((B,), v, dtype=torch.int32,  # noqa: E731
                                    device=xs.device)
        if not torch.is_tensor(pass_idx):
            pass_idx = full(pass_idx)
        s = smp.init_sampler(self.kind, pass_idx, full(spp), pix_idx)
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

    def _step(self, o, d, weight, final, s, alive, rr_active,
              prev_nee=None, params=None, isect=None, bounce=None):
        """One wavefront bounce (the JAX package's _make_step with
        rr_phase="dynamic"). rr_active: per-lane (or 0-d) Russian-roulette
        phase (path depth >= 4). prev_nee: the per-lane flag of next-event
        estimation (None: NEE off); with it the step returns the flag for
        the next bounce as a 7th output. params: the material tables to
        differentiate (default: the scene's). isect: the closest-hit +
        record function (default: the renderer's; make_trace_fn passes the
        vertex-differentiable one, or one that replays saved searches).
        bounce: the path depth of this bounce (an int, or a per-lane
        tensor), named by debug mode's error."""
        cs = self.cscene
        params = cs.params if params is None else params
        isect = self.isect if isect is None else isect
        kind = self.kind
        # the search takes detached rays (a discrete walk has no
        # gradient); gradients flow through the throughput chain
        is_hit, p_w, n_w, uv, mat_id, hit_t = isect(cs.geom, o.detach(),
                                                    d.detach(), alive)
        is_hit = is_hit & alive

        # miss: final += weight * background, terminate (pathtrace.c:39-42)
        bg = self.bg_fn(params, d)
        take_bg = (alive & ~is_hit)[..., None]
        final = torch.where(take_bg, final + weight * bg, final)

        mid = mat_id.long()
        mat_emission = vm.take_rows(params.emission, mid)
        mat_ior = vm.take_rows(params.ior, mid)
        # sanitize non-hit lanes: their hit data is garbage (t=FLT_MAX), and
        # a NaN in an untaken torch.where branch poisons the backward pass
        ih = is_hit[..., None]
        n_safe = torch.where(ih, n_w, n_w.new_tensor([0.0, 0.0, 1.0]))
        p_safe = torch.where(ih, p_w, 0.0)
        uv_safe = torch.where(ih, uv, 0.0)
        t_safe = torch.where(is_hit, hit_t, 1.0)
        rec = shading.HitRec(incident=d, normal=n_safe, uv=uv_safe,
                             hit_point=p_safe, distance=t_safe,
                             emission=mat_emission, ior=mat_ior,
                             mat_id=mat_id)
        # hit: final += weight * legacy emission (pathtrace.c:44). With NEE
        # on, a hit after an NEE-handled diffuse vertex got its direct
        # light from the shadow ray: its emission is suppressed, for the
        # emitters the light table samples
        nee_fn = self.nee_fn if prev_nee is not None else None
        emit_ok = is_hit
        if nee_fn is not None:
            emit_ok = is_hit & ~(prev_nee & cs.lights_mat_mask[mid])
        final = torch.where(emit_ok[..., None], final + weight * mat_emission,
                            final)
        if nee_fn is not None:
            delta_nee, s, is_nee_v = nee_fn(params, rec, s, is_hit, weight,
                                            isect)
            final = final + delta_nee

        # dead/missed lanes match no graph
        gid = torch.where(is_hit, cs.mat_graph[mid], -1)
        out, attenuation, s2 = self._shade_all(params, rec, s, gid)
        s = smp.select_state(is_hit, s2, s)

        # the survival probability is a sampling decision, not a value the
        # estimator differentiates
        maxc = torch.maximum(attenuation[..., 0],
                             torch.maximum(attenuation[..., 1],
                                           attenuation[..., 2])).detach()
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
        if self._debug:
            self._check_finite(bounce, survive, weight, final, d)
        if prev_nee is None:
            return o, d, weight, final, s, survive
        # NEE requested but no sampleable light table: the plain step with
        # the NEE signature
        nee_v = (is_nee_v & survive if nee_fn is not None
                 else torch.zeros_like(survive))
        return o, d, weight, final, s, survive, nee_v

    @staticmethod
    def _check_finite(bounce, survive, weight, final, d) -> None:
        """Debug mode's checks of one bounce's outputs (the JAX package's
        checkify checks and jax_debug_nans): raise if a surviving path's
        throughput or scattered direction, or any lane's radiance, is not
        finite. One host sync a bounce."""
        sv = survive[..., None]
        bad = torch.stack([(sv & ~torch.isfinite(weight)).any(-1),
                           (~torch.isfinite(final)).any(-1),
                           (sv & ~torch.isfinite(d)).any(-1)])
        if not bool(bad.any()):
            return
        what = ("path weight (bsdf output, attenuation or Russian-roulette "
                "divisor)", "accumulated radiance (emission or background)",
                "scattered direction out of a bsdf")
        for name, b in zip(what, bad):
            if bool(b.any()):
                i = int(torch.nonzero(b)[0, 0])
                depth = int(bounce[i]) if torch.is_tensor(bounce) else bounce
                raise FloatingPointError(
                    f"non-finite {name} after bounce {depth}: "
                    f"{int(b.sum())} lane(s), first lane {i} (CRAYTPU_DEBUG)")

    def _bounces(self, k, o, d, weight, delta, s, alive, pdepth):
        """k bounces; radiance sums into the per-lane delta. pdepth is the
        per-lane path depth: the per-path bounce cap (prefs.bounces) and
        the Russian-roulette phase follow each path's own depth. With NEE,
        bit 16 of pdepth carries the previous vertex's NEE flag."""
        for _ in range(k):
            if self.nee:
                depth = pdepth & 0xFFFF
                alive = alive & (depth < self.max_depth)
                o, d, weight, delta, s, alive, prev = self._step(
                    o, d, weight, delta, s, alive, depth >= 4,
                    (pdepth >> 16) > 0, bounce=depth)
                pdepth = (depth + 1) | (prev.to(torch.int32) << 16)
                continue
            alive = alive & (pdepth < self.max_depth)
            o, d, weight, delta, s, alive = self._step(
                o, d, weight, delta, s, alive, pdepth >= 4, bounce=pdepth)
            pdepth = pdepth + 1
        return o, d, weight, delta, s, alive, pdepth

    def _multi_step(self, k, o, d, weight, s, alive, pdepth, final_full,
                    lane):
        """k bounces, then the radiance deltas scatter-add into the batch
        buffer by lane."""
        o, d, weight, delta, s, alive, pdepth = self._bounces(
            k, o, d, weight, torch.zeros_like(weight), s, alive, pdepth)
        final_full.index_add_(0, lane, delta)
        return o, d, weight, s, alive, pdepth, int(alive.sum())

    def _key_consts_for(self, top: float):
        """(lo, top / extent) of the scene's root box, f32 on the device:
        quantises an origin to [0, top] per axis. Cached per `top`."""
        if top not in self._key_consts:
            bb = self.cscene.geom.node_bounds[0].cpu().numpy()
            ext = np.maximum(bb[[1, 3, 5]] - bb[[0, 2, 4]], 1e-6)
            self._key_consts[top] = (
                torch.tensor(bb[[0, 2, 4]], device=self.device),
                torch.tensor((top / ext).astype(np.float32),
                             device=self.device))
        return self._key_consts[top]

    def _compact(self, o, d, weight, s, alive, lane, pdepth, Bn: int):
        """Sort the wavefront by a spatial key (dead lanes last, stable)
        and keep the first Bn lanes (the JAX package's _make_compact)."""
        lo, inv_ext = self._key_consts_for(127.0)
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

    # ------------------------------------------------------------------
    # the differentiable trace
    # ------------------------------------------------------------------
    def _rr_flags(self):
        """0-d bool tensors (off, on) of the Russian-roulette phase, made
        on the device (no host-to-device copy a bounce)."""
        off = torch.zeros((), dtype=torch.bool, device=self.device)
        return off, ~off

    def census_schedule(self, xs, ys, spp: int = 4,
                        depth: int | None = None, safety: float = 1.3,
                        min_width: int = 1024, passes=None,
                        quant: int | None = None,
                        shrink_ratio: float = 1.0):
        """Measure live-lane counts per bounce depth with the forward
        integrator and derive a conservative compaction schedule
        [(start_depth, width), ...] for make_trace_fn(compaction=...).

        Widths are next-pow2(max live over the probed passes x safety), or
        with `quant` a multiple of quant, at least min_width and at most
        the batch. A boundary is kept only where the width falls below
        shrink_ratio x the current one. The sample streams are pure
        functions of (pass, spp, pixel), so a probe of exactly the passes
        a trace renders is a true bound for the same params; in an
        optimisation loop whose params change, keep safety >= 1.3. The
        trace poisons its result with NaN if live lanes ever exceed a
        width, rather than dropping paths."""
        depth = depth if depth is not None else self.max_depth
        B = xs.shape[0]
        off, on = self._rr_flags()
        max_live = np.zeros(depth, np.int64)
        with torch.no_grad():
            for p in (range(spp) if passes is None else passes):
                o, d, s = self._init_rays(xs, ys, int(p), int(spp))
                weight = o.new_ones(B, 4)
                final = o.new_zeros(B, 4)
                alive = torch.ones(B, dtype=torch.bool, device=o.device)
                for k in range(depth):
                    o, d, weight, final, s, alive = self._step(
                        o, d, weight, final, s, alive, on if k >= 4 else off,
                        bounce=k)
                    n = int(alive.sum())
                    max_live[k] = max(max_live[k], n)
                    if n == 0:
                        break
        sched = [(0, B)]
        for k in range(depth):
            need = max(int(max_live[k] * safety), min_width)
            if quant:
                need = -(-need // quant) * quant
            else:
                need = _next_pow2(need)
            need = min(need, B)
            # a boundary costs a sort or partition and a gather of every
            # lane at the current width: shrink only where it buys enough
            if need < sched[-1][1] * shrink_ratio:
                sched.append((k + 1, need))
        return sched

    def make_trace_fn(self, depth: int | None = None,
                      diff_geometry: bool = False, remat=False,
                      nee: bool = False, compaction=None, sort=False):
        """A differentiable fixed-depth trace of one pass:
        trace(params, xs, ys, pass_idx, spp) -> (B, 4) radiance, where
        params is a ShadeParams whose tensors may require grad.
        diff_geometry=True returns trace(params, tri_packed, xs, ys,
        pass_idx, spp) instead, whose gradient also reaches the packed
        triangle rows (130,560 x 12 on stress_highpoly): the search stays
        on the scene's geometry, the winners' records recompute from
        tri_packed (ops/hitrec.py::Isect).

        compaction: a schedule [(start_depth, width), ...] (from
        census_schedule): from each start depth the wavefront runs at that
        width, packed live-first (a stable order); radiance flushes into
        the full-width buffer by lane id (index_add). If live lanes exceed
        a width the result is NaN. Without a schedule every bounce runs at
        full width.
        sort: with a schedule, True re-sorts the live wavefront by the
        Morton/octant key before every bounce; "boundary" sorts at each
        boundary and every TRACE_SORT_EVERY bounces inside a segment.
        Neither changes the image or the gradients beyond summation order.
        remat: False keeps every bounce's residuals for the backward pass;
        True recomputes each bounce; "segment" each segment (one bounce
        without a schedule); "segment_hits" likewise, but the recompute
        replays the forward's closest-hit searches and records instead of
        launching K2 and K1 again (torch.utils.checkpoint, non-reentrant;
        the sampler is explicit PCG state, so a recompute is exact).
        nee: next-event estimation (ops/nee.py)."""
        depth = depth if depth is not None else self.max_depth
        if remat not in (False, True, "segment", "segment_hits"):
            raise ValueError(f"remat={remat!r}: one of False, True, "
                             "'segment', 'segment_hits'")
        if sort not in (False, True, "boundary"):
            raise ValueError(f"sort={sort!r}: one of False, True, "
                             "'boundary'")
        if sort and not compaction:
            raise ValueError(f"sort={sort!r} sorts the compacted wavefront "
                             "and needs a compaction schedule")
        cs = self.cscene

        def _trace(params, tri_packed, xs, ys, pass_idx, spp):
            B = xs.shape[0]
            o, d, s = self._init_rays(xs, ys, int(pass_idx), int(spp))
            if self.empty_scene or depth == 0:
                if depth == 0:
                    return o.new_zeros(B, 4)
                return self.bg_fn(params, d)
            isect = (self.isect if tri_packed is None
                     else Isect(cs, tri_packed))
            weight = o.new_ones(B, 4)
            final = o.new_zeros(B, 4)
            alive = torch.ones(B, dtype=torch.bool, device=o.device)
            prev = torch.zeros_like(alive) if nee else None
            run = _TraceRun(self, params, isect, depth, nee, remat, sort)
            if compaction:
                return run.compacted(compaction, o, d, weight, s, alive,
                                     prev)
            return run.plain(o, d, weight, final, s, alive, prev)

        if diff_geometry:
            return _trace

        def trace(params, xs, ys, pass_idx, spp):
            return _trace(params, None, xs, ys, pass_idx, spp)
        return trace

    def trace_rays_fn(self, depth: int | None = None):
        """trace_rays(params, o, d, s) -> (B, 4) radiance for explicit rays
        and sampler states (no camera), fixed depth, differentiable in
        params: the edge-gradient estimator's side evaluations."""
        depth = depth if depth is not None else self.max_depth

        def trace_rays(params, o, d, s):
            B = o.shape[0]
            alive = torch.ones(B, dtype=torch.bool, device=o.device)
            run = _TraceRun(self, params, self.isect, depth, False, False,
                            False)
            return run.plain(o, d, o.new_ones(B, 4), o.new_zeros(B, 4), s,
                             alive, None)
        return trace_rays

    @property
    def _sched_host(self):
        """Tile-ordered pixel coordinates (xs, ys) of the frame: numpy
        int32, one entry per pixel. Cached."""
        if self._sched_np is None:
            from craytpu_torch.runtime.tile import pixel_order
            p = self.cscene.prefs
            xs, ys, _, _ = pixel_order(self.width, self.height, p.tile_width,
                                       p.tile_height, p.tile_order)
            self._sched_np = (xs, ys)
        return self._sched_np

    @property
    def _pixel_schedule(self):
        """Tile-ordered pixel permutation (xs, ys, flat_idx, T), padded to a
        whole number of fixed-size ray batches. Cached."""
        if self._sched is None:
            xs, ys = self._sched_host
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

    def render(self, spp: int | None = None, progress=None,
               stop=None) -> np.ndarray:
        """Per-pass frame -> (H, W, 4) running mean on the host.
        progress(pass_done, spp, accum) after each pass; stop(), when
        given, is asked after each pass and ends the frame early (the
        mean of the passes done) when it returns True."""
        spp = spp if spp is not None else self.cscene.prefs.sample_count
        accum = torch.zeros((self.height, self.width, 4),
                            dtype=torch.float32, device=self.device)
        for p in range(spp):
            accum = self.render_pass(accum, p, spp)
            if progress is not None:
                progress(p + 1, spp, accum)
            if stop is not None and stop():
                break
        return accum.cpu().numpy()

    # ------------------------------------------------------------------
    # persistent wavefront: the pool stays full across tiles AND passes
    # ------------------------------------------------------------------
    def _pool_step(self, k: int, pool: Pool):
        """k bounces over the persistent pool. Radiance sums into the
        per-lane delta (flushed to the framebuffer only at refill and
        shrink boundaries). Returns (pool, live count as a device tensor);
        nothing here waits for the device."""
        o, d, weight, delta, s, alive, pdepth = self._bounces(
            k, pool.o, pool.d, pool.weight, pool.delta, pool.s, pool.alive,
            pool.pdepth)
        return (Pool(o, d, weight, s, alive, pool.lane, pool.lpass, pdepth,
                     delta), alive.sum())

    @property
    def _sched_dev(self):
        """Device-resident pixel schedule: (npix, 4) i32 rows
        [x, y, flat_pixel_id, 0] in tile order (one gather serves a whole
        refill)."""
        if self._sched_dev_t is None:
            xs, ys = self._sched_host
            flat = (ys.astype(np.int64) * self.width + xs).astype(np.int32)
            self._sched_dev_t = torch.tensor(
                np.stack([xs, ys, flat, np.zeros_like(xs)], axis=1),
                device=self.device)
        return self._sched_dev_t

    def _fresh_pool(self, o, d, s, lane, lpass, alive) -> Pool:
        """Lanes of fresh primaries: unit throughput, depth 0, no
        radiance yet. lane and lpass are int32."""
        n = o.shape[0]
        return Pool(o, d, o.new_ones(n, 4), s, alive, lane.contiguous(),
                    lpass, torch.zeros(n, dtype=torch.int32, device=o.device),
                    o.new_zeros(n, 4))

    def _prime_dev(self, B: int, qpix: int, qpass: int, take_n: int,
                   spp: int) -> Pool:
        """B fresh primaries generated on the device for the queue entries
        from (pass qpass, schedule index qpix) on; lanes at or past take_n
        are dead. The initial pool fill, and the fresh block of every
        contiguous-range refill."""
        npix = self.width * self.height
        i = torch.arange(B, dtype=torch.int32, device=self.device)
        px_i = i + qpix
        fpass = px_i // npix + qpass
        rows = self._sched_dev[px_i % npix]
        o, d, s = self._init_rays(rows[:, 0], rows[:, 1], fpass, spp)
        return self._fresh_pool(o, d, s, rows[:, 2], fpass, i < take_n)

    def _morton_key(self, o, d, alive):
        """Spatial+octant sort key of the pool: octant-major, then a
        9-bit/axis Morton code of the quantised origin. int64 keys holding
        uint32 values; dead lanes get 0xFFFFFFFF, so a stable argsort is
        also the alive-first pack."""
        lo, inv_ext = self._key_consts_for(511.0)
        # clamp to [0, 511] (and mask, so a NaN origin cannot escape the
        # live key range)
        q = torch.clamp((o - lo) * inv_ext, 0.0, 511.0).long() & 0x1FF
        octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
                  + 4 * (d[:, 2] < 0).long())
        key = (_spread3_10(q[:, 0]) | (_spread3_10(q[:, 1]) << 1)
               | (_spread3_10(q[:, 2]) << 2)) | (octant << 27)
        return torch.where(alive, key, 0xFFFFFFFF)

    def _permute_pool(self, order, pool: Pool) -> Pool:
        """Gather every pool tensor by a lane permutation (or a prefix of
        one). Each result is a new contiguous tensor, as K2/K1 need."""
        return Pool(pool.o[order], pool.d[order], pool.weight[order],
                    pool.s.index(order), pool.alive[order], pool.lane[order],
                    pool.lpass[order], pool.pdepth[order],
                    pool.delta[order])

    def _flush_pack(self, B: int, n: int, final, pool: Pool) -> Pool:
        """Morton-sort the pool (dead lanes last), then flush the radiance
        of the last n lanes, which are dead (n_alive <= B - n by the
        lagged live count), into the framebuffer sum `final`."""
        order = torch.argsort(self._morton_key(pool.o, pool.d, pool.alive),
                              stable=True)
        pool = self._permute_pool(order, pool)
        final.index_add_(0, pool.lane[B - n:], pool.delta[B - n:])
        return pool

    def _flush_pack_refill(self, B: int, m: int, Q: int, final, pool: Pool,
                           qpix: int, qpass: int, take_n: int,
                           spp: int) -> Pool:
        """At a refill boundary:
          1. Morton/octant sort the pool (dead lanes last): spatially
             coherent rays keep K2's walks short on bounced rays
          2. add the radiance deltas of ONLY the dead tail lanes being
             overwritten by fresh rays into `final` (in place). Live lanes
             keep their partial sums so an interrupt checkpoint can
             re-enqueue them without double counting; other dead lanes
             ride until a later refill overwrites them.
          3. generate m*Q fresh primaries on the device from the queue
             position (no host round trip) and put them in the tail.
        """
        pool = self._flush_pack(B, m * Q, final, pool)
        _set_tail(pool, B - m * Q,
                  self._prime_dev(m * Q, qpix, qpass, take_n, spp))
        return pool

    def _flush_pack_refill_host(self, B: int, m: int, Q: int, final,
                                pool: Pool, fresh: Pool) -> Pool:
        """Like _flush_pack_refill but takes host-prepared fresh rays —
        used only when resuming with re-enqueued pending paths (whose ids
        are not a contiguous queue range)."""
        pool = self._flush_pack(B, m * Q, final, pool)
        _set_tail(pool, B - m * Q, fresh)
        return pool

    def _final_flush(self, final, pool: Pool) -> None:
        """Add the radiance of every DEAD lane into `final` (in place).
        Live lanes are in-flight paths whose partial sums must not reach
        the framebuffer: an interrupt checkpoint re-enqueues them."""
        final.index_add_(0, pool.lane,
                         torch.where(pool.alive[:, None], 0.0, pool.delta))

    def _pack_shrink(self, Bn: int, final, pool: Pool) -> Pool:
        """Flush dead lanes' radiance, Morton-sorted alive-first pack,
        then truncate the pool to Bn lanes (drain phase). The flush must
        happen HERE: truncation drops dead lanes."""
        self._final_flush(final, pool)
        delta = torch.where(pool.alive[:, None], pool.delta, 0.0)
        order = torch.argsort(self._morton_key(pool.o, pool.d, pool.alive),
                              stable=True)[:Bn]
        return self._permute_pool(order, replace(pool, delta=delta))

    def _drain_all(self, pool: Pool) -> tuple:
        """Run the pool to extinction: steps of 8 bounces until no lane
        is alive, checked once a step. A step changes nothing for a dead
        lane (its radiance, throughput, ray and sampler are all masked),
        so the extra bounces of the last step do not change the image.
        Returns (pool, the number of steps)."""
        n = 0
        while True:
            pool, _ = self._pool_step(8, pool)
            n += 1
            if not bool(pool.alive.any()):
                return pool, n

    def render_persistent(self, spp: int | None = None, progress=None,
                          resume=None, interrupt=None, on_frame=None,
                          fetch=True):
        """Full render as ONE persistent wavefront: a fixed pool of
        tile_rays lanes; dead lanes are replaced by fresh (pixel, pass)
        primaries from the queue, so every step runs the full pool across
        tile and pass boundaries (no per-pass drain). Same per-(pixel,
        pass) streams as render(), same result up to float accumulation
        order.

        The host loop is PIPELINED: the live count of step i is copied to
        the host asynchronously and read one step late, so the host never
        waits for the device between steps. The lagged count only ever
        overestimates the live set, so refill decisions stay safe.

        resume: optional dict from a persistent checkpoint
        (runtime/checkpoint.py): {final_sum (npix,4), pending, ranges}
        where pending is an (n,) int64 array of in-flight queue ids to
        re-trace and ranges the untaken queue.
        interrupt: optional callable polled once per step; when it
        returns True the render stops and returns ("interrupted",
        final_sum, pending ids, ranges) for checkpointing instead of the
        finished frame.
        on_frame(final_sum, done): called after every refill with the
        framebuffer SUM on the device and the queue entries taken.
        fetch=False returns the frame on the device.
        CRAYTPU_POOL_STATS=1 prints the loop's accounting to stderr at the
        end and keeps it in self.pool_stats; CRAYTPU_POOL_SYNC=1 with it
        adds the wall time of each phase (_PoolStats).
        """
        spp = spp if spp is not None else self.cscene.prefs.sample_count
        H, W = self.height, self.width
        npix = H * W
        dev = self.device
        if self.empty_scene or self.max_depth == 0:
            acc = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
            for p in range(spp):
                acc = self.render_pass(acc, p, spp)
            return acc.cpu().numpy()
        B = min(self.tile_rays, _next_pow2(npix))
        # refill quantum: a sixteenth of the pool
        Q = B // 16
        k_env = os.environ.get("CRAYTPU_POOL_K")
        k = int(k_env) if k_env else 1
        force_k = bool(k_env)   # an explicit k also holds in the drain
        stats = _PoolStats(bool(os.environ.get("CRAYTPU_POOL_STATS")),
                           bool(os.environ.get("CRAYTPU_POOL_SYNC")), dev)

        total = npix * spp
        if resume is not None:
            final = torch.tensor(np.asarray(resume["final_sum"], np.float32),
                                 device=dev).reshape(npix, 4)
            queue = GidQueue(pending=resume["pending"],
                             ranges=resume["ranges"])
        else:
            final = torch.zeros((npix, 4), dtype=torch.float32, device=dev)
            queue = GidQueue(ranges=[[0, total]])

        def take(n):
            """Next n queue entries as fresh lanes built on the host, and
            how many were taken. Entries past the end are padded dead."""
            ids = queue.take(n)
            took = ids.shape[0]
            ids_pad = np.concatenate(
                [ids, np.zeros(n - took, np.int64)]) if took < n else ids
            px = ids_pad % npix
            xs_f, ys_f = self._sched_host
            xs = torch.tensor(xs_f[px], device=dev)
            ys = torch.tensor(ys_f[px], device=dev)
            passes = torch.tensor((ids_pad // npix).astype(np.int32),
                                  device=dev)
            o, d, s = self._init_rays(xs, ys, passes, spp)
            lane = torch.tensor(
                (ys_f[px].astype(np.int64) * W + xs_f[px]).astype(np.int32),
                device=dev)
            falive = torch.tensor(np.arange(n) < took, device=dev)
            return self._fresh_pool(o, d, s, lane, passes, falive), took

        # prime the pool — on the device from the queue head when the head
        # is a contiguous range (always, except pending-id resumes)
        if not queue.pending and queue.ranges:
            lo, hi = queue.ranges[0]
            took = min(B, hi - lo)
            pool = self._prime_dev(B, lo % npix, lo // npix, took, spp)
            queue.ranges[0][0] += took
            if queue.ranges[0][0] >= hi:
                queue.ranges.pop(0)
        else:
            pool, took = take(B)
        stale_n = took                 # lagged upper bound on live lanes
        counts: list = []              # in-flight [count handle, adjust]
        while True:
            Bc = pool.alive.shape[0]
            # drain phase: more bounces a step as the pool shrinks
            kc = k if (force_k or Bc > 32768) else (4 if Bc > 4096 else 8)
            stats.start()
            pool, n_live = self._pool_step(kc, pool)
            stats.add("step", ("step", Bc, kc), live=min(stale_n, Bc), k=kc)
            counts.append([_count_to_host(n_live), 0])
            # lag-1 count: read step i-1's count while the device runs
            # step i
            if len(counts) >= 2:
                handle, adj = counts.pop(0)
                stale_n = _count_value(handle) + adj
            if progress is not None:
                progress(total - queue.left() - min(stale_n, Bc), total)

            # interrupt latency bound: poll once per step, not only at
            # refill boundaries
            if interrupt is not None and interrupt():
                return self._persistent_interrupt(final, pool, npix, queue)

            if queue.left() > 0 and Bc == B and stale_n <= B - Q:
                # refill on the LAGGED count: it only overestimates the
                # live set, so the tail lanes it clears are dead. m rounds
                # down to a power of two.
                m = min((B - stale_n) // Q, 8,
                        max((queue.left() + Q - 1) // Q, 1))
                while m & (m - 1):
                    m &= m - 1
                stats.start()
                if queue.pending:
                    # resume path: non-contiguous re-enqueued ids go
                    # through the host-side fresh-ray builder
                    fresh, took = take(m * Q)
                    pool = self._flush_pack_refill_host(B, m, Q, final, pool,
                                                        fresh)
                else:
                    lo, hi = queue.ranges[0]
                    took = min(m * Q, hi - lo)
                    pool = self._flush_pack_refill(
                        B, m, Q, final, pool, lo % npix, lo // npix, took,
                        spp)
                    queue.ranges[0][0] += took
                    if queue.ranges[0][0] >= hi:
                        queue.ranges.pop(0)
                stats.add("refill", ("refill", m))
                # counts issued before this refill undercount by took
                for e in counts:
                    e[1] += took
                stale_n += took
                if on_frame is not None:
                    on_frame(final, total - queue.left())
            elif queue.left() == 0:
                # drain: exact count, early exit, shrink buckets
                handle, adj = counts[-1]
                stale_n = _count_value(handle) + adj
                counts.clear()
                if stale_n == 0:
                    break
                need = max(_next_pow2(stale_n), 1024)
                Bn = Bc
                while Bn // 4 >= need:
                    Bn //= 4
                if Bn < Bc:
                    stats.start()
                    pool = self._pack_shrink(Bn, final, pool)
                    stats.add("shrink", ("shrink", Bn))
                if pool.alive.shape[0] <= self.DRAIN_DEV_MAX \
                        and interrupt is None:
                    stats.start()
                    pool, n = self._drain_all(pool)
                    stats.add("step", ("drain_all", pool.alive.shape[0]), n)
                    break
        self._final_flush(final, pool)
        if stats.on:
            self.pool_stats = stats.report(B, total)
        # divide by a tensor: on CUDA, tensor / python float multiplies
        # by the reciprocal
        final = (final / final.new_tensor(float(spp))).reshape(H, W, 4)
        return final.cpu().numpy() if fetch else final

    def fetch_partial(self, final) -> np.ndarray:
        """Host copy of the in-progress radiance-sum frame (npix, 4) —
        the preview fetch hook."""
        return final.cpu().numpy()

    def _persistent_interrupt(self, final, pool: Pool, npix: int,
                              queue: GidQueue):
        """Checkpoint state at an interrupt: flush completed (dead) lanes'
        radiance, collect in-flight (pixel, pass) queue ids to re-trace,
        and keep the un-taken queue (any not-yet-consumed re-enqueued ids
        plus the remaining ranges). Returns
        ("interrupted", final_sum (npix,4) np, pending ids, ranges)."""
        self._final_flush(final, pool)
        alive_h = pool.alive.cpu().numpy()
        lane_h = pool.lane.cpu().numpy()[alive_h]
        pass_h = pool.lpass.cpu().numpy()[alive_h]
        # queue ids index the TILE-ORDER pixel schedule; lane is the flat
        # pixel id — invert the schedule permutation
        xs_f, ys_f = self._sched_host
        inv = np.empty(npix, np.int64)
        inv[ys_f.astype(np.int64) * self.width + xs_f] = np.arange(npix)
        pend = pass_h.astype(np.int64) * npix + inv[lane_h]
        pend = np.concatenate([pend, np.asarray(queue.pending, np.int64)])
        return ("interrupted", final.cpu().numpy(), pend,
                [list(r) for r in queue.ranges])


def _take(carry: tuple, order) -> tuple:
    """Every per-lane tensor (and sampler state) of a carry, gathered by
    a lane order; None stays None."""
    return tuple(None if x is None else
                 x.index(order) if isinstance(x, smp.SamplerState)
                 else x[order] for x in carry)


class _HitTape:
    """An isect that keeps its searches' detached results (K2's winners
    and K1's records) on the first run of a checkpointed segment and
    replays them, in order, on every later run (the backward pass's
    recompute): the recompute launches neither kernel. The replayed
    values are those the recompute would compute, so the records (and,
    for vertex gradients, their autograd Function) are resolved the same
    way both times."""

    def __init__(self, isect):
        self.isect = isect
        self.found: list = []
        self.replay = None

    def rewind(self) -> None:
        """Called at the start of each run of the segment."""
        self.replay = None if not self.found else iter(self.found)

    def __call__(self, geom, o_w, d_w, alive):
        if self.replay is None:
            found = self.isect.search(geom, o_w, d_w, alive)
            self.found.append(found)
        else:
            found = next(self.replay)
        return self.isect.resolve(found, o_w, d_w)


class _TraceRun:
    """One call of a trace made by make_trace_fn: the bounce loop, with
    its compaction, sorts and remat (the port of the JAX package's _trace
    scan bodies)."""

    def __init__(self, ren: WavefrontRenderer, params, isect, depth: int,
                 nee: bool, remat, sort):
        self.ren = ren
        self.params = params
        self.isect = isect
        self.depth = depth
        self.nee = nee
        self.remat = remat
        self.sort = sort
        self.rr = ren._rr_flags()

    def bounce(self, k: int, o, d, w, fin, s, al, pv, isect):
        """Bounce k of the trace: 6 outputs, or 7 with the NEE flag."""
        return self.ren._step(o, d, w, fin, s, al, self.rr[k >= 4], pv,
                              self.params, isect, bounce=k)

    def checkpointed(self, fn, *args):
        """fn(isect, *args) under torch.utils.checkpoint; with
        remat="segment_hits" its searches are replayed in the recompute."""
        if self.remat == "segment_hits":
            tape = _HitTape(self.isect)

            def seg(*a):
                tape.rewind()
                return fn(tape, *a)
        else:
            def seg(*a):
                return fn(self.isect, *a)
        return checkpoint(seg, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def plain(self, o, d, weight, final, s, alive, prev):
        """Every bounce at full width; remat recomputes each bounce."""
        def body(isect, k, *carry):
            out = self.bounce(k, *carry, isect)
            return out if self.nee else out + (None,)

        carry = (o, d, weight, final, s, alive, prev)
        for k in range(self.depth):
            carry = (self.checkpointed(body, k, *carry) if self.remat
                     else body(self.isect, k, *carry))
        return carry[3]

    def compacted(self, compaction, o, d, weight, s, alive, prev):
        ren = self.ren
        depth = self.depth
        B = o.shape[0]
        boundary_sort = self.sort == "boundary"
        sched = [(ds, min(w, B)) for ds, w in compaction if ds < depth]
        if not sched or sched[0][0] != 0:
            sched = [(0, B)] + sched
        if boundary_sort:
            # equal-width sort points inside long segments
            every = ren.TRACE_SORT_EVERY
            expanded = []
            for si, (ds, w) in enumerate(sched):
                de = sched[si + 1][0] if si + 1 < len(sched) else depth
                expanded += [(ds, w)] + [(k, w) for k in
                                         range(ds + every, de, every)]
            sched = expanded
        bounds = [ds for ds, _ in sched] + [depth]

        def seg_body(isect, k, o, d, w, dl, s, al, ln, pv):
            if self.sort is True:
                order = torch.argsort(ren._morton_key(o, d, al), stable=True)
                o, d, w, dl, s, al, ln, pv = _take(
                    (o, d, w, dl, s, al, ln, pv), order)
            out = self.bounce(k, o, d, w, dl, s, al, pv, isect)
            return out[:6] + (ln, out[6] if self.nee else None)

        def segment(isect, ks, *carry):
            for k in ks:
                carry = seg_body(isect, k, *carry)
            return carry

        final = o.new_zeros(B, 4)
        lane = torch.arange(B, device=o.device)
        delta = o.new_zeros(B, 4)
        for si, (ds, w) in enumerate(sched):
            if w < alive.shape[0] or (boundary_sort and si > 0):
                final = final.index_add(0, lane, delta)
                # truncating live lanes would drop radiance and corrupt
                # the gradients: poison the result instead (no host sync)
                overflow = alive.sum() > w
                if ren._debug and bool(overflow):
                    raise FloatingPointError(
                        f"compaction schedule overflow at bounce {ds}: "
                        f"{int(alive.sum())} live lanes exceed width {w}, "
                        "the trace would be NaN (CRAYTPU_DEBUG)")
                final = torch.where(overflow, float("nan"), final)
                if boundary_sort:
                    # dead lanes get the max key: a stable argsort is
                    # live-first and Morton-coherent
                    order = torch.argsort(ren._morton_key(o, d, alive),
                                          stable=True)[:w]
                else:
                    order = torch.argsort((~alive).to(torch.int8),
                                          stable=True)[:w]
                o, d, weight, s, alive, lane, prev = _take(
                    (o, d, weight, s, alive, lane, prev), order)
                delta = o.new_zeros(w, 4)
            carry = (o, d, weight, delta, s, alive, lane, prev)
            ks = range(ds, bounds[si + 1])
            if self.remat is True:
                for k in ks:
                    carry = self.checkpointed(seg_body, k, *carry)
            elif self.remat:
                carry = self.checkpointed(segment, ks, *carry)
            else:
                carry = segment(self.isect, ks, *carry)
            o, d, weight, delta, s, alive, lane, prev = carry
        return final.index_add(0, lane, delta)


def render(cscene: CompiledScene, kind: str = smp.RANDOM,
           spp: int | None = None, bounces: int | None = None,
           progress=None, stop=None) -> np.ndarray:
    """Full render. Returns the float accumulation buffer (H, W, 4), y-up
    like the reference's renderBuffer (row y=0 is the image BOTTOM; the PNG
    writer flips). stop: as WavefrontRenderer.render."""
    return WavefrontRenderer(cscene, kind, bounces).render(spp, progress,
                                                           stop)
