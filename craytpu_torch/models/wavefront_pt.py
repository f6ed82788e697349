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

import contextlib
import os
from dataclasses import dataclass, fields, is_dataclass, replace

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from craytpu_torch.ops import dense_isect as dx
from craytpu_torch.ops import hitrec as hr
from craytpu_torch.ops import pcg
from craytpu_torch.ops import sampler as smp
from craytpu_torch.ops import shading
from craytpu_torch.ops import traverse as trv
from craytpu_torch.ops import vecmath as vm
from craytpu_torch.ops.hitrec import TRAVERSALS, Isect
from craytpu_torch.ops.nee import make_nee_fn
from craytpu_torch.runtime.checkpoint import GidQueue
from craytpu_torch.scene.compile import CompiledScene
from craytpu_torch.utils.graphs import GraphCache
from craytpu_torch.utils.torchsetup import debug_enabled
from craytpu_torch.utils.trace import Tracer


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


def _assign(dst: Pool, src: Pool) -> None:
    """Copy every tensor of src into dst's, in place (a field that is the
    same tensor on both sides is left as it is)."""
    for f in fields(Pool):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if f.name == "s":
            for g in fields(a):
                getattr(a, g.name).copy_(getattr(b, g.name))
        else:
            a.copy_(b)


def _scatter_add(final, lane, delta) -> None:
    """final[lane[i]] += delta[i] for every i, in place and with no
    atomics, so that where lanes repeat (two passes of one pixel in one
    flush) the sum has the same bits in every run: the JAX package's
    final.at[lane].add(delta). index_put_(accumulate=True) adds a pixel's
    rows to it one after another, in order of i, on the CPU (as XLA's CPU
    scatter does: bit-equal, tests/test_torch_graph_safe.py); on CUDA it
    sorts the lane ids with a stable radix sort, sums each pixel's rows
    in that order and adds the sum to the pixel: final + (d_1 + d_2),
    the same bits in every run (chip_smoke.py's check_flush, which reads
    the order from rows of 2^-24 added to 1.0)."""
    final.index_put_((lane.long(),), delta, accumulate=True)


def _tensors_in(x):
    """Every tensor held by x through dataclass fields, lists, tuples and
    dicts."""
    if torch.is_tensor(x):
        yield x
    elif is_dataclass(x) and not isinstance(x, type):
        for f in fields(x):
            yield from _tensors_in(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors_in(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors_in(v)


class WavefrontRenderer:
    """Render pipeline for one compiled scene + sampler kind, on the
    scene's device."""

    # the drain runs as one loop of 8-bounce steps, checking for live
    # lanes once a step, once the pool is at most this wide
    DRAIN_DEV_MAX = 262144

    # sort="boundary" adds a sort point every this many bounces inside a
    # compaction segment (the JAX package's default)
    TRACE_SORT_EVERY = 3

    # the persistent pool refills in quanta of B // POOL_QDIV lanes (the
    # JAX package's default; a rank of a group refills by a quarter,
    # ShardedPoolRenderer)
    POOL_QDIV = 16

    def __init__(self, cscene: CompiledScene, kind: str = smp.RANDOM,
                 bounces: int | None = None, tile_rays: int | None = None,
                 nee: bool = False, graphs: bool = True):
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
        # CRAYTPU_TRAVERSAL: auto, simt and flash search with K2 (the BVH
        # walk), dense with K3 (ops/dense_isect.py); the JAX package walks
        # silently on any other value, the port refuses it
        mode = os.environ.get("CRAYTPU_TRAVERSAL", "auto")
        if mode not in TRAVERSALS:
            raise ValueError(f"CRAYTPU_TRAVERSAL={mode!r}: one of "
                             f"{', '.join(TRAVERSALS)}")
        self.traversal_mode = mode
        self.traversal = TRAVERSALS[mode]
        self.isect = Isect(cscene, traversal=self.traversal)
        # CRAYTPU_DEBUG: every bounce step checks its outputs (_check_finite)
        self._debug = debug_enabled()
        self._sched = None
        self._sched_np = None
        self._sched_dev_t = None
        self._key_consts = {}
        # the forward dispatches as CUDA graphs (utils/graphs.py): on the
        # card unless graphs=False (A/B runs and tests) or CRAYTPU_DEBUG
        # (whose checks read the device every bounce); the CPU runs the
        # same dispatches eagerly
        # the frame records and dispatch counters (utils/trace.py):
        # trace.frames, trace.last
        self.trace = Tracer(self.device, lambda: (
            trv.closest_hit, hr.hitrec_record, dx.dense_hit))
        self.graphs = GraphCache(self.device, graphs and not self._debug,
                                 self.trace)
        # the dispatches' static tensors: the pool of each width, the live
        # count, per-call numbers as 0-d device tensors, the persistent
        # loop's framebuffer sum and trace_batch's pixel coordinates and
        # radiance buffer of each width
        self._pools: dict = {}
        self._scalars: dict = {}
        self._n_live = torch.zeros((), dtype=torch.int64, device=self.device)
        self._fb = None
        self._batch: dict = {}

    # ------------------------------------------------------------------
    def _init_rays(self, xs, ys, pass_idx, spp):
        """Primary rays and fresh sampler states for pixel coords (the
        JAX package's _make_init_rays). pass_idx: an int, a 0-d tensor or
        a (B,) tensor of one pass per lane; spp: an int or a 0-d tensor
        (a dispatch's device inputs)."""
        B = xs.shape[0]
        pix_idx = ys.long() * self.width + xs.long()

        def full(v):
            if torch.is_tensor(v):
                return v.to(torch.int32).expand(B).contiguous()
            return torch.full((B,), v, dtype=torch.int32, device=xs.device)
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
        n_safe = torch.where(ih, n_w, vm.const((0.0, 0.0, 1.0), n_w.device))
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

    # ------------------------------------------------------------------
    # the dispatches' static state (utils/graphs.py)
    # ------------------------------------------------------------------
    def _static_pool(self, B: int) -> Pool:
        """The static pool of width B, made at its first use (outside any
        capture) and kept: every dispatch at this width reads it and
        writes its results back into it."""
        st = self._pools.get(B)
        if st is None:
            dev = self.device

            def z(*shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=dev)
            i64, i32 = torch.int64, torch.int32
            st = Pool(z(B, 3), z(B, 3), z(B, 4),
                      smp.SamplerState(z(B, dtype=i64), z(B, dtype=i64),
                                       z(B), z(B, dtype=i32),
                                       z(B, dtype=i32), z(B, dtype=i32)),
                      z(B, dtype=torch.bool), z(B, dtype=i32),
                      z(B, dtype=i32), z(B, dtype=i32), z(B, 4))
            self._pools[B] = st
        return st

    def _as_static(self, pool: Pool) -> Pool:
        """The static pool of pool's width, holding pool (copied in unless
        it is that pool already)."""
        st = self._static_pool(pool.alive.shape[0])
        if pool is not st:
            _assign(st, pool)
        return st

    def _scalar(self, name: str, value: int) -> torch.Tensor:
        """The dispatches' 0-d int32 device input `name`, set to value
        (a fill on the device: no copy from the host, nothing waits)."""
        t = self._scalars.get(name)
        if t is None:
            t = self._scalars[name] = torch.zeros(
                (), dtype=torch.int32, device=self.device)
        t.fill_(int(value))
        return t

    def _framebuffer(self, final):
        """The framebuffer sum the persistent loop's dispatches add to:
        with graphs, one static buffer of the renderer (made once, before
        any capture that reads it) holding a copy of `final`, which the
        loop copies back at its ends; without, `final` itself."""
        if not self.graphs.on:
            return final
        if self._fb is None or self._fb.shape != final.shape:
            self._fb = torch.empty_like(final)
        self._fb.copy_(final)
        return self._fb

    def _graph_context(self) -> tuple:
        """What every captured dispatch bakes in beyond its key: the NEE
        flag, sampler kind, traversal and bounce cap; CRAYTPU_FASTMATH and
        CRAYTPU_HITREC (they pick which library and which record path are
        launched) and the kernel wrappers themselves (an A/B may swap
        one); the sampler's digit steps; and the identity of the scene's
        tables (cscene.params included): a table replaced by another
        tensor means fresh captures, while an edit in place is read by
        the next replay."""
        cs = self.cscene
        # the kernels' own tables are built at their first launch: build
        # them now, so that the context holds from the first call on
        _ = cs.dense if self.traversal == "dense" else cs.layout
        return (self.nee, self.kind, self.traversal, self.max_depth,
                vm._FASTMATH, os.environ.get("CRAYTPU_HITREC", "kernel"),
                pcg.current_digit_steps(), trv.closest_hit,
                hr.hitrec_record, dx.dense_hit,
                tuple(t.data_ptr() for t in _tensors_in(cs)))

    @contextlib.contextmanager
    def _forward(self, n_passes: int):
        """Around a forward render of passes below n_passes: the sampler's
        fixed digit steps (pcg.pass_bound) and the graphs' context."""
        with pcg.pass_bound(n_passes):
            if self.graphs.on:
                self.graphs.context(self._graph_context())
            yield

    # ------------------------------------------------------------------
    # the per-pass trace: one dispatch of k bounces, then a compaction
    # ------------------------------------------------------------------
    def _trace_init(self, pool: Pool, final, xs, ys, pass_t,
                    spp_t) -> None:
        """trace_batch's primaries into the static pool: every lane live,
        lane ids 0..B-1, the radiance buffer zeroed."""
        B = xs.shape[0]
        o, d, s = self._init_rays(xs, ys, pass_t, spp_t)
        lane = torch.arange(B, dtype=torch.int32, device=o.device)
        _assign(pool, Pool(o, d, torch.ones_like(pool.weight), s,
                           torch.ones_like(pool.alive), lane,
                           pass_t.expand(B), torch.zeros_like(lane),
                           torch.zeros_like(pool.delta)))
        final.zero_()

    def _multi_step(self, k: int, pool: Pool, final) -> tuple:
        """k bounces over the trace's pool, then the radiance deltas add
        into the batch buffer `final` by lane (the JAX package's
        _multi_step, one dispatch). Returns (the static pool, the live
        count as a device tensor)."""
        st = self._as_static(pool)

        def multi():
            o, d, weight, delta, s, alive, pdepth = self._bounces(
                k, st.o, st.d, st.weight, torch.zeros_like(st.weight),
                st.s, st.alive, st.pdepth)
            _scatter_add(final, st.lane, delta)
            _assign(st, Pool(o, d, weight, s, alive, st.lane, st.lpass,
                             pdepth, st.delta))
            self._n_live.copy_(alive.sum())
        B = st.alive.shape[0]
        self.graphs(("multi", B, k), multi, (final,))
        return st, self._n_live

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

    def _compact(self, pool: Pool, Bn: int) -> Pool:
        """Sort the wavefront by a spatial key (dead lanes last, stable)
        and keep the first Bn lanes (the JAX package's _make_compact, one
        dispatch): the static pool of width Bn. Its live lanes are the
        first n_alive (Bn >= n_alive)."""
        st = self._as_static(pool)
        out = self._static_pool(Bn)

        def compact():
            lo, inv_ext = self._key_consts_for(127.0)
            o, d = st.o, st.d
            # clamp to [0, 127] (and mask, so a NaN origin cannot escape
            # the live key range)
            q = torch.clamp((o - lo) * inv_ext, 0.0, 127.0).long() & 0x7F
            octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
                      + 4 * (d[:, 2] < 0).long())
            key = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
                   | (_spread3(q[:, 2]) << 2)) | (octant << 21)
            key = torch.where(st.alive, key, 0xFFFFFFFF)
            order = torch.argsort(key, stable=True)[:Bn]
            _assign(out, self._permute_pool(order, st))
        self.graphs(("compact", st.alive.shape[0], Bn), compact)
        return out

    def trace_batch(self, xs, ys, pass_idx: int, spp: int):
        """Trace one pass for a flat batch of pixel coords -> (B, 4)."""
        B = xs.shape[0]
        if self.empty_scene or self.max_depth == 0:
            o, d, s = self._init_rays(xs, ys, pass_idx, spp)
            if self.max_depth == 0:
                return o.new_zeros(B, 4)
            return self.bg_fn(self.cscene.params, d)
        with self._forward(max(spp, pass_idx + 1)):
            return self._trace_batch(xs, ys, pass_idx, spp)

    def _trace_batch(self, xs, ys, pass_idx: int, spp: int):
        B = xs.shape[0]
        if B not in self._batch:
            dev = self.device
            self._batch[B] = (torch.zeros(B, dtype=torch.int32, device=dev),
                              torch.zeros(B, dtype=torch.int32, device=dev),
                              torch.zeros((B, 4), device=dev))
        xs_st, ys_st, final = self._batch[B]
        xs_st.copy_(xs)
        ys_st.copy_(ys)
        pool = self._static_pool(B)
        pass_t = self._scalar("pass", pass_idx)
        spp_t = self._scalar("spp", spp)
        self.graphs(("init", B),
                    lambda: self._trace_init(pool, final, xs_st, ys_st,
                                             pass_t, spp_t))
        depth = 0
        while depth < self.max_depth:
            Bc = pool.alive.shape[0]
            # more bounces between compactions as the wavefront shrinks
            k = 1 if Bc > 32768 else (4 if Bc > 4096 else 8)
            k = min(k, self.max_depth - depth)
            pool, n_live = self._multi_step(k, pool, final)
            depth += k
            n_alive = int(n_live)
            if n_alive == 0:
                break
            # quarter-step buckets (Bc/4, Bc/16, ...)
            need = max(_next_pow2(n_alive), 1024)
            Bn = Bc
            while Bn // 4 >= need:
                Bn //= 4
            pool = self._compact(pool, Bn)
        # the caller keeps the result; the buffer is the next call's
        return final.clone()

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
        passes = list(range(spp) if passes is None else passes)
        bound = max([spp] + [int(p) + 1 for p in passes])
        with torch.no_grad(), pcg.pass_bound(bound):
            for p in passes:
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
            with pcg.pass_bound(max(int(spp), int(pass_idx) + 1)):
                return _trace_pass(params, tri_packed, xs, ys, pass_idx,
                                   spp)

        def _trace_pass(params, tri_packed, xs, ys, pass_idx, spp):
            B = xs.shape[0]
            o, d, s = self._init_rays(xs, ys, int(pass_idx), int(spp))
            if self.empty_scene or depth == 0:
                if depth == 0:
                    return o.new_zeros(B, 4)
                return self.bg_fn(params, d)
            isect = (self.isect if tri_packed is None
                     else Isect(cs, tri_packed, self.traversal))
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
        """One pass over the whole frame: the running mean with accum (a
        frame of its own in self.trace)."""
        H, W = self.height, self.width
        xs, ys, flat, T = self._pixel_schedule
        with self.trace.frame():
            sample = accum.new_zeros(H * W, 4)
            for t0 in range(0, xs.shape[0], T):
                chunk = self.trace_batch(xs[t0:t0 + T], ys[t0:t0 + T],
                                         pass_idx, spp)
                # padded lanes re-trace pixel (0,0) with the same
                # per-(pixel, pass) stream, so their duplicate writes
                # carry the same value
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
        """k bounces over the persistent pool in one dispatch (the JAX
        package's _pool_step). Radiance sums into the per-lane delta
        (flushed to the framebuffer only at refill and shrink
        boundaries). Returns (the static pool, its live count as a device
        tensor); nothing here waits for the device."""
        st = self._as_static(pool)

        def step():
            o, d, weight, delta, s, alive, pdepth = self._bounces(
                k, st.o, st.d, st.weight, st.delta, st.s, st.alive,
                st.pdepth)
            _assign(st, Pool(o, d, weight, s, alive, st.lane, st.lpass,
                             pdepth, delta))
            self._n_live.copy_(alive.sum())
        self.graphs(("pool", st.alive.shape[0], k), step)
        return st, self._n_live

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

    def _fresh_dev(self, n: int, qpix, qpass, take_n, spp) -> Pool:
        """n fresh primaries generated on the device for the queue entries
        from (pass qpass, schedule index qpix) on; lanes at or past take_n
        are dead. The four are 0-d int32 device tensors."""
        npix = self.width * self.height
        i = torch.arange(n, dtype=torch.int32, device=self.device)
        px_i = i + qpix
        fpass = px_i // npix + qpass
        rows = self._sched_dev[px_i % npix]
        o, d, s = self._init_rays(rows[:, 0], rows[:, 1], fpass, spp)
        return self._fresh_pool(o, d, s, rows[:, 2], fpass, i < take_n)

    def _queue_scalars(self, qpix: int, qpass: int, take_n: int,
                       spp: int) -> tuple:
        return (self._scalar("qpix", qpix), self._scalar("qpass", qpass),
                self._scalar("take_n", take_n), self._scalar("spp", spp))

    def _prime_dev(self, B: int, qpix: int, qpass: int, take_n: int,
                   spp: int) -> Pool:
        """The static pool of width B filled with fresh primaries from the
        queue (_fresh_dev), in one dispatch: the initial pool fill."""
        st = self._static_pool(B)
        q = self._queue_scalars(qpix, qpass, take_n, spp)
        self.graphs(("prime", B),
                    lambda: _assign(st, self._fresh_dev(B, *q)))
        return st

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
        of the last n lanes, which are dead (n_alive <= B - n by the live
        count), into the framebuffer sum `final`. Returns the sorted pool
        (new tensors)."""
        order = torch.argsort(self._morton_key(pool.o, pool.d, pool.alive),
                              stable=True)
        pool = self._permute_pool(order, pool)
        _scatter_add(final, pool.lane[B - n:], pool.delta[B - n:])
        return pool

    def _flush_pack_refill(self, B: int, m: int, Q: int, final, pool: Pool,
                           qpix: int, qpass: int, take_n: int,
                           spp: int) -> Pool:
        """At a refill boundary, one dispatch:
          1. Morton/octant sort the pool (dead lanes last): spatially
             coherent rays keep K2's walks short on bounced rays
          2. add the radiance deltas of ONLY the dead tail lanes being
             overwritten by fresh rays into `final` (in place). Live lanes
             keep their partial sums so an interrupt checkpoint can
             re-enqueue them without double counting; other dead lanes
             ride until a later refill overwrites them.
          3. generate m*Q fresh primaries on the device from the queue
             position (no host round trip) and put them in the tail.
        Returns the static pool."""
        st = self._as_static(pool)
        q = self._queue_scalars(qpix, qpass, take_n, spp)

        def fpr():
            packed = self._flush_pack(B, m * Q, final, st)
            _set_tail(packed, B - m * Q, self._fresh_dev(m * Q, *q))
            _assign(st, packed)
        self.graphs(("fpr", B, m, Q), fpr, (final,))
        return st

    def _flush_pack_refill_host(self, B: int, m: int, Q: int, final,
                                pool: Pool, fresh: Pool) -> Pool:
        """Like _flush_pack_refill but takes host-prepared fresh rays —
        used only when resuming with re-enqueued pending paths (whose ids
        are not a contiguous queue range) and for a group's host-split
        queue. It stays eager: its fresh lanes are built on the host a
        call, a copy from the host that a graph would replay unchanged.
        Returns the static pool."""
        st = self._as_static(pool)
        packed = self._flush_pack(B, m * Q, final, st)
        _set_tail(packed, B - m * Q, fresh)
        _assign(st, packed)
        return st

    def _final_flush(self, final, pool: Pool) -> None:
        """Add the radiance of every DEAD lane into `final` (in place), in
        one dispatch. Live lanes are in-flight paths whose partial sums
        must not reach the framebuffer: an interrupt checkpoint
        re-enqueues them."""
        st = self._as_static(pool)
        self.graphs(("flush", st.alive.shape[0]),
                    lambda: _scatter_add(final, st.lane, torch.where(
                        st.alive[:, None], 0.0, st.delta)), (final,))

    def _pack_shrink(self, Bn: int, final, pool: Pool) -> Pool:
        """Flush dead lanes' radiance, Morton-sorted alive-first pack,
        then truncate the pool to Bn lanes (drain phase), in one dispatch:
        reads the static pool of the current width, writes that of width
        Bn. The flush must happen HERE: truncation drops dead lanes."""
        st = self._as_static(pool)
        out = self._static_pool(Bn)

        def shrink():
            _scatter_add(final, st.lane,
                         torch.where(st.alive[:, None], 0.0, st.delta))
            delta = torch.where(st.alive[:, None], st.delta, 0.0)
            order = torch.argsort(self._morton_key(st.o, st.d, st.alive),
                                  stable=True)[:Bn]
            _assign(out, self._permute_pool(order, replace(st, delta=delta)))
        self.graphs(("shrink", st.alive.shape[0], Bn), shrink, (final,))
        return out

    def _drain_all(self, pool: Pool) -> tuple:
        """Run the pool to extinction: replays of the 8-bounce step until
        no lane is alive, checked once a step by reading its live count
        (the JAX package's one while_loop dispatch; here the host loop and
        its one read a step stay). A step changes nothing for a dead lane
        (its radiance, throughput, ray and sampler are all masked), so the
        extra bounces of the last step do not change the image. Returns
        (pool, the number of steps)."""
        rec = self.trace.rec
        n = 0
        while True:
            with rec.span("pool_step"):
                pool, n_live = self._pool_step(8, pool)
            rec.step(8, pool.alive.shape[0], drain=True)
            n += 1
            with rec.span("count_wait"):
                live = int(n_live)
            rec.add("d2h_bytes", n_live.element_size())
            rec.live(live)
            if live == 0:
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

        The host reads the live count of every step as it ends, and a
        refill fills the pool up to it: m = min((B - n) // Q,
        ceil(left / Q)) quanta of Q lanes whenever n <= B - Q, so a step
        of the refill phase starts with fewer than Q dead lanes.

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
        The frame is one record of self.trace when traced
        (utils/trace.py: CRAYTPU_TRACE=1, the CLI's --trace, or a
        profiler): spans upload (the resumed sum's copy to the card),
        prime, pool_step, count_wait, refill, shrink, drain, flush and
        fetch, the pool's counters and each dispatch's device interval.
        """
        with self.trace.frame() as rec:
            return self._render_persistent(rec, spp, progress, resume,
                                           interrupt, on_frame, fetch)

    def _render_persistent(self, rec, spp, progress, resume, interrupt,
                           on_frame, fetch):
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
        total = npix * spp
        if resume is not None:
            with rec.span("upload", device=True):
                final = torch.tensor(np.asarray(resume["final_sum"],
                                                np.float32),
                                     device=dev).reshape(npix, 4)
            rec.add("h2d_bytes", final.nbytes)
            queue = GidQueue(pending=resume["pending"],
                             ranges=resume["ranges"])
        else:
            final = torch.zeros((npix, 4), dtype=torch.float32, device=dev)
            queue = GidQueue(ranges=[[0, total]])
        out = self._run_pool(B, self.refill_quantum(B), spp,
                             _QueueFeed(queue), final, total, progress,
                             interrupt, on_frame)
        if isinstance(out, tuple):
            return out
        return self._fetch(rec, out, spp, fetch)

    def _fetch(self, rec, out, spp: int, fetch: bool):
        """The frame (H, W, 4): the framebuffer sum over spp, on the host
        unless fetch is False (the span `fetch`)."""
        with rec.span("fetch", device=True):
            # divide by a tensor: on CUDA, tensor / python float
            # multiplies by the reciprocal
            final = (out / out.new_tensor(float(spp))).reshape(
                self.height, self.width, 4)
            if not fetch:
                return final
            rec.add("d2h_bytes", final.nbytes)
            return final.cpu().numpy()

    # hooks of the pool loop that a group of ranks overrides
    # (parallel/pool_shard.py): one rank's values are the group's
    n_ranks = 1

    def refill_quantum(self, B: int) -> int:
        """The refill quantum of a pool of B lanes: B // POOL_QDIV, at
        least 1 (the JAX package's wavefront_pt.py:1405 and
        pool_shard.py:534)."""
        return max(B // self.POOL_QDIV, 1)

    def _group_step(self, n: int, interrupt):
        """Once a pool step, given this rank's live count: (the group's
        live count, whether to stop at an interrupt)."""
        return n, interrupt is not None and bool(interrupt())

    def _host_lanes(self, ids, n: int, spp: int) -> Pool:
        """n fresh lanes built on the host from queue ids (at most n);
        lanes past the ids are dead."""
        npix = self.width * self.height
        dev = self.device
        took = ids.shape[0]
        ids_pad = np.concatenate(
            [ids, np.zeros(n - took, np.int64)]) if took < n else ids
        px = ids_pad % npix
        xs_f, ys_f = self._sched_host
        xs = torch.tensor(xs_f[px], device=dev)
        ys = torch.tensor(ys_f[px], device=dev)
        passes = torch.tensor((ids_pad // npix).astype(np.int32), device=dev)
        o, d, s = self._init_rays(xs, ys, passes, spp)
        lane = torch.tensor(
            (ys_f[px].astype(np.int64) * self.width + xs_f[px]).astype(
                np.int32), device=dev)
        falive = torch.tensor(np.arange(n) < took, device=dev)
        self.trace.rec.add("h2d_bytes", sum(t.nbytes for t in (
            xs, ys, passes, lane, falive)))
        return self._fresh_pool(o, d, s, lane, passes, falive)

    def _block_lanes(self, block, n: int, spp: int) -> Pool:
        """The n fresh lanes of a feed block (_QueueFeed.take)."""
        kind, lo, live, _ = block
        if kind == "dev":
            npix = self.width * self.height
            return self._prime_dev(n, lo % npix, lo // npix, live, spp)
        return self._host_lanes(lo, n, spp)

    def _run_pool(self, B: int, Q: int, spp: int, feed, final, total: int,
                  progress=None, interrupt=None, on_frame=None):
        """The persistent loop over a pool of B lanes, refilled in quanta
        of Q lanes (refill_quantum), fed by `feed`
        (_QueueFeed, or a rank's _SplitFeed), summing radiance into
        `final` (npix, 4) in place. Returns `final` with every lane
        flushed, or the interrupted tuple of render_persistent. In a
        group of ranks every decision (refill, shrink, drain, stop) is
        the group's, so all ranks step in lockstep."""
        with self._forward(spp), self.trace.frame() as rec:
            with rec.span("upload", device=True):
                fb = self._framebuffer(final)
            out = self._pool_loop(B, Q, spp, feed, fb, total, progress,
                                  interrupt, on_frame, final)
            if fb is not final and not isinstance(out, tuple):
                with rec.span("flush", device=True):
                    final.copy_(fb)
                return final
            return out

    def _pool_loop(self, B: int, Q: int, spp: int, feed, fb, total: int,
                   progress, interrupt, on_frame, final):
        """_run_pool's loop, summing into fb (_framebuffer). Every pool
        dispatch reads and writes the static pools (_static_pool), so a
        Pool from a dispatch stays valid only until the next one."""
        k_env = os.environ.get("CRAYTPU_POOL_K")
        k = int(k_env) if k_env else 1
        force_k = bool(k_env)   # an explicit k also holds in the drain
        D = self.n_ranks
        rec = self.trace.rec
        rec.add("paths", feed.left_total())

        # prime the pool — on the device from the queue head when the head
        # is a contiguous range (always, except pending-id resumes and
        # host-split queues)
        block = feed.take(B)
        with rec.span("prime", device=block[0] != "dev"):
            pool = self._block_lanes(block, B, spp)
        # the record's accounting takes each step's live lanes on this
        # rank from the count read after the step before it (the first
        # step's from the prime)
        rec.live(block[2])
        while True:
            Bc = pool.alive.shape[0]
            # drain phase: more bounces a step as the pool shrinks
            kc = k if (force_k or Bc > 32768) else (4 if Bc > 4096 else 8)
            with rec.span("pool_step"):
                pool, n_live = self._pool_step(kc, pool)
            rec.add("d2h_bytes", n_live.element_size())
            rec.step(kc, Bc)
            # the exact live count of the step just issued: the host waits
            # for it once a step, so a refill fills every dead lane but
            # the quantum's remainder
            with rec.span("count_wait"):
                own = int(n_live)
            rec.live(own)
            # interrupt latency bound: poll once per step, not only at
            # refill boundaries
            n, stop = self._group_step(own, interrupt)
            if progress is not None:
                progress(max(total - feed.left_total() - D * n, 0), total)
            if stop:
                return self._persistent_interrupt(fb, pool, feed)

            if feed.left() > 0 and Bc == B and n <= B - Q:
                # n is exact, so the m*Q tail lanes the refill clears are
                # dead
                m = min((B - n) // Q, (feed.left() + Q - 1) // Q)
                block = feed.take(m * Q)
                with rec.span("refill", device=block[0] != "dev"):
                    if block[0] == "dev":
                        _, lo, live, _ = block
                        npix = self.width * self.height
                        pool = self._flush_pack_refill(
                            B, m, Q, fb, pool, lo % npix, lo // npix, live,
                            spp)
                    else:
                        # resume path: non-contiguous re-enqueued ids go
                        # through the host-side fresh-ray builder
                        with rec.span("refill.host_lanes", device=True):
                            fresh = self._host_lanes(block[1], m * Q, spp)
                        pool = self._flush_pack_refill_host(
                            B, m, Q, fb, pool, fresh)
                rec.add("refills")
                # the dead lanes this rank's refill left unfilled
                rec.add("refill_short", B - own - m * Q)
                rec.tally(("refill", m))
                rec.live(own + block[2])
                if on_frame is not None:
                    # the hook may keep `final`: it is the caller's
                    # tensor, never a static buffer a replay overwrites
                    if fb is not final:
                        final.copy_(fb)
                    on_frame(final, total - feed.left_total())
            elif feed.left() == 0:
                # drain: early exit, shrink buckets
                if n == 0:
                    break
                need = max(_next_pow2(n), 1024)
                Bn = Bc
                while Bn // 4 >= need:
                    Bn //= 4
                if Bn < Bc:
                    with rec.span("shrink"):
                        pool = self._pack_shrink(Bn, fb, pool)
                    rec.add("shrinks")
                    rec.tally(("shrink", Bn))
                if pool.alive.shape[0] <= self.DRAIN_DEV_MAX \
                        and interrupt is None:
                    # each rank drains its own pool: no collective inside
                    with rec.span("drain"):
                        pool, _ = self._drain_all(pool)
                    break
        with rec.span("flush"):
            self._final_flush(fb, pool)
        return fb

    def fetch_partial(self, final) -> np.ndarray:
        """Host copy of the in-progress radiance-sum frame (npix, 4) —
        the preview fetch hook."""
        return final.cpu().numpy()

    def _inflight_ids(self, pool: Pool) -> np.ndarray:
        """The queue ids of the pool's live lanes (int64)."""
        npix = self.width * self.height
        alive_h = pool.alive.cpu().numpy()
        lane_h = pool.lane.cpu().numpy()[alive_h]
        pass_h = pool.lpass.cpu().numpy()[alive_h]
        # queue ids index the TILE-ORDER pixel schedule; lane is the flat
        # pixel id — invert the schedule permutation
        xs_f, ys_f = self._sched_host
        inv = np.empty(npix, np.int64)
        inv[ys_f.astype(np.int64) * self.width + xs_f] = np.arange(npix)
        return pass_h.astype(np.int64) * npix + inv[lane_h]

    def _persistent_interrupt(self, final, pool: Pool, feed):
        """Checkpoint state at an interrupt: flush completed (dead) lanes'
        radiance, collect in-flight (pixel, pass) queue ids to re-trace,
        and keep the un-taken queue (any not-yet-consumed re-enqueued ids
        plus the remaining ranges). Returns
        ("interrupted", final_sum (npix,4) np, pending ids, ranges)."""
        self._final_flush(final, pool)
        pending, ranges = feed.tail()
        pend = np.concatenate([self._inflight_ids(pool),
                               np.asarray(pending, np.int64)])
        return ("interrupted", final.cpu().numpy(), pend, ranges)


class _QueueFeed:
    """The pool loop's queue: pending ids, then ranges (GidQueue), held
    whole by every rank of a group. One rank takes contiguous range heads
    as device-generated blocks (unless dev_ranges is False) and pending
    ids as host-built lanes; rank r of D takes D*n ids at a time and
    builds its lanes from the r-th n of them on the host (the JAX
    package's _ids_to_dev split). A device block stops at the end of its
    range, so a queue of many short ranges (a tile's passes) fills the
    pool faster from the host.

    take(n) -> (kind, lo, live, bound): kind "dev" (queue ids lo ..
    lo + live - 1 live, the rest of the n lanes dead) or "host" (lo is the
    rank's ids); bound is the most live lanes the block adds on any rank,
    the same number on every rank."""

    def __init__(self, queue: GidQueue, rank: int = 0, world: int = 1,
                 dev_ranges: bool = True):
        self.queue, self.rank, self.world = queue, rank, world
        self.dev_ranges = dev_ranges and world == 1

    def left(self) -> int:
        return self.queue.left()

    left_total = left

    def take(self, n: int) -> tuple:
        q = self.queue
        if self.dev_ranges and not q.pending and q.ranges:
            lo, hi = q.ranges[0]
            took = min(n, hi - lo)
            q.ranges[0][0] += took
            if q.ranges[0][0] >= hi:
                q.ranges.pop(0)
            return ("dev", lo, took, took)
        ids = q.take(self.world * n)
        mine = ids[self.rank * n:(self.rank + 1) * n]
        return ("host", mine, mine.shape[0], min(n, ids.shape[0]))

    def tail(self) -> tuple:
        """(pending ids, ranges) not yet taken, reported by rank 0 only
        (every rank holds the same queue)."""
        if self.rank != 0:
            return [], []
        return (list(self.queue.pending),
                [list(r) for r in self.queue.ranges])


class _SplitFeed:
    """Rank r's share of a queue split evenly over the ranks: ids
    [lo, lo + stride), of which those at or past cap are dead padding (an
    uneven split's last shares). Every rank's share has the same length,
    so every rank takes the same blocks at the same steps."""

    def __init__(self, lo: int, stride: int, cap: int, world: int):
        self.lo, self.stride, self.cap, self.world = lo, stride, cap, world
        self.pos = 0

    def left(self) -> int:
        return self.stride - self.pos

    def left_total(self) -> int:
        return self.world * self.left()

    def take(self, n: int) -> tuple:
        t = min(n, self.stride - self.pos)
        lo = self.lo + self.pos
        self.pos += t
        return ("dev", lo, max(0, min(t, self.cap - lo)), t)

    def tail(self) -> tuple:
        lo = self.lo + self.pos
        hi = min(self.lo + self.stride, self.cap)
        return [], ([[lo, hi]] if hi > lo else [])


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
