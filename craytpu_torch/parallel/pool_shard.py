"""Persistent-pool rendering over a process group: the port of the JAX
package's parallel/pool_shard.py (ShardedPoolRenderer, make_renderer).

The JAX package runs one pool per device of a 1-axis mesh from one
process, through shard_map stages. The port runs one process (rank) per
card (parallel/dist.py), so each rank's stage is the single-card stage:
ShardedPoolRenderer reuses WavefrontRenderer's pool loop with a share of
the queue and the group's collectives at its decision points. The
Monte-Carlo work queue (the flat (pixel, pass) id space, tile-ordered)
is split as the JAX package splits it:

  * full render: rank r owns passes [r*P, (r+1)*P), P = ceil(spp/D);
  * single-pass progressive render (render_pass): rank r owns pixels
    [r*n, (r+1)*n) of the pass, n = ceil(npix/D);
  * an id set (render_ids, the cluster's tile path; and a resume): every
    rank holds the whole queue, takes D*n ids a refill, and builds its
    lanes from its n of them.

Every (pixel, pass) path is deterministic given its sampler stream, so any
split gives the single-card image up to float accumulation order.

Lockstep: every rank enters every collective the same number of times.
Once a pool step the ranks all-reduce (MAX, gloo, on the host) the
step's live count and rank 0's interrupt flag, so refills (sized to the
group's largest count), shrinks and the stop are the group's decisions;
a rank whose share is spent keeps stepping an empty pool. The drain
runs each rank's pool to extinction without a collective. The frame is
one all_reduce (SUM) of the ranks' partials at the end, identical on
every rank.

Interrupts checkpoint losslessly: the ranks' in-flight ids and untaken
queue tails are gathered into one checkpoint, which resumes on any rank
count and in either package.
"""

from __future__ import annotations

import socket

import numpy as np
import torch

from craytpu_torch.models.wavefront_pt import (WavefrontRenderer,
                                               _next_pow2, _QueueFeed,
                                               _SplitFeed)
from craytpu_torch.ops import sampler as smp
from craytpu_torch.parallel import dist
from craytpu_torch.runtime.checkpoint import GidQueue
from craytpu_torch.utils import logging


class ShardedPoolRenderer(WavefrontRenderer):
    """WavefrontRenderer whose render_persistent, render_pass and
    render_ids run over every rank of the process group, one pool per
    rank. `tile_rays` is the pool size of a rank. Every rank makes the
    same calls with the same arguments (the interrupt callable is polled
    on rank 0 only; pass one on every rank or on none). A rank's pool
    refills in quanta of a quarter of it, as the JAX package's
    (pool_shard.py:534)."""

    POOL_QDIV = 4

    def __init__(self, cscene, kind: str = smp.RANDOM,
                 bounces: int | None = None, tile_rays: int | None = None,
                 nee: bool = False, graphs: bool = True):
        super().__init__(cscene, kind=kind, bounces=bounces,
                         tile_rays=tile_rays, nee=nee, graphs=graphs)
        self.D = self.n_ranks = dist.world_size()
        self.rank = dist.rank()
        dev = self.device
        where = (dev.type if dev.type != "cuda"
                 else f"cuda:{torch.cuda.current_device()}")
        # the group's cards: distinct (host, device) pairs of its ranks
        self.n_cards = len(set(dist.all_gather_object(
            (socket.gethostname(), where))))

    # -- the loop's group hooks -------------------------------------------
    def _group_step(self, n: int, interrupt):
        flag = (self.rank == 0 and interrupt is not None
                and bool(interrupt()))
        n, stop = dist.host_max([n, int(flag)])
        return n, bool(stop)

    def fetch_partial(self, final) -> np.ndarray:
        """Host copy of the group's radiance-sum frame (npix, 4): the sum
        of the ranks' partials. A collective: every rank calls it."""
        return dist.all_reduce_sum_(final.clone()).cpu().numpy()

    def _persistent_interrupt(self, final, pool, feed):
        """The group's lossless checkpoint: the summed frame, every rank's
        in-flight ids and untaken queue (its share's tail, or rank 0's
        copy of a whole queue), the same on every rank."""
        self._final_flush(final, pool)
        final_sum = self.fetch_partial(final)
        pending, ranges = feed.tail()
        parts = dist.all_gather_object(
            (self._inflight_ids(pool), pending, ranges))
        pend = np.concatenate([p[0] for p in parts]
                              + [np.asarray(p[1], np.int64) for p in parts])
        return ("interrupted", final_sum, pend,
                [list(r) for p in parts for r in p[2]])

    # -- the product entry points ------------------------------------------
    def render_persistent(self, spp: int | None = None, progress=None,
                          resume=None, interrupt=None, on_frame=None,
                          fetch=True):
        """Persistent render across the group: rank r traces passes
        [r*P, (r+1)*P) of spp (P = ceil(spp/D)), or its part of a resumed
        queue. Same arguments and results as WavefrontRenderer's, the
        same frame on every rank; `resume` takes any persistent
        checkpoint (either package's, any rank or device count). Each
        rank keeps its own frame records (self.trace)."""
        with self.trace.frame() as rec:
            return self._render_group(rec, spp, progress, resume,
                                      interrupt, on_frame, fetch)

    def _render_group(self, rec, spp, progress, resume, interrupt,
                      on_frame, fetch):
        spp = spp if spp is not None else self.cscene.prefs.sample_count
        npix = self.height * self.width
        dev = self.device
        if self.empty_scene or self.max_depth == 0 or spp < 1:
            return super().render_persistent(spp=spp, progress=progress)
        B = min(self.tile_rays, _next_pow2(npix))
        total = npix * spp
        final = torch.zeros((npix, 4), dtype=torch.float32, device=dev)
        if resume is not None:
            # rank 0 carries the resumed sum whole: the partials are only
            # ever summed
            if self.rank == 0:
                with rec.span("upload", device=True):
                    final += torch.tensor(
                        np.asarray(resume["final_sum"], np.float32),
                        device=dev).reshape(npix, 4)
                rec.add("h2d_bytes", final.nbytes)
            feed = _QueueFeed(GidQueue(pending=resume["pending"],
                                       ranges=resume["ranges"]),
                              self.rank, self.D)
        else:
            P = (spp + self.D - 1) // self.D
            feed = _SplitFeed(self.rank * P * npix, P * npix, total, self.D)
        out = self._run_pool(B, self.refill_quantum(B), spp, feed, final,
                             total, progress, interrupt, on_frame)
        if isinstance(out, tuple):
            return out
        dist.all_reduce_sum_(out)
        return self._fetch(rec, out, spp, fetch)

    def render_pass(self, accum, pass_idx: int, spp: int):
        """One whole-frame pass over the group: rank r renders pixels
        [r*n, (r+1)*n) of the tile-order schedule (n = ceil(npix/D))
        through its pool; returns the running mean with `accum`, the
        same on every rank."""
        H, W = self.height, self.width
        npix = H * W
        if self.empty_scene or self.max_depth == 0:
            return super().render_pass(accum, pass_idx, spp)
        n = (npix + self.D - 1) // self.D
        B = min(self.tile_rays, _next_pow2(n))
        final = accum.new_zeros(npix, 4)
        feed = _SplitFeed(pass_idx * npix + self.rank * n, n,
                          (pass_idx + 1) * npix, self.D)
        out = self._run_pool(B, self.refill_quantum(B), spp, feed, final,
                             npix)
        sample = dist.all_reduce_sum_(out).reshape(H, W, 4)
        k = accum.new_tensor(float(pass_idx + 1))
        return (accum * (k - 1.0) + sample) / k

    def render_ids(self, ranges, spp: int) -> np.ndarray:
        """Render a set of queue-id ranges (gid = pass * npix +
        sched_index) across the group: the (npix, 4) radiance SUM of
        those paths on the host, the same on every rank. The cluster's
        tile path (parallel/cluster.py::render_tile): a tile times its
        passes is one contiguous range a pass."""
        queue = GidQueue(ranges=ranges)
        n = queue.left()
        npix = self.width * self.height
        if n == 0:
            return np.zeros((npix, 4), np.float32)
        per = (n + self.D - 1) // self.D
        B = min(self.tile_rays, max(_next_pow2(per), 1024))
        final = torch.zeros((npix, 4), dtype=torch.float32,
                            device=self.device)
        # host-built lanes: a tile's queue is one short range a pass
        out = self._run_pool(B, self.refill_quantum(B), spp,
                             _QueueFeed(queue, self.rank, self.D,
                                        dev_ranges=False), final, n)
        return dist.all_reduce_sum_(out).cpu().numpy()


def make_renderer(cscene, kind: str = smp.RANDOM,
                  bounces: int | None = None,
                  tile_rays: int | None = None, nee: bool = False,
                  graphs: bool = True):
    """The product's renderer factory: ShardedPoolRenderer when the
    process group has more than one rank, else the single-card
    WavefrontRenderer on the scene's device."""
    if dist.multi_rank():
        return ShardedPoolRenderer(cscene, kind=kind, bounces=bounces,
                                   tile_rays=tile_rays, nee=nee,
                                   graphs=graphs)
    n = torch.cuda.device_count() if cscene.device.type == "cuda" else 0
    if n > 1:
        logging.info("%d CUDA devices visible; rendering on %s only. To "
                     "render on every card, run a rank per card: torchrun "
                     "--nproc-per-node %d -m craytpu_torch ...", n,
                     cscene.device, n)
    return WavefrontRenderer(cscene, kind=kind, bounces=bounces,
                             tile_rays=tile_rays, nee=nee, graphs=graphs)
