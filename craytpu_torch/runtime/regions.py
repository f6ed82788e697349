"""Per-region render progress — the wavefront analogue of the
reference's per-tile overlays and progress bars (utils/ui.c:236-320).
A copy of the JAX package's runtime/regions.py (numpy only).

The persistent renderer consumes a (pixel, pass) id queue in schedule
order, so "how far along is each part of the image" is a pure function
of the consumed-count: queue position q maps to pixel schedule[q % npix]
(wavefront_pt._prime_dev). This tracker precomputes, per grid cell, the
sorted schedule positions of its pixels; per-cell issued counts for any
head position are then two searchsorteds — O(cells) host math per
update, no device traffic.

"In flight" mirrors the reference's highlighted tiles: cells holding
queue positions inside the live window [head - pool_lanes, head) have
lanes bouncing on device right now.
"""

from __future__ import annotations

import numpy as np


class RegionTracker:
    def __init__(self, width: int, height: int, xs, ys,
                 gw: int = 16, gh: int = 10):
        """xs, ys: the pixel schedule (queue order for one pass), fb
        coords; gw x gh: grid size (clamped to the image)."""
        self.gw = int(min(gw, width))
        self.gh = int(min(gh, height))
        xs = np.asarray(xs)
        ys = np.asarray(ys)
        self.npix = int(xs.shape[0])
        cx = np.minimum((xs.astype(np.int64) * self.gw) // width,
                        self.gw - 1)
        # schedule ys are framebuffer y-up; grid row 0 = image TOP
        cy = np.minimum(((height - 1 - ys.astype(np.int64)) * self.gh)
                        // height, self.gh - 1)
        region = (cy * self.gw + cx).astype(np.int32)
        order = np.argsort(region, kind="stable")
        self._pos = np.arange(self.npix, dtype=np.int64)[order]
        counts = np.bincount(region, minlength=self.gw * self.gh)
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        self.cell_pix = counts

    def _count_upto(self, head_in_pass: int) -> np.ndarray:
        """Per-cell number of schedule positions < head_in_pass."""
        out = np.empty(self.gw * self.gh, np.int64)
        for r in range(self.gw * self.gh):
            seg = self._pos[self._starts[r]:self._starts[r + 1]]
            out[r] = np.searchsorted(seg, head_in_pass)
        return out

    def snapshot(self, issued: int, spp: int, pool_lanes: int):
        """-> (done_frac (gh, gw) f32, inflight (gh, gw) bool).

        issued: total (pixel, pass) ids consumed from the queue;
        pool_lanes: live window size (ids possibly still bouncing).
        """
        issued = max(0, int(issued))
        total_per_cell = np.maximum(self.cell_pix * spp, 1)
        fp, rem = divmod(issued, self.npix)
        fp = min(fp, spp)
        done = self.cell_pix * fp + self._count_upto(rem)
        lo = max(0, issued - int(pool_lanes))
        lp, lrem = divmod(lo, self.npix)
        retired = self.cell_pix * min(lp, spp) + self._count_upto(lrem)
        frac = (retired / total_per_cell).astype(np.float32)
        inflight = (done - retired) > 0
        return (frac.reshape(self.gh, self.gw),
                inflight.reshape(self.gh, self.gw))
