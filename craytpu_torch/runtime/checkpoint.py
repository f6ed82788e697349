"""Render checkpoint/resume (a copy of the JAX package's
runtime/checkpoint.py, so that a checkpoint written by either package
loads in the other: same magic strings, same .npz fields).

The reference has none (SURVEY.md §5): the closest thing is abort-and-save
(S key, ui.c:206-212). Because the sampler streams are stateless functions
of (pixel, pass), the resumable state of any render is exactly
(accumulation buffer, completed pass count, total pass count) — persisting
that triple resumes bit-identically.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = "craytpu-ckpt-v1"
MAGIC_P = "craytpu-ckpt-persistent-v1"
MAGIC_P2 = "craytpu-ckpt-persistent-v2"


class GidQueue:
    """Host-side generalized work queue over global (pixel, pass) ids
    (gid = pass * npix + sched_index): explicit re-enqueued ids first
    (in-flight paths from a checkpoint), then contiguous (start, end)
    ranges. A fresh render is the single range [0, npix*spp); a resumed
    one is whatever the checkpoint recorded (one range per device of the
    interrupted render). Pure python ints — exact at any scale."""

    def __init__(self, pending=None, ranges=None):
        self.pending: list[int] = [int(x) for x in (
            pending if pending is not None else [])]
        self.ranges: list[list[int]] = [
            [int(a), int(b)] for a, b in (ranges or []) if int(b) > int(a)]

    def left(self) -> int:
        return len(self.pending) + sum(b - a for a, b in self.ranges)

    def take(self, n: int) -> np.ndarray:
        """Up to n ids, pending first, then range heads (in order)."""
        ids = self.pending[:n]
        self.pending = self.pending[len(ids):]
        while len(ids) < n and self.ranges:
            a, b = self.ranges[0]
            t = min(n - len(ids), b - a)
            ids.extend(range(a, a + t))
            self.ranges[0][0] += t
            if self.ranges[0][0] >= b:
                self.ranges.pop(0)
        return np.asarray(ids, np.int64)


def save(path: str, accum: np.ndarray, completed_passes: int,
         total_passes: int, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, magic=MAGIC, accum=np.asarray(accum, np.float32),
        completed_passes=np.int64(completed_passes),
        total_passes=np.int64(total_passes),
        meta=np.array(repr(meta or {})))


def save_persistent(path: str, final_sum: np.ndarray, pending: np.ndarray,
                    ranges, total_passes: int, shape: tuple) -> None:
    """Persistent-wavefront checkpoint (v2): the RADIANCE SUM framebuffer
    (not yet divided by spp), the in-flight queue ids whose paths must be
    re-traced on resume, and the untaken queue as (start, end) id RANGES
    — one range for a single-device render, one per device for a
    sharded render (each device's queue tail). Resumable on any device
    count."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    r = np.asarray([list(x) for x in ranges], np.int64).reshape(-1, 2)
    np.savez_compressed(
        path, magic=MAGIC_P2, final_sum=np.asarray(final_sum, np.float32),
        ranges=r, pending=np.asarray(pending, np.int64),
        total_passes=np.int64(total_passes),
        shape=np.asarray(shape, np.int64))


def kind(path: str) -> str:
    """"progressive" | "persistent" for a checkpoint file."""
    with np.load(path, allow_pickle=False) as z:
        m = str(z["magic"])
    if m == MAGIC:
        return "progressive"
    if m in (MAGIC_P, MAGIC_P2):
        return "persistent"
    raise ValueError(f"{path} is not a craytpu checkpoint")


def load(path: str):
    """Returns (accum, completed_passes, total_passes)."""
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path} is not a craytpu checkpoint")
        return (z["accum"], int(z["completed_passes"]),
                int(z["total_passes"]))


def load_persistent(path: str):
    """Returns (resume dict for render_persistent, total_passes, shape).
    The resume dict is {"final_sum", "pending", "ranges"}; v1 files (one
    qpos, single-device) load as the single range [qpos, npix*spp)."""
    with np.load(path, allow_pickle=False) as z:
        magic = str(z["magic"])
        total = int(z["total_passes"])
        shape = tuple(int(x) for x in z["shape"])
        if magic == MAGIC_P:
            npix = shape[0] * shape[1]
            ranges = [[int(z["qpos"]), npix * total]]
        elif magic == MAGIC_P2:
            ranges = [[int(a), int(b)] for a, b in z["ranges"]]
        else:
            raise ValueError(f"{path} is not a persistent checkpoint")
        return ({"final_sum": z["final_sum"], "pending": z["pending"],
                 "ranges": ranges}, total, shape)
