"""The comparison that decides `correct`: the timed path's framebuffer
against the reference, on pixels drawn from the seed.

The reference traces each checked pixel's paths of the request's passes
(one a pass) and combines them as the entry's framebuffer does (the
driver's `combine`). Per checked pixel and channel, the relative gap
|frame - ref| / max(|ref|, 1e-6). A path that the program traces over
the same closest hits rounds every value as the reference does, so the
gap of such a pixel is the rounding of the final sum over passes, a few
units in the last place. The compared number is `off_share`: the share
of checked values whose gap exceeds OFF_GAP (2^-20, about 8 units in the
last place), which counts the pixels where the program departs from the
reference: a different closest hit, a changed rounding on the way, a
lost or altered path.
"""

from __future__ import annotations

import numpy as np

OFF_GAP = 2.0 ** -20
DIVERGED_GAP = 1e-2


def gaps(frame: np.ndarray, ref: np.ndarray, xs, ys) -> dict:
    """frame (H, W, 4) against ref (P, 4) at pixels (xs, ys)."""
    got = frame[ys, xs].astype(np.float64)
    want = ref.astype(np.float64)
    bad = ~np.isfinite(got)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    rel[bad] = np.inf
    return {"off_share": float(np.mean(rel > OFF_GAP)),
            "diverged_share": float(np.mean(rel > DIVERGED_GAP)),
            "gap_q50": float(np.quantile(rel, 0.5)),
            "gap_q90": float(np.quantile(rel, 0.9)),
            "gap_max": float(np.max(rel))}
