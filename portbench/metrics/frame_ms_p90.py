"""frame_ms_p90 (host clock): the 90th percentile of the wall times of all
requests in the window, each ended by its output on the host: the frame
an animation or preview user waits for. Linear interpolation between
order statistics (numpy's default)."""

import numpy as np


def read(run):
    if "walls" not in run:
        return None
    return float(np.quantile(np.asarray(run["walls"]) * 1e3, 0.9))
