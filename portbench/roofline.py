"""The yardstick's table of peaks and the bytes K1 and K2 must move.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 at 3.35e12 B/s;
the f32 rate outside the tensor cores, 67e12 FLOP/s, counts an fma as
two operations, so unfused f32 operations (every kernel is built with
-fmad=false) run at half of it. Both as chip_smoke.py states them.

Bytes, per lane of a launch (each input read once, each output written
once, whatever a kernel reads again):
  K1 (csrc/hitrec.cu): the ray (o, d: 6 floats) and its search distance
    (1), the winner's two ids, and the 16-float record out:
    (7 + 2 + 16) x 4 B, chip_smoke.py's K1_BYTES_LANE. The triangle and
    instance rows it gathers are not counted: which rows a launch reads
    depends on which lanes hit.
  K2 (csrc/closest_hit.cu): the ray (6 floats) and its limit (1) in, the
    winner (t, prim, inst) out: (7 + 3) x 4 B. The scene tables are not
    counted: how much of them a launch needs depends on the rays.
Operations are not counted for either: K1 computes the winner's test
only on hit lanes and K2's work is its walk, neither of which the card
counts inside a graph replay. So each bound is a strict lower bound of
the kernel's time, and its share a lower bound of the true roofline
share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_LANE_OPS_PER_S = F32_OPS_PER_S / 2

K1_BYTES_LANE = (7 + 2 + 16) * 4
K2_BYTES_LANE = (7 + 3) * 4


def k1_bytes(lanes: int) -> int:
    return K1_BYTES_LANE * lanes


def k2_bytes(lanes: int) -> int:
    return K2_BYTES_LANE * lanes


def share(bytes_: int, seconds: float):
    """Per cent of the HBM bound's time in `seconds` of kernel time; None
    where the kernel did not run."""
    if seconds <= 0.0 or bytes_ <= 0:
        return None
    return 100.0 * (bytes_ / HBM_BYTES_PER_S) / seconds
