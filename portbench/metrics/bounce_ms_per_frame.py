"""bounce_ms_per_frame (program span): device milliseconds a frame in the
pool's step dispatches (kind `pool`: K2, K1, shading, the PCG and
roulette of each bounce; the drain's steps included), from the CUDA
events around each dispatch in the program's frame records of the traced
window (frame_records.py)."""

from portbench.frame_records import per_frame


def read(run):
    return per_frame(run, lambda r: r["device_ms"].get("pool", 0.0))
