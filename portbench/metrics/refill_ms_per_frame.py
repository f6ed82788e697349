"""refill_ms_per_frame (program span): device milliseconds a frame in the
pool's refill dispatches (kind `fpr`: the Morton sort and permutes of the
pool, the flush of the dead tail, the fresh primaries), from the CUDA
events around each dispatch in the program's frame records of the traced
window (frame_records.py)."""

from portbench.frame_records import per_frame


def read(run):
    return per_frame(run, lambda r: r["device_ms"].get("fpr", 0.0))
