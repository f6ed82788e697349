"""The program's own frame records (craytpu_torch/utils/trace.py) of the
traced window: a renderer keeps a record of each of its last frames, and
a frame that starts while a profiler records is traced and says so. The
window's frames are the last `requests` records with `profiled` set, the
window profiling.profile_window accepted (it renders its requests again
when it profiles again). A program without the records gives None."""

from __future__ import annotations


def window_frames(run):
    """The traced window's frame records, or None when the program keeps
    none (a program without the tracer, or an untraced run)."""
    n = run.get("requests")
    ren = getattr(run.get("entry"), "ren", None)
    frames = getattr(getattr(ren, "trace", None), "frames", None)
    if not n or not frames:
        return None
    recs = [r for r in frames if r.get("profiled")][-n:]
    return recs or None


def per_frame(run, value):
    """The mean of value(record) over the window's frames, or None."""
    recs = window_frames(run)
    if recs is None:
        return None
    return sum(value(r) for r in recs) / len(recs)
