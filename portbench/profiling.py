"""The traced window: torch.profiler over whole requests, read into device
time by kernel name, the device's busy intervals, host spans and the
idle gaps between device work.

profile_window and its retry follow chip_smoke.py's profile_frame and
profiled_replays: the profiler (CUPTI) now and then loses a run of
records inside CUDA graph replays, which shows as fewer kernel events
than the kernel wrappers counted; such a window is profiled again.
"""

from __future__ import annotations

import time

# wrapper name (the program's `launches` counter) -> its kernel's name
KERNELS = {"closest_hit": "closest_hit_kernel", "hitrec": "hitrec_kernel"}
SPAN = "portbench."


def launch_counts() -> dict:
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv
    return {"closest_hit": trv.closest_hit.launches,
            "hitrec": hr.hitrec_record.launches}


class Spans:
    """Host spans around methods of the program, installed for the traced
    run only: each call adds its host seconds and its count to
    `stats[label]`, and, where `profiled`, runs under
    torch.profiler.record_function("portbench.<label>"); `args[label]`
    keeps each call's positional arguments when asked."""

    def __init__(self, profiled: bool = True):
        self.profiled = profiled
        self.stats: dict = {}
        self.args: dict = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str, keep_args: bool = False):
        import torch
        orig = getattr(owner, name)
        st = self.stats.setdefault(label, {"n": 0, "s": 0.0})
        kept = self.args.setdefault(label, []) if keep_args else None

        def spanned(*a, **k):
            t0 = time.perf_counter()
            if self.profiled:
                with torch.profiler.record_function(SPAN + label):
                    out = orig(*a, **k)
            else:
                out = orig(*a, **k)
            st["s"] += time.perf_counter() - t0
            st["n"] += 1
            if kept is not None:
                kept.append(a)
            return out
        setattr(owner, name, spanned)
        self._undo.append((owner, name, orig))

    def reset(self) -> None:
        for st in self.stats.values():
            st["n"], st["s"] = 0, 0.0
        for v in self.args.values():
            v.clear()

    def remove(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


def _union(intervals) -> tuple:
    """(busy length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read_profile(prof, t_lo: float, t_hi: float) -> dict:
    """Device work in the window [t_lo, t_hi] (profiler microseconds):
    per kernel name (device seconds, count), busy seconds, kernel events
    of KERNELS, the host spans, and the idle gaps labelled by the
    innermost host span (or host op) that covers each gap's middle."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    dev_iv, spans, host_ops = [], [], []
    events = {k: 0 for k in KERNELS.values()}
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.name.startswith(SPAN):
            # a span also shows on the device's timeline as an annotation
            if ev.device_type != cuda:
                spans.append((s, e, ev.name[len(SPAN):]))
            continue
        if ev.device_type == cuda:
            if e <= t_lo or s >= t_hi:
                continue
            s, e = max(s, t_lo), min(e, t_hi)
            dev_iv.append((s, e))
            sec, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (sec + (e - s) * 1e-6, n + 1)
            for k in events:
                if k in ev.name:
                    events[k] += 1
        else:
            host_ops.append((s, e, ev.name))
    busy_us, merged = _union(dev_iv)
    gaps = []
    edges = [t_lo] + [x for iv in merged for x in iv] + [t_hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))

    def label(a, b):
        mid = 0.5 * (a + b)
        for pool in (spans, host_ops):
            cover = [x for x in pool if x[0] <= mid <= x[1]]
            if cover:
                return min(cover, key=lambda x: x[1] - x[0])[2]
        return "host (no span or op)"
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"by_name": by_name, "busy_s": busy_us * 1e-6,
            "window_s": (t_hi - t_lo) * 1e-6, "events": events,
            "idle_gaps": [[label(a, b), (b - a) * 1e-6]
                          for a, b in gaps[:10]]}


def profile_window(requests, attempts: int = 3) -> dict:
    """Profile `requests()` (whole requests, ending synchronised) until the
    profiler's kernel events of K1 and K2 equal their wrappers' counted
    launches, at most `attempts` windows. Returns read_profile's result
    with `counted` (wrapper counts) and `attempt`. Raises when events
    exceed the counts or no window agrees."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(SPAN + "window"):
                t0 = time.perf_counter()
                requests()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        after = launch_counts()
        win = [ev for ev in prof.events() if ev.name == SPAN + "window"
               and ev.device_type != torch.autograd.DeviceType.CUDA]
        lo, hi = win[0].time_range.start, win[0].time_range.end
        out = read_profile(prof, lo, hi)
        out["wall_s"] = wall
        out["counted"] = {k: after[k] - before[k] for k in KERNELS}
        out["attempt"] = attempt
        pairs = {k: (out["counted"][k], out["events"][v])
                 for k, v in KERNELS.items()}
        seen.append(pairs)
        if any(e > c for c, e in pairs.values()):
            raise RuntimeError(f"profiler saw more kernel events than the "
                               f"wrappers counted (count, events): {pairs}")
        if all(c == e for c, e in pairs.values()):
            return out
    raise RuntimeError(f"no profiled window's kernel events equal the "
                       f"wrappers' counts (count, events): {seen}")

