"""The port's tracer: one record a frame of the forward render, with host
spans, counters and the device's intervals on one time axis.

Tracing is on for a frame (a render_persistent, render_pass or render_ids
call; nested calls belong to the outermost) when, as it starts:

  - CRAYTPU_TRACE is set (and not "0"),
  - the CLI's --trace DIR asked for it (force()), or
  - a torch profiler is recording: whoever profiles the program gets its
    spans in the profile and its frame records.

Off, a frame pays the dispatch counters' integer increments and marks
that do nothing: no CUDA event, no profiler range, no clock read a
dispatch, no list that grows. Tracing never enters a graph's key and puts every mark
outside the captured graphs, so turning it on captures nothing.

A frame record (Tracer.frames keeps the last KEEP of them, a dict each):

  id, profiled       the frame's number in its renderer; whether a
                     profiler was recording when it started
  origin_s           perf_counter() at the frame's first device mark
  host_ms            the frame's host wall
  spans              {name, parent, frame, depth, t0_ms, t1_ms, dev_ms,
                     key}: host start and end from origin_s; dev_ms, for a
                     span that enqueues device work, its interval on the
                     device on the same axis: from its dispatches' events
                     where its work is dispatches, else from CUDA events
                     before and after it (a span opened with device=True:
                     copies, eager ops); key, a graph capture's key
  dispatches         {kind, span, dev_ms}: every GraphCache call, by the
                     kind of its key (pool, fpr, shrink, flush, prime;
                     init, multi, compact on the per-pass path) and the
                     innermost span it ran in
  device_ms          device milliseconds by dispatch kind, and of the
                     spans whose device work is no dispatch (upload, fetch,
                     refill.host_lanes, the framebuffer's copy back)
  device_span_ms     [first mark, end of the last device work]
  device_busy_ms     the union of the device intervals in that span
  gaps               the device's idle stretches inside that span: at_ms,
                     ms, before (the dispatch or span whose work followed)
                     and span (the innermost host span open at its middle)
  counts             dispatches by kind, replays, captures, kernel launches
                     by wrapper (and those that replays added); the pool's
                     steps, drain steps, refills, shrinks; refill_short
                     (the dead lanes the refills left unfilled, B - live
                     - m * Q a refill: the quanta's remainder); lanes
                     (sum of k * B over steps), live (live lane-bounces),
                     live_bound (the part of live that is a bound), paths
                     (the queue entries the frame started with: a group's,
                     on a rank); h2d_bytes and d2h_bytes
  hist               dispatches by (kind, width, ...) as the pool loop
                     names them
  occupancy          live / lanes; bounces_per_path: live / paths

The alignment: the frame's first device mark is made while the device is
idle (a frame starts after the previous one ended synchronised), so its
host time stands for its device time, and every later mark's device time
is that plus the events' elapsed time. On the CPU, which runs a
dispatch's work inside the call, a mark is the host clock.

Live lane-bounces come from the counts the pool loop reads once a step:
a step's live-in is the previous step's count plus the lanes its refill
took (the first step's: the prime's take). That is exact for a step of
one bounce; for a step of k > 1 bounces live-in * k is an upper bound,
counted also in live_bound.

Set-up spans (kernels.load, scene.load, bvh.build, scene.compile, and
graph captures outside a frame) go to the process's record, PROCESS.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import deque

ENV = "CRAYTPU_TRACE"
# frame records a renderer keeps
KEEP = 16
_FORCED = [False]
_NULL = contextlib.nullcontext()


def force(on: bool = True) -> None:
    """Trace every frame and set-up span of this process from here on
    (the CLI's --trace DIR)."""
    _FORCED[0] = bool(on)


def profiler_on() -> bool:
    import torch
    return torch.autograd._profiler_enabled()


def env_on() -> bool:
    """CRAYTPU_TRACE is set (and not "0")."""
    return os.environ.get(ENV, "") not in ("", "0")


def wanted() -> bool:
    """Whether a frame or set-up span starting now is traced."""
    return _FORCED[0] or env_on() or profiler_on()


def _profiler_range(name: str):
    """A profiler range named `name` on the host's timeline only (a
    torch.profiler.record_function range would also draw an annotation
    over the device's kernels, which readers of the device timeline take
    for device work)."""
    import torch
    return torch._C._profiler._RecordFunctionFast(name)


class _Off:
    """The record of a frame that is not traced: every mark does
    nothing."""
    on = False

    def span(self, name, device=False, key=None):
        return _NULL

    def dispatch(self, kind):
        return _NULL

    def add(self, name, n=1):
        pass

    def tally(self, key):
        pass

    def live(self, n):
        pass

    def step(self, k, width, drain=False):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "device", "key", "i", "rng")

    def __init__(self, rec, name, device, key):
        self.rec, self.name, self.device, self.key = rec, name, device, key

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        self.i = len(rec.spans)
        rec.spans.append([self.name, parent, len(rec.stack),
                          time.perf_counter(), None,
                          rec.mark() if self.device else None, None,
                          False, self.key])
        rec.stack.append(self.i)
        self.rng = None
        if rec.profiled:
            self.rng = _profiler_range(self.name)
            self.rng.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        s = rec.spans[self.i]
        if self.device:
            s[6] = rec.mark()
        if self.rng is not None:
            self.rng.__exit__(*exc)
        s[4] = time.perf_counter()
        rec.stack.pop()
        return False


class _Dispatch:
    __slots__ = ("rec", "kind", "a")

    def __init__(self, rec, kind):
        self.rec, self.kind = rec, kind

    def __enter__(self):
        rec = self.rec
        # the spans that hold a dispatch are not device work of their own
        for i in rec.stack:
            rec.spans[i][7] = True
        self.a = rec.mark()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.dispatches.append((self.kind, rec.stack[-1] if rec.stack
                               else None, self.a, rec.mark()))
        return False


class _Frame:
    """An open frame's record."""
    on = True

    def __init__(self, tracer, fid: int, profiled: bool):
        self.tracer = tracer
        self.id = fid
        self.profiled = profiled
        self.cuda = tracer.device.type == "cuda"
        self.spans: list = []
        self.stack: list = []
        self.dispatches: list = []
        self.counts: dict = {}
        self.hist: dict = {}
        self.live_in = None
        self.used: list = []
        self.start = tracer.snapshot()
        self.origin = self.mark()
        self.origin_s = time.perf_counter()

    # -- marks ------------------------------------------------------------
    def mark(self):
        """A device mark: a CUDA event recorded on the current stream, or
        on the CPU the host clock."""
        if not self.cuda:
            return time.perf_counter()
        ev = self.tracer.event()
        ev.record()
        self.used.append(ev)
        return ev

    def span(self, name, device=False, key=None):
        """A span; device=True marks its own interval on the device, for
        work that is no GraphCache dispatch (copies, eager ops)."""
        return _Span(self, name, device, key)

    def dispatch(self, kind):
        return _Dispatch(self, kind)

    # -- counters ---------------------------------------------------------
    def add(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def tally(self, key):
        self.hist[key] = self.hist.get(key, 0) + 1

    def live(self, n):
        """The live lanes entering the pool's next step, where the loop
        read them."""
        self.live_in = n

    def step(self, k, width, drain=False):
        """A pool step of k bounces over `width` lanes, entered by the
        live lanes last given to live() (none given: counted as the width
        and as a bound)."""
        live, self.live_in = self.live_in, None
        exact = live is not None
        live = width if live is None else min(live, width)
        self.add("steps")
        if drain:
            self.add("drain_steps")
        self.add("lanes", k * width)
        self.add("live", k * live)
        if k > 1 or not exact:
            self.add("live_bound", k * live)
        self.tally(("drain", width) if drain else ("step", width, k))

    # -- the record -------------------------------------------------------
    def close(self) -> dict:
        tr = self.tracer
        t_end = time.perf_counter()
        if self.cuda:
            # every mark of the frame has run once the last has
            self.used[-1].synchronize()
            origin = self.origin

            def ms(m):
                return origin.elapsed_time(m) if m is not origin else 0.0
        else:
            def ms(m):
                return 1e3 * (m - self.origin)

        def host(t):
            return 1e3 * (t - self.origin_s)
        spans, ivs = [], []
        device_ms: dict = {}
        for (name, parent, depth, t0, t1, a, b, held, key) in self.spans:
            dev = None if a is None else [ms(a), ms(b)]
            spans.append({"name": name, "parent": parent, "frame": self.id,
                          "depth": depth, "t0_ms": host(t0),
                          "t1_ms": host(t1), "dev_ms": dev, "key": key})
            if dev is not None and not held:
                ivs.append((dev[0], dev[1], name))
        dispatches = []
        for kind, span, a, b in self.dispatches:
            dev = [ms(a), ms(b)]
            dispatches.append({"kind": kind, "span": span, "dev_ms": dev})
            ivs.append((dev[0], dev[1], kind))
            # a span without marks of its own spans its dispatches
            while span is not None:
                s = spans[span]
                if self.spans[span][5] is None:
                    s["dev_ms"] = dev if s["dev_ms"] is None else [
                        min(s["dev_ms"][0], dev[0]), max(s["dev_ms"][1],
                                                         dev[1])]
                span = s["parent"]
        for a, b, kind in ivs:
            device_ms[kind] = device_ms.get(kind, 0.0) + (b - a)
        gaps, t, busy = [], 0.0, 0.0
        for a, b, kind in sorted(ivs):
            if a > t:
                gaps.append({"at_ms": t, "ms": a - t, "before": kind,
                             "span": _innermost(spans, 0.5 * (t + a))})
            busy += max(b, t) - max(a, t)
            t = max(t, b)
        for ev in self.used:
            tr.release(ev)
        end = tr.snapshot()
        counts = dict(self.counts)
        counts.update({k: end[k] - self.start[k]
                       for k in ("replays", "captures")})
        for k in ("dispatches", "replayed", "launches"):
            counts[k] = {n: v - self.start[k].get(n, 0)
                         for n, v in end[k].items()
                         if v != self.start[k].get(n, 0)}
        lanes = counts.get("lanes", 0)
        return {"id": self.id, "profiled": self.profiled,
                "origin_s": self.origin_s, "host_ms": host(t_end),
                "spans": spans, "dispatches": dispatches,
                "device_ms": device_ms, "device_span_ms": [0.0, t],
                "device_busy_ms": busy,
                "gaps": gaps, "counts": counts, "hist": dict(self.hist),
                "occupancy": counts.get("live", 0) / lanes if lanes else
                None, "bounces_per_path": counts.get("live", 0)
                / max(counts.get("paths", 0), 1)}


def _innermost(spans: list, t: float):
    """The name of the deepest span open at host time t (ms)."""
    best = None
    for s in spans:
        if s["t0_ms"] <= t <= s["t1_ms"] and (
                best is None or s["depth"] > best["depth"]):
            best = s
    return None if best is None else best["name"]


class Tracer:
    """One renderer's tracing: its frame records (`frames`, the newest
    last; `last`), the open frame's record (`rec`: OFF when none is open
    or it is not traced), and the counters its GraphCache adds to on
    every dispatch, traced or not (`dispatches` by kind, `replays`,
    `captures`, `replayed`: the kernel launches replays added, by wrapper
    name). counters(): the kernel wrappers whose `launches` a frame's
    record reads. CUDA events come from one pool a tracer, reused frame
    after frame."""

    def __init__(self, device, counters):
        self.device = device
        self.counters = counters
        self.frames: deque = deque(maxlen=KEEP)
        self.rec = OFF
        self.dispatches: dict = {}
        self.replays = 0
        self.captures = 0
        self.replayed: dict = {}
        self._free: list = []
        self._n = 0

    @property
    def last(self):
        """The newest frame record, or None."""
        return self.frames[-1] if self.frames else None

    def event(self):
        if self._free:
            return self._free.pop()
        import torch
        return torch.cuda.Event(enable_timing=True)

    def release(self, ev) -> None:
        self._free.append(ev)

    def snapshot(self) -> dict:
        return {"replays": self.replays, "captures": self.captures,
                "dispatches": dict(self.dispatches),
                "replayed": dict(self.replayed),
                "launches": {c.__name__: c.launches
                             for c in self.counters()
                             if hasattr(c, "launches")}}

    @contextlib.contextmanager
    def frame(self):
        """Around a frame: yields its record (the open one inside another
        frame, OFF when not traced) and keeps it once the frame ends."""
        if self.rec.on or not wanted():
            yield self.rec
            return
        self._n += 1
        rec = self.rec = _Frame(self, self._n, profiler_on())
        try:
            with rec.span("frame"):
                yield rec
        except BaseException:
            self.rec = OFF
            raise
        self.rec = OFF
        self.frames.append(rec.close())

    def span(self, name: str, key=None):
        """A host span in the open frame, else in the process's record."""
        if self.rec.on:
            return self.rec.span(name, key=key)
        return setup_span(name, key)


class _Process:
    """The process's record: set-up spans, each {name, parent, t0_s, t1_s,
    key} (perf_counter seconds)."""

    def __init__(self):
        self.spans: deque = deque(maxlen=256)
        self.stack: list = []

    @contextlib.contextmanager
    def span(self, name: str, key=None):
        s = {"name": name, "parent": self.stack[-1] if self.stack else None,
             "t0_s": time.perf_counter(), "t1_s": None, "key": key}
        self.spans.append(s)
        self.stack.append(name)
        rng = _profiler_range(name) if profiler_on() else _NULL
        try:
            with rng:
                yield s
        finally:
            self.stack.pop()
            s["t1_s"] = time.perf_counter()


PROCESS = _Process()


def setup_span(name: str, key=None):
    """A set-up span of the process's record, when tracing is wanted."""
    return PROCESS.span(name, key) if wanted() else _NULL


def setup(name: str):
    """Decorator: every call of the function is a set-up span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def spanned(*a, **k):
            with setup_span(name):
                return fn(*a, **k)
        return spanned
    return deco


def summary(rec: dict) -> str:
    """A frame record in a few lines: what the pool loop counted, the
    device ms of each dispatch kind, and the longest idle gaps with the
    span the host was in."""
    c = rec["counts"]
    occ = rec["occupancy"]
    lines = [
        f"frame {rec['id']}: {rec['host_ms']:.1f} ms host, "
        f"{c.get('steps', 0)} step dispatches (occupancy "
        + ("-" if occ is None else f"{occ:.3f}")
        + f"), {c.get('refills', 0)} refills, {c.get('shrinks', 0)} "
        f"shrinks, {c.get('live', 0) / 1e6:.1f}M lane-bounces "
        f"({rec['bounces_per_path']:.2f}/path, "
        f"{c.get('live_bound', 0) / 1e6:.1f}M of them bounds); "
        f"{c['replays']} replays, {c['captures']} captures; "
        f"h2d {c.get('h2d_bytes', 0) / 1e6:.1f} MB, d2h "
        f"{c.get('d2h_bytes', 0) / 1e6:.1f} MB"]
    lo, hi = rec["device_span_ms"]
    busy = rec["device_busy_ms"]
    lines.append("  device ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(rec["device_ms"].items(),
                                          key=lambda kv: -kv[1]))
        + f"; span {hi - lo:.2f}")
    if hi > lo:
        lines[-1] += f" (busy {100 * busy / (hi - lo):.1f}%)"
    top = sorted(rec["gaps"], key=lambda g: -g["ms"])[:5]
    if top:
        lines.append("  longest gaps: " + ", ".join(
            f"{g['ms']:.2f} ms at {g['at_ms']:.1f} in {g['span']} before "
            f"{g['before']}" for g in top))
    for k in sorted(rec["hist"], key=str):
        lines.append(f"  {k}: {rec['hist'][k]}")
    return "\n".join(lines)


def to_json(records) -> dict:
    """Frame records and the process's set-up spans as JSON data: a
    histogram key becomes its parts joined by commas."""
    return {"frames": [dict(r, hist={",".join(map(str, k)): v
                                     for k, v in r["hist"].items()})
                       for r in records],
            "process": list(PROCESS.spans)}
