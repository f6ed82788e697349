"""CUDA graphs of the forward integrator: the port's counterpart of the
JAX package's jitted dispatches (WavefrontRenderer._jit and _multi_cache,
craytpu/models/wavefront_pt.py:110-124, :127-170, :955-1084, :1202-1335).

A dispatch is a function of no arguments that reads only static tensors
(allocated outside any capture and kept by their owner) and writes its
results into static tensors, as the last ops it runs: the counterpart of
craytpu's donated buffers. A Python number it needs per call is a 0-d
device tensor that the caller sets (`fill_`) before the dispatch; one
that would be baked into a kernel argument is replayed unchanged.

On the card the first call of a key runs the function once eagerly on a
side stream (the warm-up PyTorch's graph notes ask for; it does this
call's work and any first-use host work: tables built at first launch,
kernel libraries loaded, constants cached) and then captures it into a
torch.cuda.CUDAGraph, which every later call of the key replays. Every
graph of one cache shares one memory pool: they never run concurrently,
and nothing a graph allocates outlives its replay (its results are in the
static tensors). On the CPU, or with the cache switched off, every call
runs eagerly. A capture that fails raises, naming its key; nothing falls
back to the eager path.

Launch counters: a kernel wrapper counts a launch on the host (its
`launches` attribute), so under a graph it would only count the capture.
A capture therefore records the launches each counter took while it was
captured, takes them back, and adds them again on every replay.

Every call passes through __call__, which counts it by its key's kind
(key[0]) in the renderer's tracer (utils/trace.py), and replays and
captures with it; in a traced frame it also marks the call's interval on
the device and spans each capture (`graph.capture`, with its key).
"""

from __future__ import annotations


class GraphCache:
    """The captured dispatches of one renderer, keyed as craytpu keys its
    `_multi_cache`, plus the context every capture bakes in (`context`).

    trace: the renderer's tracer (utils/trace.py), which counts the
    calls, replays, captures and replayed launches; its counters(): the
    kernel wrappers whose `launches` a replay adds to, looked up at each
    capture (a wrapper swapped for an A/B is the one counted; one without
    a counter is skipped). `on` is fixed at construction: False on the
    CPU whatever is asked."""

    def __init__(self, device, enabled: bool, trace):
        self._on = bool(enabled) and device.type == "cuda"
        self.trace = trace
        # key + (context,) + buffer addresses -> (graph, launches a
        # replay adds)
        self.graphs: dict = {}
        self.ctx = None
        self.mempool = None

    @property
    def on(self) -> bool:
        return self._on

    @property
    def replays(self) -> int:
        return self.trace.replays

    @property
    def captures(self) -> int:
        return self.trace.captures

    def context(self, ctx) -> None:
        """Set what the captures depend on beyond their key (flags, the
        identity of the scene's tables and kernel wrappers): it is part
        of every key from here on. Under a new value every key captures
        afresh, and going back to an earlier one replays its graphs (they
        read the same addresses). They all share one memory pool."""
        self.ctx = ctx

    def __call__(self, key: tuple, fn, reads=()) -> None:
        """Run fn() as the graph of `key`: eagerly when off, else capture
        it at the key's first call and replay it after. reads: tensors fn
        reads or writes that a caller passes in (the addresses a graph
        holds are part of its key)."""
        tr = self.trace
        kind = key[0]
        tr.dispatches[kind] = tr.dispatches.get(kind, 0) + 1
        with tr.rec.dispatch(kind):
            if not self.on:
                fn()
                return
            full = key + (self.ctx,) + tuple(t.data_ptr() for t in reads)
            entry = self.graphs.get(full)
            if entry is None:
                with tr.span("graph.capture", key=key):
                    self._capture(full, fn)
                return
            graph, launches = entry
            graph.replay()
            tr.replays += 1
            for c, n in launches:
                c.launches += n
                tr.replayed[c.__name__] = tr.replayed.get(c.__name__, 0) + n

    def _capture(self, key: tuple, fn) -> None:
        import torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if self.mempool is None:
            self.mempool = torch.cuda.graph_pool_handle()
        counters = [c for c in self.trace.counters()
                    if hasattr(c, "launches")]
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.mempool, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            launches = [(c, c.launches - b) for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b
        self.graphs[key] = (graph, launches)
        self.trace.captures += 1
