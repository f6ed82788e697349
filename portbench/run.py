"""The benchmark of craytpu_torch, the PyTorch/CUDA port, on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one process: it loads the cell's scene (BENCHMARK.json names
the cell's configuration and traffic mix; the mix names its entry), warms
up the shapes that entry uses, then, with --trace 0, sends requests back
to back for --seconds and reports the cell's end-to-end metrics; with
--trace 1 it times the dispatches of a few whole requests without the
profiler, then profiles a short window of whole requests, and reports
the cell's per-layer metrics. Either way it then frees the program's state
and hands the kept outputs (the window's last request and one drawn
from the seed) to the entry's own `check`, which compares them with the
plain reference; each output is correct where every number that the
traffic's `limits` name is within its limit. The last line of standard
output is one JSON object (correct, attempted, failed, metrics, device,
breakdown with --trace 1, checks); the numbers compared are also the
last lines of standard error.

Exit codes: 0 with a result; 2 for bad arguments; 3 when no CUDA card
(or too few for the cell) is visible; 4 when JAX or the JAX package was
loaded in this process. Nothing is printed on standard output then.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "craytpu")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port's kernels build into build/craytpu_torch/ (its default, or
    CRAYTPU_CACHE where a caller set it) and its native BVH builder next
    to its source; PyTorch's and Triton's caches go under build/portbench/
    in case anything the port loads uses them."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


@contextlib.contextmanager
def capture_timer():
    """Seconds spent in the program's CUDA graph captures (each key's
    first call: its eager run and its capture) inside the block."""
    from craytpu_torch.utils.graphs import GraphCache
    orig = GraphCache._capture
    acc = {"s": 0.0, "n": 0}

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **k)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["n"] += 1
    GraphCache._capture = timed
    try:
        yield acc
    finally:
        GraphCache._capture = orig


class Keep:
    """The outputs kept for the check: the window's last request and one
    drawn from the seed (reservoir sampling), nothing else."""

    def __init__(self, seed: int):
        from portbench import scenes
        self.rng = scenes.rng(seed, scenes.KEEP)
        self.n = 0
        self.drawn = self.last = None

    def add(self, out) -> None:
        if self.rng.integers(0, self.n + 1) == 0:
            self.drawn = out
        self.last = out
        self.n += 1

    def outputs(self) -> list:
        return [x for x in (self.drawn, self.last) if x is not None]


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def window(entry, seconds: float, keep: Keep, device: str) -> dict:
    """Requests back to back until `seconds` have passed; each request's
    wall time ends when its output is on the host. Graph captures inside
    the window are counted (there should be none)."""
    walls = []
    _sync(device)
    with capture_timer() as cap:
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            out = entry.request()
            _sync(device)
            now = time.perf_counter()
            walls.append(now - t)
            keep.add(out)
            if now - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    return {"walls": walls, "window_s": window_s, "captures": cap["n"]}


def fifths(walls: list) -> str:
    """The mean request wall of each fifth of the window, in order."""
    ends, t, out = [], 0.0, []
    for x in walls:
        t += x
        ends.append(t)
    for i in range(5):
        part = [x for x, e in zip(walls, ends)
                if i * t / 5 < e <= (i + 1) * t / 5]
        out.append("%.4f" % (sum(part) / len(part)) if part else "-")
    return " ".join(out)


def _spanned(entry, spans, n: int, keep: Keep) -> None:
    spans.reset()
    for _ in range(n):
        keep.add(entry.request())


def traced(entry, cell, keep: Keep) -> dict:
    """The per-layer readings: first `timed_requests` whole requests with
    host spans around the entry's dispatches and no profiler (the
    dispatches' host time), then `traced_requests` under the profiler
    with the spans (profiling.profile_window profiles again when the
    profiler lost kernel records)."""
    from portbench import profiling
    timed = profiling.Spans(profiled=False)
    entry.install_spans(timed)
    try:
        _spanned(entry, timed, int(cell.traffic["timed_requests"]), keep)
    finally:
        timed.remove()
    n = int(cell.traffic["traced_requests"])
    spans = profiling.Spans()
    entry.install_spans(spans)
    try:
        prof = profiling.profile_window(
            lambda: _spanned(entry, spans, n, keep))
    finally:
        spans.remove()
    return {"prof": prof, "spans": spans, "timed_spans": timed,
            "requests": n}


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of `cell` on `device` (the card; "cpu" serves the tests,
    untraced): set-up, the window, the check. Returns the result line's
    object."""
    import gc
    import torch
    from portbench import manifest, scenes
    t_start = time.perf_counter() if t_start is None else t_start
    entry_mod = cell.driver()
    adir = scenes.check_assets(cell.config, cell.root)
    text = scenes.scene_text(cell.config, cell.traffic)
    entry = entry_mod.Entry(text, adir, cell.traffic, seed, device)
    facts = entry.setup(capture_timer)
    setup_s = time.perf_counter() - t_start
    print("portbench setup: %.3f s; %s" % (setup_s, json.dumps(facts)),
          file=sys.stderr)
    keep = Keep(seed)
    if trace:
        run = traced(entry, cell, keep)
        attempted, spec = run["requests"], cell.per_layer
    else:
        run = window(entry, seconds, keep, device)
        attempted, spec = len(run["walls"]), cell.end_to_end
        w = sorted(run["walls"])
        print("portbench window: %d requests in %.3f s, %d graph captures "
              "in it; request s: min %.4f median %.4f max %.4f; mean by "
              "fifth of the window: %s" % (
                  len(w), run["window_s"], run["captures"], w[0],
                  w[len(w) // 2], w[-1], fifths(run["walls"])),
              file=sys.stderr)
    run.update(facts=facts, setup_s=setup_s, paths=entry.paths,
               entry=entry, entry_mod=entry_mod)
    metrics = {}
    for m in spec:
        v = manifest.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": None, "attempted": attempted, "failed": None,
              "metrics": metrics, "device": {}}
    if device == "cuda":
        result["device"] = device_info(torch, cell.chips)
    if trace:
        prof = run["prof"]
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        ops = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[k, v[0]] for k, v in ops[:10]],
            "idle_gaps": prof["idle_gaps"][:10]}
    # the reference runs once the program's state is freed
    outputs = keep.outputs()
    entry.close()
    run.clear()
    del keep, entry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = entry_mod.check(cell, text, adir, seed, outputs, device)
    result["reference_s"] = time.perf_counter() - t0
    limits = cell.traffic["limits"]
    checks, failed = {}, 0
    for i, r in enumerate(res):
        which = "drawn" if i == 0 and len(res) > 1 else "last"
        failed += 0 if all(r[k] <= lim for k, lim in limits.items()) else 1
        for k, lim in limits.items():
            checks[f"{k}.{which}"] = {"value": r[k], "limit": lim}
        print(f"portbench check: {which} output: {json.dumps(r)}",
              file=sys.stderr)
    result.update(correct=failed == 0, failed=failed, checks=checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    cache_env(ROOT)
    from portbench import manifest
    cell = manifest.Cell(args.workload, ROOT)
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        fail(3, f"cell {cell.name} needs {cell.chips} CUDA card(s); "
             f"{seen} visible")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        fail(4, f"modules of JAX or the JAX package loaded: {bad}")
    for k, v in result["checks"].items():
        print(f"portbench check: {k} = {v['value']!r} (limit "
              f"{v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
