"""CLI entry point — the equivalent of src/main.c, and the port of the
JAX package's main.py.

Flow mirrors main.c:14-42: parse args -> (test dispatch | worker mode |
load scene from file/stdin -> render, locally or over cluster workers ->
write image). Adds what the wavefront design gives for free: live
progress stats, SIGINT checkpoint-and-save, --resume, a live HTTP
preview and a profiler trace.

    python -m craytpu_torch assets/entry_scene.json -s 4 -d 320x200
    python -m craytpu_torch --worker 23222
    python -m craytpu_torch assets/entry_scene.json --nodes localhost:23222

Runs on the CUDA card; CRAYTPU_PLATFORM=cpu (or main(..., device="cpu"))
runs on the CPU.
"""

from __future__ import annotations

import os
import re
import sys
import time

from craytpu_torch import args as cliargs
from craytpu_torch.utils import logging, trace
from craytpu_torch.version import REFERENCE_VERSION, __version__

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a test file that imports either of these needs jax
_NEEDS_JAX = re.compile(r"^\s*(import jax|from jax[ .]|import craytpu\b|"
                        r"from craytpu[ .])", re.M)


def _status(pass_done: int, spp: int, t_start: float, width: int,
            height: int) -> None:
    """The reference's live stats line (renderer.c:137-155): completion %,
    us/path (approximated per pixel-sample), ETA, Msamples/s."""
    elapsed = time.perf_counter() - t_start
    frac = pass_done / spp
    samples = width * height * pass_done
    rate = samples / elapsed if elapsed > 0 else 0.0
    us_per = 1e6 / rate if rate > 0 else 0.0
    eta_ms = (elapsed / frac * (1 - frac)) * 1e3 if frac > 0 else 0.0
    sys.stderr.write(
        f"\r[{int(frac * 100):3d}%] μs/path: {us_per:.2f}, "
        f"ETA: {logging.smart_time(eta_ms)}, {rate / 1e6:.2f}Ms/s "
        f"(pass {pass_done}/{spp})")
    sys.stderr.flush()
    if pass_done == spp:
        sys.stderr.write("\n")


class _KeyPoller:
    """Non-blocking single-key reads from a TTY (the headless analogue of
    the reference's SDL key handler, ui.c:190-233: S=abort+save, X=abort,
    P=pause). No-ops when stdin is not an interactive terminal."""

    def __init__(self):
        self.enabled = False
        self._old = None

    def __enter__(self):
        import termios
        import tty
        try:
            if sys.stdin.isatty():
                self._fd = sys.stdin.fileno()
                self._old = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                self.enabled = True
        except (OSError, ValueError, termios.error):
            self.enabled = False
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)

    def poll(self) -> str | None:
        if not self.enabled:
            return None
        import select
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1).lower()
        return None

    def wait_key(self) -> str:
        import select
        select.select([sys.stdin], [], [])
        return sys.stdin.read(1).lower()


def _pytest_command(suite: str | None, collect: bool) -> list[str]:
    """The pytest command of --test/--tcount: the port's tests
    (tests/test_torch_*.py). Where jax cannot be imported, only the
    files that import neither jax nor the JAX package, without
    tests/conftest.py (which imports jax); the others are logged as left
    out."""
    import glob
    import importlib.util
    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    cmd = [sys.executable, "-m", "pytest", "-q"]
    if collect:
        cmd.append("--collect-only")
    if importlib.util.find_spec("jax") is None:
        left = []
        for f in files:
            with open(f, encoding="utf-8") as fh:
                if _NEEDS_JAX.search(fh.read()):
                    left.append(f)
        files = [f for f in files if f not in left]
        if left:
            logging.info("jax is not installed: leaving out %s",
                         ", ".join(os.path.basename(f) for f in left))
        cmd.append("--noconftest")
    return cmd + files + (["-k", suite] if suite else [])


def _collected(out: str) -> int:
    """The test count of `pytest --collect-only` output: one "::" line a
    test, or (at -qq, which the repository's -q addopts makes of -q)
    "<file>: <count>" lines."""
    n = 0
    for line in out.splitlines():
        m = re.fullmatch(r"\S+\.py: (\d+)", line.strip())
        if m:
            n += int(m.group(1))
        elif "::" in line:
            n += 1
    return n


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the CLI. device: where to render (None = the CUDA card, or
    the CPU when CRAYTPU_PLATFORM=cpu). Returns the exit code: 0, or 130
    after an interrupt that wrote a checkpoint.

    Several ranks (CRAYTPU_COORDINATOR / CRAYTPU_NUM_PROCESSES /
    CRAYTPU_PROCESS_ID, or torchrun's variables; parallel/dist.py) join
    one process group first, as the JAX package's main joins
    jax.distributed: every rank loads and compiles the scene and renders
    its share; rank 0 alone writes the image, checkpoints, status and
    progress lines, and decides an interrupt."""
    from craytpu_torch.parallel import dist
    if device is None and os.environ.get("CRAYTPU_PLATFORM") == "cpu":
        device = "cpu"
    joined = not dist.initialized() and dist.init_distributed(device=device)
    try:
        return _main(argv, device)
    finally:
        trace.force(False)
        if joined:
            import torch.distributed
            torch.distributed.destroy_process_group()


def _rank0() -> bool:
    """True on the only process, or on rank 0 of a group: images,
    checkpoints, status and progress are written once."""
    from craytpu_torch.parallel import dist
    return dist.rank() == 0


def _group_key(key: str | None) -> str | None:
    """Rank 0's key press (S, X, P, or None) on every rank of a group."""
    from craytpu_torch.parallel import dist
    return dist.broadcast_object(key) if dist.multi_rank() else key


def _main(argv: list[str] | None, device) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    opts = cliargs.parse_args(argv)
    logging.set_verbose(bool(opts.get("v")))
    logging.info("craytpu_torch v%s (c-ray %s capability surface)",
                 __version__, REFERENCE_VERSION)

    if opts.get("help"):
        print(cliargs.USAGE.format(prog="python -m craytpu_torch"))
        return 0

    if opts.get("runPerfTests"):
        # perf table (tests/perf/tests.h + testrunner.c:127-148 analogue)
        from craytpu_torch.utils.perftest import run_perf_tests
        return run_perf_tests(opts.get("test_suite"))

    if opts.get("runTests"):
        # test dispatch lives in the CLI exactly like args.c:224-249; we
        # delegate to pytest (the testrunner equivalent)
        import subprocess
        suite = opts.get("test_suite")
        if opts["test_idx"] in (-2, -3):
            out = subprocess.run(_pytest_command(suite, collect=True),
                                 capture_output=True, text=True)
            print(_collected(out.stdout))
            return 0
        return subprocess.call(_pytest_command(suite, collect=False))

    if opts.get("shutdown") and opts.get("nodes_list"):
        from craytpu_torch.parallel import cluster
        cluster.shutdown_workers(opts["nodes_list"])
        return 0

    if opts.get("is_worker"):
        from craytpu_torch.parallel import cluster
        return cluster.start_worker(port=opts.get("worker_port", 2222),
                                    device=device)

    # --trace DIR: every frame and set-up span is traced (utils/trace.py)
    # and its records written beside the profiler's trace
    if opts.get("trace_dir"):
        trace.force()

    # ---- load scene (main.c:21-27) ----
    overrides = cliargs.scene_overrides(opts)
    clustering = bool(opts.get("use_clustering") and opts.get("nodes_list"))
    from craytpu_torch.utils import fileio
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    # the master ships the exact bytes of every asset it read
    assets = fileio.start_recording() if clustering else None
    input_file = opts.get("inputFile")
    if input_file:
        scene_text = fileio.load_file(input_file, text=True)
        asset_path = os.path.dirname(os.path.abspath(input_file)) + "/"
    else:
        logging.info("Reading scene JSON from stdin")
        scene_text = sys.stdin.read()
        asset_path = ""
    scene = load_scene_from_buf(scene_text, asset_path, overrides)
    if clustering:
        fileio.stop_recording()

    import torch
    from craytpu_torch.ops import sampler as smp
    from craytpu_torch.parallel.pool_shard import make_renderer
    from craytpu_torch.runtime import checkpoint
    from craytpu_torch.scene.compile import compile_scene

    cscene = compile_scene(scene, device)
    kind = smp.HALTON if opts.get("interactive") else smp.RANDOM
    # --nee: next-event estimation (explicit light sampling, ops/nee.py)
    nee = bool(opts.get("nee"))
    if nee:
        logging.info("Next-event estimation enabled (--nee)")
    # one factory for every role: the TCP master renders its share of
    # tiles with it too (renderer.c:96-117)
    r = make_renderer(cscene, kind=kind, nee=nee)

    spp = scene.prefs.sample_count
    start_pass = 0
    persist_resume = None
    accum = torch.zeros((r.height, r.width, 4), dtype=torch.float32,
                        device=r.device)
    if opts.get("resume"):
        if checkpoint.kind(opts["resume"]) == "persistent":
            persist_resume, total, shape = checkpoint.load_persistent(
                opts["resume"])
            if shape != (r.height, r.width) or total != spp:
                # logging.error raises FatalError -> nonzero process exit
                logging.error(
                    "Checkpoint %s does not match this render "
                    "(shape %s vs %s, spp %d vs %d)", opts["resume"],
                    shape, (r.height, r.width), total, spp)
            left = (len(persist_resume["pending"])
                    + sum(b - a for a, b in persist_resume["ranges"]))
            logging.info("Resuming persistent render: %d/%d queue entries "
                         "left (%d in-flight paths re-traced)",
                         left, r.width * r.height * spp,
                         len(persist_resume["pending"]))
        else:
            acc_np, start_pass, total = checkpoint.load(opts["resume"])
            if acc_np.shape != (r.height, r.width, 4) or total != spp:
                logging.error(
                    "Checkpoint %s does not match this render "
                    "(shape %s vs %s, spp %d vs %d)", opts["resume"],
                    acc_np.shape, (r.height, r.width, 4), total, spp)
            accum = torch.tensor(acc_np, device=r.device)
            logging.info("Resuming at pass %d/%d", start_pass, spp)

    ckpt_path = os.path.join(scene.prefs.img_file_path or ".",
                             scene.prefs.img_file_name + ".ckpt.npz")

    logging.info("Rendering at %dx%d", r.width, r.height)
    logging.info("Rendering %d samples with %d bounces", spp, r.max_depth)
    logging.info("Pathtracing on %s...", _device_name(r.device))

    from craytpu_torch.api import Renderer
    if clustering:
        from craytpu_torch.parallel import cluster
        if not _rank0():
            # rank 0 owns the sockets; this rank renders the local tiles
            # it is handed
            cluster.follow_jobs(r)
            return 0
        t0 = time.perf_counter()
        clients = cluster.sync_with_clients(
            opts["nodes_list"], scene_text, asset_path, assets, overrides)
        if not clients:
            logging.warning("No network render workers, rendering locally")

        worker_stats: dict = {}

        def tile_progress(done, total):
            ws = "  ".join(f"{n.split(':')[0]}:{c}t/{a:.0f}ms"
                           for n, (c, a) in sorted(worker_stats.items()))
            sys.stderr.write(f"\r[{int(done / total * 100):3d}%] "
                             f"tile {done}/{total}  {ws}")
            sys.stderr.flush()

        def on_stats(name, completed, avg_ms):
            # per-worker progress from the ~1 Hz stats stream
            # (server.c:240-244 analogue)
            worker_stats[name] = (completed, avg_ms)
        fb = cluster.render_clustered(scene, r, clients, spp,
                                      progress=tile_progress,
                                      on_stats=on_stats)
        sys.stderr.write("\n")
        render_ms = (time.perf_counter() - t0) * 1e3
        logging.info("Finished render in %s", logging.smart_time(render_ms))
        Renderer(scene=scene, compiled=cscene, framebuffer=fb,
                 render_time_ms=render_ms).write_image()
        return 0

    # --preview-http: live localhost view of the accumulating frame +
    # progress counters (ui.c:88-160/:236-320 analogue for headless hosts)
    preview_srv = None
    if opts.get("preview_http") is not None and _rank0():
        from craytpu_torch.runtime.preview import PreviewServer
        preview_srv = PreviewServer(r.width, r.height,
                                    port=opts["preview_http"] or 8650)
        url = preview_srv.start()
        logging.info("Live preview at %s", url)

    # progressive preview (the SDL window analogue on headless hosts):
    # --preview [N] writes <name>_preview.png every N passes
    preview_every = opts.get("preview")
    if preview_every is True:
        preview_every = 1
    preview_path = os.path.join(scene.prefs.img_file_path or ".",
                                scene.prefs.img_file_name + "_preview.png")
    if preview_every:
        # the first preview comes before write_image creates the directory
        os.makedirs(os.path.dirname(preview_path), exist_ok=True)

    # Fast path: when no progressive feature is requested (no preview,
    # not interactive, not a progressive resume), render the whole frame
    # as ONE persistent wavefront, like the reference's batch mode which
    # also only delivers the finished frame.
    progressive = bool(preview_every or opts.get("interactive")
                       or start_pass)

    # --trace DIR: torch.profiler trace (CPU ops and CUDA kernels) of the
    # whole render, written as a Chrome trace JSON (chrome://tracing,
    # perfetto)
    trace_dir = opts.get("trace_dir")
    prof = None
    if trace_dir and _rank0():
        os.makedirs(trace_dir, exist_ok=True)
        prof = _start_trace(r.device)
        logging.info("Capturing a profiler trace to %s", trace_dir)

    t0 = time.perf_counter()
    interrupted = False
    try:
        if not progressive:
            import signal

            region_tracker = None
            last_regions = [0.0]
            if preview_srv is not None:
                # per-region progress grid for the preview overlay — the
                # reference's per-tile in-flight feedback (ui.c:236-320)
                from craytpu_torch.runtime.regions import RegionTracker
                xs_s, ys_s = r._sched_host
                region_tracker = RegionTracker(r.width, r.height, xs_s, ys_s)

            def ray_progress(done, total):
                frac = max(done, 0) / max(total, 1)
                sys.stderr.write(f"\r[{int(frac * 100):3d}%] "
                                 f"{done // 1000}k/{total // 1000}k paths")
                sys.stderr.flush()
                if preview_srv is not None:
                    preview_srv.progress_only(max(done, 0), total)
                    now = time.perf_counter()
                    if now - last_regions[0] >= 1.0:
                        last_regions[0] = now
                        preview_srv.update_regions(*region_tracker.snapshot(
                            max(done, 0), spp, r.tile_rays * r.n_ranks))

            on_frame = None
            if opts.get("preview_http") is not None:
                # throttled host fetches of the running frame (every 2 s;
                # in a group every rank joins each fetch, and rank 0 alone
                # has the server)
                from craytpu_torch.runtime.preview import frame_hook
                on_frame = frame_hook(preview_srv, r, spp)

            # SIGINT or the X/S keys on the fast path: checkpoint within
            # one pool step (losslessly: completed lanes' radiance +
            # in-flight queue ids). P pauses (ui.c:190-233 analogue).
            want_stop = []
            prev_handler = signal.signal(
                signal.SIGINT, lambda *_: want_stop.append(True))
            keys = _KeyPoller()

            def interrupt():
                k = keys.poll()
                if k == "p":
                    sys.stderr.write("\n[paused — any key resumes]")
                    sys.stderr.flush()
                    keys.wait_key()
                elif k in ("x", "s"):
                    want_stop.append(True)
                return bool(want_stop)

            try:
                with keys:
                    out = r.render_persistent(spp=spp, progress=(
                                              ray_progress if _rank0()
                                              else None),
                                              resume=persist_resume,
                                              interrupt=interrupt,
                                              on_frame=on_frame)
            finally:
                signal.signal(signal.SIGINT, prev_handler)
            sys.stderr.write("\n")
            if isinstance(out, tuple) and out[0] == "interrupted":
                _, final_sum, pending, ranges = out
                logging.info("Aborting persistent render; checkpointing "
                             "(%d in-flight paths recorded)", len(pending))
                if _rank0():
                    checkpoint.save_persistent(ckpt_path, final_sum, pending,
                                               ranges, spp,
                                               (r.height, r.width))
                    logging.info("Wrote checkpoint %s (resume with "
                                 "--resume)", ckpt_path)
                return 130
            fb = out
        else:
            prev_accum = accum
            p = start_pass
            npx = r.width * r.height
            # in a group SIGINT only sets a flag: rank 0 turns it into an
            # X key that every rank takes after the same pass
            sigint = []
            if r.n_ranks > 1:
                import signal
                prev_sigint = signal.signal(
                    signal.SIGINT, lambda *_: sigint.append(True))
            try:
                with _KeyPoller() as keys:
                    for p in range(start_pass, spp):
                        prev_accum = accum  # pre-update buffer (checkpoint)
                        accum = r.render_pass(accum, p, spp)
                        if _rank0():
                            _status(p + 1, spp, t0, r.width, r.height)
                        if preview_srv is not None:
                            preview_srv.update(accum.cpu().numpy(),
                                               (p + 1) * npx, spp * npx)
                        if preview_every and _rank0() and \
                                (p + 1) % int(preview_every) == 0:
                            from craytpu_torch.io.png import write_png
                            write_png(preview_path, accum.cpu().numpy(),
                                      {"Samples per pixel": str(p + 1)})
                        # S=abort+save partial, X=abort(checkpoint),
                        # P=pause (ui.c:190-233)
                        k = "x" if sigint else keys.poll()
                        k = _group_key(k if _rank0() else None)
                        if k == "p":
                            sys.stderr.write("\n[paused — any key resumes]")
                            sys.stderr.flush()
                            keys.wait_key()
                        elif k == "s":
                            logging.info("Aborting render, saving partial "
                                         "result (%d/%d passes)", p + 1, spp)
                            break
                        elif k == "x":
                            raise KeyboardInterrupt
            except KeyboardInterrupt:
                interrupted = True
                # SIGINT may land after accum was reassigned for pass p
                # but before the pass counter advanced; checkpoint the
                # PRE-update buffer with p so resume re-renders pass p
                # exactly once instead of double-weighting it
                sys.stderr.write("\n")
                logging.info("Aborting render (pass %d/%d); checkpointing",
                             p, spp)
                if _rank0():
                    checkpoint.save(ckpt_path, prev_accum.cpu().numpy(), p,
                                    spp)
                    logging.info("Wrote checkpoint %s (resume with "
                                 "--resume)", ckpt_path)
                accum = prev_accum
            finally:
                if r.n_ranks > 1:
                    signal.signal(signal.SIGINT, prev_sigint)
            fb = accum.cpu().numpy()
        render_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if prof is not None:
            for path in _stop_trace(prof, trace_dir,
                                    scene.prefs.img_file_name, r.trace):
                logging.info("Wrote %s", path)
        if preview_srv is not None:
            preview_srv.stop()
    logging.info("Finished render in %s", logging.smart_time(render_ms))
    if trace.env_on():
        # CRAYTPU_TRACE=1: each frame's record in a few lines
        for rec in r.trace.frames:
            print(trace.summary(rec), file=sys.stderr)

    # ---- write image (main.c:30, c-ray.c:85-111) ----
    if _rank0():
        Renderer(scene=scene, compiled=cscene, framebuffer=fb,
                 render_time_ms=render_ms).write_image()
    return 130 if interrupted else 0


def _start_trace(device):
    """Start a torch.profiler trace of CPU ops, and of CUDA kernels when
    rendering on the card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_trace(prof, trace_dir: str, name: str, tracer) -> tuple:
    """Stop the trace and write it as <trace_dir>/<name>_trace.json, and
    the renderer's frame records with the process's set-up spans as
    <trace_dir>/<name>_frames.json (utils/trace.py)."""
    import json
    prof.stop()
    path = os.path.join(trace_dir, f"{name}_trace.json")
    prof.export_chrome_trace(path)
    frames = os.path.join(trace_dir, f"{name}_frames.json")
    with open(frames, "w") as f:
        json.dump(trace.to_json(tracer.frames), f)
    return path, frames
