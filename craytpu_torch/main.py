"""CLI entry point — the equivalent of src/main.c, and the non-cluster
part of the JAX package's main.py.

Flow mirrors main.c:14-42: parse args -> load scene from file/stdin ->
render -> write image. Adds what the wavefront design gives for free:
live progress stats, SIGINT checkpoint-and-save, and --resume.

    python -m craytpu_torch assets/entry_scene.json -s 4 -d 320x200

Runs on the CUDA card; CRAYTPU_PLATFORM=cpu (or main(..., device="cpu"))
runs on the CPU. Flags of modules the port does not have yet exit with
the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import os
import sys
import time

from craytpu_torch import args as cliargs
from craytpu_torch.utils import logging
from craytpu_torch.version import REFERENCE_VERSION, __version__

# option key -> (flag, ROADMAP.md item) of flags that are not ported yet
_LATER_ITEMS = {
    "is_worker": ("--worker", 15),
    "use_clustering": ("--nodes", 15),
    "shutdown": ("--shutdown", 15),
    "preview_http": ("--preview-http", 15),
    "trace_dir": ("--trace", 16),
    "runTests": ("--test/--tcount/--ptcount", 15),
    "runPerfTests": ("--test-perf", 15),
}


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


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the CLI. device: where to render (None = the CUDA card, or
    the CPU when CRAYTPU_PLATFORM=cpu). Returns the exit code: 0, or 130
    after an interrupt that wrote a checkpoint."""
    argv = argv if argv is not None else sys.argv[1:]
    opts = cliargs.parse_args(argv)
    logging.set_verbose(bool(opts.get("v")))
    logging.info("craytpu_torch v%s (c-ray %s capability surface)",
                 __version__, REFERENCE_VERSION)

    if opts.get("help"):
        print(cliargs.USAGE.format(prog="python -m craytpu_torch"))
        return 0

    for key, (flag, item) in _LATER_ITEMS.items():
        if key in opts:
            # logging.error raises FatalError -> nonzero process exit
            logging.error("%s is not ported to craytpu_torch yet "
                          "(ROADMAP.md item %d)", flag, item)

    if device is None and os.environ.get("CRAYTPU_PLATFORM") == "cpu":
        device = "cpu"

    # ---- load scene (main.c:21-27) ----
    overrides = cliargs.scene_overrides(opts)
    from craytpu_torch.utils import fileio
    from craytpu_torch.scene.sceneloader import load_scene_from_buf
    input_file = opts.get("inputFile")
    if input_file:
        scene_text = fileio.load_file(input_file, text=True)
        asset_path = os.path.dirname(os.path.abspath(input_file)) + "/"
    else:
        logging.info("Reading scene JSON from stdin")
        scene_text = sys.stdin.read()
        asset_path = ""
    scene = load_scene_from_buf(scene_text, asset_path, overrides)

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

    t0 = time.perf_counter()
    interrupted = False
    if not progressive:
        import signal

        def ray_progress(done, total):
            frac = max(done, 0) / max(total, 1)
            sys.stderr.write(f"\r[{int(frac * 100):3d}%] "
                             f"{done // 1000}k/{total // 1000}k paths")
            sys.stderr.flush()

        # SIGINT or the X/S keys on the fast path: checkpoint within one
        # pool step (losslessly: completed lanes' radiance + in-flight
        # queue ids). P pauses (ui.c:190-233 analogue).
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
                out = r.render_persistent(spp=spp, progress=ray_progress,
                                          resume=persist_resume,
                                          interrupt=interrupt)
        finally:
            signal.signal(signal.SIGINT, prev_handler)
        sys.stderr.write("\n")
        if isinstance(out, tuple) and out[0] == "interrupted":
            _, final_sum, pending, ranges = out
            logging.info("Aborting persistent render; checkpointing "
                         "(%d in-flight paths recorded)", len(pending))
            checkpoint.save_persistent(ckpt_path, final_sum, pending,
                                       ranges, spp, (r.height, r.width))
            logging.info("Wrote checkpoint %s (resume with --resume)",
                         ckpt_path)
            return 130
        fb = out
    else:
        prev_accum = accum
        p = start_pass
        try:
            with _KeyPoller() as keys:
                for p in range(start_pass, spp):
                    prev_accum = accum  # pre-update buffer for checkpoint
                    accum = r.render_pass(accum, p, spp)
                    _status(p + 1, spp, t0, r.width, r.height)
                    if preview_every and (p + 1) % int(preview_every) == 0:
                        from craytpu_torch.io.png import write_png
                        write_png(preview_path, accum.cpu().numpy(),
                                  {"Samples per pixel": str(p + 1)})
                    # S=abort+save partial, X=abort(checkpoint), P=pause
                    # (ui.c:190-233)
                    k = keys.poll()
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
            # SIGINT may land after accum was reassigned for pass p but
            # before the pass counter advanced; checkpoint the PRE-update
            # buffer with p so resume re-renders pass p exactly once
            # instead of double-weighting it
            sys.stderr.write("\n")
            logging.info("Aborting render (pass %d/%d); checkpointing",
                         p, spp)
            checkpoint.save(ckpt_path, prev_accum.cpu().numpy(), p, spp)
            logging.info("Wrote checkpoint %s (resume with --resume)",
                         ckpt_path)
            accum = prev_accum
        fb = accum.cpu().numpy()

    render_ms = (time.perf_counter() - t0) * 1e3
    logging.info("Finished render in %s", logging.smart_time(render_ms))

    # ---- write image (main.c:30, c-ray.c:85-111) ----
    from craytpu_torch.api import Renderer
    Renderer(scene=scene, compiled=cscene, framebuffer=fb,
             render_time_ms=render_ms).write_image()
    return 130 if interrupted else 0
