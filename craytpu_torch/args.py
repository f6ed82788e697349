"""CLI flag parsing (utils/args.c parity), a copy of the JAX package's
args.py.

Same surface as the reference parser (args.c:69-250): a positional scene
file (with the `.json`-appending fallback), `-j/-s/-d/-t` overrides,
`--iterative`, `--worker [port]`, `--nodes list`, `--shutdown`,
`--test/--test-perf/--tcount/--ptcount/--suite` test dispatch, `-v`, and the
reference's catch-all rule that any unknown `-flag` becomes a queryable
boolean tag. Results land in a flat dict (the "constants database",
hashtable.c:191-217 — a Python dict is that component).
"""

from __future__ import annotations

import os

USAGE = """Usage: {prog} [-hjsdtv] [input.json]
Options:
  -h             Show this message
  -j <n>         Thread count (kept for compatibility; the wavefront
                 renderer is card-parallel, not thread-parallel)
  -s <n>         Sample count override
  -d <w>x<h>     Image dimension override
  -t <w>x<h>     Tile dimension override
  -v             Enable verbose mode
  --iterative    Progressive render (Halton sampler, whole-frame passes)
  --worker [p]   Start a render worker on TCP port p (default 2222)
  --nodes <list> Use worker processes at comma-separated addresses
  --shutdown     Ask workers on --nodes to shut down
  --resume <f>   Resume a render from a checkpoint file
  --nee          Next-event estimation (explicit light sampling)
  --preview [n]  Write a preview PNG every n passes
  --preview-http [port]  Live render view at http://127.0.0.1:<port>/
                 (a bare flag serves on port 8650)
  --trace [dir]  Profile the render (torch.profiler, CPU and CUDA) into
                 a Chrome trace JSON in dir (default output/trace)
  --test [n]     Run the port's tests (tests/test_torch_*.py) via pytest
  --tcount       Print test count
  --ptcount      Print test count (same as --tcount)
  --test-perf    Run the host-side performance microtests
  --suite <s>    Select tests (pytest -k) or perf tests by name prefix
  Empty input reads the scene JSON from stdin.
  CRAYTPU_PLATFORM=cpu runs on the CPU (the default is the CUDA card).
  CRAYTPU_DEBUG=1 checks every bounce for non-finite values and every
  hit id for its range; CRAYTPU_TRACE=1 traces every frame and prints
  each one's record (the pool's accounting, device ms by dispatch, the
  longest idle gaps) to stderr.
"""


def _parse_dims(s: str | None):
    """parseDims (args.c:53-66): 'WxH', both > 0."""
    if not s:
        return None
    try:
        w, h = s.lower().split("x", 1)
        w, h = int(w), int(h)
    except ValueError:
        return None
    if w > 0 and h > 0:
        return w, h
    return None


def get_sys_cores() -> int:
    return os.cpu_count() or 1


# flags whose next token is always a value, never the positional scene
# input (`--trace out` must not make the trace directory become the scene
# JSON even if a path of that name exists — the misparse class fixed for
# --resume)
_VALUE_FLAGS = ("--resume", "--suite", "--nodes", "--trace",
                "-s", "-d", "-t", "-j")
# flags that consume the next token only when it is an integer
# (`--preview 4` vs `--preview scene.json`)
_OPT_INT_FLAGS = ("--preview", "--preview-http", "--worker", "--test")


def _is_int(tok: str | None) -> bool:
    try:
        int(tok)
        return True
    except (TypeError, ValueError):
        return False


def parse_args(argv: list[str]) -> dict:
    opts: dict = {}
    input_file_set = False
    test_idx = -1
    for i, a in enumerate(argv):
        nxt = argv[i + 1] if i + 1 < len(argv) else None
        prev = argv[i - 1] if i > 0 else None
        # a token that is the VALUE of a value-taking flag is never the
        # positional scene input (`--resume ckpt.npz` must not make the
        # checkpoint file the scene JSON)
        is_flag_value = (prev in _VALUE_FLAGS
                         or (prev in _OPT_INT_FLAGS and _is_int(a)))
        if not input_file_set and not is_flag_value and os.path.isfile(a):
            opts["inputFile"] = a
            input_file_set = True
        elif (not input_file_set and not is_flag_value
              and not a.startswith("-") and os.path.isfile(a + ".json")):
            opts["inputFile"] = a + ".json"
            input_file_set = True
        if a == "-h":
            opts["help"] = True
        elif a == "-j":
            try:
                n = int(nxt)
                n = max(n, 0)
                n = min(n, get_sys_cores() * 2)
                opts["thread_override"] = n
            except (TypeError, ValueError):
                from craytpu_torch.utils import logging
                logging.warning("Invalid -j parameter given!")
        elif a == "-s":
            try:
                opts["samples_override"] = max(int(nxt), 1)
            except (TypeError, ValueError):
                from craytpu_torch.utils import logging
                logging.warning("Invalid -s parameter given!")
        elif a == "-d":
            dims = _parse_dims(nxt)
            if dims:
                opts["dims_override"] = True
                opts["dims_width"], opts["dims_height"] = dims
            else:
                from craytpu_torch.utils import logging
                logging.warning("Invalid -d parameter given!")
        elif a == "-t":
            dims = _parse_dims(nxt)
            if dims:
                opts["tiledims_override"] = True
                opts["tile_width"], opts["tile_height"] = dims
            else:
                from craytpu_torch.utils import logging
                logging.warning("Invalid -t parameter given!")
        elif a == "--suite":
            if nxt:
                opts["test_suite"] = nxt
        elif a == "--test":
            opts["runTests"] = True
            if nxt and not nxt.startswith("-"):
                try:
                    test_idx = max(int(nxt), 0)
                except ValueError:
                    pass
        elif a == "--test-perf":
            opts["runPerfTests"] = True
        elif a == "--tcount":
            opts["runTests"] = True
            test_idx = -2
        elif a == "--ptcount":
            opts["runTests"] = True
            test_idx = -3
        elif a == "--iterative":
            opts["interactive"] = True
        elif a == "--shutdown":
            opts["shutdown"] = True
        elif a == "--nodes":
            opts["use_clustering"] = True
            if nxt:
                opts["nodes_list"] = nxt
        elif a == "--worker":
            opts["is_worker"] = True
            if nxt and not nxt.startswith("-"):
                try:
                    opts["worker_port"] = min(max(int(nxt), 1024), 65535)
                except ValueError:
                    pass
        elif a == "--resume":
            if nxt:
                opts["resume"] = nxt
        elif a == "--trace":
            opts["trace_dir"] = (nxt if nxt and not nxt.startswith("-")
                                 else "output/trace")
        elif a == "--preview":
            opts["preview"] = True
            if nxt and not nxt.startswith("-"):
                try:
                    opts["preview"] = max(int(nxt), 1)
                except ValueError:
                    pass
        elif a == "--preview-http":
            opts["preview_http"] = 0      # 0 = ephemeral port
            if nxt and not nxt.startswith("-"):
                try:
                    opts["preview_http"] = min(max(int(nxt), 0), 65535)
                except ValueError:
                    pass
        elif a.startswith("-"):
            # any unknown -flag becomes a boolean tag (args.c:207-209)
            opts[a.lstrip("-")] = True
    opts["test_idx"] = test_idx
    return opts


def scene_overrides(opts: dict) -> dict:
    """CLI overrides reapplied over scene JSON prefs (sceneloader.c:425-467).
    Keys match the loader's override dict."""
    ov = {}
    if "samples_override" in opts:
        ov["samples"] = opts["samples_override"]
    if opts.get("dims_override"):
        ov["width"] = opts["dims_width"]
        ov["height"] = opts["dims_height"]
    if opts.get("tiledims_override"):
        ov["tileWidth"] = opts["tile_width"]
        ov["tileHeight"] = opts["tile_height"]
    if "thread_override" in opts:
        ov["threads"] = opts["thread_override"]
    return ov
