"""Build and load the port's CUDA kernels (craytpu_torch/csrc/*.cu).

Each kernel source is compiled by nvcc into its own shared library with a
plain C interface and loaded with ctypes. Libraries go to
build/craytpu_torch/ at the repository root, or to the directory that
CRAYTPU_CACHE names (the counterpart of the JAX package's compile cache,
craytpu/utils/jaxsetup.py:54-55), named by a hash of the sources and
flags, and are built at first use; `build_all` starts one nvcc per
source and variant at once. A failed build raises.

Every kernel has two variants: exact (the default) and fast
(-DCRAYTPU_FASTMATH=1, csrc/detmath.cuh's plain fallbacks; profiling
only). They have distinct names and hashes, and a process loads the
variant that vecmath's CRAYTPU_FASTMATH flag selects at the launch.

nvcc runs with `-Xptxas -v`; its log is kept beside the library
(`<lib>.log`), and `kernel_usage` reads each kernel's registers, stack
frame and spills from it. Nothing is built when a module is imported: the CPU tests
import every module on a machine that has no nvcc.

Flags: sm_90a (Hopper), and IEEE float arithmetic that the plain
versions reproduce bit for bit: -fmad=false (no contraction of a*b+c into
an fma), correctly rounded division and sqrt, no flush of denormals, and
never --use_fast_math.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from craytpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "craytpu_torch")
KERNELS = ("closest_hit", "hitrec", "dense_hit")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

# loaded libraries by kernel name: a launch looks its library up here
# without hashing the sources again
_LIBS: dict[tuple, ctypes.CDLL] = {}
# the fast variant's extra flag (csrc/detmath.cuh)
FAST_FLAGS = ["-DCRAYTPU_FASTMATH=1"]
# kernel name -> [(batch size, (start, end) CUDA events)], while
# launch_timing() is on
_TIMING: dict | None = None


def nvcc(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", tool)
    if os.path.exists(path):
        return path
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found (CUDA_HOME or PATH): the CUDA "
                           "kernels cannot be built on this machine")
    return found


def fastmath() -> bool:
    """Whether this process runs the fast variant: vecmath's
    CRAYTPU_FASTMATH flag, tested at each call as the primitives test
    it."""
    from craytpu_torch.ops import vecmath
    return vecmath._FASTMATH


def build_dir() -> str:
    """Where the libraries go: CRAYTPU_CACHE, else build/craytpu_torch/."""
    return os.environ.get("CRAYTPU_CACHE") or BUILD_DIR


def _flags(fast: bool) -> list[str]:
    return FLAGS + (FAST_FLAGS if fast else [])


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, h) for h in headers]


def lib_path(name: str, fast: bool | None = None) -> str:
    """The library of kernel `name` in the exact or fast variant (default:
    this process's, `fastmath()`)."""
    fast = fastmath() if fast is None else fast
    h = hashlib.sha256(" ".join(_flags(fast)).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    tag = "_fast" if fast else ""
    return os.path.join(build_dir(),
                        f"lib{name}{tag}-{h.hexdigest()[:16]}.so")


def _start(name: str, fast: bool):
    """Start nvcc for one kernel variant; None if its library is already
    built."""
    out = lib_path(name, fast)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc()] + _flags(fast) + ["-o", tmp,
                                     os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {os.path.basename(out)} "
                           f"(exit {proc.returncode}):\n"
                           f"{log.decode(errors='replace')}")
    with open(f"{out}.log", "wb") as f:
        f.write(log)
    os.replace(tmp, out)


@trace.setup("kernels.load")
def build_all(names=KERNELS, variants=None) -> float:
    """Build every kernel library that is missing, one nvcc per source
    and variant (False: exact, True: fast; default: this process's),
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    variants = (fastmath(),) if variants is None else variants
    jobs = {(n, v): _start(n, v) for n in names for v in variants}
    for (n, _), job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def kernel_usage(name: str, fast: bool = False) -> dict:
    """Per __global__ function of kernel library `name` (built first if
    missing), what ptxas reported: {"registers", "stack_bytes",
    "spill_stores", "spill_loads", "smem_bytes"}, "sass", the number of
    machine instructions in the built function, and "f32", how many of
    them are f32 arithmetic (FADD, FMUL, FFMA, MUFU: the adds, products
    and the steps of divisions and roots). Keyed by the mangled function
    name."""
    build_all((name,), (fast,))
    with open(f"{lib_path(name, fast)}.log", errors="replace") as f:
        log = f.read()
    usage: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            usage.setdefault(fn, {}).update(
                stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            usage.setdefault(fn, {}).update(
                registers=int(m.group(1)),
                smem_bytes=int(smem.group(1)) if smem else 0)
    # static SASS instruction count of each function (cuobjdump -sass)
    sass = subprocess.run([nvcc("cuobjdump"), "-sass",
                           lib_path(name, fast)],
                          capture_output=True, text=True)
    fn = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S",
                                         line):
            u = usage.setdefault(fn, {})
            u["sass"] = u.get("sass", 0) + 1
            if re.search(r"\*/\s+(@!?U?P\w+\s+)?(FADD|FMUL|FFMA|MUFU)\b",
                         line):
                u["f32"] = u.get("f32", 0) + 1
    return usage


def usage_lines(names=KERNELS, fast: bool = False) -> list[str]:
    """One line per kernel of a variant: registers, stack frame, spills,
    shared memory, SASS instructions."""
    lines = []
    tag = " (fast)" if fast else ""
    for name in names:
        for fn, u in kernel_usage(name, fast).items():
            if f"{name}_kernel" not in fn:
                continue
            lines.append(
                f"ptxas {name}_kernel{tag}: {u.get('registers')} registers, "
                f"{u.get('stack_bytes')} B stack frame, "
                f"{u.get('spill_stores')} B spill stores, "
                f"{u.get('spill_loads')} B spill loads, "
                f"{u.get('smem_bytes')} B shared, "
                f"{u.get('sass')} SASS instructions (static), "
                f"{u.get('f32', 0)} of them f32 arithmetic")
    return lines


def library(name: str) -> ctypes.CDLL:
    """Kernel library `name` in this process's variant, built at first
    use."""
    key = (name, fastmath())
    if key not in _LIBS:
        build_all((name,), key[1:])
        _LIBS[key] = ctypes.CDLL(lib_path(name, key[1]))
    return _LIBS[key]


def function(lib: str, symbol: str, signature: str):
    """The C entry point `symbol` of kernel library `lib`. `signature`
    has one letter per argument: "p" a pointer or stream (c_void_p), "i"
    an int, "f" a float. The result is a cudaError_t."""
    fn = getattr(library(lib), symbol)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.restype = ctypes.c_int
        fn.argtypes = [kinds[c] for c in signature]
    return fn


def check_tensor(t, name: str, dtype, shape=None, align: int = 1) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)
    whose data starts on an `align`-byte boundary (for vector loads)."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, "
                         f"got {t.device} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data not {align}-byte aligned")


def launch(name: str, fn, *args, size: int) -> None:
    """Call a kernel's C entry point and raise if it returned a CUDA error
    (its cudaGetLastError after the launch). Under launch_timing(), CUDA
    events are recorded on the current stream around the launch, filed
    with its batch `size`, unless the stream is being captured into a
    CUDA graph (a replay records no events; its launches are timed by
    the profiler)."""
    timed = _TIMING is not None
    if timed:
        import torch
        timed = not torch.cuda.is_current_stream_capturing()
    if timed:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    err = fn(*args)
    if timed:
        ev[1].record()
        _TIMING.setdefault(name, []).append((size, ev))
    if err != 0:
        msg = library(name).craytpu_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg(err).decode()})")


@contextlib.contextmanager
def launch_timing():
    """Time every kernel launch in the block with CUDA events. Yields a
    dict that, after the block (which synchronizes), maps each kernel
    name to the list of its launches as (batch size, ms)."""
    global _TIMING
    import torch
    _TIMING = {}
    times: dict = {}
    try:
        yield times
        torch.cuda.synchronize()
        for name, evs in _TIMING.items():
            times[name] = [(n, a.elapsed_time(b)) for n, (a, b) in evs]
    finally:
        _TIMING = None


def main(argv=None) -> int:
    """Build both variants of the kernels and print what ptxas reported
    for each.

        python -m craytpu_torch.ops.cuda_build [--csrc DIR]

    DIR: another checkout's kernel sources (e.g. a later commit's
    craytpu_torch/csrc), built with these flags; it must hold every
    source of KERNELS (an earlier commit with fewer kernels runs its own
    copy of this module)."""
    import argparse
    global CSRC
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=CSRC)
    CSRC = os.path.abspath(ap.parse_args(argv).csrc)
    print(f"build: {build_all(variants=(False, True)):.1f} s, sources "
          f"{CSRC}", flush=True)
    for line in usage_lines() + usage_lines(fast=True):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
