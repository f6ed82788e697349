"""Build and load the port's CUDA kernels (craytpu_torch/csrc/*.cu).

Each kernel source is compiled by nvcc into its own shared library with a
plain C interface and loaded with ctypes. Libraries go to
build/craytpu_torch/ at the repository root, named by a hash of the
sources and flags, and are built at first use; `build_all` starts one
nvcc per source at once. A failed build raises. Nothing is built when a
module is imported: the CPU tests import every module on a machine that
has no nvcc.

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
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "craytpu_torch")
KERNELS = ("closest_hit", "hitrec")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
         "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
# kernel name -> [(start, end) CUDA events], while launch_timing() is on
_TIMING: dict | None = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                           "kernels cannot be built on this machine")
    return found


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, h) for h in headers]


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one kernel; None if its library is already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc()] + FLAGS + ["-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n"
                           f"{log.decode(errors='replace')}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> float:
    """Build every kernel library that is missing, one nvcc per source
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(lib_path(name))
    return _LIBS[name]


def function(lib: str, symbol: str, signature: str):
    """The C entry point `symbol` of kernel library `lib`. `signature`
    has one letter per argument: "p" a pointer or stream (c_void_p), "i"
    an int. The result is a cudaError_t."""
    fn = getattr(library(lib), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in signature]
    return fn


def check_tensor(t, name: str, dtype, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, "
                         f"got {t.device} {t.dtype} "
                         f"contiguous={t.is_contiguous()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def launch(name: str, fn, *args) -> None:
    """Call a kernel's C entry point and raise if it returned a CUDA error
    (its cudaGetLastError after the launch). Under launch_timing(), CUDA
    events are recorded on the current stream around the launch."""
    if _TIMING is not None:
        import torch
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    err = fn(*args)
    if _TIMING is not None:
        ev[1].record()
        _TIMING.setdefault(name, []).append(ev)
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
    name to the list of its launch times in ms."""
    global _TIMING
    import torch
    _TIMING = {}
    times: dict = {}
    try:
        yield times
        torch.cuda.synchronize()
        for name, evs in _TIMING.items():
            times[name] = [a.elapsed_time(b) for a, b in evs]
    finally:
        _TIMING = None
