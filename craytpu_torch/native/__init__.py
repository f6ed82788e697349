"""Native (C++) fast paths, compiled on demand and loaded via ctypes.

The runtime around the TPU compute path is allowed to be native; these
libraries accelerate host-side work that Python is orders of magnitude too
slow for (SAH BVH builds, OBJ parsing). Every native entry point has a
pure-Python equivalent behind the same interface; set CRAYTPU_NO_NATIVE=1
to force the Python paths (used by the parity tests).

Compilation: g++ -O2 -shared -fPIC (no -ffast-math — the SAH sweeps rely
on IEEE inf/NaN semantics). Artifacts are cached next to the sources,
keyed by a source hash, and rebuilt automatically when sources change.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict[str, object] = {}


def _build(name: str, lib_dir: str = _DIR) -> str | None:
    """Path of lib<name>-<source hash>.so in lib_dir, built if missing.
    Safe when several processes build at once: each compiles into a
    temporary name of its own and renames it into place (an atomic
    replace by identical bytes), and one that finds the library already
    published uses it."""
    src = os.path.join(lib_dir, f"{name}.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(lib_dir, f"lib{name}-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError) as e:
        if os.path.exists(out):     # another process published it
            return out
        from craytpu_torch.utils import logging
        logging.warning("native build of %s failed (%s); using Python path",
                        name, e)
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    # clean up stale builds of this lib (never another process's .tmp)
    for f in os.listdir(lib_dir):
        if (f.startswith(f"lib{name}-") and f.endswith(".so")
                and f != os.path.basename(out)):
            try:
                os.remove(os.path.join(lib_dir, f))
            except OSError:
                pass
    return out


def load(name: str):
    """Load (building if needed) libcraytpu <name>; None if unavailable."""
    if os.environ.get("CRAYTPU_NO_NATIVE"):
        return None
    if name not in _LIBS:
        path = _build(name)
        _LIBS[name] = ctypes.CDLL(path) if path else None
    return _LIBS[name]


def bvh_builder():
    """ctypes handle to craytpu_build_bvh, or None."""
    lib = load("bvh_builder")
    if lib is None:
        return None
    fn = lib.craytpu_build_bvh
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_float)] * 3 + [
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return fn
