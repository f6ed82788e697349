"""File IO with an in-memory cache layer (utils/fileio.c + filecache.c).

Mirrors the reference's worker-mode redirection (fileio.c:66-92): when a
process is a render worker, every asset read is served from an in-memory
path->bytes cache that the master shipped in-band (filecache.c:64-91), so
workers need zero local files. On the master, reads are recorded into the
cache when clustering is active so the exact bytes can be forwarded.
"""

from __future__ import annotations

import base64
import io
import os

_worker_cache: dict[str, bytes] | None = None
_record_cache: dict[str, bytes] | None = None


def set_worker_cache(cache: dict[str, bytes] | None) -> None:
    global _worker_cache
    _worker_cache = cache


def start_recording() -> dict[str, bytes]:
    """Master side: record every subsequent load for shipping to workers."""
    global _record_cache
    _record_cache = {}
    return _record_cache


def stop_recording() -> None:
    global _record_cache
    _record_cache = None


def _normkey(path: str) -> str:
    return os.path.normpath(path)


def load_file(path: str, text: bool = False):
    """loadFile (fileio.c:66-92): worker cache first, else disk (+record)."""
    key = _normkey(path)
    if _worker_cache is not None:
        try:
            data = _worker_cache[key]
        except KeyError:
            # fail cleanly (a worker has no disk fallback by design);
            # the cluster loop reports the error to the master
            raise FileNotFoundError(
                f"Worker has no cached file for {path}") from None
        return data.decode("utf-8", errors="replace") if text else data
    with open(path, "rb") as f:
        data = f.read()
    if _record_cache is not None:
        _record_cache[key] = data
    return data.decode("utf-8", errors="replace") if text else data


def open_file(path: str) -> io.BytesIO:
    """Binary reads that want a file object (PIL, HDR decoder)."""
    return io.BytesIO(load_file(path))


def encode_cache(cache: dict[str, bytes]) -> dict[str, str]:
    """filecache encodeFileCache (base64 JSON payload, filecache.c:64-80)."""
    return {k: base64.b64encode(v).decode("ascii") for k, v in cache.items()}


def decode_cache(payload: dict[str, str]) -> dict[str, bytes]:
    return {_normkey(k): base64.b64decode(v) for k, v in payload.items()}
