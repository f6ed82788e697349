"""A CPU stand-in for a CUDA graph's capture: a TorchDispatchMode that
raises on the ops a capture cannot hold.

A CUDA graph records the kernels a stream launches; it cannot record a
read of a device value on the host (`.item()`, `bool()`, `int()` of a
tensor: aten._local_scalar_dense), an op whose output shape depends on
the data (nonzero, masked_select, unique, indexing by a boolean mask,
which runs nonzero), or a copy of host data made on every call
(`torch.tensor(data)` and `new_tensor` dispatch lift_fresh): the first
fails the capture, the last is replayed with the values it was captured
with. On the CPU the same code runs under this guard, so a test finds
such an op without a card.

The plain versions of the kernels (the closest-hit walk, the dense
search, the hit records) run under `guard.paused()`: on the card they are
single kernel launches (K2, K3, K1)."""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

aten = torch.ops.aten

_BLOCKED = {
    aten._local_scalar_dense.default:
        "reads a device value on the host (.item(), bool(), int())",
    aten.nonzero.default: "has a data-dependent shape (nonzero)",
    aten.masked_select.default:
        "has a data-dependent shape (masked_select)",
    aten._unique.default: "has a data-dependent shape (unique)",
    aten._unique2.default: "has a data-dependent shape (unique)",
    aten.unique_dim.default: "has a data-dependent shape (unique)",
    aten.unique_consecutive.default:
        "has a data-dependent shape (unique_consecutive)",
    aten.lift_fresh.default:
        "copies host data into a new tensor on every call (torch.tensor, "
        "new_tensor)",
    aten.lift_fresh_copy.default:
        "copies host data into a new tensor on every call (torch.tensor, "
        "new_tensor)",
}
_INDEXING = (aten.index.Tensor, aten.index_put.default,
             aten.index_put_.default, aten._index_put_impl_.default)


class CaptureError(RuntimeError):
    pass


class CaptureGuard(TorchDispatchMode):
    """Raise CaptureError on an op a CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        """Run the block unchecked (a kernel's plain version)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._paused:
            why = _BLOCKED.get(func)
            if why is None and func in _INDEXING and _bool_index(args[1]):
                why = "indexes by a boolean mask (nonzero)"
            if why is not None:
                raise CaptureError(f"{func} {why}")
        return func(*args, **kwargs)


def _bool_index(indices) -> bool:
    return any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in indices)


@contextlib.contextmanager
def kernels_unchecked(guard: CaptureGuard):
    """Within the block, the kernel wrappers' plain versions run paused
    under `guard` (patched on their modules and restored after)."""
    from craytpu_torch.ops import dense_isect as dx
    from craytpu_torch.ops import hitrec as hr
    from craytpu_torch.ops import traverse as trv

    def unchecked(fn):
        def run(*a, **kw):
            # out of the mode altogether: the plain walk runs thousands
            # of small ops, each a Python call under a dispatch mode
            with guard.paused(), _disable_current_modes():
                return fn(*a, **kw)
        run.launches = 0
        return run

    saved = [(trv, "closest_hit"), (hr, "hitrec_record"), (dx, "dense_hit")]
    old = [getattr(m, n) for m, n in saved]
    for (m, n), fn in zip(saved, old):
        setattr(m, n, unchecked(fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(saved, old):
            setattr(m, n, fn)
