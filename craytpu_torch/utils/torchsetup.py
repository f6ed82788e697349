"""Shared PyTorch runtime configuration (the counterpart of the JAX
package's utils/jaxsetup.py).

Geometry math must run in full float32: with reduced-precision products
(TF32 on the card) a transformed ray origin is off by ~1e-3 relative,
which makes bounced rays re-hit the sphere they left and darkens every
sphere scene several-fold. So TF32 is switched off for matmuls and cuDNN
and the float32 matmul precision is pinned to "highest". The port also
never routes geometry through a matmul (ops/vecmath.py).
"""

from __future__ import annotations

import torch


def setup_torch() -> None:
    """Pin full float32 arithmetic. Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Asking for CUDA on a machine without it raises; there is no
    silent fallback to the CPU."""
    setup_torch()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "craytpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev
