"""craytpu_torch — the PyTorch/CUDA port of craytpu, the differentiable
wavefront path tracer with c-ray's feature set.

The layout mirrors the JAX package module for module, so each counterpart
is found under the same name:
  craytpu_torch.api     — public API (Renderer: load, render, write)
  craytpu_torch.models  — the wavefront path tracer (forward render)
  craytpu_torch.ops     — device ops: sampler, camera, intersect,
                          traverse, hit records, texture fetch, shading
  craytpu_torch.csrc    — CUDA C++ kernels for Hopper (sm_90a): the
                          closest-hit walk and the hit-record resolve
  craytpu_torch.scene   — host scene pipeline (JSON/OBJ/MTL loaders,
                          transforms, material graph IR, device scene)
  craytpu_torch.accel   — BVH build (native C++ SAH builder via ctypes)
  craytpu_torch.runtime — tile pixel order
  craytpu_torch.io      — PNG/BMP encoders and a PNG reader (no PIL),
                          HDR decode
  craytpu_torch.utils   — logging, timers, golden comparison, torch setup

It imports torch and numpy only, never jax or craytpu. Entry points run
on CUDA unless the caller passes device="cpu".
"""

from craytpu_torch.version import __version__

__all__ = ["__version__"]
