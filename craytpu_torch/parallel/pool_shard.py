"""The product's renderer factory (the JAX package's
parallel/pool_shard.py::make_renderer).

The sharded persistent-pool renderer (one pool per card, queue ranges
split across cards) is not ported yet (ROADMAP.md item 15): the factory
returns the single-card WavefrontRenderer on the scene's device.
"""

from __future__ import annotations

import torch

from craytpu_torch.models.wavefront_pt import WavefrontRenderer
from craytpu_torch.ops import sampler as smp
from craytpu_torch.utils import logging


def make_renderer(cscene, kind: str = smp.RANDOM,
                  bounces: int | None = None,
                  tile_rays: int | None = None, nee: bool = False):
    """The renderer the CLI runs: the single-card WavefrontRenderer on
    the scene's device (cuda:0 for a scene compiled with the default
    device)."""
    if cscene.device.type == "cuda" and torch.cuda.device_count() > 1:
        logging.info("%d CUDA devices visible; rendering on %s only (the "
                     "sharded renderer is ROADMAP.md item 15)",
                     torch.cuda.device_count(), cscene.device)
    return WavefrontRenderer(cscene, kind=kind, bounces=bounces,
                             tile_rays=tile_rays, nee=nee)
