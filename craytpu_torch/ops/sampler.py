"""Per-pixel sample-stream samplers with reference parity.

Mirrors renderer/samplers/sampler.c: a sampler is (re)initialised per
(pixel, pass) and hands out one float dimension at a time. Three types:

  RANDOM     — PCG32 seeded with hash64(pixelIndex * maxPasses + pass)
               (sampler.c:41-43); used by the batch renderer (renderer.c:281).
  HALTON     — radical-inverse sequence over primes {2,3,5,7,11,13} with a
               per-pixel Cranley-Patterson rotation seeded by
               hash(pixelIndex) (sampler.c:33-35, halton.c); used by the
               progressive/interactive renderer (renderer.c:206).
  HAMMERSLEY — kept for completeness; reference marks it "Wrong"
               (hammersley.c:25) and never selects it.

State is a dataclass of (B,) tensors, one state per ray. Advance lanes
*conditionally* with `select_state(cond, advanced, original)` to keep
per-ray stream parity when only some lanes consume a dimension.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from craytpu_torch.ops import pcg

RANDOM = "random"
HALTON = "halton"
HAMMERSLEY = "hammersley"


@dataclass
class SamplerState:
    pcg_hi: torch.Tensor      # int64 in [0, 2^32): PCG32 state (RANDOM)
    pcg_lo: torch.Tensor
    rnd_offset: torch.Tensor  # f32 Cranley-Patterson offset (Halton)
    curr_prime: torch.Tensor  # i32 running dimension counter
    curr_pass: torch.Tensor   # i32
    max_passes: torch.Tensor  # i32

    def index(self, order) -> "SamplerState":
        """Per-lane gather of every field."""
        return SamplerState(*(getattr(self, f.name)[order]
                              for f in fields(self)))


def init_sampler(kind: str, pass_idx, max_passes,
                 pixel_index) -> SamplerState:
    """initSampler (sampler.c:31-46). pass_idx/max_passes are (B,) int32,
    pixel_index (B,) int64 in [0, 2^32)."""
    pass_idx = pass_idx.to(torch.int32)
    max_passes = max_passes.to(torch.int32)
    pixel_index = pixel_index.to(torch.int64) & pcg.M32
    if kind == RANDOM:
        # seed = hash64(pixelIndex * maxPasses + pass): uint32 arithmetic
        # (C usual conversions), then zero-extended to 64 bits.
        mp = max_passes.to(torch.int64) & pcg.M32
        seed_lo = (pcg.mullo32(pixel_index, mp)
                   + (pass_idx.to(torch.int64) & pcg.M32)) & pcg.M32
        sh, sl = pcg.hash64(torch.zeros_like(seed_lo), seed_lo)
        ph, plo = pcg.pcg32_seed(sh, sl)
        return SamplerState(ph, plo,
                            torch.zeros_like(plo, dtype=torch.float32),
                            torch.zeros_like(pass_idx), pass_idx, max_passes)
    if kind in (HALTON, HAMMERSLEY):
        offset = pcg.uint_to_unit_real(pcg.hash32(pixel_index))
        z = torch.zeros_like(pixel_index)
        return SamplerState(z, z, offset, torch.zeros_like(pass_idx),
                            pass_idx, max_passes)
    raise ValueError(f"unknown sampler kind {kind!r}")


def get_dimension(kind: str, s: SamplerState):
    """getDimension (sampler.c:48-58). Returns (value, new_state)."""
    if kind == RANDOM:
        v, nh, nl = pcg.pcg32_float(s.pcg_hi, s.pcg_lo)
        return v, replace(s, pcg_hi=nh, pcg_lo=nl)
    if kind == HALTON:
        v, nxt = pcg.halton_dimension(s.curr_pass, s.curr_prime,
                                      s.rnd_offset)
        return v, replace(s, curr_prime=nxt)
    if kind == HAMMERSLEY:
        ri = pcg.radical_inverse_dyn(s.curr_pass,
                                     pcg.halton_base(s.curr_prime))
        # reference: currPrime only advances when currPass > 0
        taken = s.curr_pass > 0
        u = torch.where(taken, ri,
                        torch.div(s.curr_pass, s.max_passes,
                                  rounding_mode="floor").to(torch.float32))
        v = pcg.wrap_add(u, s.rnd_offset)
        return v, replace(s, curr_prime=s.curr_prime
                          + taken.to(s.curr_prime.dtype))
    raise ValueError(f"unknown sampler kind {kind!r}")


def select_state(cond, a: SamplerState, b: SamplerState) -> SamplerState:
    """Per-lane select between two sampler states (masked advance).
    Fields the advance did not touch are the same tensor on both sides
    and are passed through without a select."""
    return SamplerState(*(
        x if x is y else torch.where(cond, x, y)
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in fields(a))))
