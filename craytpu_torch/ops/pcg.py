"""PCG32 RNG and hash functions with bit parity to the reference renderer.

The 64-bit PCG state is carried as (hi, lo) halves, as the JAX package
carries it on the TPU. PyTorch has no unsigned 32-bit arithmetic, so each
half is an int64 tensor holding a value in [0, 2^32), and every operation
that can leave that range is masked with & 0xFFFFFFFF. Products are split
so that no intermediate exceeds 2^63. Semantics mirror:
  - pcg32 generator        libraries/pcg_basic.c:42-67
  - Thomas Wang hash       renderer/samplers/common.h:14-20
  - splitmix-style hash64  renderer/samplers/common.h:22-27
  - uintToUnitReal         renderer/samplers/common.h:48-56
  - radicalInverse (PBRT)  renderer/samplers/common.h:34-46
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

M32 = 0xFFFFFFFF

# 6364136223846793005 = 0x5851F42D4C957F2D (pcg_basic.c:63)
_PCG_MUL_HI = 0x5851F42D
_PCG_MUL_LO = 0x4C957F2D


def mullo32(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def mul32_hi_lo(a, b):
    """Full 32x32 -> 64 multiply, returns (hi, lo) halves."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    a0b0 = a0 * b0
    a1b0 = a1 * b0
    a0b1 = a0 * b1
    a1b1 = a1 * b1
    carry = ((a0b0 >> 16) + (a1b0 & 0xFFFF) + (a0b1 & 0xFFFF)) >> 16
    lo = (a0b0 + ((a1b0 + a0b1) << 16)) & M32
    hi = (a1b1 + (a1b0 >> 16) + (a0b1 >> 16) + carry) & M32
    return hi, lo


def add64(ah, al, bh, bl):
    lo = (al + bl) & M32
    carry = (lo < al).to(torch.int64)
    hi = (ah + bh + carry) & M32
    return hi, lo


def mul64(ah, al, bh, bl):
    """(a * b) mod 2^64 on (hi, lo) pairs."""
    p_hi, p_lo = mul32_hi_lo(al, bl)
    hi = (p_hi + mullo32(al, bh) + mullo32(ah, bl)) & M32
    return hi, p_lo


def shr64(ah, al, n: int):
    """Logical right shift of a u64 pair by a static 0<n<32."""
    if not 0 < n < 32:
        raise ValueError(n)
    lo = (al >> n) | ((ah << (32 - n)) & M32)
    hi = ah >> n
    return hi, lo


def xor64(ah, al, bh, bl):
    return ah ^ bh, al ^ bl


def _const(x, like):
    return torch.full_like(like, x)


def hash32(x):
    """Thomas Wang integer hash (samplers/common.h:14-20)."""
    k = _const(2654435769, x)
    x = mullo32(x ^ 12345391, k)
    x = x ^ (((x << 6) & M32) ^ (x >> 26))
    x = mullo32(x, k)
    x = (x + (((x << 5) & M32) ^ (x >> 12))) & M32
    return x


def hash64(xh, xl):
    """Stafford/splitmix-style 64-bit hash (samplers/common.h:22-27)."""
    h, l = shr64(xh, xl, 30)
    xh, xl = xor64(xh, xl, h, l)
    xh, xl = mul64(xh, xl, _const(0xBF58476D, xh), _const(0x1CE4E5B9, xl))
    h, l = shr64(xh, xl, 27)
    xh, xl = xor64(xh, xl, h, l)
    xh, xl = mul64(xh, xl, _const(0x94D049BB, xh), _const(0x133111EB, xl))
    h, l = shr64(xh, xl, 31)
    xh, xl = xor64(xh, xl, h, l)
    return xh, xl


def pcg32_seed(seed_hi, seed_lo):
    """State after pcg32_srandom_r(rng, seed, 0) (pcg_basic.c:42-49):
    inc=1; state = (seed + 1) * MUL + 1 (mod 2^64)."""
    zero, one = torch.zeros_like(seed_hi), torch.ones_like(seed_lo)
    sh, sl = add64(seed_hi, seed_lo, zero, one)
    sh, sl = mul64(sh, sl, _const(_PCG_MUL_HI, sh), _const(_PCG_MUL_LO, sl))
    return add64(sh, sl, zero, one)


def pcg32_next(state_hi, state_lo):
    """One pcg32_random_r step (pcg_basic.c:60-68).

    Returns (out, new_state_hi, new_state_lo)."""
    oh, ol = state_hi, state_lo
    nh, nl = mul64(oh, ol, _const(_PCG_MUL_HI, oh), _const(_PCG_MUL_LO, ol))
    nh, nl = add64(nh, nl, torch.zeros_like(nh), torch.ones_like(nl))
    # xorshifted = (uint32)(((old >> 18) ^ old) >> 27)
    sh, sl = shr64(oh, ol, 18)
    xh, xl = xor64(oh, ol, sh, sl)
    _, xorshifted = shr64(xh, xl, 27)
    rot = oh >> 27  # old >> 59
    out = (xorshifted >> rot) | ((xorshifted << ((32 - rot) & 31)) & M32)
    # rot == 0 needs out == xorshifted; (32-0)&31 == 0 so the | keeps it.
    return out, nh, nl


def pcg32_float(state_hi, state_lo):
    """getRandom (samplers/random.c:16-21): u32 * 2^-32 as float32."""
    out, nh, nl = pcg32_next(state_hi, state_lo)
    v = out.to(torch.float32) * (1.0 / 4294967296.0)
    return v, nh, nl


def uint_to_unit_real(v):
    """[1,2) bit trick minus 1 (samplers/common.h:48-56)."""
    bits = (v >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# Halton prime bases (samplers/halton.c:16)
HALTON_PRIMES = (2, 3, 5, 7, 11, 13)


def wrap_add(u, v):
    """(u + v) mod 1 without fmod (samplers/common.h:29-31)."""
    s = u + v
    return torch.where(s < 1.0, s, s - 1.0)


def radical_inverse(pass_idx, base: int):
    """PBRT radical inverse in a static base (samplers/common.h:34-46):
    the JAX package's radical_inverse (craytpu/ops/pcg.py:149-167), per
    lane of an int32 pass_idx tensor, clamped below 1 at 0.99999994."""
    return radical_inverse_dyn(pass_idx, torch.full_like(pass_idx, base))


# the digit steps radical_inverse_dyn runs: set by pass_bound() around a
# render whose largest pass the host knows, else every int32 pass (31)
_STEPS = contextvars.ContextVar("craytpu_torch_digit_steps", default=31)


@contextlib.contextmanager
def pass_bound(n_passes: int):
    """Within the block, radical_inverse_dyn runs the digit steps of
    passes below n_passes (a render's spp): the bits of the largest pass,
    which exhaust its digits in any base >= 2. A fixed count, so nothing
    waits for the device and a CUDA graph can capture it."""
    token = _STEPS.set(max(int(n_passes) - 1, 0).bit_length())
    try:
        yield
    finally:
        _STEPS.reset(token)


def current_digit_steps() -> int:
    return _STEPS.get()


def radical_inverse_dyn(pass_idx, base):
    """PBRT radical inverse with a per-lane base, over a fixed count of
    digit steps (pass_bound's, else 31), enough for every lane's pass.
    A lane whose digits run out holds its values (the JAX package's
    while_loop, craytpu/ops/pcg.py:176-205, runs until every lane's are
    exhausted and holds them the same way), so each lane's result is the
    scalar loop's whatever the count beyond its own digits."""
    steps = _STEPS.get()
    inv_base = 1.0 / base.to(torch.float32)
    p = pass_idx.clone()
    rev = torch.zeros_like(p)
    inv_n = torch.ones(p.shape, dtype=torch.float32, device=p.device)
    for _ in range(steps):
        nxt = torch.div(p, base, rounding_mode="floor")
        digit = p - base * nxt
        active = p > 0
        rev = torch.where(active, rev * base + digit, rev)
        inv_n = torch.where(active, inv_n * inv_base, inv_n)
        p = torch.where(active, nxt, p)
    return torch.clamp_max(rev.to(torch.float32) * inv_n, 0.99999994)


# HALTON_PRIMES as a tensor, made once per device and dtype (not a
# host-to-device copy on every call)
_PRIMES: dict = {}


def halton_base(prime_idx):
    key = (prime_idx.device, prime_idx.dtype)
    if key not in _PRIMES:
        _PRIMES[key] = torch.tensor(HALTON_PRIMES, dtype=prime_idx.dtype,
                                    device=prime_idx.device)
    return _PRIMES[key][prime_idx % len(HALTON_PRIMES)]


def halton_dimension(pass_idx, prime_idx, rnd_offset):
    """One Halton sample with Cranley-Patterson rotation (halton.c:25-31).
    Returns (value, next_prime_idx)."""
    ri = radical_inverse_dyn(pass_idx, halton_base(prime_idx))
    return wrap_add(ri, rnd_offset), prime_idx + 1
