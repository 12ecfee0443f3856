"""Counter-based random bits for the flip chain.

Counterpart of ``smol_tpu/ops/prims.py`` (``pos_bits``, ``uniform01``) and
of the interpret-mode hashes in ``smol_tpu/ops/pallas_chain.py``
(``_hash_uniform01``, ``_hash_randint``).  Two generators:

- :func:`hash_bits`, a bit-exact port of the reference's murmur3-finalizer
  hash of (seed, step, slot, lane).  It lets the tests drive the port and
  the reference chain with the same random numbers.
- :func:`philox4x32_10`, the Philox4x32-10 generator (Salmon et al., SC'11)
  that the CUDA kernel uses in run mode, keyed by (seed, walker) with the
  step as counter.

Both compute in int64 on values kept in [0, 2**32), with every product
split so that it stays below 2**63: torch's ``>>`` on int32 is an
arithmetic shift and its int32 products are not guaranteed to wrap, while
the reference multiplies in wrapping int32 and shifts logically.
"""

from __future__ import annotations

import torch

__all__ = [
    "hash_bits",
    "hash_uniform01",
    "hash_randint",
    "philox4x32_10",
    "uniform01_from_bits",
]

MASK32 = 0xFFFFFFFF

# murmur3 finalizer constants, as the reference writes them in int32
_SEED_MULT = 2654435761 & 0x7FFFFFFF
_STEP_MULT = 40503
_SLOT_MULT = 2246822519 & 0x7FFFFFFF
_MIX = ((-2048144789 & MASK32, 13), (-1028477387 & MASK32, 16))

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _u32(x):
    """Two's-complement image in [0, 2**32) of an int or int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def _mul32(x, m: int):
    """(x * m) mod 2**32 for x in [0, 2**32) and a constant m < 2**32."""
    lo = x * (m & 0xFFFF)
    hi = (x * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def hash_bits(seed, step, slot, lanes):
    """31-bit hash of (seed, step, slot, lane) as int64 in [0, 2**31).

    ``seed``, ``step`` and ``slot`` are int32 values (ints or tensors that
    broadcast against ``lanes``); ``lanes`` is an integer tensor of lane
    indices.  Bit-identical to the reference hash.
    """
    x = (_u32(lanes) + _mul32(_u32(seed), _SEED_MULT)) & MASK32
    x = x ^ ((_mul32(_u32(step), _STEP_MULT) + _mul32(_u32(slot), _SLOT_MULT)) & MASK32)
    for mult, shift in _MIX:
        x = _mul32(x ^ (x >> shift), mult)
    x = x ^ (x >> 16)
    return x & 0x7FFFFFFF


def uniform01_from_bits(r):
    """float32 uniforms in (0, 1] from 31-bit positive ints (reference form)."""
    return ((r >> 7).to(torch.float32) + 1.0) * (2.0**-24)


def hash_uniform01(seed, step, slot, lanes):
    """Counterpart of the reference's ``_hash_uniform01``."""
    return uniform01_from_bits(hash_bits(seed, step, slot, lanes))


def hash_randint(seed, step, slot, lanes, bound):
    """Counterpart of the reference's ``_hash_randint``: ints in [0, bound)."""
    return hash_bits(seed, step, slot, lanes) % bound


def _mulhilo32(m: int, x):
    """(hi, lo) words of m * x for a constant m and x in [0, 2**32)."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 of int64 tensors ``counter`` [..., 4], ``key`` [..., 2].

    Words are taken modulo 2**32 and returned as int64 in [0, 2**32),
    shape [..., 4].  Matches the Random123 reference implementation.
    """
    c0, c1, c2, c3 = (_u32(counter[..., i]) for i in range(4))
    k0, k1 = _u32(key[..., 0]), _u32(key[..., 1])
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo32(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)
