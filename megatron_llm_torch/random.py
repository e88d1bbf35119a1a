"""RNG seed domains (the counterpart of ``megatron_llm_tpu/random.py``).

The JAX package keeps no per-rank RNG state: a dropout stream is the
seed's key folded in by iteration and micro-batch, split into the
embedding's and the stack's keys, the stack's split by layer and each
layer's by site (attention probs, after attention, after the MLP), and
``jax.checkpoint`` replays the same keys on recompute by construction;
``RngDomain`` names the purposes a key serves.  The port keeps that
discipline with plain integers: a key is a 64-bit seed, ``fold_in`` and
``split`` derive new seeds through a fixed integer mix (splitmix64), and
a ``torch.Generator`` is seeded
from one only where a mask is drawn.  A generator made inside the
function that draws from it is what makes recompute replay the same
mask: ``torch.utils.checkpoint`` restores only the default generators'
state, never an explicit generator's.

The bits cannot equal JAX's (threefry against Philox / Mersenne
Twister); what carries over is the structure, one stream for each
purpose, iteration, micro-batch, layer and site.
"""

from __future__ import annotations

from enum import IntEnum

import torch

_MASK64 = (1 << 64) - 1


class RngDomain(IntEnum):
    INIT = 0
    DROPOUT = 1
    DATA = 2
    SAMPLING = 3


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def base_key(seed: int) -> int:
    return _mix(seed & _MASK64)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the integer ``data`` (``jax.random.
    fold_in``)."""
    return _mix(_mix(key) ^ (data & _MASK64))


def split(key: int, num: int = 2) -> tuple:
    """``num`` keys for the streams under ``key`` (``jax.random.split``)."""
    return tuple(_mix(fold_in(key, i)) for i in range(num))


def generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return gen


def bernoulli(key: int, p: float, shape, device, local=None
              ) -> torch.Tensor:
    """Bool mask of ``shape``, True with probability ``p`` (``jax.random.
    bernoulli``: a uniform draw below ``p``).  The one function that
    draws a dropout mask.

    ``local = (dim, start, length)``, or a list of them: the slice of
    that mask along each ``dim`` that a rank keeps (a tensor-parallel
    rank's sequence shard or heads, a data-parallel rank's rows).  A
    mask then does not depend on the sharding: a rank's slice equals the
    same slice of the one-device mask for the same key (the JAX
    package's sharding-invariant bits).  Each rank draws the whole mask
    to keep its slice, tp x dp times the draws of its share."""
    u = torch.rand(tuple(shape), generator=generator(key, device),
                   device=device)
    mask = u < p
    if local is None:
        return mask
    for cut in ([local] if isinstance(local[0], int) else local):
        mask = mask.narrow(*cut)
    return mask


class KeySeq:
    """Hands out fresh fold_in'd subkeys (for init)."""

    def __init__(self, seed_or_key: int, *, is_key: bool = False):
        self._key = seed_or_key if is_key else base_key(seed_or_key)
        self._n = 0

    def next(self) -> int:
        self._n += 1
        return fold_in(self._key, self._n)
