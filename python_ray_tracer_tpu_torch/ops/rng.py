"""Stateless per-ray RNG of the stochastic and supersampling paths.

Port of :mod:`python_ray_tracer_tpu.ops.rng`: the lowbias32 finalizer as a
keyed counter-based hash, bit for bit.  A seed is a u32 value, held as a
Python int or as a 0-d int64 tensor; every helper is a pure function of
(seed, lane index, stream salt), so a render replays from
``RenderConfig.rng_seed`` and the pure-torch route and the kernels draw the
same numbers.

The u32 arithmetic is done in int64 and masked to 32 bits after every step
(torch's ``uint32`` support on CUDA is thin).  Multiplications by a 32-bit
constant are split into its two 16-bit halves, so no int64 product
overflows: the wrapped u32 result is exact.
"""

from __future__ import annotations

import torch

_M1 = 0x21F0AAAD  # lowbias32 multipliers (Wellons' search)
_M2 = 0x735A2D97
_GOLD = 0x9E3779B9  # Weyl increment for seed folding
_MASK = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c`` modulo 2**32 for u32 values ``x`` (int or int64 tensor)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(x):
    """lowbias32: a well-mixed u32 -> u32 finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 15)
    return x


def seed_root(rng_seed: int) -> int:
    """The root seed of a render: the config int as a u32 value."""
    return rng_seed & _MASK


def fold_seed(seed, salt):
    """A child seed, the stateless analog of ``jax.random.fold_in``.
    ``seed`` and ``salt`` are ints or int64 tensors holding u32 values."""
    return _mix((seed + _mul32(salt & _MASK, _GOLD)) & _MASK)


def uniform01(seed, n: int, dtype: torch.dtype = torch.float32, offset: int = 0, device=None) -> torch.Tensor:
    """(n,) floats in [0, 1): hash of (lane index + offset, seed), 24 bits.

    ``offset`` shifts the lane indices, so a shard of the rays that passes
    its global ray offset draws what the whole frame's draw has there.
    ``bits >> 8`` has 24 bits, so the value is exact in float32 and float64.
    """
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = _mix((idx + offset + seed) & _MASK)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def uniform2(seed, n: int, dtype: torch.dtype = torch.float32, offset: int = 0, device=None) -> torch.Tensor:
    """(n, 2) independent uniforms in [0, 1): two salted streams."""
    u1 = uniform01(fold_seed(seed, 1), n, dtype, offset, device)
    u2 = uniform01(fold_seed(seed, 2), n, dtype, offset, device)
    return torch.stack([u1, u2], dim=1)


def bounce_xi(key, n: int, depth: int, dtype: torch.dtype, device=None, offset: int = 0) -> list[torch.Tensor]:
    """Each bounce's (2, n) xi for the bounce kernels, on the schedule of the
    JAX package's ``render.trace``: ``key, k_bounce = fold(key, 1),
    fold(key, 2)``, then ``uniform2(k_bounce, n, offset=offset)``, over
    exactly n rays from global ray index ``offset`` on."""
    xis = []
    for _ in range(depth):
        key, k_bounce = fold_seed(key, 1), fold_seed(key, 2)
        xis.append(uniform2(k_bounce, n, dtype, offset, device=device).T.contiguous())
    return xis
