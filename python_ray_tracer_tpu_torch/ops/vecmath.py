"""Small vector helpers over packed (..., 3) tensors.

Floating-point contracts kept from the reference (and the JAX package):

* ``dot`` expands to ``x*x + y*y + z*z`` in that association order —
  ``torch.sum`` over the last axis may associate differently.
* ``normalize`` multiplies by a guarded reciprocal magnitude rather than
  dividing.

Gradient contracts kept from ``jax.grad``, which the smooth path's
gradients are held against:

* ``sqrt``'s derivative is ``g * (0.5 / y)``, JAX's JVP of ``sqrt``;
* at an exact tie, ``jnp.maximum``/``jnp.minimum`` (and so ``jnp.clip``)
  split the gradient 0.5/0.5, where ``torch.clamp`` and
  ``torch.clamp_min`` pass all of it.  :func:`clip` and :func:`relu0`
  build on ``torch.maximum``/``torch.minimum``, which split as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch


class _Sqrt(torch.autograd.Function):
    """Correctly rounded root with JAX's derivative ``g * (0.5 / y)``."""

    @staticmethod
    def forward(ctx, x):
        if x.device.type != "cpu":
            y = torch.sqrt(x)
        else:
            with np.errstate(invalid="ignore"):
                y = torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (0.5 / y)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as XLA and CUDA compute it.

    torch's CPU ``sqrt`` goes through MKL's vector math, which is accurate
    to 1 ulp but not correctly rounded; one ulp of a ~1e5 root moves hit
    distances by 3e-11 in float64.  On the CPU the root is taken by numpy
    (IEEE ``sqrt``); on CUDA ``torch.sqrt`` is already correctly rounded.
    Differentiable, with JAX's derivative.
    """
    return _Sqrt.apply(x)


def relu0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with ``jnp.maximum``'s 0.5 gradient at ``x == 0``."""
    return torch.maximum(x, torch.zeros_like(x))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``min(max(x, lo), hi)``, JAX's tie gradients."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-order-exact dot product over the trailing axis of size 3."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector with the reference's zero guard: ``a * (1 / mag)``."""
    mag = sqrt(dot(a, a))
    inv = 1.0 / torch.where(mag == 0, torch.ones_like(mag), mag)
    return a * inv[..., None]


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror direction, normalized."""
    return normalize(direction - normal * (2.0 * dot(direction, normal))[..., None])
