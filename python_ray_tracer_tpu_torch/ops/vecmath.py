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
  build on ``torch.maximum``/``torch.minimum``, which split as JAX does;
* ``jnp.abs``'s derivative at exactly 0 is 1, torch's is 0: :func:`abs`
  takes JAX's.
"""

from __future__ import annotations

import math

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


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's derivative ``g * where(x >= 0, 1, -1)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x >= 0, 1.0, -1.0).to(g.dtype)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - the jnp.abs counterpart
    """``jnp.abs``: at exactly 0 ``jax.grad`` gives 1, torch's ``abs`` 0."""
    return _Abs.apply(x)


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for a positive int ``n`` by the same binary exponentiation
    (and so the same roundings) as JAX's ``integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


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


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless tangent frame around unit normals (Duff/Frisvad)."""
    one = torch.ones_like(n[..., 2])
    s = torch.where(n[..., 2] >= 0, one, -one)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    t2 = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t1, t2


def ggx_perturb_reflect(
    direction: torch.Tensor,  # (N, 3) incoming unit dirs
    normal: torch.Tensor,  # (N, 3) unit normals
    roughness: torch.Tensor,  # (N,)
    xi: torch.Tensor,  # (N, 2) uniforms in [0, 1)
) -> torch.Tensor:
    """Reflect about a GGX-sampled microfacet half-vector.

    ``tan^2(theta_h) = alpha^2 xi1 / (1 - xi1)`` with ``alpha =
    roughness^2``; roughness 0 gives the exact mirror, and samples that
    would leave below the surface fall back to the mirror.  The root of
    ``sin^2`` sits in a double ``where``, so roughness -> 0 gives a zero
    slope and not NaN, as in the JAX package.
    """
    alpha = ipow(roughness, 2)[..., None]
    xi1 = xi[..., 0:1]
    xi2 = xi[..., 1:2]
    tan2 = ipow(alpha, 2) * xi1 / torch.clamp_min(1.0 - xi1, 1e-8)
    cos_t = 1.0 / sqrt(1.0 + tan2)
    sin2 = relu0(1.0 - ipow(cos_t, 2))
    sin_pos = sin2 > 0
    sin_t = torch.where(sin_pos, sqrt(torch.where(sin_pos, sin2, torch.ones_like(sin2))), torch.zeros_like(sin2))
    phi = (2.0 * math.pi) * xi2
    t1, t2 = orthonormal_basis(normal)
    h = normalize(t1 * (sin_t * torch.cos(phi)) + t2 * (sin_t * torch.sin(phi)) + normal * cos_t)
    r = reflect(direction, h)
    mirror = reflect(direction, normal)
    above = dot(r, normal) > 0
    return torch.where(above[..., None], r, mirror)
