"""Small vector helpers over packed (..., 3) tensors.

Floating-point contracts kept from the reference (and the JAX package):

* ``dot`` expands to ``x*x + y*y + z*z`` in that association order —
  ``torch.sum`` over the last axis may associate differently.
* ``normalize`` multiplies by a guarded reciprocal magnitude rather than
  dividing.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as XLA and CUDA compute it.

    torch's CPU ``sqrt`` goes through MKL's vector math, which is accurate
    to 1 ulp but not correctly rounded; one ulp of a ~1e5 root moves hit
    distances by 3e-11 in float64.  On the CPU the root is taken by numpy
    (IEEE ``sqrt``); on CUDA ``torch.sqrt`` is already correctly rounded.
    """
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.detach().numpy()))


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
