"""Image-texture math of the kernels: polynomial UV, flat texel ids, and the
texel composition outside the kernels.

Port of the atlas pieces of :mod:`python_ray_tracer_tpu.ops.pallas_bounce`
(``_ATAN_C``, ``_atan2_poly``, ``_asin_poly``) and of the external texel
gather every kernel route with an atlas runs after its kernel.  A kernel
that takes an atlas computes, for each lane that hits an image-textured
sphere, only the flat id of its nearest texel (equirectangular UV from the
unit normal, over the texture's native extents) and ``dww``, the diffuse
weight times the path weight; it zeroes its own diffuse texture there.  The
caller then adds ``texels[flat] * dww`` to the accumulated color
(:func:`compose_texels`).

The UV comes from an odd polynomial for ``atan`` on [0, 1], not from libm:
the JAX kernels had no ``atan2`` to call, and the port's kernels and plain
versions evaluate the same polynomial so that their texel ids agree
exactly.  :data:`ATAN_C` holds its 11 coefficients as literal doubles, the
JAX package's least-squares fit bit for bit; they are not refitted at
import, since another LAPACK may round the last bit otherwise.  The CUDA
sources read them from a header :mod:`._build` generates from this module.

The plain functions follow JAX's rounding in float32: each Python constant
rounds to the dtype, and the UV divides by the rounded ``2 pi`` and ``pi``
(a 0-dim tensor, so that torch on the card divides and does not multiply
by a reciprocal).
"""

from __future__ import annotations

import math

import torch

from .tables import segment_sum
from .vecmath import sqrt

# Largest atlas (texels, all slots) the JAX package's lane hard kernel
# (ops/pallas_bounce.py _bounce_kernel) samples in-kernel; a hard scene that
# only that kernel would take goes to the XLA path with a bigger atlas.
MAX_FUSED_TEXELS = 1 << 15

# Coefficients of atan(x) / x as a polynomial in x^2 on [0, 1] (|err| < 1e-7),
# lowest order first: python_ray_tracer_tpu.ops.pallas_bounce._ATAN_C.
ATAN_C = (
    float.fromhex("0x1.fffffffcb055cp-1"),
    float.fromhex("-0x1.55554ed86f202p-2"),
    float.fromhex("0x1.99977b2a27c61p-3"),
    float.fromhex("-0x1.246f565d87514p-3"),
    float.fromhex("0x1.c4c3558263bddp-4"),
    float.fromhex("-0x1.6849fa47d3e48p-4"),
    float.fromhex("0x1.12d8a517d6af4p-4"),
    float.fromhex("-0x1.6ab09cae2eb67p-5"),
    float.fromhex("0x1.6bc80a33e38bdp-6"),
    float.fromhex("-0x1.d5a44be67e647p-8"),
    float.fromhex("0x1.1c4b139c52bc9p-10"),
)


def cuda_header() -> str:
    """The coefficients as a CUDA header: ``PRT_ATAN_C``, lowest order first,
    as hex-float literals (exact in double; the kernels round them to their
    dtype as JAX does)."""
    values = ", ".join(c.hex() for c in ATAN_C)
    return (
        "// Generated by python_ray_tracer_tpu_torch/ops/_build.py from ops/texture.py ATAN_C.\n"
        "#pragma once\n"
        f"#define PRT_ATAN_C {values}\n"
    )


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def atan_unit(x: torch.Tensor) -> torch.Tensor:
    """atan(x) for x in [0, 1] via the polynomial (Horner, highest order first)."""
    x2 = x * x
    p = ATAN_C[-1] * x2 + ATAN_C[-2]
    for c in ATAN_C[-3::-1]:
        p = p * x2 + c
    return x * p


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-quadrant atan2 from the [0, 1] polynomial (octant reduction)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.clamp_min(torch.where(swap, ay, ax), 1e-30)
    a = atan_unit(num / den)
    a = torch.where(swap, (math.pi / 2) - a, a)
    a = torch.where(x < 0, math.pi - a, a)
    return torch.where(y < 0, -a, a)


def asin_poly(y: torch.Tensor) -> torch.Tensor:
    """asin(y) = atan2(y, sqrt(1 - y^2)) for y clipped to [-1, 1]."""
    y = torch.clamp(y, -1.0, 1.0)
    return atan2_poly(y, sqrt(torch.clamp_min(1.0 - y * y, 0.0)))


def flat_texel(normal, tid, tex_h, tex_w, tex_hw: tuple[int, int]) -> torch.Tensor:
    """Flat id ``tid * (Hpad * Wpad) + tj * Wpad + ti`` of each lane's nearest
    texel (int32): equirectangular UV of the unit ``normal`` (a 3-tuple of
    (N,) rows) over the texture's native extents ``tex_h``/``tex_w`` (the
    material table's float columns), in an atlas of padded slots
    ``tex_hw = (Hpad, Wpad)``.  Every lane gets an id; callers keep it on
    image lanes only."""
    th_pad, tw_pad = tex_hw
    u = 0.5 + atan2_poly(normal[2], normal[0]) / _const(normal[0], 2.0 * math.pi)
    v = 0.5 - asin_poly(normal[1]) / _const(normal[0], math.pi)
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    ti = torch.minimum(torch.clamp_min((u * (tex_w - 1.0)).to(torch.int32), 0), (tex_w - 1.0).to(torch.int32))
    tj = torch.minimum(torch.clamp_min((v * (tex_h - 1.0)).to(torch.int32), 0), (tex_h - 1.0).to(torch.int32))
    return tid.to(torch.int32) * (th_pad * tw_pad) + tj * tw_pad + ti


def slot_args(tex_hw) -> tuple[int, int]:
    """The atlas's slot extents as the kernels' C entries take them: (0, 0)
    without an atlas."""
    return (0, 0) if tex_hw is None else (int(tex_hw[0]), int(tex_hw[1]))


def atlas_texels(scene, dtype: torch.dtype):
    """``(texels, tex_hw)``: the atlas as a (T * Hpad * Wpad, 3) table in
    ``dtype`` (differentiable back to ``scene.texture_atlas``) and its padded
    slot extents, or ``(None, None)`` for a scene without an atlas."""
    if not scene.has_atlas:
        return None, None
    atlas = scene.texture_atlas
    return atlas.to(dtype).reshape(-1, 3), (int(atlas.shape[1]), int(atlas.shape[2]))


class _ComposeTexels(torch.autograd.Function):
    """``acc + texels[flat].T * dww`` with a deterministic texel gradient;
    both passes are named ranges of a ``torch.profiler`` trace."""

    @staticmethod
    def forward(ctx, acc, texels, flat, dww):
        with torch.profiler.record_function("compose_texels"):
            tex = texels[flat.long()].T  # (3, N)
            ctx.save_for_backward(texels, flat, dww)
            return acc + tex * dww[None]

    @staticmethod
    def backward(ctx, g):
        texels, flat, dww = ctx.saved_tensors
        g_texels = g_dww = None
        with torch.profiler.record_function("compose_texels backward"):
            if ctx.needs_input_grad[3]:
                tex = texels[flat.long()].T
                g_dww = g[0] * tex[0] + g[1] * tex[1] + g[2] * tex[2]
            if ctx.needs_input_grad[1]:
                g_texels = scatter_texels(g * dww[None], flat, texels.shape[0])
        return g, g_texels, None, g_dww


def scatter_texels(contrib: torch.Tensor, flat: torch.Tensor, n_texels: int) -> torch.Tensor:
    """The adjoint of the gather: ``out[flat[i]] += contrib[:, i]`` into an
    (n_texels, 3) zero table, summed in a fixed order (ascending lane within
    each texel, the order of a sequential scatter-add) with no atomics, so
    two calls on the same inputs agree bit for bit (:func:`.tables.segment_sum`)."""
    return segment_sum(contrib.T, flat, n_texels)


def compose_texels(acc: torch.Tensor, texels: torch.Tensor, flat: torch.Tensor, dww: torch.Tensor) -> torch.Tensor:
    """The image-diffuse term composed outside a kernel: ``acc`` (3, N) plus
    each lane's nearest texel ``texels[flat]`` ((T * Hpad * Wpad, 3) table,
    flat ids (N,) int32) times its weight ``dww`` (N,).  Differentiable in
    ``acc``, ``texels`` and ``dww``; the ids are selectors."""
    return _ComposeTexels.apply(acc, texels, flat, dww)
