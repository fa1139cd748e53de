"""Shared helpers of the smooth bounce: quadratic, sigmoid and their adjoint.

Port of the helpers of :mod:`python_ray_tracer_tpu.ops.pallas_bounce_smooth`
(``_sig``, ``_norm3``, ``_quad_sol_disc``, the two tiers of per-sphere
quadratics, ``_EPS_DEN`` and ``_sol_disc_adjoint``) over per-lane rows: each
vector is a 3-tuple of (N,) tensors.  The sublane kernels' plain versions
(:mod:`.bounce_smooth_sub`) are built from them, and
``csrc/bounce_smooth_sub.cu`` evaluates the same expressions in the same
order.  The lane-layout kernels of that JAX module (``_fwd_kernel``,
``_bwd_kernel``) are ported as the one-bounce pair of
:mod:`.bounce_smooth_sub` (``smooth_fwd_step``, ``smooth_bwd_step``), launched
once per bounce past 4096 spheres.
"""

from __future__ import annotations

import torch

from .intersect import _two_prod, _two_sum
from .vecmath import sqrt

# Guard of the adjoint's divisions by magnitudes, roots and shadow factors.
EPS_DEN = 1e-6


def sig(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid, ``1 / (1 + exp(-x))`` (torch's and the kernels' form)."""
    return torch.sigmoid(x)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(v):
    """``(v / |v|, |v|)`` with the reference's zero guard (multiply by 1/mag)."""
    mag = sqrt(dot3(v, v))
    inv = 1.0 / torch.where(mag == 0, torch.ones_like(mag), mag)
    return tuple(c * inv for c in v), mag


def quad_sol_disc(b, c_term, faraway: float):
    """Root selection and validity; returns ``(sol, disc, t)``."""
    disc = b * b - 4.0 * c_term
    pos = disc > 0
    sq = torch.where(pos, sqrt(torch.where(pos, disc, torch.ones_like(disc))), torch.zeros_like(disc))
    qroot = -0.5 * (b + torch.where(b < 0, -sq, sq))
    safe_q = torch.where(qroot == 0, torch.ones_like(qroot), qroot)
    other = torch.where(qroot == 0, torch.zeros_like(qroot), c_term / safe_q)
    t0 = torch.minimum(qroot, other)
    t1 = torch.maximum(qroot, other)
    sol = torch.where((t0 > 0) & (t0 < t1), t0, t1)
    t = torch.where(pos & (sol > 0), sol, torch.full_like(sol, faraway))
    return sol, disc, t


def b_cterm_plain(o, d, c, r):
    """``b = 2 d.(o - c)`` and ``|o - c|^2 - r^2``, plain (cheap tier)."""
    oc = tuple(o[i] - c[i] for i in range(3))
    return 2.0 * dot3(d, oc), dot3(oc, oc) - r * r


def compensated_b_cterm(o, d, c, r):
    """The same two coefficients with Knuth twoSum / Dekker twoProd (exact tier)."""
    h, lo = [], []
    for i in range(3):
        hi_i, lo_i = _two_sum(o[i], -c[i])
        h.append(hi_i)
        lo.append(lo_i)
    b = 2.0 * ((d[0] * h[0] + d[1] * h[1] + d[2] * h[2]) + (d[0] * lo[0] + d[1] * lo[1] + d[2] * lo[2]))
    p0, e0 = _two_prod(h[0], h[0])
    p1, e1 = _two_prod(h[1], h[1])
    p2, e2 = _two_prod(h[2], h[2])
    pr, er = _two_prod(r, r)
    s1, t1 = _two_sum(p0, p1)
    s2, t2 = _two_sum(s1, p2)
    s3, t3 = _two_sum(s2, -pr)
    corr = (
        (t1 + t2 + t3) + (e0 + e1 + e2 - er)
        + 2.0 * (h[0] * lo[0] + h[1] * lo[1] + h[2] * lo[2])
        + (lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2])
    )
    return b, s3 + corr


def sol_disc_plain(o, d, c, r, faraway: float):
    """Cheap tier: ``(sol, disc, t, b, c_term)`` of one sphere."""
    b, ct = b_cterm_plain(o, d, c, r)
    return (*quad_sol_disc(b, ct, faraway), b, ct)


def sol_disc_exact(o, d, c, r, faraway: float):
    """Exact tier: ``(sol, disc, t, b, c_term)`` of one sphere."""
    b, ct = compensated_b_cterm(o, d, c, r)
    return (*quad_sol_disc(b, ct, faraway), b, ct)


def sol_disc_adjoint(b, ct, g_sol, g_disc):
    """``(g_b, g_ct)`` for the AS-COMPUTED :func:`quad_sol_disc` outputs.

    The smooth relaxation uses ``sol`` as a signed proximity signal on
    ``disc <= 0`` lanes too, where it is not a root, so the adjoint follows
    the computed expression branch for branch, recomputing the forward's
    selections.
    """
    disc = b * b - 4.0 * ct
    pos = disc > 0
    sq = torch.where(pos, sqrt(torch.where(pos, disc, torch.ones_like(disc))), torch.zeros_like(disc))
    sgn = torch.where(b < 0, -1.0, 1.0).to(b.dtype)
    qroot = -0.5 * (b + sgn * sq)
    q_zero = qroot == 0
    safe_q = torch.where(q_zero, torch.ones_like(qroot), qroot)
    other = torch.where(q_zero, torch.zeros_like(qroot), ct / safe_q)

    t0 = torch.minimum(qroot, other)
    t1 = torch.maximum(qroot, other)
    sol = torch.where((t0 > 0) & (t0 < t1), t0, t1)
    chose_q = sol == qroot

    zero = torch.zeros_like(g_sol)
    g_b_out = 2.0 * b * g_disc
    g_ct_out = -4.0 * g_disc

    g_qroot = torch.where(chose_q, g_sol, zero)
    g_other = torch.where(chose_q, zero, g_sol)
    g_ct_out = g_ct_out + torch.where(q_zero, zero, g_other / safe_q)
    g_qroot = g_qroot + torch.where(q_zero, zero, -g_other * ct / (safe_q * safe_q))
    g_b_out = g_b_out - 0.5 * g_qroot
    g_sq = -0.5 * sgn * g_qroot
    g_disc_sq = torch.where(pos, g_sq / (2.0 * torch.clamp_min(sq, EPS_DEN)), zero)
    g_b_out = g_b_out + 2.0 * b * g_disc_sq
    g_ct_out = g_ct_out - 4.0 * g_disc_sq
    return g_b_out, g_ct_out
