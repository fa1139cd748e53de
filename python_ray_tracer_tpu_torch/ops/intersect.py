"""Batched ray-sphere intersection and nearest-hit selection (pure torch).

Port of :mod:`python_ray_tracer_tpu.ops.intersect`: one dense (N rays x S
spheres) sweep followed by a nearest-hit reduction.  The float64 form
(:func:`intersect_all`) keeps the reference's coefficient order; the
float32 forms rebuild ``|o-c|^2 - r^2`` with error-free transformations
(Knuth twoSum, Dekker twoProd) and pair the roots stably.  Strict
``disc > 0 & t > 0`` hits; FARAWAY on a miss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import sqrt


class IntersectResult(NamedTuple):
    """Per (ray, sphere) sweep output: ``t`` (FARAWAY on miss), raw root
    ``sol`` and discriminant ``disc``, each (N, S)."""

    t: torch.Tensor
    sol: torch.Tensor
    disc: torch.Tensor


class NearestHit(NamedTuple):
    """Nearest hit per ray: ``t`` (N,), ``idx`` (N,) int32 (0 on miss), ``hit`` bool."""

    t: torch.Tensor
    idx: torch.Tensor
    hit: torch.Tensor


def _rays(origin: torch.Tensor, direction: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return origin.expand(direction.shape)[:, None, :], direction[:, None, :]


def _roots(b: torch.Tensor, c_term: torch.Tensor, faraway: float) -> IntersectResult:
    """Stable root pairing: large root by addition, small root by division."""
    disc = b * b - 4.0 * c_term
    pos = disc > 0
    sq = torch.where(pos, sqrt(torch.where(pos, disc, torch.ones_like(disc))), torch.zeros_like(disc))
    qroot = -0.5 * (b + torch.copysign(sq, b))
    safe_q = torch.where(qroot == 0, torch.ones_like(qroot), qroot)
    other = torch.where(qroot == 0, torch.zeros_like(qroot), c_term / safe_q)
    t0 = torch.minimum(qroot, other)
    t1 = torch.maximum(qroot, other)
    sol = torch.where((t0 > 0) & (t0 < t1), t0, t1)
    t = torch.where(pos & (sol > 0), sol, torch.full_like(sol, faraway))
    return IntersectResult(t=t, sol=sol, disc=disc)


def intersect_all(
    origin: torch.Tensor,  # (N, 3) or (3,)
    direction: torch.Tensor,  # (N, 3)
    center: torch.Tensor,  # (S, 3)
    radius: torch.Tensor,  # (S,)
    faraway: float,
) -> IntersectResult:
    """Reference-form quadratic sweep of every ray against every sphere."""
    o, d = _rays(origin, direction)
    c = center[None, :, :]

    oc = o - c
    b = 2.0 * (d[..., 0] * oc[..., 0] + d[..., 1] * oc[..., 1] + d[..., 2] * oc[..., 2])

    def sq3(v: torch.Tensor) -> torch.Tensor:
        return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]

    c_dot_o = c[..., 0] * o[..., 0] + c[..., 1] * o[..., 1] + c[..., 2] * o[..., 2]
    c_term = sq3(c) + sq3(o) - 2.0 * c_dot_o - radius[None, :] * radius[None, :]

    disc = b * b - 4.0 * c_term
    pos = disc > 0
    sq = torch.where(pos, sqrt(torch.where(pos, disc, torch.ones_like(disc))), torch.zeros_like(disc))

    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    sol = torch.where((t0 > 0) & (t0 < t1), t0, t1)

    t = torch.where(pos & (sol > 0), sol, torch.full_like(sol, faraway))
    return IntersectResult(t=t, sol=sol, disc=disc)


def nearest_hit(t: torch.Tensor, faraway: float) -> NearestHit:
    """Reduce the (N, S) distance table to the nearest sphere per ray.

    Argmin takes the first winner: the lowest index wins an exact tie.
    """
    tmin = torch.amin(t, dim=1)
    idx = torch.argmin(t, dim=1).to(torch.int32)
    hit = tmin != faraway
    return NearestHit(t=tmin, idx=idx, hit=hit)


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth twoSum: a + b = s + e exactly."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker split: a = hi + lo with hi/lo each half-width."""
    factor = 4097.0 if a.dtype == torch.float32 else 134217729.0
    c = a * factor
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker twoProd: a * b = p + e exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def intersect_all_plain(
    origin: torch.Tensor,
    direction: torch.Tensor,
    center: torch.Tensor,
    radius: torch.Tensor,
    faraway: float,
) -> IntersectResult:
    """Well-conditioned plain sweep: ``c_term = |o-c|^2 - r^2`` directly.

    Accurate for ordinary radii/centers (the cheap tier); NOT safe for huge
    spheres, which need :func:`intersect_all_stable`.
    """
    o, d = _rays(origin, direction)
    c = center[None, :, :]

    oc = o - c
    b = 2.0 * (d[..., 0] * oc[..., 0] + d[..., 1] * oc[..., 1] + d[..., 2] * oc[..., 2])
    c_term = (
        oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1] + oc[..., 2] * oc[..., 2]
        - radius[None, :] * radius[None, :]
    )
    return _roots(b, c_term, faraway)


def intersect_all_stable(
    origin: torch.Tensor,
    direction: torch.Tensor,
    center: torch.Tensor,
    radius: torch.Tensor,
    faraway: float,
) -> IntersectResult:
    """float32-robust quadratic sweep (same hit semantics as the reference)."""
    o, d = _rays(origin, direction)
    c = center[None, :, :]
    r = radius[None, :]

    # Exact (hi, lo) pair for each component of o - c.
    h, low = [], []
    for i in range(3):
        hi, lo = _two_sum(o[..., i], -c[..., i])
        h.append(hi)
        low.append(lo)

    b = 2.0 * (
        (d[..., 0] * h[0] + d[..., 1] * h[1] + d[..., 2] * h[2])
        + (d[..., 0] * low[0] + d[..., 1] * low[1] + d[..., 2] * low[2])
    )

    # c_term = |o - c|^2 - r^2 with compensated products and summation.
    p0, e0 = _two_prod(h[0], h[0])
    p1, e1 = _two_prod(h[1], h[1])
    p2, e2 = _two_prod(h[2], h[2])
    pr, er = _two_prod(r, r)
    s1, t1 = _two_sum(p0, p1)
    s2, t2 = _two_sum(s1, p2)
    s3, t3 = _two_sum(s2, -pr)
    corr = (
        (t1 + t2 + t3)
        + (e0 + e1 + e2 - er)
        + 2.0 * (h[0] * low[0] + h[1] * low[1] + h[2] * low[2])
        + (low[0] * low[0] + low[1] * low[1] + low[2] * low[2])
    )
    return _roots(b, s3 + corr, faraway)


def intersect_two_tier(
    origin: torch.Tensor,
    direction: torch.Tensor,
    center: torch.Tensor,  # (S, 3) — cheap rows first, exact rows last
    radius: torch.Tensor,
    faraway: float,
    n_exact: int,
) -> IntersectResult:
    """Plain math on the cheap prefix, compensated on the exact suffix."""
    s = center.shape[0]
    n_exact = min(n_exact, s)
    if n_exact == 0:
        return intersect_all_plain(origin, direction, center, radius, faraway)
    if n_exact == s:
        return intersect_all_stable(origin, direction, center, radius, faraway)
    s_cheap = s - n_exact
    a = intersect_all_plain(origin, direction, center[:s_cheap], radius[:s_cheap], faraway)
    b = intersect_all_stable(origin, direction, center[s_cheap:], radius[s_cheap:], faraway)
    return IntersectResult(*(torch.cat([x, y], dim=1) for x, y in zip(a, b)))
