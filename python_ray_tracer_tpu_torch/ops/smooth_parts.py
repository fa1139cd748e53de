"""Per-shard smooth-visibility sweeps: wrappers, plain versions and autograd.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_smooth_parts`, the kernels
the sphere-sharded smooth path (:func:`..render.trace` with a sphere axis)
runs on every bounce, each over one shard of the sphere table, reduced in
the kernel to O(N) per-ray quantities with LOCAL sphere indices; the
caller's collectives finish the reductions across the shards.  The CUDA
kernels sit in ``csrc/smooth_parts.cu``:

* ``smooth_nearest_parts`` (``_smooth_nearest_kernel``): the strict-hit
  winner ``(t, idx)`` with its raw ``(sol_w, disc_w)`` and the
  max-discriminant fallback ``(dmax, fidx, sol_f)``
  (:class:`SmoothParts`).  Its backward is plain torch, as the JAX VJP is
  XLA code (``_smooth_nearest_bwd``, ``_row_adjoint``): the adjoints of the
  two selected rows, pushed into the shard's (S, 4) geometry with
  :func:`.tables.segment_sum` (a fixed order, no float atomics);
* ``clear_fwd`` and ``clear_bwd`` (``_clear_fwd_kernel``,
  ``_clear_bwd_kernel``): the shadow product over the shard's spheres
  other than the lane's own, and its adjoint swept again (lane gradients
  and the per-sphere ``(center, radius)`` gradients, block rows reduced in
  a fixed order).

:func:`smooth_nearest_parts` and :func:`smooth_clear_parts` are the two
``torch.autograd.Function``s that stand for JAX's two ``custom_vjp``s.  The
geometry of a shard is one (S, 4) ``[cx, cy, cz, r]`` table with its last
``S - s_cheap`` rows in the compensated tier; JAX's kernels clamp the
global ``n_exact`` to ``min(n_exact, S)`` per shard, and the caller does the
same.  The JAX kernels pad each tier to their sphere block with zero-radius
rows whose indices run on past the tier's end (into the exact tier's, for
the cheap tier's padding); the port sweeps the real rows only.

``clear_fwd`` leaves out of its product the factors that are exactly 1
(``csrc/smooth_math.cuh`` ``shadow_skip_product``): per lane a pair whose
``sig(k disc)`` is exactly 0, and per warp the cheap-tier spheres no shadow
line of the warp comes within ``r_eff`` of, the warp's bound taking the
light (``light``) as its apex.  :func:`clear_fwd_plain` with ``skip=True``
multiplies those pairs only, bitwise the product over every pair; the
wrapper's ``skip`` ("auto", "on", "off") picks the kernel with the skip or
without, "auto" from :data:`CLEAR_SKIP_MIN_CHEAP` cheap-tier spheres on.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  :data:`LAUNCHES` counts the launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .bounce_smooth import EPS_DEN, b_cterm_plain, sig, sol_disc_adjoint
from .bounce_smooth_sub import shadow_reach
from .intersect import intersect_two_tier
from .intersect_fused import WARP, _light, _skip_code
from .tables import segment_sum

LAUNCHES = {"smooth_nearest_parts": 0, "clear_fwd": 0, "clear_bwd": 0}

_SOURCE = "smooth_parts.cu"

# The max-discriminant fallback's sentinel (the JAX kernel's carry init).
NEG_BIG = -3.0e38

# Ray-sphere pairs per chunk of the plain versions.
_CHUNK_PAIRS = 1 << 23

# clear_fwd's skip (csrc/smooth_parts.cu kClearSkipMinCheap): "auto" takes
# it from this many cheap-tier spheres on.
CLEAR_SKIP_MIN_CHEAP = 16

# C signatures of the entries in csrc/smooth_parts.cu, before the trailing
# stream: p = pointer, i = int, r = the dtype's real.
_SIGNATURES = {
    # o, d, geom, t, idx, sol_w, disc_w, dmax, fidx, sol_f; n, s_cheap, s_total; faraway
    "smooth_nearest_parts": "pppppppppp" "iii" "r",
    # o, d, geom, self_idx, clear; n, s_cheap, s_total; faraway, sharpness; the light (3,) or null; skip
    "clear_fwd": "ppppp" "iii" "rr" "p" "i",
    # o, d, geom, self_idx, clear, g_clear, g_o, g_d, parts, g_geom; n, s_cheap, s_total; faraway, sharpness
    "clear_bwd": "pppppppppp" "iii" "rr",
}


class SmoothParts(NamedTuple):
    """One shard's reduced smooth-sweep quantities (LOCAL sphere indices)."""

    t: torch.Tensor  # (N,) winner hit distance; faraway when no strict hit
    idx: torch.Tensor  # (N,) int32 local winner index (0 when no hit)
    sol_w: torch.Tensor  # (N,) winner's raw root (== t on hit lanes)
    disc_w: torch.Tensor  # (N,) winner's raw discriminant
    dmax: torch.Tensor  # (N,) max discriminant over the shard (fallback)
    fidx: torch.Tensor  # (N,) int32 local argmax-disc index
    sol_f: torch.Tensor  # (N,) the argmax-disc row's raw root


def _chunks(n: int, s: int):
    step = max(1, _CHUNK_PAIRS // max(s, 1))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _tables(o, d, geom, faraway: float, s_cheap: int):
    """(N, S) ``(t, sol, disc)`` of the kernels' two tiers."""
    return intersect_two_tier(o, d, geom[:, :3], geom[:, 3], faraway, geom.shape[0] - s_cheap)


def _ids(geom: torch.Tensor) -> torch.Tensor:
    return torch.arange(geom.shape[0], dtype=torch.int32, device=geom.device)[None, :]


def smooth_nearest_parts_plain(o, d, geom, *, faraway: float, s_cheap: int) -> SmoothParts:
    """Plain version of ``smooth_nearest_parts``: the first minimum of ``t``
    (a miss keeps idx 0 and zero ``sol_w``, ``disc_w``) and the first maximum
    of ``disc`` above the sentinel (else 0, and ``sol_f`` 0)."""
    outs = []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        res = _tables(o[a:b], d[a:b], geom, faraway, s_cheap)
        tmin, imin = torch.min(res.t, dim=1)
        hit = tmin != faraway
        zero = torch.zeros_like(tmin)
        sol_w = torch.where(hit, torch.gather(res.sol, 1, imin[:, None])[:, 0], zero)
        disc_w = torch.where(hit, torch.gather(res.disc, 1, imin[:, None])[:, 0], zero)
        dmax, fidx = torch.max(res.disc, dim=1)
        found = dmax > NEG_BIG
        sol_f = torch.where(found, torch.gather(res.sol, 1, fidx[:, None])[:, 0], zero)
        outs.append((
            tmin, torch.where(hit, imin, 0).to(torch.int32), sol_w, disc_w,
            torch.where(found, dmax, torch.full_like(dmax, NEG_BIG)), torch.where(found, fidx, 0).to(torch.int32),
            sol_f,
        ))
    return SmoothParts(*(torch.cat(col) for col in zip(*outs)))


def _factors(o, d, geom, self_idx, *, faraway: float, sharpness: float, s_cheap: int):
    """Per (ray, sphere): ``(fac, sd, ss, is_self)``, the shadow factor
    ``1 - sig(k disc) sig(k sol)`` (1 on the lane's own sphere) and its parts."""
    res = _tables(o, d, geom, faraway, s_cheap)
    sd = sig(sharpness * res.disc)
    ss = sig(sharpness * res.sol)
    is_self = _ids(geom) == self_idx[:, None]
    fac = torch.where(is_self, torch.ones_like(sd), 1.0 - sd * ss)
    return fac, sd, ss, is_self


def clear_fwd_plain(o, d, geom, self_idx, *, faraway: float, sharpness: float, s_cheap: int, skip: bool = False,
                    light=None) -> torch.Tensor:
    """Plain version of ``clear_fwd``: the product of the factors, taken in
    row order as the kernel takes it.  ``skip``: over the pairs the kernel's
    skip keeps only (its warp bound, :func:`.bounce_smooth_sub.shadow_reach`
    with ``light`` (3,) or None its apex; not the lane's own sphere; a
    shadow sigmoid that is not exactly 0 where ``sharpness`` is finite),
    bitwise the product over every pair; only the tests and the card check's
    counts run it."""
    reach = None
    if skip:
        reach = shadow_reach(o, d, _light(light, o), geom, s_cheap, sharpness)
        finite = bool(torch.isfinite(torch.tensor(sharpness, dtype=o.dtype)))
    clears = []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        fac, sd, _, is_self = _factors(o[a:b], d[a:b], geom, self_idx[a:b], faraway=faraway, sharpness=sharpness,
                                       s_cheap=s_cheap)
        if reach is not None:
            kept = reach[torch.arange(a, b, device=o.device) // WARP] & ~is_self & ((sd != 0) if finite else True)
        clear = torch.ones_like(fac[:, 0])
        for k in range(fac.shape[1]):
            clear = clear * fac[:, k] if reach is None else torch.where(kept[:, k], clear * fac[:, k], clear)
        clears.append(clear)
    return torch.cat(clears)


def clear_bwd_plain(o, d, geom, self_idx, clear, g_clear, *, faraway: float, sharpness: float, s_cheap: int):
    """Plain version of ``clear_bwd``: ``(g_o, g_d, g_geom)``, (N, 3) twice
    and (S, 4), the product's adjoint with ``g_fac = g clear / max(fac,
    1e-6)`` and the branch adjoint at the plain tier's ``(b, c_term)``."""
    g_o, g_d = [], []
    g_geom = torch.zeros_like(geom)
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        go, gd, rows, _ = clear_terms(o[a:b], d[a:b], geom, self_idx[a:b], g_clear[a:b] * clear[a:b],
                                      faraway=faraway, sharpness=sharpness, s_cheap=s_cheap)
        g_o.append(torch.stack([x.sum(1) for x in go], dim=1))
        g_d.append(torch.stack([x.sum(1) for x in gd], dim=1))
        g_geom = g_geom + torch.stack([x.sum(0) for x in rows], dim=1)
    return torch.cat(g_o), torch.cat(g_d), g_geom


def clear_terms(o, d, geom, self_idx, gc, *, faraway: float, sharpness: float, s_cheap: int):
    """The (N, S) terms of ``clear_bwd_plain``, lane by sphere: what each
    sphere adds to g_o (3) and g_d (3) and its row of g_geom (4), with
    ``gc = g_clear * clear`` (N,); and where the sphere reaches the lane.
    It does not where it is the lane's own or its shadow sigmoid
    ``sig(k disc)`` (disc in its tier) is exactly 0: every term is exactly
    +-0 there, and the kernel's warps pass such spheres."""
    fac, sd, ss, is_self = _factors(o, d, geom, self_idx, faraway=faraway, sharpness=sharpness, s_cheap=s_cheap)
    g_fac = gc[:, None] / torch.clamp_min(fac, EPS_DEN)
    g_occl = torch.where(is_self, torch.zeros_like(g_fac), -g_fac)
    g_disc = g_occl * ss * sd * (1.0 - sd) * sharpness
    g_sol = g_occl * sd * ss * (1.0 - ss) * sharpness
    c = tuple(geom[None, :, i] for i in range(3))
    r = geom[None, :, 3]
    oi = tuple(o[:, i, None] for i in range(3))
    di = tuple(d[:, i, None] for i in range(3))
    b_, ct = b_cterm_plain(oi, di, c, r)
    g_b, g_ct = sol_disc_adjoint(b_, ct, g_sol, g_disc)
    oc = tuple(oi[i] - c[i] for i in range(3))
    go = [2.0 * di[i] * g_b + 2.0 * oc[i] * g_ct for i in range(3)]
    gd = [2.0 * oc[i] * g_b for i in range(3)]
    rows = [-x for x in go] + [-2.0 * r * g_ct]
    return go, gd, rows, ~is_self & (sd != 0)


def _row_adjoint(o, d, geom, idx, g_sol, g_disc):
    """Push ``(g_sol, g_disc)`` at sphere row ``idx`` of each lane to
    ``(g_o, g_d)`` and the rows' ``(g_c, g_r)`` contributions (N, 4)."""
    row = geom[idx.long()]  # (N, 4)
    oc = o - row[:, :3]
    b = 2.0 * (d[:, 0] * oc[:, 0] + d[:, 1] * oc[:, 1] + d[:, 2] * oc[:, 2])
    ct = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] - row[:, 3] * row[:, 3]
    g_b, g_ct = sol_disc_adjoint(b, ct, g_sol, g_disc)
    g_o = d * (2.0 * g_b)[:, None] + oc * (2.0 * g_ct)[:, None]
    g_d = oc * (2.0 * g_b)[:, None]
    return g_o, g_d, torch.cat([-g_o, (-2.0 * row[:, 3] * g_ct)[:, None]], dim=1)


def _check(o, d, geom, s_cheap: int, self_idx=None) -> torch.device:
    """Validate what the kernels take; returns the common device."""
    n, s = o.shape[0], geom.shape[0]
    tensors = {"o": o, "d": d, "geom": geom, **({} if self_idx is None else {"self_idx": self_idx})}
    for name, x in tensors.items():
        if x.device != o.device:
            raise ValueError(f"{name}: expected a tensor on {o.device}, got {x.device}")
    for name, x in (("d", d), ("geom", geom)):
        if x.dtype != o.dtype:
            raise ValueError(f"{name}: expected {o.dtype}, got {x.dtype}")
    if o.shape != (n, 3) or d.shape != (n, 3) or n == 0:
        raise ValueError(f"rays: expected o and d of one shape (N, 3), N > 0; got {tuple(o.shape)}, {tuple(d.shape)}")
    if self_idx is not None and (self_idx.shape != (n,) or self_idx.dtype != torch.int32):
        raise ValueError(f"self_idx: expected int32 of shape ({n},)")
    if geom.shape != (s, 4) or s < 1:
        raise ValueError("geom: expected (S, 4) with S >= 1")
    if not 0 <= s_cheap <= s:
        raise ValueError(f"s_cheap must lie in 0..{s}, got {s_cheap}")
    if o.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {o.dtype}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")
    return o.device


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch kernel ``name`` on the current stream and count it."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    LAUNCHES[name] += 1


def _contig(*xs):
    return [x.detach().contiguous() for x in xs]


def nearest_parts(o, d, geom, *, faraway: float, s_cheap: int) -> SmoothParts:
    """``smooth_nearest_parts`` of rays ``o``/``d`` (N, 3) over the shard
    ``geom`` (S, 4); no gradient (see :func:`smooth_nearest_parts`)."""
    device = _check(o, d, geom, s_cheap)
    o, d, geom = _contig(o, d, geom)
    if device.type == "cpu":
        return smooth_nearest_parts_plain(o, d, geom, faraway=faraway, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        real = [torch.empty((n,), dtype=o.dtype, device=device) for _ in range(5)]
        ints = [torch.empty((n,), dtype=torch.int32, device=device) for _ in range(2)]
        t, sol_w, disc_w, dmax, sol_f = real
        idx, fidx = ints
        _launch("smooth_nearest_parts", o.dtype, o, d, geom, t, idx, sol_w, disc_w, dmax, fidx, sol_f, n, s_cheap,
                geom.shape[0], float(faraway))
    return SmoothParts(t, idx, sol_w, disc_w, dmax, fidx, sol_f)


def clear_fwd(o, d, geom, self_idx, *, faraway: float, sharpness: float, s_cheap: int, light=None,
              skip: str = "auto") -> torch.Tensor:
    """``clear_fwd``: the shard's shadow product (N,); no gradient (see
    :func:`smooth_clear_parts`).  ``light`` (3,), the point the shadow rays
    aim at, tightens the skip's bound and nothing else (any value, or None,
    gives the same result); ``skip`` ("auto", "on", "off") picks the kernel
    that leaves out the factors of exactly 1 or the kernel without, the
    result the same bitwise."""
    code = _skip_code(skip)
    device = _check(o, d, geom, s_cheap, self_idx)
    o, d, geom, self_idx = _contig(o, d, geom, self_idx)
    light = _light(light, o)
    if device.type == "cpu":
        return clear_fwd_plain(o, d, geom, self_idx, faraway=faraway, sharpness=sharpness, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        clear = torch.empty((n,), dtype=o.dtype, device=device)
        _launch("clear_fwd", o.dtype, o, d, geom, self_idx, clear, n, s_cheap, geom.shape[0], float(faraway),
                float(sharpness), light, code)
    return clear


def clear_fwd_blocks_per_sm(dtype: torch.dtype, s: int, *, skip: bool) -> int:
    """Resident 256-thread blocks per SM of the clear_fwd instantiation
    (``skip``) a launch for ``s`` spheres takes, on the current card."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(_build.load_library(_SOURCE), f"prt_clear_fwd_blocks_per_sm_{suffix}")(int(skip), s)


def clear_bwd_blocks_per_sm(dtype: torch.dtype, s: int) -> int:
    """Resident 256-thread blocks per SM of the clear_bwd instantiation a
    launch for ``s`` spheres takes (staged or global geometry) on the
    current card."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(_build.load_library(_SOURCE), f"prt_clear_bwd_blocks_per_sm_{suffix}")(s)


def clear_bwd(o, d, geom, self_idx, clear, g_clear, *, faraway: float, sharpness: float, s_cheap: int):
    """``clear_bwd``: ``(g_o, g_d, g_geom)`` of the shard's shadow product."""
    device = _check(o, d, geom, s_cheap, self_idx)
    for name, x in (("clear", clear), ("g_clear", g_clear)):
        if x.shape != (o.shape[0],) or x.dtype != o.dtype or x.device != device:
            raise ValueError(f"{name}: expected {o.dtype} of shape ({o.shape[0]},) on {device}")
    o, d, geom, self_idx, clear, g_clear = _contig(o, d, geom, self_idx, clear, g_clear)
    kw = dict(faraway=faraway, sharpness=sharpness, s_cheap=s_cheap)
    if device.type == "cpu":
        return clear_bwd_plain(o, d, geom, self_idx, clear, g_clear, **kw)
    n, s = o.shape[0], geom.shape[0]
    with torch.cuda.device(device):
        g_o = torch.empty_like(o)
        g_d = torch.empty_like(d)
        parts = torch.empty((4 * s, -(-n // 256)), dtype=o.dtype, device=device)  # csrc kThreads rays a block
        g_geom = torch.empty((s, 4), dtype=o.dtype, device=device)
        _launch("clear_bwd", o.dtype, o, d, geom, self_idx, clear, g_clear, g_o, g_d, parts, g_geom, n, s_cheap, s,
                float(faraway), float(sharpness))
    return g_o, g_d, g_geom


class _NearestParts(torch.autograd.Function):
    """JAX's ``_smooth_nearest_raw`` custom_vjp: the kernel forward, the
    adjoints of the two selected rows backward."""

    @staticmethod
    def forward(ctx, o, d, geom, faraway, s_cheap):
        parts = nearest_parts(o, d, geom, faraway=faraway, s_cheap=s_cheap)
        ctx.faraway = faraway
        ctx.save_for_backward(o, d, geom, parts.t, parts.idx, parts.fidx)
        ctx.mark_non_differentiable(parts.idx, parts.fidx)
        return tuple(parts)

    @staticmethod
    def backward(ctx, g_t, _g_idx, g_solw, g_discw, g_dmax, _g_fidx, g_solf):
        o, d, geom, t, idx, fidx = ctx.saved_tensors
        with torch.profiler.record_function("smooth_nearest_parts backward"):
            # The winner's raw root is its hit distance, so g_t (hit lanes
            # only) folds into g_sol_w; a miss lane's winner row is zeroed.
            hitf = (t != ctx.faraway).to(t.dtype)
            g_sol_w = (g_solw + torch.where(t != ctx.faraway, g_t, torch.zeros_like(g_t))) * hitf
            g_disc_w = g_discw * hitf
            g_o1, g_d1, rows1 = _row_adjoint(o, d, geom, idx, g_sol_w, g_disc_w)
            g_o2, g_d2, rows2 = _row_adjoint(o, d, geom, fidx, g_solf, g_dmax)
            g_geom = segment_sum(torch.cat([rows1, rows2]), torch.cat([idx, fidx]), geom.shape[0])
        return g_o1 + g_o2, g_d1 + g_d2, g_geom, None, None


class _ClearParts(torch.autograd.Function):
    """JAX's ``_clear_raw`` custom_vjp: ``clear_fwd`` forward, ``clear_bwd``
    backward."""

    @staticmethod
    def forward(ctx, o, d, geom, self_idx, faraway, sharpness, s_cheap, light):
        kw = dict(faraway=faraway, sharpness=sharpness, s_cheap=s_cheap)
        clear = clear_fwd(o, d, geom, self_idx, **kw, light=light)
        ctx.kw = kw
        ctx.save_for_backward(o, d, geom, self_idx, clear)
        return clear

    @staticmethod
    def backward(ctx, g_clear):
        o, d, geom, self_idx, clear = ctx.saved_tensors
        g_o, g_d, g_geom = clear_bwd(o, d, geom, self_idx, clear, g_clear, **ctx.kw)
        return g_o, g_d, g_geom, None, None, None, None, None


def smooth_nearest_parts(o, d, geom, *, faraway: float, s_cheap: int) -> SmoothParts:
    """One shard's smooth nearest and coverage partials (:class:`SmoothParts`),
    differentiable in ``o``, ``d`` (N, 3) and the shard ``geom`` (S, 4)."""
    return SmoothParts(*_NearestParts.apply(o, d, geom, faraway, s_cheap))


def smooth_clear_parts(o, d, geom, self_idx, *, faraway: float, sharpness: float, s_cheap: int,
                       light=None) -> torch.Tensor:
    """One shard's smooth shadow product (N,) over its spheres other than
    each lane's own ``self_idx`` (int32, LOCAL: an index out of ``0..S-1``
    matches no sphere); the caller multiplies the shards' products.
    Differentiable in ``o``, ``d`` and ``geom``; ``light`` (3,), the point
    the shadow rays aim at, only tightens the forward kernel's skip."""
    return _ClearParts.apply(o, d, geom, self_idx, faraway, float(sharpness), s_cheap, light)
