"""Standalone nearest-hit and hard-shadow sweeps: wrappers and plain versions.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_intersect`'s two kernels,
``_nearest_kernel`` (``nearest_hit_pallas``) and ``_shadow_kernel`` in its
hard mode (``shadow_hard_pallas``) and its parts mode
(``shadow_parts_pallas``), as the CUDA kernels ``nearest_sweep``,
``shadow_sweep`` and ``shadow_parts`` in ``csrc/intersect_fused.cu``: one
thread per ray over the (N, 3) rows of :func:`..render.trace`, one ascending
loop over the (S, 4) geometry table, cheap tier then exact tier.
``render.trace`` calls the first two once each per bounce on its kernel
branch (a stochastic glossy hard scene above 64 spheres), with plain torch
shading between them; its sphere-sharded hard branch sweeps each shard with
``nearest_sweep`` and ``shadow_parts``.  (The module is not
``intersect.py``, which is the port of the JAX ``ops/intersect.py``.)

The plain versions are the pure-torch two-tier sweep
(:func:`.intersect.intersect_two_tier`, the same operations as the JAX
kernels' ``_block_t_fast``/``_block_t_exact``) reduced as the kernels
reduce, over chunks of rays so that no (N, S) table outgrows memory.  A
wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches the kernel or raises.  Hard visibility has no gradient here: the
JAX ``nearest_hit_pallas`` VJP is XLA code that hard rendering never runs.
:data:`LAUNCHES` counts the launches, :data:`PARTS_LAUNCHES` the parts
mode's.

The shadow kernel (both modes) and ``bounce_lane`` skip the cheap-tier
spheres that no ray of a warp (32 consecutive rays) can hit: the warp
bounds its rays by a ball of origins and a cone of directions (shadow rays
also by how near their lines pass the light, the wrappers' ``light``), and
each cheap sphere is tested once against that bound
(``csrc/sweep_math.cuh``, which states the margin).  :func:`warp_bundles`
and :func:`bundle_test` are that test term for term, :func:`bundle_reach`
the (warp, sphere) pairs a kernel sweeps; the plain versions with
``skip=True`` sweep only those and fold a skipped sphere as the kernels do,
bitwise the plain versions without; only the tests and the card check's
counts run them.  A wrapper's ``skip`` ("auto", "on", "off") picks the
kernel with the skip or without (the card check and the A/B time both);
"auto" is the launcher's rule (``kSkipMinCheap`` in ``sweep_math.cuh``).
On the CPU a wrapper runs the plain version over every pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .bounce_sub import _dot3, _normalize3
from .intersect import NearestHit, intersect_two_tier, nearest_hit
from .vecmath import sqrt

LAUNCHES = {"nearest_sweep": 0, "shadow_sweep": 0}
# The shadow kernel's parts mode, counted apart as the atlas modes are.
PARTS_LAUNCHES = {"shadow_parts": 0}

_SOURCE = "intersect_fused.cu"

# The shadow sweep's sentinel per dtype, the JAX kernel's.
_BIG = {torch.float32: 3.0e38, torch.float64: 1.0e300}

# Ray-sphere pairs per chunk of the plain versions.
_CHUNK_PAIRS = 1 << 24

# The skip of the shadow sweep and bounce_lane (csrc/sweep_math.cuh Skip):
# "auto" takes the launcher's rule.
SKIP = {"auto": -1, "off": 0, "on": 1}
WARP = 32
# The bundle test's limits and its margin's unit, the dtype's unit roundoff
# (csrc/sweep_math.cuh kBundleMaxCoord, kBundleMaxV2, unit_roundoff).
BUNDLE_MAX_COORD = 2.0**40
BUNDLE_MAX_V2 = 2.0**100
UNIT_ROUNDOFF = {torch.float32: 2.0**-24, torch.float64: 2.0**-53}


class Bundles(NamedTuple):
    """Each warp's bound of its rays (W = ceil(N / 32) warps): every origin
    within ``r`` (W,) of ``c`` (W, 3), every direction within the cone about
    ``a`` (W, 3) of half-angle cosine ``cos_t`` and sine ``sin_t`` (W,),
    every ray's line within ``eps`` (W,) of the apex ``p`` (W, 3); ``ok``
    (W,) false: the warp sweeps every sphere."""

    c: torch.Tensor
    r: torch.Tensor
    a: torch.Tensor
    cos_t: torch.Tensor
    sin_t: torch.Tensor
    p: torch.Tensor
    eps: torch.Tensor
    ok: torch.Tensor


def _lanes(x):
    """(W, 32) tuples of the three components of rows ``x`` (N, 3), the last
    warp padded with zeros."""
    pad = (-x.shape[0]) % WARP
    x = torch.cat([x, x.new_zeros((pad, 3))]) if pad else x
    return tuple(x[:, i].reshape(-1, WARP) for i in range(3))


def warp_bundles(o, d, apex=None) -> Bundles:
    """``warp_bundle`` of ``csrc/sweep_math.cuh`` for rays ``o``/``d`` (N, 3):
    the box centre of the origins, the farthest origin from it times 1 + 16u,
    the xor-butterfly sum of the directions normalised, the least cosine to
    it less 64u, and the farthest line from ``apex`` (3,) (the light, for
    shadow rays; None: NaN, no such bound).  A warp with a lane past N, an
    origin coordinate past 2^40 in magnitude or not a number, or a direction
    with | |d|^2 - 1 | > 32u, or a cone of 90 degrees or more, is not ``ok``."""
    u = UNIT_ROUNDOFF[o.dtype]
    n = o.shape[0]
    ol, dl = _lanes(o), _lanes(d)
    live = (torch.arange(ol[0].numel(), device=o.device) < n).reshape(-1, WARP)
    lane_ok = live & (torch.abs(_dot3(dl, dl) - 1.0) <= 32 * u)
    for x in ol:
        lane_ok = lane_ok & (torch.abs(x) <= BUNDLE_MAX_COORD)
    c = tuple((torch.amin(x, 1) + torch.amax(x, 1)) * 0.5 for x in ol)
    e = tuple(x - ci[:, None] for x, ci in zip(ol, c))
    r = torch.amax(sqrt(_dot3(e, e)), 1) * (1 + 16 * u)
    lanes = torch.arange(WARP, device=o.device)
    s = dl
    for m in (16, 8, 4, 2, 1):
        s = tuple(x + x[:, lanes ^ m] for x in s)
    a = _normalize3(tuple(x[:, 0] for x in s))
    cos_t = torch.amin(_dot3(dl, tuple(x[:, None] for x in a)), 1) - 64 * u
    sin_t = sqrt((1.0 - cos_t) * (1.0 + cos_t))
    p = torch.full((3,), float("nan"), dtype=o.dtype, device=o.device) if apex is None else apex.to(o.dtype)
    w = tuple(p[i] - x for i, x in enumerate(ol))
    wd = _dot3(w, dl)
    f = tuple(wi - wd * di for wi, di in zip(w, dl))
    eps = torch.amax(sqrt(_dot3(f, f)) + (16 * u) * sqrt(_dot3(w, w)), 1) * (1 + 16 * u)
    return Bundles(torch.stack(c, 1), r, torch.stack(a, 1), cos_t, sin_t, p.expand(len(r), 3), eps,
                   lane_ok.all(1) & (cos_t > 0))


def _outside_cone(b: Bundles, v, v2, vl, rho, doubled: bool):
    """``outside_cone`` of ``csrc/sweep_math.cuh``."""
    u = UNIT_ROUNDOFF[rho.dtype]
    rho2 = rho * rho
    x = v2 - rho2 - (8 * u) * (v2 + rho2)
    av = _dot3(tuple(b.a[:, i, None] for i in range(3)), v)
    lhs = (torch.abs(av) if doubled else av) + (64 * u) * (vl + rho)
    rhs = b.cos_t[:, None] * sqrt(x) - b.sin_t[:, None] * rho
    return (v2 < BUNDLE_MAX_V2) & (x > 0) & (lhs < rhs)


def bundle_test(b: Bundles, geom) -> torch.Tensor:
    """``bundle_reaches`` of ``csrc/sweep_math.cuh``: (W, S) whether a ray of
    warp w may hit sphere k of ``geom`` (S, 4), as the test of a cheap-tier
    sphere answers: not if the cone from the ball of origins rules it out,
    nor if the double cone from the apex does (the margin the source states;
    NaN never rules out)."""
    u = UNIT_ROUNDOFF[geom.dtype]
    v = tuple(geom[None, :, i] - b.c[:, i, None] for i in range(3))
    v2 = _dot3(v, v)
    vl = sqrt(v2)
    w = vl + b.r[:, None]
    r = geom[None, :, 3]
    q = sqrt(r * r * (1 + 16 * u) + (256 * u) * (w * w))
    outside = _outside_cone(b, v, v2, vl, b.r[:, None] + q + (64 * u) * w, False)
    if bool((b.eps == b.eps).any()):  # an apex (one for every warp of the call)
        vp = tuple(geom[None, :, i] - b.p[:, i, None] for i in range(3))
        vp2 = _dot3(vp, vp)
        vpl = sqrt(vp2)
        outside = outside | _outside_cone(b, vp, vp2, vpl, b.eps[:, None] + q + (64 * u) * (w + vpl), True)
    return ~outside


def bundle_reach(o, d, geom, s_cheap: int, apex=None) -> torch.Tensor:
    """(W, S) the (warp, sphere) pairs a kernel with the skip sweeps for rays
    ``o``/``d`` (N, 3) (``apex`` the point shadow rays aim at, or None): the
    cheap-tier spheres the test passes, every exact-tier sphere, and every
    sphere of a warp whose bound is not ``ok``."""
    b = warp_bundles(o, d, apex)
    reach = torch.ones((b.ok.shape[0], geom.shape[0]), dtype=torch.bool, device=o.device)
    reach[:, :s_cheap] = bundle_test(b, geom[:s_cheap]) | ~b.ok[:, None]
    return reach


def _lane_reach(reach, a: int, b: int):
    """Rows a..b of the (N, S) lane-sphere pairs that ``reach`` (W, S) holds."""
    return reach[torch.arange(a, b, device=reach.device) // WARP]


def _skip_code(skip: str) -> int:
    """The kernels' code of ``skip`` ("auto", "on", "off")."""
    if skip not in SKIP:
        raise ValueError(f"skip: expected one of {sorted(SKIP)}, got {skip!r}")
    return SKIP[skip]


def _chunks(n: int, s: int):
    step = max(1, _CHUNK_PAIRS // max(s, 1))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _t_table(o, d, geom, faraway: float, s_cheap: int):
    """(N, S) hit distances of the kernels' two tiers."""
    return intersect_two_tier(o, d, geom[:, :3], geom[:, 3], faraway, geom.shape[0] - s_cheap).t


def nearest_sweep_plain(o, d, geom, *, faraway: float, s_cheap: int, skip: bool = False):
    """Plain version of ``nearest_sweep``: ``(t, idx)`` (N,), idx int32;
    ``skip``: over the (warp, sphere) pairs :func:`bundle_reach` keeps only
    (a skipped sphere is a miss at ``faraway``, which never wins), as
    ``bounce_lane``'s nearest sweep with its skip."""
    reach = bundle_reach(o, d, geom, s_cheap) if skip else None
    ts, idxs = [], []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        t = _t_table(o[a:b], d[a:b], geom, faraway, s_cheap)
        if reach is not None:
            t = torch.where(_lane_reach(reach, a, b), t, faraway)
        near = nearest_hit(t, faraway)
        ts.append(near.t)
        idxs.append(torch.where(near.hit, near.idx, 0))
    return torch.cat(ts), torch.cat(idxs)


def shadow_parts_plain(o, d, geom, self_idx, *, faraway: float, s_cheap: int, skip: bool = False, light=None):
    """Plain version of ``shadow_parts``: ``(t_others, t_self)`` (N,), the
    least hit distance along each shadow ray over the spheres other than the
    lane's own ``self_idx`` and that of its own sphere, both starting from
    the sentinel; an index outside ``0..S-1`` matches no sphere.  ``skip``:
    over the (warp, sphere) pairs :func:`bundle_reach` keeps only (``light``
    the apex of its bound), each minimum then folding ``faraway`` where it
    skipped a sphere, as the kernel with its skip does."""
    reach = bundle_reach(o, d, geom, s_cheap, light) if skip else None
    big = torch.tensor(_BIG[o.dtype], dtype=o.dtype, device=o.device)
    far = torch.tensor(faraway, dtype=o.dtype, device=o.device)
    ids = torch.arange(geom.shape[0], dtype=torch.int32, device=o.device)[None, :]
    others, selfs = [], []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        t = _t_table(o[a:b], d[a:b], geom, faraway, s_cheap)
        is_self = ids == self_idx[a:b, None]
        if reach is None:
            others.append(torch.minimum(torch.amin(torch.where(is_self, big, t), dim=1), big))
            selfs.append(torch.minimum(torch.amin(torch.where(is_self, t, big), dim=1), big))
            continue
        kept = _lane_reach(reach, a, b)
        t_others = torch.minimum(torch.amin(torch.where(is_self | ~kept, big, t), dim=1), big)
        t_self = torch.minimum(torch.amin(torch.where(is_self & kept, t, big), dim=1), big)
        others.append(torch.where(torch.any(~is_self & ~kept, dim=1), torch.minimum(t_others, far), t_others))
        selfs.append(torch.where(torch.any(is_self & ~kept, dim=1), torch.minimum(t_self, far), t_self))
    return torch.cat(others), torch.cat(selfs)


def shadow_sweep_plain(o, d, geom, self_idx, *, faraway: float, s_cheap: int, skip: bool = False, light=None):
    """Plain version of ``shadow_sweep``: 1 where the lane's own sphere
    ``self_idx`` is nearest along its shadow ray (``t_self <= t_others``,
    both starting from the sentinel), else 0; (N,) in the rays' dtype.
    ``skip`` and ``light`` as :func:`shadow_parts_plain` takes them."""
    t_others, t_self = shadow_parts_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap, skip=skip,
                                          light=light)
    return (t_self <= t_others).to(o.dtype)


def _check(o, d, geom, s_cheap: int, self_idx=None) -> torch.device:
    """Validate what the sweep kernels take; returns the common device."""
    n = o.shape[0]
    s = geom.shape[0]
    tensors = {"o": o, "d": d, "geom": geom, **({} if self_idx is None else {"self_idx": self_idx})}
    for name, x in tensors.items():
        if x.requires_grad:
            raise ValueError(f"{name}: the sweep kernels have no gradient; pass a detached tensor")
        if x.device != o.device:
            raise ValueError(f"{name}: expected a tensor on {o.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
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
    if o.device.type == "cuda" and 4 * s * o.element_size() > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{s} spheres do not fit the kernels' shared-memory geometry table")
    return o.device


# C signatures of the entries in csrc/intersect_fused.cu, before the
# trailing stream: p = pointer, i = int, r = the dtype's real.
_SIGNATURES = {
    "nearest_sweep": "ppppp" "iii" "r",  # o, d, geom, t, idx; n, s_cheap, s_total; faraway
    # o, d, geom, self_idx, lit; n, s_cheap, s_total; faraway; the light (3,) or null; skip
    "shadow_sweep": "ppppp" "iii" "r" "p" "i",
    "shadow_parts": "pppppp" "iii" "r" "p" "i",  # ... t_others, t_self; the rest as shadow_sweep
}


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    """Launch kernel ``name`` on the current stream and count it."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    (PARTS_LAUNCHES if name in PARTS_LAUNCHES else LAUNCHES)[name] += 1


def nearest_sweep(o, d, geom, *, faraway: float, s_cheap: int) -> NearestHit:
    """Nearest hit of rays ``o``/``d`` (N, 3) over the spheres ``geom`` (S,
    4), rows ``s_cheap..S`` in the compensated tier."""
    device = _check(o, d, geom, s_cheap)
    if device.type == "cpu":
        t, idx = nearest_sweep_plain(o, d, geom, faraway=faraway, s_cheap=s_cheap)
    else:
        n = o.shape[0]
        with torch.cuda.device(device):
            t = torch.empty((n,), dtype=o.dtype, device=device)
            idx = torch.empty((n,), dtype=torch.int32, device=device)
            _launch("nearest_sweep", o.dtype, o, d, geom, t, idx, n, s_cheap, geom.shape[0], float(faraway))
    return NearestHit(t=t, idx=idx, hit=t != faraway)


def _light(light, o):
    """The light point (3,) in the rays' dtype and on their device, or None."""
    if light is None:
        return None
    light = torch.as_tensor(light)
    if light.shape != (3,):
        raise ValueError(f"light: expected a point (3,), got shape {tuple(light.shape)}")
    return light.to(dtype=o.dtype, device=o.device).contiguous()


def shadow_sweep(o, d, geom, self_idx, *, faraway: float, s_cheap: int, light=None,
                 skip: str = "auto") -> torch.Tensor:
    """Hard shadow visibility (N,) of shadow rays ``o``/``d`` (N, 3) from
    each lane's own sphere ``self_idx`` (N,) int32.  ``light`` (3,), the
    point the rays aim at, tightens the skip's bound and nothing else (any
    value, or None, gives the same result); ``skip`` ("auto", "on", "off")
    picks the kernel with the warp-bundle sphere skip or without, the result
    the same bitwise."""
    code = _skip_code(skip)
    device = _check(o, d, geom, s_cheap, self_idx)
    light = _light(light, o)
    if device.type == "cpu":
        return shadow_sweep_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        lit = torch.empty((n,), dtype=o.dtype, device=device)
        _launch("shadow_sweep", o.dtype, o, d, geom, self_idx, lit, n, s_cheap, geom.shape[0], float(faraway),
                light, code)
    return lit


def shadow_parts(o, d, geom, self_idx, *, faraway: float, s_cheap: int, light=None,
                 skip: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """One sphere shard's hard-shadow partials ``(t_others, t_self)`` (N,) of
    shadow rays ``o``/``d`` (N, 3) from each lane's own sphere ``self_idx``
    (N,) int32, an index LOCAL to the shard ``geom`` (S, 4): out of range on
    a lane whose sphere another shard holds.  ``light`` and ``skip`` as
    :func:`shadow_sweep` takes them."""
    code = _skip_code(skip)
    device = _check(o, d, geom, s_cheap, self_idx)
    light = _light(light, o)
    if device.type == "cpu":
        return shadow_parts_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        t_others = torch.empty((n,), dtype=o.dtype, device=device)
        t_self = torch.empty((n,), dtype=o.dtype, device=device)
        _launch("shadow_parts", o.dtype, o, d, geom, self_idx, t_others, t_self, n, s_cheap, geom.shape[0],
                float(faraway), light, code)
    return t_others, t_self


def shadow_blocks_per_sm(dtype: torch.dtype, s: int, *, parts: bool, skip: bool) -> int:
    """Resident 256-thread blocks per SM of the shadow_sweep instantiation
    (``parts`` mode, ``skip``) at ``s`` spheres' shared memory, on the
    current card."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(_build.load_library(_SOURCE), f"prt_shadow_blocks_per_sm_{suffix}")(int(parts), int(skip), s)
