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
"""

from __future__ import annotations

import torch

from . import _build
from .intersect import NearestHit, intersect_two_tier, nearest_hit

LAUNCHES = {"nearest_sweep": 0, "shadow_sweep": 0}
# The shadow kernel's parts mode, counted apart as the atlas modes are.
PARTS_LAUNCHES = {"shadow_parts": 0}

_SOURCE = "intersect_fused.cu"

# The shadow sweep's sentinel per dtype, the JAX kernel's.
_BIG = {torch.float32: 3.0e38, torch.float64: 1.0e300}

# Ray-sphere pairs per chunk of the plain versions.
_CHUNK_PAIRS = 1 << 24


def _chunks(n: int, s: int):
    step = max(1, _CHUNK_PAIRS // max(s, 1))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _t_table(o, d, geom, faraway: float, s_cheap: int):
    """(N, S) hit distances of the kernels' two tiers."""
    return intersect_two_tier(o, d, geom[:, :3], geom[:, 3], faraway, geom.shape[0] - s_cheap).t


def nearest_sweep_plain(o, d, geom, *, faraway: float, s_cheap: int):
    """Plain version of ``nearest_sweep``: ``(t, idx)`` (N,), idx int32."""
    ts, idxs = [], []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        near = nearest_hit(_t_table(o[a:b], d[a:b], geom, faraway, s_cheap), faraway)
        ts.append(near.t)
        idxs.append(torch.where(near.hit, near.idx, 0))
    return torch.cat(ts), torch.cat(idxs)


def shadow_parts_plain(o, d, geom, self_idx, *, faraway: float, s_cheap: int):
    """Plain version of ``shadow_parts``: ``(t_others, t_self)`` (N,), the
    least hit distance along each shadow ray over the spheres other than the
    lane's own ``self_idx`` and that of its own sphere, both starting from
    the sentinel; an index outside ``0..S-1`` matches no sphere."""
    big = torch.tensor(_BIG[o.dtype], dtype=o.dtype, device=o.device)
    ids = torch.arange(geom.shape[0], dtype=torch.int32, device=o.device)[None, :]
    others, selfs = [], []
    for a, b in _chunks(o.shape[0], geom.shape[0]):
        t = _t_table(o[a:b], d[a:b], geom, faraway, s_cheap)
        is_self = ids == self_idx[a:b, None]
        others.append(torch.minimum(torch.amin(torch.where(is_self, big, t), dim=1), big))
        selfs.append(torch.minimum(torch.amin(torch.where(is_self, t, big), dim=1), big))
    return torch.cat(others), torch.cat(selfs)


def shadow_sweep_plain(o, d, geom, self_idx, *, faraway: float, s_cheap: int):
    """Plain version of ``shadow_sweep``: 1 where the lane's own sphere
    ``self_idx`` is nearest along its shadow ray (``t_self <= t_others``,
    both starting from the sentinel), else 0; (N,) in the rays' dtype."""
    t_others, t_self = shadow_parts_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap)
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
    "shadow_sweep": "ppppp" "iii" "r",  # o, d, geom, self_idx, lit; n, s_cheap, s_total; faraway
    "shadow_parts": "pppppp" "iii" "r",  # o, d, geom, self_idx, t_others, t_self; n, s_cheap, s_total; faraway
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


def shadow_sweep(o, d, geom, self_idx, *, faraway: float, s_cheap: int) -> torch.Tensor:
    """Hard shadow visibility (N,) of shadow rays ``o``/``d`` (N, 3) from
    each lane's own sphere ``self_idx`` (N,) int32."""
    device = _check(o, d, geom, s_cheap, self_idx)
    if device.type == "cpu":
        return shadow_sweep_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        lit = torch.empty((n,), dtype=o.dtype, device=device)
        _launch("shadow_sweep", o.dtype, o, d, geom, self_idx, lit, n, s_cheap, geom.shape[0], float(faraway))
    return lit


def shadow_parts(o, d, geom, self_idx, *, faraway: float, s_cheap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One sphere shard's hard-shadow partials ``(t_others, t_self)`` (N,) of
    shadow rays ``o``/``d`` (N, 3) from each lane's own sphere ``self_idx``
    (N,) int32, an index LOCAL to the shard ``geom`` (S, 4): out of range on
    a lane whose sphere another shard holds."""
    device = _check(o, d, geom, s_cheap, self_idx)
    if device.type == "cpu":
        return shadow_parts_plain(o, d, geom, self_idx, faraway=faraway, s_cheap=s_cheap)
    n = o.shape[0]
    with torch.cuda.device(device):
        t_others = torch.empty((n,), dtype=o.dtype, device=device)
        t_self = torch.empty((n,), dtype=o.dtype, device=device)
        _launch("shadow_parts", o.dtype, o, d, geom, self_idx, t_others, t_self, n, s_cheap, geom.shape[0],
                float(faraway))
    return t_others, t_self
