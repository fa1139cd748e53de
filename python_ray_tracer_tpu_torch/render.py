"""The renderer: ``render(scene, cfg) -> (H, W, 3)`` float image.

Port of the single-shard paths of :mod:`python_ray_tracer_tpu.render`, hard
and smooth visibility, with jittered supersampling and stochastic glossy
roughness on the JAX package's seed schedule (:mod:`.ops.rng`).  The
reference's unbounded mirror recursion is a fixed-depth loop carrying
``(origin, direction, throughput, alive, accum)``; every lane computes
every bounce and dead lanes are multiplied away.

Two routes, chosen as the JAX package chooses them:

* ``cfg.use_pallas`` -> the hand-written CUDA kernels (their plain torch
  versions on a CPU tensor).  Hard visibility (:func:`hard_route`):
  :func:`.ops.bounce_sub.trace_fused_sub` up to 64 spheres,
  :func:`.ops.culled.trace_fused_culled` for 96 and more with at most 8 in
  the exact tier, :func:`.ops.bounce_lane.trace_fused_lane` (one lane-layout
  bounce a launch, image texels sampled in the kernel) for the rest, and
  with a stochastic key above 64 spheres :func:`trace` with the standalone
  sweep kernels (:mod:`.ops.intersect_fused`), as with an image atlas of
  more than MAX_FUSED_TEXELS texels on a scene the sub and culled kernels
  do not take.  Smooth visibility
  (:func:`smooth_route`): :func:`.ops.culled_smooth.trace_culled_smooth`
  (the culled smooth kernels, one ``near_cs`` and one ``fwd_cs``/``bwd_cs``
  pair per bounce) where :func:`.ops.culled_smooth.cull_smooth_ok` holds,
  else :func:`.ops.bounce_smooth_sub.trace_fused_smooth_sub`: up to 4096
  spheres the depth-fused smooth pair (the one-bounce pair at depth 1),
  above that the one-bounce pair once per bounce, each a
  ``torch.autograd.Function``; a stochastic key or an image atlas above
  4096 spheres takes :func:`trace`, as the JAX package takes its XLA path
  there.  Every kernel route samples image atlases in the kernels' atlas
  mode: the kernels write flat texel ids and weights, and the route adds
  the texels outside them (:func:`.ops.texture.compose_texels`); the lane
  kernel reads its texels itself;
* otherwise :func:`trace`, the pure-torch bounce loop that mirrors the JAX
  XLA path term for term.  Torch autograd through it is the oracle for the
  kernels' handwritten adjoints.  So do ``cfg.ray_chunk`` (the frame traced
  tile by tile through :func:`trace`, which still sweeps hard tiles through
  the sweep kernels and sends smooth ones down the smooth kernel routes)
  and, on hard visibility, ``cfg.tie_mode="sum"`` (both tied winners
  shaded), as in the JAX package.

:func:`l2_loss_fused` is the L2 training loss as one ``train_deep``
launch, where :func:`fused_train_l2_ok` allows it.  The one option of the
JAX renderer this port refuses is ``pallas_interpret``: a CUDA kernel has
no interpret mode.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from .camera import ray_directions, ray_directions_t
from .config import VISIBILITY_SMOOTH, RenderConfig
from .ops.intersect import (
    IntersectResult,
    NearestHit,
    intersect_all,
    intersect_all_plain,
    intersect_all_stable,
    intersect_two_tier,
    nearest_hit,
)
from .ops.bounce_smooth_sub import MAX_TRAIN_DEPTH, fused_train_l2, trace_fused_smooth_sub
from .ops.bounce_lane import trace_fused_lane
from .ops.bounce_sub import MAX_SUB_SPHERES, trace_fused_sub
from .ops.texture import MAX_FUSED_TEXELS
from .ops.culled import MAX_CULL_DEPTH, MAX_CULL_EXACT, MIN_CULL_SPHERES, trace_fused_culled
from .ops.culled_smooth import MAX_BLK_SPHERES_SMOOTH, cull_smooth_ok, trace_culled_smooth
from .ops.intersect_fused import nearest_sweep, shadow_parts, shadow_sweep
from .ops.shading import NUDGE, gather_material, shade
from .ops.smooth_parts import SmoothParts, smooth_clear_parts, smooth_nearest_parts
from .ops.rng import bounce_xi, fold_seed, seed_root, uniform2
from .ops.tables import geometry_table
from .ops.vecmath import ggx_perturb_reflect, normalize, reflect
from .parallel import collectives
from .scene import Scene


def auto_max_depth(
    scene: Scene,
    quantum: float = 1.0 / 510.0,
    color_bound: float = 2.0,
    cap: int = 64,
) -> int:
    """Depth at which truncating the reference's unbounded recursion is
    invisible at uint8 precision.

    Each bounce attenuates by ``0.5 * specular_gain * in_light``; with
    ``g = 0.5 * max(specular_gain)`` everything from depth D on contributes
    at most ``color_bound * g^D / (1 - g)`` per channel, so D is the
    smallest depth putting that under half a uint8 quantum.
    """
    g = 0.5 * float(torch.max(scene.spheres.specular_gain))
    if g <= 0.0:
        return 1
    if g >= 1.0:
        return cap
    d = math.log(0.5 * quantum * (1.0 - g) / color_bound, g)
    return max(1, min(cap, math.ceil(d)))


def _sweep(
    origin: torch.Tensor,
    direction: torch.Tensor,
    scene: Scene,
    cfg: RenderConfig,
) -> IntersectResult:
    sp = scene.spheres
    if not cfg.stable_intersect:
        return intersect_all(origin, direction, sp.center, sp.radius, cfg.faraway)
    return intersect_two_tier(origin, direction, sp.center, sp.radius, cfg.faraway, sp.n_exact)


def _shadow_hard(res: IntersectResult, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Lit iff the lane's own sphere is the nearest hit along the light ray,
    evaluated as ``t_self <= min(others)``."""
    s = res.t.shape[1]
    is_self = torch.arange(s, dtype=torch.int32, device=idx.device)[None, :] == idx[:, None]
    tmin_others = torch.amin(torch.where(is_self, torch.full_like(res.t, math.inf), res.t), dim=1)
    t_self = torch.gather(res.t, 1, idx.long()[:, None])[:, 0]
    return (t_self <= tmin_others).to(dtype)


def _soft_cover(sol: torch.Tensor, disc: torch.Tensor, sharpness: float) -> torch.Tensor:
    """Soft "this quadratic has a positive root": ``sig(k disc) * sig(k sol)``."""
    return torch.sigmoid(sharpness * disc) * torch.sigmoid(sharpness * sol)


def _shadow_smooth(res: IntersectResult, idx: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Smooth shadow: product over *other* spheres of (1 - soft occlusion)."""
    occl = _soft_cover(res.sol, res.disc, cfg.shadow_sharpness)  # (N, S)
    s = res.t.shape[1]
    not_self = torch.arange(s, dtype=torch.int32, device=idx.device)[None, :] != idx[:, None]
    return torch.prod(torch.where(not_self, 1.0 - occl, torch.ones_like(occl)), dim=1)


def _smooth_winner_idx(res: IntersectResult, near) -> torch.Tensor:
    """Hit lanes keep the nearest sphere; miss lanes attribute coverage (and
    its gradient) to the sphere whose discriminant came closest to zero."""
    fidx = torch.argmax(res.disc.detach(), dim=1).to(torch.int32)  # selector only
    return torch.where(near.hit, near.idx, fidx)


def _coverage_at(res: IntersectResult, idx: torch.Tensor, sharpness: float) -> torch.Tensor:
    """Soft coverage of each lane's winning sphere."""
    cover_all = _soft_cover(res.sol, res.disc, sharpness)
    return torch.gather(cover_all, 1, idx.long()[:, None])[:, 0]


def bounce(
    o: torch.Tensor,  # (N, 3)
    d: torch.Tensor,  # (N, 3) unit
    throughput: torch.Tensor,  # (N,)
    alive: torch.Tensor,  # (N,)
    accum: torch.Tensor,  # (N, 3)
    scene: Scene,
    cfg: RenderConfig,
    xi: torch.Tensor | None = None,  # (N, 2) uniforms: GGX-sampled continuation
) -> tuple[torch.Tensor, ...]:
    """One bounce of :func:`trace`: returns the next ``(o, d, throughput,
    alive, accum)``.

    Misses contribute black; ``to_camera`` always points at the ORIGINAL
    camera (reference quirk kept).  Smooth visibility relaxes coverage and
    shadow with sigmoids, and the next ``alive`` is the coverage itself.
    With ``xi`` the continuation reflects about a GGX-sampled microfacet
    (stochastic glossy roughness) instead of the mirror normal.  Hard
    visibility with ``cfg.use_pallas`` sweeps through the ``nearest_sweep``
    and ``shadow_sweep`` kernels, the JAX ``trace``'s fused branch; hard
    visibility with ``cfg.tie_mode="sum"`` also shades each lane's second
    tied winner (:func:`_add_tied_winner`).
    """
    smooth = cfg.visibility == VISIBILITY_SMOOTH
    dtype = cfg.dtype
    if _sweep_kernels(cfg):
        geom = geometry_table(scene, dtype)
        sweep_kw = dict(faraway=cfg.faraway, s_cheap=scene.spheres.count - scene.spheres.n_exact)
        near = nearest_sweep(o.contiguous(), d.contiguous(), geom, **sweep_kw)
    else:
        res = _sweep(o, d, scene, cfg)
        near = nearest_hit(res.t, cfg.faraway)
    hit = near.hit.to(dtype)
    if smooth:
        idx = _smooth_winner_idx(res, near)
        coverage = _coverage_at(res, idx, cfg.edge_sharpness) * alive
    else:
        idx = near.idx
        coverage = hit * alive

    mat, p, normal, to_light, to_camera, p_nudged = _hit_frame(o, d, near, idx, scene, dtype)

    if _sweep_kernels(cfg):
        in_light = shadow_sweep(p_nudged.contiguous(), to_light.contiguous(), geom, idx,
                                light=scene.lights.point_position, **sweep_kw)
    elif smooth:
        in_light = _shadow_smooth(_sweep(p_nudged, to_light, scene, cfg), idx, cfg)
    else:
        in_light = _shadow_hard(_sweep(p_nudged, to_light, scene, cfg), idx, dtype)
    local = shade(p, normal, to_light, to_camera, in_light, mat, scene)

    accum = accum + local.color * (throughput * coverage)[:, None]
    if cfg.tie_mode == "sum" and not smooth:
        accum = _add_tied_winner(accum, res, near, idx, p, d, to_light, to_camera, throughput * coverage, scene, cfg)
    return p_nudged, *_advance(d, normal, mat, local, throughput, coverage, alive, hit, smooth, xi), accum


def _hit_frame(o, d, near: NearestHit, idx, scene: Scene, dtype: torch.dtype):
    """The winner's material and the hit's frame: ``(mat, p, normal,
    to_light, to_camera, p_nudged)``.  A miss lane's ``t`` reads 1 so dead
    lanes stay finite; ``to_camera`` points at the ORIGINAL camera on every
    bounce (reference quirk kept)."""
    t_safe = torch.where(near.hit, near.t, torch.ones_like(near.t))
    mat = gather_material(scene.spheres, idx)
    p = o + d * t_safe[:, None]
    normal = (p - mat.center) * (1.0 / mat.radius)[:, None]
    to_light = normalize(scene.lights.point_position.to(dtype)[None, :] - p)
    to_camera = normalize(scene.camera.position.to(dtype)[None, :] - p)
    return mat, p, normal, to_light, to_camera, p + normal * NUDGE


def _advance(d, normal, mat, local, throughput, coverage, alive, hit, smooth: bool, xi):
    """The next ``(d, throughput, alive)``: the mirror continuation, or with
    ``xi`` the GGX-sampled one; smooth visibility's ``alive`` is the coverage."""
    throughput = throughput * coverage * local.refl_coeff
    alive = coverage if smooth else alive * hit
    if xi is None:
        d_next = reflect(d, normal)
    else:
        d_next = ggx_perturb_reflect(d, normal, mat.specular_roughness, xi)
    return d_next, throughput, alive


def _add_tied_winner(accum, res: IntersectResult, near, idx, p, d, to_light, to_camera, weight, scene: Scene,
                     cfg: RenderConfig) -> torch.Tensor:
    """The JAX ``trace``'s tie_sum branch: shade each hit lane's second tied
    winner too, as the reference shades every sphere at the minimum distance
    and sums.  The second winner is the HIGHEST index whose ``t`` equals the
    winning ``t`` bitwise (2-way ties); it is shaded with its own normal and
    shadow sweep and weighted by ``weight`` (throughput x coverage).  With
    depth > 1 its mirror continuation runs as a nested depth - 1 trace
    (``tie_mode="first"``, no kernels, no key), scaled by its weight times
    its reflection coefficient.  The main continuation stays with the
    lowest-index winner."""
    dtype = cfg.dtype
    ids = torch.arange(res.t.shape[1], dtype=torch.int32, device=idx.device)[None, :]
    idx2 = torch.amax(torch.where(res.t == near.t[:, None], ids, -1), dim=1)
    has2 = near.hit & (idx2 != idx)
    idx2 = torch.where(has2, idx2, idx)
    mat2 = gather_material(scene.spheres, idx2)
    normal2 = (p - mat2.center) * (1.0 / mat2.radius)[:, None]
    p_nudged2 = p + normal2 * NUDGE
    in_light2 = _shadow_hard(_sweep(p_nudged2, to_light, scene, cfg), idx2, dtype)
    local2 = shade(p, normal2, to_light, to_camera, in_light2, mat2, scene)
    w2 = weight * has2.to(dtype)
    accum = accum + local2.color * w2[:, None]
    if cfg.max_depth > 1:
        sub_cfg = dataclasses.replace(cfg, max_depth=cfg.max_depth - 1, tie_mode="first", use_pallas=False)
        cont2 = trace(p_nudged2, reflect(d, normal2), scene, sub_cfg)
        accum = accum + cont2 * (w2 * local2.refl_coeff)[:, None]
    return accum


def _sweep_kernels(cfg: RenderConfig) -> bool:
    """Does ``trace`` sweep through the kernels (the JAX ``fused`` branch)?"""
    return cfg.use_pallas and cfg.visibility != VISIBILITY_SMOOTH and cfg.tie_mode == "first"


def culled_ok(scene: Scene, cfg: RenderConfig) -> bool:
    """Scope of the culled hard kernels, as the JAX renderer gates them."""
    return (
        scene.spheres.count >= MIN_CULL_SPHERES
        and scene.spheres.n_exact <= MAX_CULL_EXACT
        and cfg.max_depth <= MAX_CULL_DEPTH
    )


def trace(
    origin: torch.Tensor,  # (N, 3) or (3,)
    direction: torch.Tensor,  # (N, 3) unit
    scene: Scene,
    cfg: RenderConfig,
    key=None,
    *,
    ray_offset: int = 0,
    sweep_center: torch.Tensor | None = None,  # (S_local, 3) this rank's sphere shard
    sweep_radius: torch.Tensor | None = None,  # (S_local,)
    sphere_axis=None,  # the mesh's sphere Axis the sweep is sharded over
    sphere_offset: int = 0,  # global index of sweep row 0
) -> torch.Tensor:
    """Trace N rays to ``cfg.max_depth`` bounces; returns (N, 3) color.

    With ``cfg.stochastic_roughness`` and a seed ``key``, each bounce takes
    its xi on the JAX package's schedule (:func:`.ops.rng.bounce_xi`), the
    lanes' draws from global ray index ``ray_offset`` on, so a chunk of a
    frame draws what the whole frame's draw has there.  As in the JAX
    ``trace``, ``cfg.use_pallas`` sends hard visibility with no key and no
    ``ray_chunk`` to the culled kernels where :func:`culled_ok` holds, and
    smooth visibility with no key to the smooth kernel routes
    (:func:`smooth_route` judged on these N rays) unless that route is
    ``"pure"``.  ``cfg.remat`` recomputes each bounce of the loop below in
    the backward pass (``torch.utils.checkpoint``); the kernel routes have
    their own backward passes and ignore it, as the JAX package's do.

    With ``sphere_axis`` (a :class:`.parallel.mesh.Axis`, inside
    :func:`.parallel.sharded.trace_sharded`) the sweeps cover only this
    rank's shard ``sweep_center``/``sweep_radius`` of the sphere table, rows
    ``sphere_offset`` on (the whole table by default), and every reduction
    over spheres finishes with a collective along the axis
    (:func:`_bounce_sphere_sharded`); shading reads the whole replicated
    ``scene``.
    """
    if sphere_axis is not None:
        center = scene.spheres.center if sweep_center is None else sweep_center
        radius = scene.spheres.radius if sweep_radius is None else sweep_radius
        return _trace_sphere_sharded(origin, direction, scene, cfg, key, ray_offset,
                                     _SphereShard(center, radius, sphere_axis, sphere_offset))
    if sweep_center is not None or sweep_radius is not None:
        raise ValueError("sweep_center and sweep_radius are a sphere shard: pass them with sphere_axis")
    dtype = cfg.dtype
    if _sweep_kernels(cfg) and key is None and not cfg.ray_chunk and culled_ok(scene, cfg):
        return trace_fused_culled(origin.expand(direction.shape).T, direction.T, scene, cfg)
    if cfg.use_pallas and cfg.visibility == VISIBILITY_SMOOTH and key is None:
        route = smooth_route(scene, cfg, direction.shape[0], None)
        if route != "pure":
            return _smooth_kernels(route, origin.to(dtype).expand(direction.shape).T, direction.T, scene, cfg, None)
    direction = direction.to(dtype)
    n = direction.shape[0]
    o = origin.to(dtype).expand(direction.shape)
    d = direction
    throughput = torch.ones((n,), dtype=dtype, device=d.device)
    alive = torch.ones((n,), dtype=dtype, device=d.device)
    accum = torch.zeros((n, 3), dtype=dtype, device=d.device)
    xis = [None] * cfg.max_depth
    if cfg.stochastic_roughness and key is not None:
        xis = [xi.T for xi in bounce_xi(key, n, cfg.max_depth, dtype, d.device, offset=ray_offset)]
    for xi in xis:
        state = (o, d, throughput, alive, accum, scene, cfg, xi)
        if cfg.remat:
            o, d, throughput, alive, accum = torch.utils.checkpoint.checkpoint(bounce, *state, use_reentrant=False)
        else:
            o, d, throughput, alive, accum = bounce(*state)
    return accum


# ---------------------------------------------------------------------------
# Sphere-sharded tracing: each rank sweeps its shard of the sphere table and
# the reductions over spheres finish with collectives along the sphere axis
# (the JAX trace's sphere_axis branches).  Selectors (the winning index, the
# shadow comparison) run on detached values; the values they pick come
# through owner-masked sums, so gradients reach exactly the owning shard
# (.parallel.collectives says how the backward counts).
# ---------------------------------------------------------------------------

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class _SphereShard:
    center: torch.Tensor  # (S_local, 3)
    radius: torch.Tensor  # (S_local,)
    axis: object  # parallel.mesh.Axis
    offset: int  # global index of row 0

    def gidx(self) -> torch.Tensor:
        """(1, S_local) global sphere indices of the shard's rows."""
        return (torch.arange(self.center.shape[0], device=self.center.device) + self.offset).to(torch.int32)[None, :]

    def geom(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.cat([self.center.to(dtype), self.radius.to(dtype)[:, None]], dim=1)


def _sweep_shard(o, d, shard: _SphereShard, scene: Scene, cfg: RenderConfig) -> IntersectResult:
    """The JAX ``_sweep`` on a sphere shard: the shard's rows each in the
    tier of their GLOBAL index (``exact_mask``, when the exact tier cuts
    strictly inside the table), so every row gets the formula it gets on one
    device."""
    c, r = shard.center, shard.radius
    if not cfg.stable_intersect:
        return intersect_all(o, d, c, r, cfg.faraway)
    n_ex, s_glob = scene.spheres.n_exact, scene.spheres.count
    if 0 < n_ex < s_glob:
        a = intersect_all_plain(o, d, c, r, cfg.faraway)
        b = intersect_all_stable(o, d, c, r, cfg.faraway)
        m = shard.gidx() >= s_glob - n_ex
        return IntersectResult(*(torch.where(m, y, x) for x, y in zip(a, b)))
    return intersect_two_tier(o, d, c, r, cfg.faraway, n_ex)


def _self_lookup(table, idx, shard: _SphereShard, fill: float):
    """Each lane's value of its own (global) sphere ``idx`` from the shard's
    (N, S_local) ``table`` as a one-hot masked sum, and whether this shard
    owns it; ``fill`` where it does not."""
    onehot = shard.gidx() == idx[:, None]
    val = torch.sum(torch.where(onehot, table, torch.zeros_like(table)), dim=1)
    owns = torch.any(onehot, dim=1)
    return torch.where(owns, val, torch.full_like(val, fill)), owns


def _combine_nearest_reduced(t_l, idx_l, faraway: float, axis) -> NearestHit:
    """Nearest hit across the shards from each shard's ``(t, global idx)``:
    the least ``t`` wins, the lowest global index on a tie (a miss resolves
    to index 0); the winning ``t`` is the owner's, summed from it."""
    t_sg = t_l.detach()
    tmin_sel = collectives.pmin(t_sg, axis)
    idx = collectives.pmin(torch.where(t_sg == tmin_sel, idx_l, _INT32_MAX), axis)
    tmin = collectives.psum_owner(torch.where(idx_l == idx, t_l, torch.zeros_like(t_l)), axis)
    return NearestHit(t=tmin, idx=idx, hit=tmin != faraway)


def _combine_nearest(t_table, faraway: float, shard: _SphereShard) -> NearestHit:
    """:func:`_combine_nearest_reduced` from the shard's (N, S_local) table."""
    t_sg = t_table.detach()
    tmin_l, arg = torch.min(t_sg, dim=1)
    idx_l = arg.to(torch.int32) + shard.offset
    tmin_sel = collectives.pmin(tmin_l, shard.axis)
    idx = collectives.pmin(torch.where(tmin_l == tmin_sel, idx_l, _INT32_MAX), shard.axis)
    t_val, _ = _self_lookup(t_table, idx, shard, 0.0)
    tmin = collectives.psum_owner(t_val, shard.axis)
    return NearestHit(t=tmin, idx=idx, hit=tmin != faraway)


def _fallback_idx(dmax_l, fidx_l, axis) -> torch.Tensor:
    """Global index of the largest discriminant over the shards (the lowest
    index among equal maxima)."""
    dmax = collectives.pmax(dmax_l, axis)
    return collectives.pmin(torch.where(dmax_l == dmax, fidx_l, _INT32_MAX), axis)


def _shadow_hard_sharded(res: IntersectResult, idx, shard: _SphereShard, dtype) -> torch.Tensor:
    """Hard shadow over the shards: ``t_self <= min(others)``, each side the
    least over the shards (a step function: no gradient)."""
    is_self = shard.gidx() == idx[:, None]
    t_others = torch.amin(torch.where(is_self, torch.full_like(res.t, math.inf), res.t), dim=1)
    t_self, _ = _self_lookup(res.t, idx, shard, math.inf)
    t_others = collectives.pmin(t_others, shard.axis)
    t_self = collectives.pmin(t_self, shard.axis)
    return (t_self <= t_others).to(dtype)


def _shadow_smooth_sharded(res: IntersectResult, idx, shard: _SphereShard, cfg: RenderConfig) -> torch.Tensor:
    """Smooth shadow: each shard's product over its spheres other than the
    lane's own, multiplied over the shards."""
    occl = _soft_cover(res.sol, res.disc, cfg.shadow_sharpness)
    not_self = shard.gidx() != idx[:, None]
    clear = torch.prod(torch.where(not_self, 1.0 - occl, torch.ones_like(occl)), dim=1)
    return collectives.gather_prod(clear, shard.axis)


def _winner_cover_parts(parts: SmoothParts, near: NearestHit, shard: _SphereShard, sharpness: float):
    """Winner index and soft coverage from the shards' :class:`SmoothParts`:
    the fallback winner by the largest discriminant, the winner's ``(sol,
    disc)`` summed from its owner, the sigmoids taken after the sum."""
    gidx_l = parts.idx + shard.offset
    gfidx_l = parts.fidx + shard.offset
    fidx = _fallback_idx(parts.dmax.detach(), gfidx_l, shard.axis)
    idx = torch.where(near.hit, near.idx, fidx)
    zero = torch.zeros_like(parts.sol_w)
    own_hit = gidx_l == idx
    own_f = gfidx_l == idx
    sol = torch.where(near.hit, torch.where(own_hit, parts.sol_w, zero), torch.where(own_f, parts.sol_f, zero))
    disc = torch.where(near.hit, torch.where(own_hit, parts.disc_w, zero), torch.where(own_f, parts.dmax, zero))
    sol = collectives.psum_owner(sol, shard.axis)
    disc = collectives.psum_owner(disc, shard.axis)
    return idx, _soft_cover(sol, disc, sharpness)


def _bounce_sphere_sharded(o, d, throughput, alive, accum, scene: Scene, cfg: RenderConfig, shard: _SphereShard,
                           xi: torch.Tensor | None = None):
    """One bounce of the JAX ``trace`` with a sphere axis: returns the next
    ``(o, d, throughput, alive, accum)``, equal on every rank of the axis.

    ``cfg.use_pallas`` sweeps each shard through the kernels: hard
    visibility (``tie_mode="first"``) with ``nearest_sweep`` and
    ``shadow_parts``, smooth visibility with ``smooth_nearest_parts`` and
    ``clear_fwd``/``clear_bwd``; each shard takes its last ``min(n_exact,
    S_local)`` rows as its exact tier, as the JAX kernels clamp it.  Else the
    shard's (N, S_local) tables (:func:`_sweep_shard`) and the collective
    forms of the single-device helpers; hard ``tie_mode="sum"`` shades each
    lane's second tied winner too (the highest tied global index over the
    shards) and continues it with a nested sharded trace.
    """
    smooth = cfg.visibility == VISIBILITY_SMOOTH
    dtype = cfg.dtype
    axis, offset = shard.axis, shard.offset
    fused = cfg.use_pallas and not smooth and cfg.tie_mode == "first"
    parts_route = cfg.use_pallas and smooth
    tie_sum = cfg.tie_mode == "sum" and not smooth and not fused
    s_local = shard.center.shape[0]
    kw = dict(faraway=cfg.faraway, s_cheap=s_local - min(scene.spheres.n_exact, s_local))
    if fused or parts_route:
        geom = shard.geom(dtype)
    if fused:
        near_l = nearest_sweep(o.contiguous(), d.contiguous(), geom.contiguous(), **kw)
        near = _combine_nearest_reduced(near_l.t, near_l.idx + offset, cfg.faraway, axis)
    elif parts_route:
        parts = smooth_nearest_parts(collectives.vary(o, axis), collectives.vary(d, axis), geom, **kw)
        near = _combine_nearest_reduced(parts.t, parts.idx + offset, cfg.faraway, axis)
    else:
        res = _sweep_shard(collectives.vary(o, axis), collectives.vary(d, axis), shard, scene, cfg)
        near = _combine_nearest(res.t, cfg.faraway, shard)
    hit = near.hit.to(dtype)
    if smooth and parts_route:
        idx, cover = _winner_cover_parts(parts, near, shard, cfg.edge_sharpness)
        coverage = cover * alive
    elif smooth:
        dmax_l, arg = torch.max(res.disc.detach(), dim=1)
        idx = torch.where(near.hit, near.idx, _fallback_idx(dmax_l, arg.to(torch.int32) + offset, axis))
        cover, _ = _self_lookup(_soft_cover(res.sol, res.disc, cfg.edge_sharpness), idx, shard, 0.0)
        coverage = collectives.psum_owner(cover, axis) * alive
    else:
        idx = near.idx
        coverage = hit * alive

    mat, p, normal, to_light, to_camera, p_nudged = _hit_frame(o, d, near, idx, scene, dtype)

    if fused:
        t_others, t_self = shadow_parts(p_nudged.contiguous(), to_light.contiguous(), geom.contiguous(),
                                        (idx - offset).to(torch.int32), light=scene.lights.point_position, **kw)
        in_light = (collectives.pmin(t_self, axis) <= collectives.pmin(t_others, axis)).to(dtype)
    elif parts_route:
        clear_l = smooth_clear_parts(collectives.vary(p_nudged, axis), collectives.vary(to_light, axis), geom,
                                     (idx - offset).to(torch.int32), sharpness=cfg.shadow_sharpness,
                                     light=scene.lights.point_position, **kw)
        in_light = collectives.gather_prod(clear_l, axis).to(dtype)
    else:
        shadow_res = _sweep_shard(collectives.vary(p_nudged, axis), collectives.vary(to_light, axis), shard, scene,
                                  cfg)
        if smooth:
            in_light = _shadow_smooth_sharded(shadow_res, idx, shard, cfg).to(dtype)
        else:
            in_light = _shadow_hard_sharded(shadow_res, idx, shard, dtype)
    local = shade(p, normal, to_light, to_camera, in_light, mat, scene)

    accum = accum + local.color * (throughput * coverage)[:, None]
    if tie_sum:
        tied = res.t == near.t[:, None]
        idx2 = collectives.pmax(torch.amax(torch.where(tied, shard.gidx(), -1), dim=1), axis)
        has2 = near.hit & (idx2 != idx)
        idx2 = torch.where(has2, idx2, idx)
        mat2 = gather_material(scene.spheres, idx2)
        normal2 = (p - mat2.center) * (1.0 / mat2.radius)[:, None]
        p_nudged2 = p + normal2 * NUDGE
        shadow_res2 = _sweep_shard(collectives.vary(p_nudged2, axis), collectives.vary(to_light, axis), shard,
                                   scene, cfg)
        in_light2 = _shadow_hard_sharded(shadow_res2, idx2, shard, dtype)
        local2 = shade(p, normal2, to_light, to_camera, in_light2, mat2, scene)
        w2 = throughput * coverage * has2.to(dtype)
        accum = accum + local2.color * w2[:, None]
        if cfg.max_depth > 1:
            sub_cfg = dataclasses.replace(cfg, max_depth=cfg.max_depth - 1, tie_mode="first", use_pallas=False)
            cont2 = _trace_sphere_sharded(p_nudged2, reflect(d, normal2), scene, sub_cfg, None, 0, shard)
            accum = accum + cont2 * (w2 * local2.refl_coeff)[:, None]
    return p_nudged, *_advance(d, normal, mat, local, throughput, coverage, alive, hit, smooth, xi), accum


def _trace_sphere_sharded(origin, direction, scene: Scene, cfg: RenderConfig, key, ray_offset: int,
                          shard: _SphereShard) -> torch.Tensor:
    """:func:`trace`'s loop with :func:`_bounce_sphere_sharded`."""
    dtype = cfg.dtype
    d = direction.to(dtype)
    n = d.shape[0]
    o = origin.to(dtype).expand(d.shape)
    throughput = torch.ones((n,), dtype=dtype, device=d.device)
    alive = torch.ones((n,), dtype=dtype, device=d.device)
    accum = torch.zeros((n, 3), dtype=dtype, device=d.device)
    xis = [None] * cfg.max_depth
    if cfg.stochastic_roughness and key is not None:
        xis = [xi.T for xi in bounce_xi(key, n, cfg.max_depth, dtype, d.device, offset=ray_offset)]
    for xi in xis:
        state = (o, d, throughput, alive, accum, scene, cfg, shard, xi)
        if cfg.remat:
            o, d, throughput, alive, accum = torch.utils.checkpoint.checkpoint(
                _bounce_sphere_sharded, *state, use_reentrant=False
            )
        else:
            o, d, throughput, alive, accum = _bounce_sphere_sharded(*state)
    return accum


def _check_scope(scene: Scene, cfg: RenderConfig) -> None:
    """Refuse the one option of the JAX renderer the port has no counterpart
    for: interpret mode."""
    if cfg.pallas_interpret:
        raise NotImplementedError(
            "not ported: interpret mode (a CUDA kernel has none; pallas_interpret of python_ray_tracer_tpu "
            "has no counterpart)"
        )


def smooth_route(scene: Scene, cfg: RenderConfig, n_rays: int, key) -> str:
    """The kernels a smooth frame with ``cfg.use_pallas`` takes, as the JAX
    ``render._render_sample`` and ``_trace_smooth_fused`` pick them:
    ``"culled"`` (:func:`.ops.culled_smooth.cull_smooth_ok`), ``"sub"`` (the
    depth-fused pair, or the one-bounce pair at depth 1: up to
    MAX_BLK_SPHERES_SMOOTH spheres, JAX's sublane kernels), ``"step"`` (the
    one-bounce pair once per bounce: more spheres and no key, JAX's lane
    kernels) or ``"pure"`` (:func:`trace`: more spheres with a stochastic
    key or an image atlas, which the JAX package sends down its XLA path)."""
    big = scene.spheres.count > MAX_BLK_SPHERES_SMOOTH
    if big and (key is not None or scene.has_atlas):
        return "pure"
    if cull_smooth_ok(scene, cfg, n_rays):
        return "culled"
    return "step" if big else "sub"


def hard_route(scene: Scene, cfg: RenderConfig, key) -> str:
    """The kernels a hard frame with ``cfg.use_pallas`` takes, as the JAX
    ``render._render_sample`` picks them: ``"sub"`` (``trace_deep`` or
    ``bounce_step``, up to 64 spheres), ``"culled"`` (the culled pair, 96 and
    more spheres with at most 8 in the exact tier, no key), ``"lane"``
    (``bounce_lane`` once a bounce: the rest without a key, with an image
    atlas of at most MAX_FUSED_TEXELS texels) or ``"sweeps"`` (``trace`` with
    ``nearest_sweep``/``shadow_sweep`` and the pure-torch shading: a key
    above 64 spheres, or a bigger atlas on a scene the lane kernel would
    take, which the JAX package sends down its XLA path).
    """
    s = scene.spheres.count
    if key is not None and s > MAX_SUB_SPHERES:
        return "sweeps"
    if key is None and culled_ok(scene, cfg):
        return "culled"
    if s <= MAX_SUB_SPHERES:
        return "sub"
    if scene.has_atlas and scene.texture_atlas[..., 0].numel() > MAX_FUSED_TEXELS:
        return "sweeps"
    return "lane"


def _smooth_kernels(route: str, origin, dirs_t, scene: Scene, cfg: RenderConfig, key) -> torch.Tensor:
    """The smooth kernel route ``route`` of :func:`smooth_route` (not
    ``"pure"``) on the rays ``dirs_t`` (3, N): (N, 3) colors."""
    if route == "culled":
        return trace_culled_smooth(origin, dirs_t, scene, cfg, key=key)
    if route == "step":
        return trace_fused_smooth_sub(origin, dirs_t, scene, cfg, route="step")
    return trace_fused_smooth_sub(origin, dirs_t, scene, cfg, key=key)


def _render_sample(scene: Scene, cfg: RenderConfig, jitter: torch.Tensor | None, key) -> torch.Tensor:
    """One (optionally jittered) sample per pixel -> flat (H*W, 3) colors;
    ``key`` seeds the stochastic continuation (None: mirror).

    The kernel routes take the whole frame where the JAX package's
    ``_can_fuse_bounce`` lets them: ``cfg.use_pallas``, no ``ray_chunk``,
    and on hard visibility ``tie_mode="first"``.  Everything else goes
    through :func:`trace`: with ``cfg.ray_chunk`` below the frame's ray
    count, tile by tile (the last tile padded with copies of ray 0); a
    stochastic key gives tile ``i`` the key ``fold_seed(key, i)``, its lanes
    drawing from offset 0, the JAX package's ``lax.map`` schedule.
    """
    smooth = cfg.visibility == VISIBILITY_SMOOTH
    pos = scene.camera.position
    if cfg.use_pallas and not cfg.ray_chunk and (smooth or cfg.tie_mode == "first"):
        if smooth:
            route = smooth_route(scene, cfg, scene.camera.width * scene.camera.height, key)
        else:
            route = hard_route(scene, cfg, key)
        if route not in ("pure", "sweeps"):
            dirs_t = ray_directions_t(scene.camera, cfg.dtype, None if jitter is None else jitter.T)
            if smooth:
                return _smooth_kernels(route, pos, dirs_t, scene, cfg, key)
            if route == "culled":
                return trace_fused_culled(pos, dirs_t, scene, cfg)
            if route == "lane":
                return trace_fused_lane(pos, dirs_t, scene, cfg)
            return trace_fused_sub(pos, dirs_t, scene, cfg, key=key)
    dirs = ray_directions(scene.camera, cfg.dtype, jitter)
    n, chunk = dirs.shape[0], cfg.ray_chunk
    if not chunk or n <= chunk:
        return trace(pos, dirs, scene, cfg, key=key)
    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        dirs = torch.cat([dirs, dirs[:1].expand(n_pad - n, 3)])
    tiles = [
        trace(pos, dirs[a : a + chunk], scene, cfg, key=None if key is None else fold_seed(key, i))
        for i, a in enumerate(range(0, n_pad, chunk))
    ]
    return torch.cat(tiles)[:n]


def fused_train_l2_ok(scene: Scene, cfg: RenderConfig) -> bool:
    """Is the single-launch train kernel applicable?

    Scope of :func:`l2_loss_fused`: smooth visibility through the kernels,
    one center ray per pixel, no atlas (``train_deep`` has no atlas mode, as
    the JAX train kernel has none), depth 2 and up (depth 1 is the JAX
    package's scan route), up to MAX_BLK_SPHERES_SMOOTH (4096) spheres, and
    not a scene the JAX package would send down its culled route.  The JAX
    package caps its train kernel at MAX_FUSED_TRAIN_SPHERES = 2048, a VMEM
    limit of the whole chain in one TPU kernel, and sends 2049-4096 spheres
    through its blocked two-launch pair; ``train_deep`` has no such limit
    (its table gradients take memory bounded in N), so the port keeps it up
    to 4096, the edge of the JAX sublane kernels.  Past that the JAX package
    has no fused kernel (its lane pair runs once per bounce), and the port
    takes the one-bounce pair through :func:`render`.
    """
    n_rays = scene.camera.width * scene.camera.height
    return (
        cfg.use_pallas
        and cfg.visibility == VISIBILITY_SMOOTH
        and 2 <= cfg.max_depth <= MAX_TRAIN_DEPTH
        and cfg.samples_per_pixel == 1
        and not scene.has_atlas
        and scene.spheres.count <= MAX_BLK_SPHERES_SMOOTH
        and not cfg.ray_chunk
        and not cull_smooth_ok(scene, cfg, n_rays)
    )


def l2_loss_fused(scene: Scene, target: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """``l2_image_loss(render(scene, cfg), target)`` as one ``train_deep``
    launch.  Callers gate on :func:`fused_train_l2_ok`."""
    _check_scope(scene, cfg)
    dirs_t = ray_directions_t(scene.camera, cfg.dtype)
    key = None
    if cfg.stochastic_roughness:
        # The seed schedule of render()'s sample loop at spp 1, sample 0.
        key = fold_seed(fold_seed(seed_root(cfg.rng_seed), 0), 4)
    return fused_train_l2(scene.camera.position, dirs_t, target.reshape(-1, 3), scene, cfg, key=key)


def render(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Render the scene to an (H, W, 3) float image (unclipped).

    ``cfg.samples_per_pixel > 1`` averages jittered subpixel samples, one
    frame at a time; ``cfg.stochastic_roughness`` draws glossy reflection
    directions.  Both follow the JAX package's seed schedule from
    ``cfg.rng_seed``: sample ``i`` takes ``k = fold(root, i)``, its jitter
    from ``fold(k, 3)`` and its trace key ``fold(k, 4)``.
    """
    _check_scope(scene, cfg)
    h, w = scene.camera.height, scene.camera.width
    spp = cfg.samples_per_pixel
    if spp == 1 and not cfg.stochastic_roughness:
        return _render_sample(scene, cfg, None, None).reshape(h, w, 3)
    base = seed_root(cfg.rng_seed)
    n = h * w
    device = scene.camera.position.device
    acc = torch.zeros((n, 3), dtype=cfg.dtype, device=device)
    for i in range(spp):
        k = fold_seed(base, i)
        k_jit, k_trace = fold_seed(k, 3), fold_seed(k, 4)
        jitter = uniform2(k_jit, n, cfg.dtype, device=device) - 0.5 if spp > 1 else None
        acc = acc + _render_sample(scene, cfg, jitter, k_trace if cfg.stochastic_roughness else None)
    return (acc / spp).reshape(h, w, 3)
