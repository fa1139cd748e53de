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
  :func:`.ops.culled.trace_fused_culled` for 96 and more, and with a
  stochastic key above 64 spheres :func:`trace` with the standalone sweep
  kernels (:mod:`.ops.intersect_fused`), as with an image atlas of more
  than MAX_FUSED_TEXELS texels on a scene neither of the others takes.
  Smooth visibility
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
  the texels outside them (:func:`.ops.texture.compose_texels`);
* otherwise :func:`trace`, the pure-torch bounce loop that mirrors the JAX
  XLA path term for term.  Torch autograd through it is the oracle for the
  kernels' handwritten adjoints.

:func:`l2_loss_fused` is the L2 training loss as one ``train_deep``
launch, where :func:`fused_train_l2_ok` allows it.  Every route the JAX
package has and this port does not raises ``NotImplementedError`` naming
the JAX function it waits for.
"""

from __future__ import annotations

import math

import torch

from .camera import ray_directions, ray_directions_t
from .config import VISIBILITY_SMOOTH, RenderConfig
from .ops.intersect import (
    IntersectResult,
    intersect_all,
    intersect_two_tier,
    nearest_hit,
)
from .ops.bounce_smooth_sub import MAX_TRAIN_DEPTH, fused_train_l2, trace_fused_smooth_sub
from .ops.bounce_sub import MAX_SUB_SPHERES, trace_fused_sub
from .ops.texture import MAX_FUSED_TEXELS
from .ops.culled import MAX_CULL_DEPTH, MAX_CULL_EXACT, MIN_CULL_SPHERES, trace_fused_culled
from .ops.culled_smooth import MAX_BLK_SPHERES_SMOOTH, cull_smooth_ok, trace_culled_smooth
from .ops.intersect_fused import nearest_sweep, shadow_sweep
from .ops.shading import NUDGE, gather_material, shade
from .ops.rng import bounce_xi, fold_seed, seed_root, uniform2
from .ops.tables import geometry_table
from .ops.vecmath import ggx_perturb_reflect, normalize, reflect
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
    and ``shadow_sweep`` kernels, the JAX ``trace``'s fused branch.
    """
    smooth = cfg.visibility == VISIBILITY_SMOOTH
    dtype = cfg.dtype
    cam_pos = scene.camera.position.to(dtype)
    light_pos = scene.lights.point_position.to(dtype)
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

    t_safe = torch.where(near.hit, near.t, torch.ones_like(near.t))
    mat = gather_material(scene.spheres, idx)

    p = o + d * t_safe[:, None]
    normal = (p - mat.center) * (1.0 / mat.radius)[:, None]
    to_light = normalize(light_pos[None, :] - p)
    to_camera = normalize(cam_pos[None, :] - p)
    p_nudged = p + normal * NUDGE

    if _sweep_kernels(cfg):
        in_light = shadow_sweep(p_nudged.contiguous(), to_light.contiguous(), geom, idx, **sweep_kw)
    elif smooth:
        in_light = _shadow_smooth(_sweep(p_nudged, to_light, scene, cfg), idx, cfg)
    else:
        in_light = _shadow_hard(_sweep(p_nudged, to_light, scene, cfg), idx, dtype)
    local = shade(p, normal, to_light, to_camera, in_light, mat, scene)

    accum = accum + local.color * (throughput * coverage)[:, None]
    throughput = throughput * coverage * local.refl_coeff
    alive = coverage if smooth else alive * hit
    if xi is None:
        d_next = reflect(d, normal)
    else:
        d_next = ggx_perturb_reflect(d, normal, mat.specular_roughness, xi)
    return p_nudged, d_next, throughput, alive, accum


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
) -> torch.Tensor:
    """Trace N rays to ``cfg.max_depth`` bounces; returns (N, 3) color.

    With ``cfg.stochastic_roughness`` and a seed ``key``, each bounce takes
    its xi on the JAX package's schedule (:func:`.ops.rng.bounce_xi`), the
    lanes' draws from global ray index ``ray_offset`` on, so a chunk of a
    frame draws what the whole frame's draw has there.  Hard visibility
    with ``cfg.use_pallas`` and no key takes the culled kernels where the
    JAX ``trace`` does (:func:`culled_ok`).
    """
    dtype = cfg.dtype
    if _sweep_kernels(cfg) and key is None and not cfg.ray_chunk and culled_ok(scene, cfg):
        return trace_fused_culled(origin.expand(direction.shape).T, direction.T, scene, cfg)
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
        o, d, throughput, alive, accum = bounce(o, d, throughput, alive, accum, scene, cfg, xi)
    return accum


def _check_scope(scene: Scene, cfg: RenderConfig) -> None:
    """Refuse every route of the JAX renderer this port does not have yet."""
    waits = None
    if cfg.tie_mode == "sum":
        waits = "tie_mode='sum' (render.trace's tie_sum branch)"
    elif cfg.ray_chunk:
        waits = "ray chunking (render._render_sample's lax.map over tiles)"
    elif cfg.remat:
        waits = "remat (render.trace's jax.checkpoint around each bounce)"
    elif cfg.pallas_interpret:
        waits = "interpret mode (a CUDA kernel has none; pallas_interpret has no counterpart)"
    if waits is not None:
        raise NotImplementedError(f"not ported yet: {waits} in python_ray_tracer_tpu")


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
    more spheres with at most 8 in the exact tier, no key) or ``"sweeps"``
    (``trace`` with ``nearest_sweep``/``shadow_sweep`` and the pure-torch
    shading: a key above 64 spheres, or the rest with an image atlas of more
    than MAX_FUSED_TEXELS texels, which the JAX package sends down its XLA
    path).  Raises ``NotImplementedError`` for the lane kernel's scenes.
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
    raise NotImplementedError(
        f"not ported yet: a mirror scene of {s} spheres ({scene.spheres.n_exact} in the exact tier) takes "
        "python_ray_tracer_tpu.ops.pallas_bounce._bounce_kernel (trace_fused) in python_ray_tracer_tpu"
    )


def _render_sample(scene: Scene, cfg: RenderConfig, jitter: torch.Tensor | None, key) -> torch.Tensor:
    """One (optionally jittered) sample per pixel -> flat (H*W, 3) colors;
    ``key`` seeds the stochastic continuation (None: mirror)."""
    route = None
    if cfg.use_pallas and cfg.visibility == VISIBILITY_SMOOTH:
        route = "smooth_" + smooth_route(scene, cfg, scene.camera.width * scene.camera.height, key)
    elif cfg.use_pallas:
        route = hard_route(scene, cfg, key)
    if route in ("smooth_culled", "smooth_sub", "smooth_step", "culled", "sub"):
        dirs_t = ray_directions_t(scene.camera, cfg.dtype, None if jitter is None else jitter.T)
        if route == "smooth_culled":
            return trace_culled_smooth(scene.camera.position, dirs_t, scene, cfg, key=key)
        if route == "smooth_sub":
            return trace_fused_smooth_sub(scene.camera.position, dirs_t, scene, cfg, key=key)
        if route == "smooth_step":
            return trace_fused_smooth_sub(scene.camera.position, dirs_t, scene, cfg, route="step")
        if route == "culled":
            return trace_fused_culled(scene.camera.position, dirs_t, scene, cfg)
        return trace_fused_sub(scene.camera.position, dirs_t, scene, cfg, key=key)
    dirs = ray_directions(scene.camera, cfg.dtype, jitter)
    return trace(scene.camera.position, dirs, scene, cfg, key=key)


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
