"""The renderer: ``render(scene, cfg) -> (H, W, 3)`` float image.

Port of the hard-visibility, single-shard, deterministic path of
:mod:`python_ray_tracer_tpu.render`.  The reference's unbounded mirror
recursion is a fixed-depth loop carrying ``(origin, direction, throughput,
alive, accum)``; every lane computes every bounce and dead lanes are
multiplied away.

Two routes, chosen as the JAX package chooses them:

* ``cfg.use_pallas`` -> :func:`.ops.bounce_sub.trace_fused_sub`, the
  hand-written CUDA bounce kernels (their plain torch version on a CPU
  tensor);
* otherwise :func:`trace`, the pure-torch bounce loop that mirrors the JAX
  XLA path term for term.

Every route the JAX package has and this port does not raises
``NotImplementedError`` naming the JAX function it waits for.
"""

from __future__ import annotations

import math

import torch

from .camera import ray_directions, ray_directions_t
from .config import VISIBILITY_SMOOTH, RenderConfig
from .ops.intersect import (
    IntersectResult,
    intersect_all,
    intersect_all_stable,
    intersect_two_tier,
    nearest_hit,
)
from .ops.shading import NUDGE, gather_material, shade
from .ops.vecmath import normalize, reflect
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


def trace(
    origin: torch.Tensor,  # (N, 3) or (3,)
    direction: torch.Tensor,  # (N, 3) unit
    scene: Scene,
    cfg: RenderConfig,
) -> torch.Tensor:
    """Trace N rays to ``cfg.max_depth`` bounces; returns (N, 3) color.

    Misses contribute black; ``to_camera`` always points at the ORIGINAL
    camera, every bounce (reference quirk kept).
    """
    dtype = cfg.dtype
    direction = direction.to(dtype)
    n = direction.shape[0]
    o = origin.to(dtype).expand(direction.shape)
    d = direction
    cam_pos = scene.camera.position.to(dtype)
    light_pos = scene.lights.point_position.to(dtype)
    throughput = torch.ones((n,), dtype=dtype, device=d.device)
    alive = torch.ones((n,), dtype=dtype, device=d.device)
    accum = torch.zeros((n, 3), dtype=dtype, device=d.device)
    for _ in range(cfg.max_depth):
        near = nearest_hit(_sweep(o, d, scene, cfg).t, cfg.faraway)
        idx = near.idx
        hit = near.hit.to(dtype)
        coverage = hit * alive

        t_safe = torch.where(near.hit, near.t, torch.ones_like(near.t))
        mat = gather_material(scene.spheres, idx)

        p = o + d * t_safe[:, None]
        normal = (p - mat.center) * (1.0 / mat.radius)[:, None]
        to_light = normalize(light_pos[None, :] - p)
        to_camera = normalize(cam_pos[None, :] - p)
        p_nudged = p + normal * NUDGE

        in_light = _shadow_hard(_sweep(p_nudged, to_light, scene, cfg), idx, dtype)
        local = shade(p, normal, to_light, to_camera, in_light, mat, scene)

        accum = accum + local.color * (throughput * coverage)[:, None]
        throughput = throughput * coverage * local.refl_coeff
        alive = alive * hit
        o = p_nudged
        d = reflect(d, normal)
    return accum


def _check_scope(scene: Scene, cfg: RenderConfig) -> None:
    """Refuse every route of the JAX renderer this port does not have yet."""
    waits = None
    if cfg.visibility == VISIBILITY_SMOOTH:
        waits = "smooth visibility (render._trace_smooth_fused, trace's smooth branch)"
    elif cfg.samples_per_pixel > 1:
        waits = "supersampling (render.render's jittered sample scan, ops.rng)"
    elif cfg.stochastic_roughness:
        waits = "stochastic roughness (ops.vecmath.ggx_perturb_reflect, ops.rng)"
    elif scene.has_atlas:
        waits = "image-texture atlases (ops.shading.texture_color, the sublane kernels' texel gather)"
    elif cfg.tie_mode == "sum":
        waits = "tie_mode='sum' (render.trace's tie_sum branch)"
    elif cfg.ray_chunk:
        waits = "ray chunking (render._render_sample's lax.map over tiles)"
    elif cfg.pallas_interpret:
        waits = "interpret mode (a CUDA kernel has none; pallas_interpret has no counterpart)"
    if waits is not None:
        raise NotImplementedError(f"not ported yet: {waits} in python_ray_tracer_tpu")


def _render_sample(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """One center ray per pixel -> flat (H*W, 3) colors."""
    if cfg.use_pallas:
        from .ops.bounce_sub import trace_fused_sub

        dirs_t = ray_directions_t(scene.camera, cfg.dtype)
        return trace_fused_sub(scene.camera.position, dirs_t, scene, cfg)
    dirs = ray_directions(scene.camera, cfg.dtype)
    return trace(scene.camera.position, dirs, scene, cfg)


def render(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Render the scene to an (H, W, 3) float image (unclipped)."""
    _check_scope(scene, cfg)
    h, w = scene.camera.height, scene.camera.width
    return _render_sample(scene, cfg).reshape(h, w, 3)
