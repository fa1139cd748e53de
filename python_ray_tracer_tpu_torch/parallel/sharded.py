"""Rendering over a ``(rays, spheres)`` mesh of ranks.

Port of :mod:`python_ray_tracer_tpu.parallel.sharded`, where one program
``shard_map``s the render over a device mesh.  Here every rank of the
mesh runs the same calls on its own device:

* the flattened ray/pixel axis is cut along the ``rays`` axis: each rank
  traces its own slice of the rays, and the colors are gathered back into
  the whole frame on every rank;
* with more than one sphere shard the sphere table's geometry is cut along
  the ``spheres`` axis: each rank sweeps its rays against its own rows, and
  the nearest-hit, shadow and coverage reductions finish with collectives
  (:func:`..render.trace` with a sphere axis); with one sphere shard the
  geometry is replicated and each rank takes the single-device kernel
  routes on its rays;
* the material table, lights and camera are replicated: the material
  gather after a reduction is rank-local.

Gradients follow JAX's transpose of ``shard_map`` (:mod:`.collectives`):
a loss that every rank computes from the gathered frame gives every rank
the gradient of the single-device loss.

Padding: rays to a multiple of the ray-shard count with copies of ray 0
(sliced off again), spheres to a multiple of the sphere-shard count with
zero-radius spheres far below the scene (``disc <= 0`` for every ray, so the
strict hit test never fires, and the smooth sigmoids stay at 0), folded
into the exact tier.

JAX's ``render_sharded_jit`` has no counterpart: PyTorch has no ``jit`` to
wrap.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import render as _render
from ..camera import ray_directions
from ..config import RenderConfig
from ..ops.rng import fold_seed, seed_root, uniform2
from ..scene import Scene, Spheres
from . import collectives
from .mesh import Mesh, round_up

_PAD_CENTER = (0.0, -1.0e7, 0.0)


def pad_spheres(spheres: Spheres, multiple: int) -> Spheres:
    """Pad the sphere table to a multiple of the shard count with
    zero-radius rows at ``(0, -1e7, 0)`` (every other column 0), folded into
    the exact tier so the real rows keep theirs."""
    s = spheres.count
    target = round_up(s, multiple)
    if target == s:
        return spheres
    pad = target - s

    def pad_leaf(x: torch.Tensor, fill) -> torch.Tensor:
        block = torch.as_tensor(fill, dtype=x.dtype, device=x.device).expand((pad,) + tuple(x.shape[1:]))
        return torch.cat([x, block], dim=0)

    kw = {f.name: pad_leaf(getattr(spheres, f.name), 0) for f in dataclasses.fields(Spheres) if f.name != "n_exact"}
    kw["center"] = pad_leaf(spheres.center, _PAD_CENTER)
    return Spheres(**kw, n_exact=spheres.n_exact + pad)


def _replicated(scene: Scene, mesh: Mesh) -> Scene:
    """The scene with the gradients of its differentiable tensors summed over
    the ray shards (each rank's backward covers its own rays)."""
    fields = []
    for group in ("spheres", "lights", "camera"):
        obj = getattr(scene, group)
        fields += [(group, f.name) for f in dataclasses.fields(obj)
                   if isinstance(getattr(obj, f.name), torch.Tensor) and getattr(obj, f.name).requires_grad]
    if scene.texture_atlas.requires_grad:
        fields.append((None, "texture_atlas"))
    if not fields or mesh.rays.size == 1:
        return scene

    def get(group, name):
        return getattr(scene if group is None else getattr(scene, group), name)

    summed = collectives.sum_grads([get(g, n) for g, n in fields], mesh.rays)
    by_group: dict = {}
    for (group, name), x in zip(fields, summed):
        by_group.setdefault(group, {})[name] = x
    out = dataclasses.replace(scene, **by_group.pop(None, {}))
    for group, kw in by_group.items():
        out = dataclasses.replace(out, **{group: dataclasses.replace(getattr(out, group), **kw)})
    return out


def trace_sharded(
    dirs: torch.Tensor,  # (N, 3), N divisible by the ray-shard count, the same on every rank
    scene: Scene,  # sphere count divisible by the sphere-shard count
    cfg: RenderConfig,
    mesh: Mesh,
    key=None,  # seed of stochastic glossy bounces
) -> torch.Tensor:
    """Trace the rays across the mesh; returns the (N, 3) colors on every rank.

    Each rank traces rays ``[r * N/R, (r+1) * N/R)`` of its ray shard ``r``
    against its sphere shard.  With ``key`` each rank draws its stochastic
    samples at its GLOBAL ray offsets, so the sharded frame takes the
    single-device sample sequence of the same seed.
    """
    n_local = dirs.shape[0] // mesh.rays.size
    if n_local * mesh.rays.size != dirs.shape[0]:
        raise ValueError(f"{dirs.shape[0]} rays do not split into {mesh.rays.size} ray shards")
    if scene.spheres.count % mesh.spheres.size:
        raise ValueError(f"{scene.spheres.count} spheres do not split into {mesh.spheres.size} sphere shards")
    ray_offset = mesh.rays.index * n_local
    mine = dirs[ray_offset : ray_offset + n_local]
    pos = scene.camera.position
    if mesh.spheres.size == 1:
        color = _render.trace(pos, mine, scene, cfg, key=key, ray_offset=ray_offset)
    else:
        s_local = scene.spheres.count // mesh.spheres.size
        color = _render.trace(
            pos, mine, scene, cfg, key=key, ray_offset=ray_offset,
            sweep_center=collectives.shard_rows(scene.spheres.center, mesh.spheres, s_local),
            sweep_radius=collectives.shard_rows(scene.spheres.radius, mesh.spheres, s_local),
            sphere_axis=mesh.spheres, sphere_offset=mesh.spheres.index * s_local,
        )
    return collectives.gather_rows(color, mesh.rays)


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Sharded :func:`..render.render`: the (H, W, 3) image on every rank.

    Pads rays and spheres to shard multiples, traces, unpads.
    ``cfg.samples_per_pixel > 1`` and ``cfg.stochastic_roughness`` draw
    their jitter at global scope on the seed schedule of :func:`..render.render`
    (sample ``i``: ``k = fold(root, i)``, jitter from ``fold(k, 3)``, trace
    key ``fold(k, 4)``), so the sharded frame uses the single-device samples.
    """
    _render._check_scope(scene, cfg)
    h, w = scene.camera.height, scene.camera.width
    n = h * w
    scene = _replicated(scene, mesh)
    padded = pad_spheres(scene.spheres, mesh.spheres.size)
    if padded is not scene.spheres:
        scene = dataclasses.replace(scene, spheres=padded)
    n_pad = round_up(n, mesh.rays.size)

    def dirs_for(jitter: torch.Tensor | None) -> torch.Tensor:
        dirs = ray_directions(scene.camera, cfg.dtype, jitter)
        if n_pad != n:
            dirs = torch.cat([dirs, dirs[:1].expand(n_pad - n, 3)])
        return dirs

    spp = cfg.samples_per_pixel
    if spp == 1 and not cfg.stochastic_roughness:
        return trace_sharded(dirs_for(None), scene, cfg, mesh)[:n].reshape(h, w, 3)
    base = seed_root(cfg.rng_seed)
    device = scene.camera.position.device
    acc = torch.zeros((n_pad, 3), dtype=cfg.dtype, device=device)
    for i in range(spp):
        k = fold_seed(base, i)
        jitter = uniform2(fold_seed(k, 3), n, cfg.dtype, device=device) - 0.5 if spp > 1 else None
        acc = acc + trace_sharded(dirs_for(jitter), scene, cfg, mesh,
                                  key=fold_seed(k, 4) if cfg.stochastic_roughness else None)
    return (acc / spp)[:n].reshape(h, w, 3)
