"""Split a scene into optimizable parameters and static structure.

Port of :mod:`python_ray_tracer_tpu.optim.params`.  A :class:`..scene.Scene`
is partitioned into

* **params**: a flat ``dict[str, Tensor]`` of leaves that require grad
  (sphere geometry and material columns, light parameters, the camera
  position, optionally the image-texture atlas), keyed as the JAX dict is;
* **static**: the scene template carrying everything else (texture kinds
  and ids, frame size, ``n_exact``).

:func:`combine` re-assembles a scene whose tensors are the params
themselves, so ``loss.backward()`` fills each leaf's ``.grad``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from typing import Any

import torch

from ..scene import Scene

SPHERE_PARAM_FIELDS = (
    "center",
    "radius",
    "reflection_gain",
    "specular_gain",
    "specular_roughness",
    "iridescence_gain",
    "diffuse_gain",
    "diffuse_color",
    "specular_ior",
    "thin_film_weight",
    "thin_film_thickness",
    "thin_film_ior",
)
LIGHT_PARAM_FIELDS = ("point_position", "dome_intensity", "dome_color")

Params = dict[str, torch.Tensor]


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def scene_to_params(
    scene: Scene,
    *,
    sphere_fields: Iterable[str] = SPHERE_PARAM_FIELDS,
    light_fields: Iterable[str] = LIGHT_PARAM_FIELDS,
    camera: bool = True,
    atlas: bool = False,
) -> Params:
    """The requested differentiable leaves, as fresh tensors that require grad."""
    params: Params = {}
    for f in sphere_fields:
        params[f"spheres.{f}"] = _leaf(getattr(scene.spheres, f))
    for f in light_fields:
        params[f"lights.{f}"] = _leaf(getattr(scene.lights, f))
    if camera:
        params["camera.position"] = _leaf(scene.camera.position)
    if atlas:
        params["textures.atlas"] = _leaf(scene.texture_atlas)
    return params


def combine(params: Params, template: Scene) -> Scene:
    """Rebuild a scene from params + the static template."""
    groups: dict[str, dict[str, Any]] = {"spheres": {}, "lights": {}, "camera": {}, "textures": {}}
    for key, val in params.items():
        group, field = key.split(".", 1)
        if group not in groups or (group == "textures" and field != "atlas"):
            raise KeyError(f"unknown param group in {key!r}")
        groups[group][field] = val
    scene = template
    if groups["textures"]:
        scene = dataclasses.replace(scene, texture_atlas=groups["textures"]["atlas"])
    for group in ("spheres", "lights", "camera"):
        if groups[group]:
            scene = dataclasses.replace(scene, **{group: dataclasses.replace(getattr(scene, group), **groups[group])})
    return scene
