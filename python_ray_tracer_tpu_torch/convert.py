"""Carry a scene across frameworks as a flat dict of numpy arrays.

The keys are the JAX ``Scene`` pytree's leaf paths (``spheres.center``,
``lights.dome_color``, ``camera.position``, ``texture_atlas``, ...), so a
JAX scene flattened with its leaf paths rebuilds here as the same scene.
The static fields (frame size, ``n_exact``) travel as arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene import Camera, Lights, Scene, Spheres

_INT_KEYS = ("spheres.texture_kind", "spheres.texture_id", "texture_hw")


def _tensor_fields(cls: type) -> list[str]:
    return [f.name for f in dataclasses.fields(cls) if f.name not in ("n_exact", "width", "height")]


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    """Every tensor leaf of ``scene`` as numpy, keyed by its leaf path."""
    out: dict[str, np.ndarray] = {}
    for prefix, obj in (("spheres", scene.spheres), ("lights", scene.lights), ("camera", scene.camera)):
        for name in _tensor_fields(type(obj)):
            out[f"{prefix}.{name}"] = getattr(obj, name).detach().cpu().numpy()
    out["texture_atlas"] = scene.texture_atlas.detach().cpu().numpy()
    out["texture_hw"] = scene.texture_hw.detach().cpu().numpy()
    return out


def scene_from_numpy(
    arrays: dict[str, np.ndarray],
    *,
    width: int,
    height: int,
    n_exact: int,
    device: torch.device | str,
    dtype: torch.dtype,
) -> Scene:
    """Inverse of :func:`scene_to_numpy`: floats cast to ``dtype``, ids int32."""

    def leaf(key: str) -> torch.Tensor:
        if key not in arrays:
            raise KeyError(f"scene array {key!r} missing")
        d = torch.int32 if key in _INT_KEYS else dtype
        return torch.tensor(np.asarray(arrays[key])).to(d).to(device)

    def build(cls: type, prefix: str, **static: int):
        return cls(**{n: leaf(f"{prefix}.{n}") for n in _tensor_fields(cls)}, **static)

    return Scene(
        spheres=build(Spheres, "spheres", n_exact=int(n_exact)),
        lights=build(Lights, "lights"),
        camera=build(Camera, "camera", width=int(width), height=int(height)),
        texture_atlas=leaf("texture_atlas"),
        texture_hw=leaf("texture_hw"),
    )
