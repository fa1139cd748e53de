"""JSON scene and render-settings loader.

Port of :mod:`python_ray_tracer_tpu.io.scene_json`: the same schema, keys and
defaults, building the port's scene on an explicit ``device``.

Scene file, a JSON list of typed objects:

* ``{"type": "Sphere", "centerXYZ": [..], "radius": r, "colorRGB": [..]
  (diffuse_color), "reflection": g (reflection_gain), "roughness": a
  (specular_roughness), "texture": "" | "checker" | "<png path relative to
  the scene file>", and optionally "diffuse_gain", "specular_gain",
  "iridescence_gain", "specular_ior", "thin_film_weight",
  "thin_film_thickness", "thin_film_ior"}``;
* ``{"type": "Light", "centerXYZ": [..], "intensityRGB": [..]}``, the point
  light (its intensity is unused, as in the reference);
* ``{"type": "DomeLight", "intensity": i, "colorRGB": [..]}``;
* ``{"type": "Camera", "positionXYZ": [..]}``.

Image textures are read with :func:`..utils.image.load_png` and packed into
one atlas padded to the largest texture; ``texture_hw`` keeps each texture's
own extents, over which the samplers map UV.

Settings file: ``{"image_width": W, "image_height": H,
"max_specular_depth": D, "output_path": "...", "dtype": "float32",
"visibility": "hard", "use_pallas": false, "max_samples_per_pixel": 1,
"stochastic_roughness": false, "rng_seed": 0, "denoise": false}``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config import RenderConfig
from ..scene import (
    TEXTURE_CHECKER,
    TEXTURE_CONST,
    TEXTURE_IMAGE,
    Scene,
    build_lights,
    build_spheres,
    make_scene,
    make_sphere_row,
)
from ..utils.image import load_png

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_scene(
    path: str | Path,
    *,
    width: int = 960,
    height: int = 540,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str,
) -> Scene:
    """Parse a JSON scene file into the port's scene, on ``device``: the
    caller names it (``"cuda"`` for the kernels), so no scene lands on the
    CPU unasked."""
    objects = json.loads(Path(path).read_text())
    if not isinstance(objects, list):
        raise ValueError(f"{path}: scene file must be a JSON list of objects")

    rows: list[dict[str, Any]] = []
    point_light: Any = None
    domes: list[tuple[float, Any]] = []
    camera_position: Any = (0.0, 0.2, -2.0)
    atlas_images: list[np.ndarray] = []

    for obj in objects:
        kind = obj.get("type")
        if kind == "Sphere":
            texture = obj.get("texture", "")
            tex_kind, tex_id = TEXTURE_CONST, 0
            if texture == "checker":
                tex_kind = TEXTURE_CHECKER
            elif texture:
                atlas_images.append(np.asarray(load_png(Path(path).parent / texture), np.float64) / 255.0)
                tex_kind, tex_id = TEXTURE_IMAGE, len(atlas_images) - 1
            rows.append(
                make_sphere_row(
                    obj["centerXYZ"],
                    obj["radius"],
                    diffuse_color=obj.get("colorRGB", (1.0, 1.0, 1.0)),
                    reflection_gain=obj.get("reflection", 0.0),
                    specular_roughness=obj.get("roughness", 0.0),
                    diffuse_gain=obj.get("diffuse_gain", 1.0),
                    specular_gain=obj.get("specular_gain", 0.0),
                    iridescence_gain=obj.get("iridescence_gain", 0.0),
                    specular_ior=obj.get("specular_ior", 1.5),
                    thin_film_weight=obj.get("thin_film_weight", 0.1),
                    thin_film_thickness=obj.get("thin_film_thickness", 0.3),
                    thin_film_ior=obj.get("thin_film_ior", 1.4),
                    texture_kind=tex_kind,
                    texture_id=tex_id,
                )
            )
        elif kind == "Light":
            point_light = obj["centerXYZ"]
        elif kind == "DomeLight":
            domes.append((float(obj.get("intensity", 0.1)), obj.get("colorRGB", (1.0, 1.0, 1.0))))
        elif kind == "Camera":
            camera_position = obj["positionXYZ"]
        else:
            raise ValueError(f"{path}: unknown object type {kind!r}")

    if point_light is None:
        raise ValueError(f"{path}: scene needs a point light (the reference shades lights[0])")

    atlas = atlas_hw = None
    if atlas_images:
        ht = max(a.shape[0] for a in atlas_images)
        wt = max(a.shape[1] for a in atlas_images)
        atlas = np.zeros((len(atlas_images), ht, wt, 3))
        for i, a in enumerate(atlas_images):
            atlas[i, : a.shape[0], : a.shape[1], :] = a[..., :3]
        atlas_hw = np.asarray([[a.shape[0], a.shape[1]] for a in atlas_images], np.int32)

    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights(point_light, domes=domes, dtype=dtype, device=device)
    return make_scene(
        spheres, lights, camera_position, width, height,
        texture_atlas=atlas, texture_hw=atlas_hw, dtype=dtype, device=device,
    )


def load_settings(path: str | Path) -> tuple[RenderConfig, dict[str, Any]]:
    """Parse a render-settings file into ``(RenderConfig, extras)``; extras
    holds the keys that are not render options: ``width``, ``height``,
    ``output_path`` and ``denoise``."""
    raw = json.loads(Path(path).read_text())
    cfg = RenderConfig(
        max_depth=int(raw.get("max_specular_depth", 3)),
        dtype=_DTYPES[raw.get("dtype", "float32")],
        visibility=raw.get("visibility", "hard"),
        use_pallas=bool(raw.get("use_pallas", False)),
        samples_per_pixel=int(raw.get("max_samples_per_pixel", 1)),
        stochastic_roughness=bool(raw.get("stochastic_roughness", False)),
        rng_seed=int(raw.get("rng_seed", 0)),
    )
    extras = {
        "width": int(raw.get("image_width", 960)),
        "height": int(raw.get("image_height", 540)),
        "output_path": raw.get("output_path", "render_out.png"),
        "denoise": bool(raw.get("denoise", False)),
    }
    return cfg, extras
