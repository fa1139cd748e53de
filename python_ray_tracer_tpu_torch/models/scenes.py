"""Built-in scenes (port of :mod:`python_ray_tracer_tpu.models.scenes`).

``reference_scene`` is the reference demo scene literal, the golden-image
scene; ``all_effects_scene`` turns every shading feature on at once.  The
JAX package's other builders are not ported yet.
"""

from __future__ import annotations

import torch

from ..scene import (
    TEXTURE_CHECKER,
    Scene,
    build_lights,
    build_spheres,
    make_scene,
    make_sphere_row,
)


def reference_scene(
    width: int = 960,
    height: int = 540,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """The 3-sphere README scene.

    Sphere 1: white, all gains zero (silhouette + ambient/dome only).
    Sphere 2: red constant texture, specular_gain 1, roughness 0.1.
    Ground: giant checker sphere (r=99999), diffuse 1, specular 0.1.
    Lights: point at (-2, 1, 2); dome intensity 0.1 white.
    Camera at (0, 0.2, -2).
    """
    rows = [
        make_sphere_row(
            (0.55, 0.5, 3.0),
            1.0,
            reflection_gain=0.0,
            specular_gain=0.0,
            specular_roughness=0.01,
            iridescence_gain=0.0,
            diffuse_gain=0.0,
            diffuse_color=(1.0, 1.0, 1.0),
        ),
        make_sphere_row(
            (-0.45, 0.1, 1.0),
            0.4,
            reflection_gain=0.0,
            specular_gain=1.0,
            specular_roughness=0.1,
            iridescence_gain=0.0,
            diffuse_gain=0.0,
            diffuse_color=(1.0, 0.0, 0.0),
        ),
        make_sphere_row(
            (0.0, -99999.5, 0.0),
            99999.0,
            reflection_gain=0.0,
            specular_gain=0.1,
            specular_roughness=0.5,
            iridescence_gain=0.0,
            diffuse_gain=1.0,
            diffuse_color=(1.0, 1.0, 1.0),
            texture_kind=TEXTURE_CHECKER,
        ),
    ]
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((-2.0, 1.0, 2.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=dtype, device=device)
    return make_scene(spheres, lights, (0.0, 0.2, -2.0), width, height, dtype=dtype, device=device)


def all_effects_scene(
    width: int = 960,
    height: int = 540,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """Every feature at once: checker ground, glossy red sphere, iridescent
    sphere, mirror sphere, matte colored sphere, point + dome light."""
    rows = [
        # mirror sphere
        make_sphere_row((0.9, 0.35, 2.6), 0.85, specular_gain=1.0, specular_roughness=0.02),
        # glossy red sphere
        make_sphere_row(
            (-0.9, 0.0, 1.6), 0.5, specular_gain=0.9, specular_roughness=0.15,
            diffuse_gain=0.6, diffuse_color=(0.9, 0.05, 0.05),
        ),
        # iridescent sphere
        make_sphere_row(
            (0.0, -0.1, 1.1), 0.35, specular_gain=0.4, specular_roughness=0.3,
            iridescence_gain=2.5, diffuse_gain=0.25, diffuse_color=(0.2, 0.2, 0.4),
        ),
        # matte green sphere
        make_sphere_row(
            (-2.0, 0.3, 3.2), 0.8, diffuse_gain=1.0, diffuse_color=(0.1, 0.7, 0.2),
            specular_gain=0.15, specular_roughness=0.5,
        ),
        # checker ground
        make_sphere_row(
            (0.0, -99999.5, 0.0), 99999.0, specular_gain=0.1, specular_roughness=0.5,
            diffuse_gain=1.0, texture_kind=TEXTURE_CHECKER,
        ),
    ]
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((-2.0, 2.5, -1.0), domes=[(0.12, (0.9, 0.95, 1.0))], dtype=dtype, device=device)
    return make_scene(spheres, lights, (0.0, 0.3, -2.2), width, height, dtype=dtype, device=device)
