"""Built-in scenes (port of :mod:`python_ray_tracer_tpu.models.scenes`).

``reference_scene`` is the reference demo scene literal, the golden-image
scene; ``all_effects_scene`` turns every shading feature on at once;
``random_spheres_scene`` is BASELINE config 4's 1024 random spheres,
``textured_spheres_scene`` the same scale with image textures on every 4th
sphere, ``texture_task_scene`` the inverse-texture task's one textured
sphere and ``inverse_task_scene`` BASELINE config 5's inverse-rendering
scene.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene import (
    TEXTURE_CHECKER,
    TEXTURE_IMAGE,
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


def random_spheres_scene(
    n_spheres: int = 1024,
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """BASELINE config 4: the checker ground and ``n_spheres - 1`` random
    spheres, drawn from ``np.random.default_rng(seed)`` in the JAX builder's
    order, so the tables are the JAX package's bit for bit.  The r = 99999
    ground is the one exact-tier row."""
    rng = np.random.default_rng(seed)
    rows = [
        make_sphere_row(
            (0.0, -99999.5, 0.0), 99999.0, specular_gain=0.1, specular_roughness=0.5,
            diffuse_gain=1.0, texture_kind=TEXTURE_CHECKER,
        )
    ]
    for _ in range(n_spheres - 1):
        center = rng.uniform([-12.0, -0.3, 1.0], [12.0, 6.0, 30.0])
        radius = rng.uniform(0.1, 0.5)
        color = rng.uniform(0.1, 1.0, size=3)
        rows.append(
            make_sphere_row(
                center,
                radius,
                specular_gain=float(rng.uniform(0.0, 1.0)),
                specular_roughness=float(rng.uniform(0.05, 0.8)),
                iridescence_gain=float(rng.uniform(0.0, 0.3)),
                diffuse_gain=float(rng.uniform(0.3, 1.0)),
                diffuse_color=color,
            )
        )
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((-8.0, 10.0, -2.0), domes=[(0.15, (1.0, 1.0, 1.0))], dtype=dtype, device=device)
    return make_scene(spheres, lights, (0.0, 1.0, -4.0), width, height, dtype=dtype, device=device)


def textured_spheres_scene(
    n_spheres: int = 1024,
    width: int = 1920,
    height: int = 1080,
    tex_side: int = 512,
    n_textures: int = 2,
    seed: int = 13,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """Config-4 scale with equirectangular image textures: the checker ground
    and ``n_spheres - 1`` random spheres, every 4th of which samples one of
    ``n_textures`` random ``tex_side`` x ``tex_side`` images.  The atlas and
    the rows are drawn from ``np.random.default_rng(seed)`` in the JAX
    builder's order, so they are the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0.05, 1.0, (n_textures, tex_side, tex_side, 3)).astype(np.float32)
    rows = [
        make_sphere_row(
            (0.0, -99999.5, 0.0), 99999.0, specular_gain=0.1, specular_roughness=0.5,
            diffuse_gain=1.0, texture_kind=TEXTURE_CHECKER,
        )
    ]
    for i in range(n_spheres - 1):
        center = rng.uniform([-12.0, -0.3, 1.0], [12.0, 6.0, 30.0])
        kw = dict(
            specular_gain=float(rng.uniform(0.0, 1.0)),
            specular_roughness=float(rng.uniform(0.05, 0.8)),
            diffuse_gain=float(rng.uniform(0.3, 1.0)),
            diffuse_color=rng.uniform(0.1, 1.0, 3),
        )
        if i % 4 == 0:
            kw.update(texture_kind=TEXTURE_IMAGE, texture_id=i % n_textures)
        rows.append(make_sphere_row(center, float(rng.uniform(0.1, 0.5)), **kw))
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((-8.0, 10.0, -2.0), domes=[(0.15, (1.0, 1.0, 1.0))], dtype=dtype, device=device)
    return make_scene(
        spheres, lights, (0.0, 1.0, -4.0), width, height, texture_atlas=atlas, dtype=dtype, device=device
    )


def texture_task_scene(
    texture,
    width: int = 256,
    height: int = 144,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """The inverse-texture task: one image-textured sphere filling the frame
    (``texture`` an (Ht, Wt, 3) array), facing the camera with
    ``diffuse_gain=1`` and no specular terms, the point light behind the
    camera, so nearly every front-facing texel receives loss signal."""
    atlas = np.asarray(texture, np.float32)[None]  # (1, Ht, Wt, 3)
    rows = [make_sphere_row((0.0, 0.0, 2.2), 1.4, diffuse_gain=1.0, texture_kind=TEXTURE_IMAGE, texture_id=0)]
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((0.5, 1.0, -6.0), domes=[(0.05, (1.0, 1.0, 1.0))], dtype=dtype, device=device)
    return make_scene(
        spheres, lights, (0.0, 0.0, -1.0), width, height, texture_atlas=atlas, dtype=dtype, device=device
    )


def inverse_task_scene(
    n_spheres: int = 64,
    width: int = 256,
    height: int = 144,
    seed: int = 7,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    """BASELINE config 5: ``n_spheres`` random spheres and no ground, drawn
    from ``np.random.default_rng(seed)`` in the JAX builder's order, so the
    tables are the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_spheres):
        center = rng.uniform([-3.0, -0.2, 1.0], [3.0, 2.0, 8.0])
        radius = rng.uniform(0.15, 0.45)
        color = rng.uniform(0.1, 1.0, size=3)
        rows.append(
            make_sphere_row(
                center,
                radius,
                specular_gain=float(rng.uniform(0.0, 0.5)),
                specular_roughness=float(rng.uniform(0.1, 0.6)),
                diffuse_gain=float(rng.uniform(0.5, 1.0)),
                diffuse_color=color,
            )
        )
    spheres = build_spheres(rows, dtype=dtype, device=device)
    lights = build_lights((-4.0, 6.0, -1.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=dtype, device=device)
    return make_scene(spheres, lights, (0.0, 0.6, -3.0), width, height, dtype=dtype, device=device)
