"""PyTorch + CUDA port of the differentiable sphere ray tracer.

The JAX package ``python_ray_tracer_tpu`` beside this one is the
reference; this package mirrors its module names.  The first slice is the
hard-visibility forward render: scene, camera, intersection, shading, the
pure-torch bounce loop, and the hand-written CUDA bounce kernels for
Hopper (:mod:`.ops.bounce_sub`, sources in ``csrc/``).
"""

from .config import RenderConfig, faraway
from .render import auto_max_depth, render, trace
from .scene import (
    TEXTURE_CHECKER,
    TEXTURE_CONST,
    TEXTURE_IMAGE,
    Camera,
    Lights,
    Scene,
    Spheres,
    build_lights,
    build_spheres,
    make_scene,
    make_sphere_row,
)

__all__ = [
    "TEXTURE_CHECKER",
    "TEXTURE_CONST",
    "TEXTURE_IMAGE",
    "Camera",
    "Lights",
    "RenderConfig",
    "Scene",
    "Spheres",
    "auto_max_depth",
    "build_lights",
    "build_spheres",
    "faraway",
    "make_scene",
    "make_sphere_row",
    "render",
    "trace",
]
