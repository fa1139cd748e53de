"""The full shading stack over ray lanes (port of
:mod:`python_ray_tracer_tpu.ops.shading`).

Every live term of the reference shader, per lane, with per-lane
materials gathered by nearest-hit index: ambient, diffuse x texture
(constant, checker or image), dome,
GGX specular + glint, thin-film iridescence.  Term order and association
follow the JAX package so float64 renders agree to roundoff, and the
clamps are :func:`.vecmath.clip`/:func:`.vecmath.relu0` (and ``|x|`` is
:func:`.vecmath.abs`) so their gradients at exact boundaries are
``jax.grad``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene import TEXTURE_CHECKER, TEXTURE_IMAGE, Lights, Scene, Spheres
from .vecmath import abs as vabs
from .vecmath import clip, dot, ipow, normalize, relu0, sqrt

AMBIENT = 0.004
SHADING_EPS = 1e-8
GLINT_EXPONENT = 2.5
NUDGE = 0.0001


class LaneMaterial(NamedTuple):
    """Per-lane material parameters gathered from the sphere table."""

    center: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,)
    specular_gain: torch.Tensor
    specular_roughness: torch.Tensor
    iridescence_gain: torch.Tensor
    diffuse_gain: torch.Tensor
    diffuse_color: torch.Tensor  # (N, 3)
    specular_ior: torch.Tensor
    thin_film_weight: torch.Tensor
    thin_film_thickness: torch.Tensor
    thin_film_ior: torch.Tensor
    texture_kind: torch.Tensor  # (N,) int32
    texture_id: torch.Tensor  # (N,) int32


def gather_material(spheres: Spheres, idx: torch.Tensor) -> LaneMaterial:
    """Per-lane material rows for each lane's nearest sphere (index gather)."""
    i = idx.long()
    return LaneMaterial(**{f: getattr(spheres, f)[i] for f in LaneMaterial._fields})


def texture_color(point: torch.Tensor, normal: torch.Tensor, mat: LaneMaterial, scene: Scene) -> torch.Tensor:
    """Per-lane diffuse texture, selected by ``texture_kind``: constant
    color, the reference checker ``trunc(2x) mod 2 == trunc(2z) mod 2``
    (torch's integer ``%`` floors, as JAX's does), or the nearest texel of
    an equirectangular image texture.

    The image UV comes from the DETACHED unit normal, ``u = 0.5 +
    atan2(nz, nx) / 2 pi``, ``v = 0.5 - asin(ny) / pi``, each mod 1, over
    the texture's native extents (``scene.texture_hw``), so padded atlas
    slots are never sampled.  The lookup is piecewise constant: UV carries
    no gradient, and the atlas gets its gradient through the gather."""
    dtype = point.dtype
    cx = torch.trunc(point[..., 0] * 2.0).to(torch.int32) % 2
    cz = torch.trunc(point[..., 2] * 2.0).to(torch.int32) % 2
    checker_c = (cx == cz).to(dtype)[..., None]

    n = normal.detach()
    ny = torch.clamp(n[..., 1], -1.0, 1.0)  # guards asin on dead lanes
    u = 0.5 + torch.atan2(n[..., 2], n[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(ny) / math.pi
    u = torch.remainder(u, 1.0)
    v = torch.remainder(v, 1.0)
    hw = scene.texture_hw[mat.texture_id.long()]  # (N, 2) int32
    ti = torch.clamp((u * (hw[..., 1].to(dtype) - 1.0)).to(torch.int32), min=0)
    ti = torch.minimum(ti, hw[..., 1] - 1)
    tj = torch.clamp((v * (hw[..., 0].to(dtype) - 1.0)).to(torch.int32), min=0)
    tj = torch.minimum(tj, hw[..., 0] - 1)
    image_c = scene.texture_atlas[mat.texture_id.long(), tj.long(), ti.long()].to(dtype)

    kind = mat.texture_kind[..., None]
    return torch.where(
        kind == TEXTURE_CHECKER, checker_c, torch.where(kind == TEXTURE_IMAGE, image_c, mat.diffuse_color)
    )


def dome_light(normal: torch.Tensor, lights: Lights) -> torch.Tensor:
    """Dome contribution: summed intensities times the LAST dome's color."""
    updot = relu0(normal[..., 1])
    intensity = torch.sum(lights.dome_intensity) * updot
    return lights.dome_color[-1][None, :] * intensity[..., None]


def ggx_specular(
    normal: torch.Tensor,
    to_light: torch.Tensor,
    to_camera: torch.Tensor,
    mat: LaneMaterial,
) -> torch.Tensor:
    """GGX microfacet specular + edge glint; scalar per lane."""
    eps = SHADING_EPS
    L = normalize(to_light)
    V = normalize(to_camera)
    H = normalize(L + V)

    n_dot_v = clip(dot(normal, V), 0.0, 1.0)
    n_dot_h = clip(dot(normal, H), 0.0, 1.0)
    v_dot_h = clip(dot(V, H), 0.0, 1.0)
    n_dot_l = clip(dot(normal, L), 0.0, 1.0)

    f0 = ipow((mat.specular_ior - 1.0) / (mat.specular_ior + 1.0), 2)
    fresnel = f0 + (1.0 - f0) * ipow(1.0 - v_dot_h, 5)

    alpha = ipow(mat.specular_roughness, 2)
    alpha2 = ipow(alpha, 2)
    denom = ipow(n_dot_h, 2) * (alpha2 - 1.0) + 1.0
    dist = alpha2 / (math.pi * (ipow(denom, 2) + eps))

    def g1(x_dot_n: torch.Tensor) -> torch.Tensor:
        arg = alpha2 + (1.0 - alpha2) * ipow(x_dot_n, 2)
        pos = arg > 0
        root = torch.where(pos, sqrt(torch.where(pos, arg, torch.ones_like(arg))), torch.zeros_like(arg))
        return 2.0 * x_dot_n / (x_dot_n + root + eps)

    geom = g1(n_dot_l) * g1(n_dot_v)

    spec_base = (fresnel * dist * geom) / (4.0 * n_dot_v + eps)
    glint = torch.pow(1.0 - n_dot_v, GLINT_EXPONENT) * n_dot_l
    spec_final = spec_base + mat.specular_gain * glint
    return torch.where(n_dot_v <= 0, torch.zeros_like(spec_final), spec_final)


def iridescence(normal: torch.Tensor, to_camera: torch.Tensor, mat: LaneMaterial) -> torch.Tensor:
    """Thin-film interference tint."""
    view_angle = clip(dot(normal, to_camera), 0.0, 1.0)
    angle_factor = vabs(view_angle - 0.5) * 2.0
    phase = angle_factor * math.pi * mat.thin_film_thickness * 10.0
    ip = torch.sin(phase)
    hue = (mat.thin_film_ior - 1.0) / 2.0
    r = ip * hue + (1.0 - hue) * (1.0 - ip)
    g = ip * (1.0 - hue) + hue * (1.0 - ip)
    b = 0.5 + 0.5 * ip
    film = torch.stack([r, g, b], dim=-1)
    return film * (mat.thin_film_weight * mat.iridescence_gain)[..., None]


class ShadeResult(NamedTuple):
    """Local shading plus the mirror-continuation weight
    ``refl_coeff = 0.5 * specular_gain * in_light``."""

    color: torch.Tensor  # (N, 3)
    refl_coeff: torch.Tensor  # (N,)


def shade(
    point: torch.Tensor,  # (N, 3) intersection points
    normal: torch.Tensor,  # (N, 3) unit normals
    to_light: torch.Tensor,  # (N, 3) unit dir to the point light
    to_camera: torch.Tensor,  # (N, 3) unit dir to the *original* camera
    in_light: torch.Tensor,  # (N,) shadow visibility in [0, 1]
    mat: LaneMaterial,
    scene: Scene,
) -> ShadeResult:
    """Everything the reference shader computes except the recursion, in its
    term order ``((((ambient + diffuse) + dome) + spec) + iridescence)``."""
    ambient = torch.full_like(point, AMBIENT)

    n_dot_l = relu0(dot(normal, to_light))
    diffuse = texture_color(point, normal, mat, scene) * (n_dot_l * in_light * mat.diffuse_gain)[..., None]

    dome = dome_light(normal, scene.lights)

    spec = ggx_specular(normal, to_light, to_camera, mat)
    spec_term = (spec * mat.specular_gain * in_light)[..., None].expand_as(point)

    irid = iridescence(normal, to_camera, mat)

    color = ambient + diffuse + dome + spec_term + irid
    refl_coeff = 0.5 * mat.specular_gain * in_light
    return ShadeResult(color=color, refl_coeff=refl_coeff)
