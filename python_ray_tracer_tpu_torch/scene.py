"""Scene description as structure-of-arrays tensor dataclasses.

PyTorch port of :mod:`python_ray_tracer_tpu.scene`: every per-sphere
quantity lives in one dense tensor over the sphere axis ``S``, lights are
split by kind, and the camera's ``width``/``height`` and the spheres'
``n_exact`` are plain ints.  Each type moves to a device with an explicit
``.to(device)``; builders take ``device=`` and ``dtype=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Texture kinds: constant color, procedural checker, equirectangular image.
TEXTURE_CONST = 0
TEXTURE_CHECKER = 1
TEXTURE_IMAGE = 2

# Reference-hardcoded material constants.
DEFAULT_SPECULAR_IOR = 1.5
DEFAULT_THIN_FILM_WEIGHT = 0.1
DEFAULT_THIN_FILM_THICKNESS = 0.3
DEFAULT_THIN_FILM_IOR = 1.4

# Host-side partition thresholds: beyond these, |o-c|^2 - r^2 cancels
# catastrophically in float32 and the sphere goes to the exact tier.
EXACT_TIER_RADIUS = 100.0
EXACT_TIER_CENTER = 1000.0


def _to(obj: Any, device: torch.device | str) -> Any:
    """Copy of a tensor dataclass with every tensor field on ``device``."""
    moved = {
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    }
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass
class Camera:
    """Pinhole camera: ``position`` (3,) plus the frame size."""

    position: torch.Tensor  # (3,)
    width: int
    height: int

    def to(self, device: torch.device | str) -> Camera:
        return _to(self, device)


@dataclasses.dataclass
class Lights:
    """One point light plus dense dome arrays.

    With several dome lights their intensities accumulate but only the
    *last* dome light's color is used (reference quirk kept).
    """

    point_position: torch.Tensor  # (3,)
    dome_intensity: torch.Tensor  # (D,)
    dome_color: torch.Tensor  # (D, 3)

    def to(self, device: torch.device | str) -> Lights:
        return _to(self, device)


@dataclasses.dataclass
class Spheres:
    """Dense sphere + material table over the sphere axis ``S``.

    ``n_exact``: number of TRAILING rows that need the compensated
    intersection path in float32 (huge radius or far-off center).
    :func:`build_spheres` orders such spheres last and sets the split.
    """

    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    reflection_gain: torch.Tensor  # (S,) vestigial, never read by shading
    specular_gain: torch.Tensor
    specular_roughness: torch.Tensor
    iridescence_gain: torch.Tensor
    diffuse_gain: torch.Tensor
    diffuse_color: torch.Tensor  # (S, 3)
    specular_ior: torch.Tensor
    thin_film_weight: torch.Tensor
    thin_film_thickness: torch.Tensor
    thin_film_ior: torch.Tensor
    texture_kind: torch.Tensor  # (S,) int32
    texture_id: torch.Tensor  # (S,) int32
    n_exact: int = 0

    @property
    def count(self) -> int:
        return self.center.shape[0]

    def to(self, device: torch.device | str) -> Spheres:
        return _to(self, device)


@dataclasses.dataclass
class Scene:
    """Spheres + lights + camera + texture atlas.

    ``texture_atlas`` is ``(T, Ht, Wt, 3)``; a ``(1, 1, 1, 3)`` dummy means
    no image textures.  ``texture_hw`` is each texture's native (h, w).
    """

    spheres: Spheres
    lights: Lights
    camera: Camera
    texture_atlas: torch.Tensor  # (T, Ht, Wt, 3)
    texture_hw: torch.Tensor  # (T, 2) int32

    @property
    def has_atlas(self) -> bool:
        return self.texture_atlas.shape[1] > 1 or self.texture_atlas.shape[2] > 1

    def to(self, device: torch.device | str) -> Scene:
        return Scene(
            spheres=self.spheres.to(device),
            lights=self.lights.to(device),
            camera=self.camera.to(device),
            texture_atlas=self.texture_atlas.to(device),
            texture_hw=self.texture_hw.to(device),
        )


def make_sphere_row(
    center: Any,
    radius: float,
    *,
    reflection_gain: float = 0.0,
    specular_gain: float = 0.0,
    specular_roughness: float = 0.0,
    iridescence_gain: float = 0.0,
    diffuse_gain: float = 0.0,
    diffuse_color: Any = (1.0, 1.0, 1.0),
    specular_ior: float = DEFAULT_SPECULAR_IOR,
    thin_film_weight: float = DEFAULT_THIN_FILM_WEIGHT,
    thin_film_thickness: float = DEFAULT_THIN_FILM_THICKNESS,
    thin_film_ior: float = DEFAULT_THIN_FILM_IOR,
    texture_kind: int = TEXTURE_CONST,
    texture_id: int = 0,
) -> dict[str, Any]:
    """One sphere's row as a plain dict (stacked later by :func:`build_spheres`)."""
    return dict(
        center=np.asarray(center, dtype=np.float64),
        radius=float(radius),
        reflection_gain=float(reflection_gain),
        specular_gain=float(specular_gain),
        specular_roughness=float(specular_roughness),
        iridescence_gain=float(iridescence_gain),
        diffuse_gain=float(diffuse_gain),
        diffuse_color=np.asarray(diffuse_color, dtype=np.float64),
        specular_ior=float(specular_ior),
        thin_film_weight=float(thin_film_weight),
        thin_film_thickness=float(thin_film_thickness),
        thin_film_ior=float(thin_film_ior),
        texture_kind=int(texture_kind),
        texture_id=int(texture_id),
    )


def _tensor(a: Any, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """float64 numpy -> tensor of ``dtype`` (host-side cast, then moved)."""
    return torch.as_tensor(np.asarray(a)).to(dtype).to(device)


def build_spheres(
    rows: list[dict[str, Any]],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Spheres:
    """Stack per-sphere rows into the dense SoA table.

    Rows are reordered cheap-tier first / exact-tier last (stable within
    each tier) so the float32 sweeps run plain math on the cheap prefix;
    ``n_exact`` records the split.
    """
    if not rows:
        raise ValueError("scene needs at least one sphere")

    def is_exact(r: dict[str, Any]) -> bool:
        return float(r["radius"]) > EXACT_TIER_RADIUS or float(
            np.abs(np.asarray(r["center"])).max()
        ) > EXACT_TIER_CENTER

    rows = sorted(rows, key=is_exact)  # stable: cheap tier keeps input order
    n_exact = sum(1 for r in rows if is_exact(r))

    def col(name: str, d: torch.dtype) -> torch.Tensor:
        return _tensor(np.stack([np.asarray(r[name]) for r in rows]), d, device)

    return Spheres(
        n_exact=n_exact,
        center=col("center", dtype),
        radius=col("radius", dtype),
        reflection_gain=col("reflection_gain", dtype),
        specular_gain=col("specular_gain", dtype),
        specular_roughness=col("specular_roughness", dtype),
        iridescence_gain=col("iridescence_gain", dtype),
        diffuse_gain=col("diffuse_gain", dtype),
        diffuse_color=col("diffuse_color", dtype),
        specular_ior=col("specular_ior", dtype),
        thin_film_weight=col("thin_film_weight", dtype),
        thin_film_thickness=col("thin_film_thickness", dtype),
        thin_film_ior=col("thin_film_ior", dtype),
        texture_kind=col("texture_kind", torch.int32),
        texture_id=col("texture_id", torch.int32),
    )


def build_lights(
    point_position: Any,
    domes: list[tuple[float, Any]] | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Lights:
    """Build the light table. ``domes`` is a list of (intensity, color)."""
    domes = domes or []
    if domes:
        intensity = _tensor([float(d[0]) for d in domes], dtype, device)
        color = _tensor(np.stack([np.asarray(d[1], dtype=np.float64) for d in domes]), dtype, device)
    else:
        intensity = torch.zeros((1,), dtype=dtype, device=device)
        color = torch.ones((1, 3), dtype=dtype, device=device)
    return Lights(
        point_position=_tensor(np.asarray(point_position, dtype=np.float64), dtype, device),
        dome_intensity=intensity,
        dome_color=color,
    )


def make_scene(
    spheres: Spheres,
    lights: Lights,
    camera_position: Any,
    width: int,
    height: int,
    texture_atlas: Any | None = None,
    texture_hw: Any | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Scene:
    if texture_atlas is None:
        texture_atlas = torch.zeros((1, 1, 1, 3), dtype=dtype, device=device)
    else:
        texture_atlas = torch.as_tensor(texture_atlas).to(dtype).to(device)
    if texture_hw is None:
        # Every texture assumed to fill the atlas slot (single-size case).
        t = texture_atlas.shape[0]
        texture_hw = np.tile(
            np.asarray([[texture_atlas.shape[1], texture_atlas.shape[2]]], np.int32), (t, 1)
        )
    cam = Camera(
        position=_tensor(np.asarray(camera_position, dtype=np.float64), dtype, device),
        width=int(width),
        height=int(height),
    )
    return Scene(
        spheres=spheres,
        lights=lights,
        camera=cam,
        texture_atlas=texture_atlas,
        texture_hw=_tensor(texture_hw, torch.int32, device),
    )
