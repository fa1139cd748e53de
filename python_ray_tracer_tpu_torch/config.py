"""Render configuration (PyTorch port of :mod:`python_ray_tracer_tpu.config`).

The fields, defaults and validation are the JAX package's, so a config
written for one package reads the same in the other.  ``dtype`` is a torch
dtype here.
"""

from __future__ import annotations

import dataclasses

import torch

# Sentinel distance for "ray missed" (reference FARAWAY = 1e39).  1e39 only
# fits in float64; float32 uses a large finite value so masked-lane
# arithmetic never produces inf/nan.
_FARAWAY = {
    torch.float64: 1.0e39,
    torch.float32: 1.0e30,
}

VISIBILITY_HARD = "hard"
VISIBILITY_SMOOTH = "smooth"


def faraway(dtype: torch.dtype) -> float:
    return _FARAWAY[dtype]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering options; see the JAX ``RenderConfig`` for each field.

    ``use_pallas`` keeps its JAX name: here it routes the render through the
    hand-written CUDA bounce kernels (:mod:`.ops.bounce_sub`) instead of the
    pure-torch bounce loop.  ``block_rays``, ``block_spheres`` and
    ``pallas_interpret`` are TPU tiling and interpreter knobs kept for
    parity; the CUDA kernels pick their own launch shape, and interpret
    mode is refused by :func:`..render.render`.
    """

    max_depth: int = 3
    dtype: torch.dtype = torch.float32
    visibility: str = VISIBILITY_HARD
    edge_sharpness: float = 200.0
    shadow_sharpness: float = 200.0
    use_pallas: bool = False
    block_rays: int = 512
    block_spheres: int = 256
    pallas_interpret: bool = False
    ray_chunk: int = 0
    remat: bool = False
    samples_per_pixel: int = 1
    stochastic_roughness: bool = False
    rng_seed: int = 0
    intersect_mode: str = "auto"
    tie_mode: str = "first"

    def __post_init__(self) -> None:
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.samples_per_pixel < 1:
            raise ValueError("samples_per_pixel must be >= 1")
        if self.visibility not in (VISIBILITY_HARD, VISIBILITY_SMOOTH):
            raise ValueError(f"unknown visibility mode: {self.visibility}")
        if self.intersect_mode not in ("auto", "reference", "stable"):
            raise ValueError(f"unknown intersect mode: {self.intersect_mode}")
        if self.tie_mode not in ("first", "sum"):
            raise ValueError(f"unknown tie mode: {self.tie_mode}")
        if self.dtype not in _FARAWAY:
            raise ValueError(f"unsupported compute dtype: {self.dtype}")

    @property
    def stable_intersect(self) -> bool:
        """Use the compensated-arithmetic sweep (float32 default).

        ``auto``: float64 keeps the reference's exact coefficient form;
        float32 gets the hardened two-tier form.
        """
        if self.intersect_mode == "auto":
            return self.dtype != torch.float64
        return self.intersect_mode == "stable"

    @property
    def faraway(self) -> float:
        return faraway(self.dtype)
