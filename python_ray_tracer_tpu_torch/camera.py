"""Camera ray generation (port of :mod:`python_ray_tracer_tpu.camera`).

Screen rectangle ``x in [-1, 1]``, ``y in [1/aspect + 0.25, -1/aspect + 0.25]``
(the reference's +0.25 vertical lift), image plane at ``z = 0``.  The pixel
grid is built with numpy ``linspace`` in float64 and then cast, exactly as
the JAX package does: ``torch.linspace`` rounds differently.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.vecmath import normalize, sqrt
from .scene import Camera


def pixel_grid(width: int, height: int, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """Flattened (H*W, 3) grid of image-plane points at z=0 (row-major).

    The two axes come from numpy ``linspace`` in float64; tiling them into
    the grid and the final cast happen on ``device`` (pure copies, then one
    rounding: the same values as tiling in numpy, without building and
    copying a 12 MB float64 grid on the host for every frame).
    """
    aspect_ratio = float(width) / float(height)
    screen = (-1.0, 1.0 / aspect_ratio + 0.25, 1.0, -1.0 / aspect_ratio + 0.25)
    xs = torch.from_numpy(np.linspace(screen[0], screen[2], width)).to(device)
    ys = torch.from_numpy(np.linspace(screen[1], screen[3], height)).to(device)
    x = xs.repeat(height)  # np.tile
    y = ys.repeat_interleave(width)  # np.repeat
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1).to(dtype)


def pixel_pitch(width: int, height: int) -> tuple[float, float]:
    """Screen-space (dx, dy) between adjacent pixel centers."""
    aspect_ratio = float(width) / float(height)
    dx = 2.0 / (width - 1) if width > 1 else 0.0
    dy = (2.0 / aspect_ratio) / (height - 1) if height > 1 else 0.0
    return dx, dy


def ray_directions_t(camera: Camera, dtype: torch.dtype, jitter_t: torch.Tensor | None = None) -> torch.Tensor:
    """(3, H*W) unit ray directions, component axis first (the kernels' layout).

    ``jitter_t`` is an optional (2, H*W) subpixel offset in pixel units.
    """
    pos = camera.position.to(dtype)
    grid = pixel_grid(camera.width, camera.height, dtype, pos.device).T  # (3, N)
    if jitter_t is not None:
        dx, dy = pixel_pitch(camera.width, camera.height)
        pitch = torch.tensor([dx, -dy], dtype=dtype, device=pos.device)
        grid = torch.cat([grid[0:2] + jitter_t.to(dtype) * pitch[:, None], grid[2:3]])
    v = grid - pos[:, None]
    mag = sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    inv = 1.0 / torch.where(mag == 0, torch.ones_like(mag), mag)
    return (v * inv[None, :]).contiguous()


def ray_directions(camera: Camera, dtype: torch.dtype, jitter: torch.Tensor | None = None) -> torch.Tensor:
    """(H*W, 3) unit ray directions from the camera through the pixel grid.

    ``jitter`` is an optional (H*W, 2) subpixel offset in [-0.5, 0.5) pixel
    units (supersampling); None keeps the reference's center rays.
    """
    pos = camera.position.to(dtype)
    grid = pixel_grid(camera.width, camera.height, dtype, pos.device)
    if jitter is not None:
        dx, dy = pixel_pitch(camera.width, camera.height)
        pitch = torch.tensor([dx, -dy, 0.0], dtype=dtype, device=pos.device)  # y decreases downward
        offs = torch.cat([jitter.to(dtype), torch.zeros_like(jitter[:, :1], dtype=dtype)], dim=1)
        grid = grid + offs * pitch[None, :]
    return normalize(grid - pos[None, :])
