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


def ray_directions_t(camera: Camera, dtype: torch.dtype) -> torch.Tensor:
    """(3, H*W) unit ray directions, component axis first (the kernels' layout)."""
    pos = camera.position.to(dtype)
    grid = pixel_grid(camera.width, camera.height, dtype, pos.device).T  # (3, N)
    v = grid - pos[:, None]
    mag = sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    inv = 1.0 / torch.where(mag == 0, torch.ones_like(mag), mag)
    return (v * inv[None, :]).contiguous()


def ray_directions(camera: Camera, dtype: torch.dtype) -> torch.Tensor:
    """(H*W, 3) unit ray directions from the camera through the pixel grid."""
    pos = camera.position.to(dtype)
    grid = pixel_grid(camera.width, camera.height, dtype, pos.device)
    return normalize(grid - pos[None, :])
