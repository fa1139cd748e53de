"""Non-local-means image denoiser.

Port of :mod:`python_ray_tracer_tpu.utils.denoise` (the counterpart of the
reference's orphan ``cv2.fastNlMeansDenoisingColored`` wrapper, which the old
settings schema's ``denoise`` flag asked for): a loop over the search
offsets, each a shifted copy of the image and a box-filtered patch distance,
in plain torch on the image's device.

Two borders differ, as in the JAX function: the shifted copies read a
**reflect**-padded image (OpenCV's border default, no wraparound), while the
patch box sum pads with **zeros** (``reduce_window`` with SAME padding and
init 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W) sliding-window sum of ``size`` x ``size``, zero-padded to keep
    the shape (SAME padding: ``(size - 1) // 2`` before, the rest after)."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    padded = F.pad(x, (lo, hi, lo, hi))
    h, w = x.shape
    out = torch.zeros_like(x)
    for i in range(size):
        for j in range(size):
            out = out + padded[i : i + h, j : j + w]
    return out


def nl_means_denoise(
    image: torch.Tensor,  # (H, W, 3) float in [0, 1]
    strength: float = 0.05,
    patch_size: int = 3,
    search_radius: int = 4,
) -> torch.Tensor:
    """Non-local means: each pixel averages similar patches nearby.

    Weights are ``exp(-patch_SSD / (strength^2 * patch_size^2 * 3))`` over a
    ``(2 * search_radius + 1)^2`` neighbourhood; larger ``strength`` smooths
    more (the reference's ``h = 3 / 255``).
    """
    h2 = torch.tensor(strength, dtype=image.dtype, device=image.device) ** 2
    acc = torch.zeros_like(image)
    wsum = torch.zeros(image.shape[:2], dtype=image.dtype, device=image.device)
    r = search_radius
    hh, ww = image.shape[:2]
    padded = F.pad(image.permute(2, 0, 1)[None], (r, r, r, r), mode="reflect")[0].permute(1, 2, 0)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            # shifted[y, x] = image_reflected[y - dy, x - dx]
            shifted = padded[r - dy : r - dy + hh, r - dx : r - dx + ww, :]
            diff = image - shifted
            ssd = _box_sum(torch.sum(diff * diff, dim=-1), patch_size)
            w = torch.exp(-ssd / (h2 * patch_size * patch_size * 3.0))
            acc = acc + shifted * w[..., None]
            wsum = wsum + w
    return acc / wsum[..., None]
