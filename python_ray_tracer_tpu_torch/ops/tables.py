"""The bounce kernels' side tables, built from a :class:`..scene.Scene`.

Port of ``_material_table`` (``ops/pallas_bounce.py``), ``_geometry_table``
and ``_consts_row`` (``ops/pallas_bounce_sub.py``) of the JAX package.  The
column orders are the kernels' ABI: ``csrc/bounce_sub.cu`` reads them by
the same indices.
"""

from __future__ import annotations

import torch

from ..scene import Scene

# Material-table columns (kind, texture id and native texture extents are
# stored as small exact floats).
MAT_COLS = 19
(
    CX, CY, CZ, RAD, DG, DCR, DCG, DCB, SG, ROUGH, IG, IOR,
    TFW, TFT, TFI, KIND, TID, TEXH, TEXW,
) = range(MAT_COLS)

# Consts row: camera (0:3), point light (3:6), LAST dome color (6:9), SUM
# of dome intensities (9); the rest is zero.
N_CONST = 16


def material_table(scene: Scene, dtype: torch.dtype) -> torch.Tensor:
    """(S, 19) material table in kernel column order (unpadded)."""
    sp = scene.spheres
    hw = scene.texture_hw[sp.texture_id.long()]  # (S, 2) int32
    cols = [
        sp.center[:, 0], sp.center[:, 1], sp.center[:, 2], sp.radius,
        sp.diffuse_gain, sp.diffuse_color[:, 0], sp.diffuse_color[:, 1], sp.diffuse_color[:, 2],
        sp.specular_gain, sp.specular_roughness, sp.iridescence_gain, sp.specular_ior,
        sp.thin_film_weight, sp.thin_film_thickness, sp.thin_film_ior,
        sp.texture_kind, sp.texture_id, hw[:, 0], hw[:, 1],
    ]
    return torch.stack([c.to(dtype) for c in cols], dim=1).contiguous()


def geometry_table(scene: Scene, dtype: torch.dtype) -> torch.Tensor:
    """(S, 4) ``[cx, cy, cz, r]``."""
    sp = scene.spheres
    return torch.cat([sp.center.to(dtype), sp.radius.to(dtype)[:, None]], dim=1).contiguous()


def consts_row(scene: Scene, dtype: torch.dtype) -> torch.Tensor:
    """(1, 16) scene constants; see :data:`N_CONST` for the layout."""
    lights = scene.lights
    consts = torch.zeros((1, N_CONST), dtype=dtype, device=scene.camera.position.device)
    consts[0, 0:3] = scene.camera.position.to(dtype)
    consts[0, 3:6] = lights.point_position.to(dtype)
    consts[0, 6:9] = lights.dome_color[-1].to(dtype)
    consts[0, 9] = torch.sum(lights.dome_intensity.to(dtype))
    return consts
