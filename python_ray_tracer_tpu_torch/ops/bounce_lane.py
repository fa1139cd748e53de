"""Lane-layout hard bounce kernel: wrapper, plain version and the trace.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_bounce`.  Its TPU kernel
``_bounce_kernel``, one fused hard bounce a launch that ``trace_fused`` scans
``max_depth`` times, becomes the CUDA kernel ``bounce_lane`` in
``csrc/bounce_lane.cu``: one thread per ray over the (3, N) layout of
:func:`..camera.ray_directions_t`, the geometry staged in shared memory while
that keeps as many blocks resident on an SM as global reads do and read from
global memory past that, the winner's material row and the texel read
straight from global memory.  The JAX renderer takes it for the
hard scenes its other kernels leave (:func:`..render.hard_route`): 65-95
spheres, or more with over 8 in the exact tier, mirror bounces, image atlases
of at most MAX_FUSED_TEXELS texels.

Unlike the sub and culled kernels' atlas mode, which export texel ids and
weights for :func:`.texture.compose_texels`, this kernel reads each image
lane's nearest texel itself and adds it inside the colour sum, ``amb +
tex * diffuse_w + dome + spec + irid``, before the sum is weighted, as the
JAX kernel does; the texel ids are :func:`.texture.flat_texel`'s.

:func:`bounce_lane_plain` is the JAX kernel body term for term: the
standalone sweeps' plain versions (:mod:`.intersect_fused`, the same two
tiers) for the nearest hit and the hard shadow, and
:func:`.bounce_sub.shade_color` with the texel inside the sum.  (The plain
shadow sweep starts its minima from 1e300 in f64 where the kernel starts from
3e38; every hit distance lies far below both and a miss is ``faraway``, so
the lit test comes out the same.)  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.  The JAX kernel
has no gradient, and the wrapper refuses tensors that require grad.
The material and texel reads are exact in f64, where the JAX kernel's
one-hot products accumulate in float32.

:data:`LAUNCHES` counts the launches without an atlas, :data:`ATLAS_LAUNCHES`
those with one.
"""

from __future__ import annotations

import torch

from . import _build
from .bounce_sub import _dot3, _normalize3, shade_color
from .intersect_fused import nearest_sweep_plain, shadow_sweep_plain
from .shading import NUDGE
from .tables import CX, CY, CZ, MAT_COLS, N_CONST, RAD, SG, consts_row, geometry_table, material_table
from .texture import MAX_FUSED_TEXELS, atlas_texels, slot_args

LAUNCHES = {"bounce_lane": 0}
ATLAS_LAUNCHES = {"bounce_lane": 0}

_SOURCE = "bounce_lane.cu"

# C signature of the entry in csrc/bounce_lane.cu, before the trailing
# stream: o, d, thr, alive, acc, their five outputs, geom, mat, consts,
# texels (or null); n, s_cheap, s_total; faraway; the atlas's slot extents;
# where the geometry is read (_GEOMETRY).
_SIGNATURE = "ppppp" "ppppp" "pppp" "iii" "r" "ii" "i"
_GEOMETRY = {"auto": -1, "global": 0, "shared": 1}


def bounce_lane_plain(o, d, thr, alive, acc, geom, mat, consts, texels=None, *, faraway: float, s_cheap: int,
                      tex_hw=None):
    """Plain version of ``bounce_lane``: the next ``(o, d, thr, alive, acc)``
    of rays ``o``/``d``/``acc`` (3, N) and lanes ``thr``/``alive`` (N,)."""
    dtype = o.dtype
    tmin, idx = nearest_sweep_plain(o.T, d.T, geom, faraway=faraway, s_cheap=s_cheap)
    hit = (tmin != faraway).to(dtype)
    coverage = hit * alive
    t_safe = torch.where(hit > 0, tmin, 1.0)

    rows = mat[idx.long()].T  # (MAT_COLS, N): the per-lane material select

    def m(col):
        return rows[col]

    def const(i):
        return consts[0, i]

    p = tuple(o[i] + d[i] * t_safe for i in range(3))
    inv_r = 1.0 / m(RAD)
    center = (m(CX), m(CY), m(CZ))
    normal = tuple((p[i] - center[i]) * inv_r for i in range(3))
    to_light = _normalize3(tuple(const(3 + i) - p[i] for i in range(3)))
    to_cam = _normalize3(tuple(const(i) - p[i] for i in range(3)))
    p_n = tuple(p[i] + normal[i] * NUDGE for i in range(3))

    in_light = shadow_sweep_plain(torch.stack(p_n, 1), torch.stack(to_light, 1), geom, idx, faraway=faraway,
                                  s_cheap=s_cheap)
    color = shade_color(p, normal, to_light, to_cam, in_light, m, const, tex_hw, texels)
    if tex_hw is not None:
        color = color[0]

    w = thr * coverage
    refl_coeff = 0.5 * m(SG) * in_light
    ddn = 2.0 * _dot3(d, normal)
    refl = _normalize3(tuple(d[i] - normal[i] * ddn for i in range(3)))
    acc_next = torch.stack([acc[i] + color[i] * w for i in range(3)])
    return torch.stack(p_n), torch.stack(refl), w * refl_coeff, alive * hit, acc_next


def _check(o, d, thr, alive, acc, geom, mat, consts, texels, s_cheap: int, tex_hw) -> torch.device:
    """Validate what the kernel takes; returns the common device."""
    n = o.shape[-1]
    s = geom.shape[0]
    tensors = dict(o=o, d=d, thr=thr, alive=alive, acc=acc, geom=geom, mat=mat, consts=consts)
    if texels is not None:
        tensors["texels"] = texels
    for name, t in tensors.items():
        if t.requires_grad:
            raise ValueError(f"{name}: the lane bounce kernel has no gradient; pass a detached tensor")
        if t.device != o.device or t.dtype != o.dtype:
            raise ValueError(f"{name}: expected {o.dtype} on {o.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, t in (("o", o), ("d", d), ("acc", acc)):
        if t.shape != (3, n):
            raise ValueError(f"{name}: expected shape (3, {n}), got {tuple(t.shape)}")
    for name, t in (("thr", thr), ("alive", alive)):
        if t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if geom.shape != (s, 4) or mat.shape != (s, MAT_COLS) or consts.shape != (1, N_CONST):
        raise ValueError("tables: expected geom (S, 4), mat (S, 19) and consts (1, 16)")
    if s < 1 or not 0 <= s_cheap <= s:
        raise ValueError(f"expected S >= 1 spheres and s_cheap in 0..S, got S = {s}, s_cheap = {s_cheap}")
    if (texels is None) != (tex_hw is None):
        raise ValueError("texels and tex_hw go together: the atlas's texel table and its slot extents")
    if texels is not None:
        slot = int(tex_hw[0]) * int(tex_hw[1])
        rows = texels.shape[0]
        if texels.shape != (rows, 3) or slot < 1 or rows % slot or not 0 < rows <= MAX_FUSED_TEXELS:
            raise ValueError(
                f"texels: expected (T * Hpad * Wpad, 3) with at most {MAX_FUSED_TEXELS} rows for slots "
                f"{tuple(tex_hw)}, got {tuple(texels.shape)}"
            )
    if n == 0:
        raise ValueError("no rays to trace")
    if o.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {o.dtype}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")
    return o.device


def bounce_lane(o, d, thr, alive, acc, geom, mat, consts, texels=None, *, faraway: float, s_cheap: int,
                tex_hw=None, geometry: str = "auto"):
    """One hard bounce of rays ``o``/``d``/``acc`` (3, N), ``thr``/``alive``
    (N,) over the tables ``geom`` (S, 4), ``mat`` (S, 19), ``consts`` (1, 16),
    rows ``s_cheap..S`` in the exact tier; returns the next ``(o, d, thr,
    alive, acc)``.  With an atlas, ``texels`` (T * Hpad * Wpad, 3) and its
    slot extents ``tex_hw = (Hpad, Wpad)``: image lanes shade their texel.
    ``geometry`` ("auto", "shared" or "global") is where the kernel reads the
    sphere table; the result is the same bitwise, and the card check forces
    each side to time it."""
    if geometry not in _GEOMETRY:
        raise ValueError(f"geometry: expected one of {sorted(_GEOMETRY)}, got {geometry!r}")
    device = _check(o, d, thr, alive, acc, geom, mat, consts, texels, s_cheap, tex_hw)
    kw = dict(faraway=faraway, s_cheap=s_cheap, tex_hw=tex_hw)
    if device.type == "cpu":
        return bounce_lane_plain(o, d, thr, alive, acc, geom, mat, consts, texels, **kw)
    with torch.cuda.device(device):
        out = tuple(torch.empty_like(t) for t in (o, d, thr, alive, acc))
        _build.launch(
            _SOURCE, "bounce_lane", _SIGNATURE, o.dtype, o, d, thr, alive, acc, *out, geom, mat, consts, texels,
            o.shape[1], s_cheap, geom.shape[0], float(faraway), *slot_args(tex_hw), _GEOMETRY[geometry],
        )
        (LAUNCHES if texels is None else ATLAS_LAUNCHES)["bounce_lane"] += 1
    return out


def trace_fused_lane(origin: torch.Tensor, dirs_t: torch.Tensor, scene, cfg) -> torch.Tensor:
    """Hard-visibility trace through ``bounce_lane``, one launch a bounce:
    (N, 3) colors of the rays ``dirs_t`` (3, N) from ``origin`` (3,) or
    (3, N).  An atlas scene (at most MAX_FUSED_TEXELS texels) shades its
    texels in the kernel."""
    dtype = cfg.dtype
    d = dirs_t.to(dtype).contiguous()
    o = origin.to(dtype).reshape(3, -1).expand(d.shape).contiguous()
    geom, mat, consts = geometry_table(scene, dtype), material_table(scene, dtype), consts_row(scene, dtype)
    texels, tex_hw = atlas_texels(scene, dtype)
    if texels is not None:
        texels = texels.contiguous()
    kw = dict(faraway=cfg.faraway, s_cheap=scene.spheres.count - scene.spheres.n_exact, tex_hw=tex_hw)
    thr, alive, acc = torch.ones_like(d[0]), torch.ones_like(d[0]), torch.zeros_like(d)
    for _ in range(cfg.max_depth):
        o, d, thr, alive, acc = bounce_lane(o, d, thr, alive, acc, geom, mat, consts, texels, **kw)
    return acc.T
