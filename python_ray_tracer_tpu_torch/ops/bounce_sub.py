"""Hard-visibility bounce kernels: wrappers, plain versions and the trace.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_bounce_sub`.  The two TPU
kernels there, ``_trace_kernel_sub_deep`` (the whole bounce chain in one
launch) and ``_bounce_kernel_sub`` (one bounce per launch), become the
CUDA kernels ``trace_deep`` and ``bounce_step`` in ``csrc/bounce_sub.cu``:
one thread per ray over the (3, N) layout that
:func:`..camera.ray_directions_t` gives, with the sphere, material and
scene tables staged in shared memory.

Beside each kernel sits its plain PyTorch version.  :func:`bounce_math` is
the term-for-term mirror of the JAX kernel body ``_bounce_math`` (with
``parts="full"``), the glossy xi continuation and the atlas mode included:
given the atlas's slot extents ``tex_hw``, each kernel also returns each
bounce's flat texel ids and ``dww`` weights (:mod:`.texture`), and
:func:`trace_fused_sub` composes the texels after the launch, as the JAX
package does.  A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises.  The hard path has no
gradient in the JAX package either, so the wrappers refuse tensors that
require grad.

:data:`LAUNCHES` counts kernel launches, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from . import _build
from .bounce_smooth import norm3
from .rng import bounce_xi
from .shading import AMBIENT, GLINT_EXPONENT, NUDGE, SHADING_EPS
from .tables import (
    CX, CY, CZ, DCB, DCG, DCR, DG, IG, IOR, KIND, MAT_COLS, N_CONST, RAD, ROUGH, SG, TEXH, TEXW, TFI, TFT, TFW, TID,
    consts_row, geometry_table, material_table,
)
from .texture import atlas_texels, compose_texels, flat_texel, slot_args
from .vecmath import ipow, sqrt

# The kernels stage the side tables in fixed-size shared arrays of this many
# rows (csrc/bounce_sub.cu kMaxSpheres); it is also the JAX package's
# MAX_SUB_SPHERES, above which the JAX renderer takes other kernels.
MAX_SUB_SPHERES = 64

# Shadow-sweep sentinel of the JAX kernel body.
_BIG = 3.0e38

LAUNCHES = {"trace_deep": 0, "bounce_step": 0}
# Launches of the kernels' atlas mode.
ATLAS_LAUNCHES = {"trace_deep": 0, "bounce_step": 0}

_SOURCE = "bounce_sub.cu"


# ---------------------------------------------------------------------------
# Plain versions: the JAX kernel body, term for term, on (N,) rows.
# ---------------------------------------------------------------------------


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(v):
    mag = sqrt(_dot3(v, v))
    inv = 1.0 / torch.where(mag == 0, 1.0, mag)
    return tuple(c * inv for c in v)


def _roots(b, ct, faraway):
    disc = b * b - 4.0 * ct
    pos = disc > 0
    sq = torch.where(pos, sqrt(torch.where(pos, disc, 1.0)), 0.0)
    qroot = -0.5 * (b + torch.where(b < 0, -sq, sq))
    safe_q = torch.where(qroot == 0, 1.0, qroot)
    other = torch.where(qroot == 0, 0.0, ct / safe_q)
    t0 = torch.minimum(qroot, other)
    t1 = torch.maximum(qroot, other)
    sol = torch.where((t0 > 0) & (t0 < t1), t0, t1)
    return torch.where(pos & (sol > 0), sol, faraway)


def _sphere_t(o, d, cx, cy, cz, r, faraway):
    """Hit distance of ONE sphere: plain well-conditioned quadratic."""
    ocx = o[0] - cx
    ocy = o[1] - cy
    ocz = o[2] - cz
    b = 2.0 * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    ct = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return _roots(b, ct, faraway)


def _sphere_t_exact(o, d, cx, cy, cz, r, faraway):
    """Exact-tier distance: compensated ``|o-c|^2 - r^2`` for huge spheres.

    The Dekker splitter is 4097 in every dtype, as in the JAX kernel.
    """
    h, lo = [], []
    for oi, ci in zip(o, (cx, cy, cz)):
        s = oi - ci
        bv = s - oi
        h.append(s)
        lo.append((oi - (s - bv)) + (-ci - bv))
    b = 2.0 * ((d[0] * h[0] + d[1] * h[1] + d[2] * h[2]) + (d[0] * lo[0] + d[1] * lo[1] + d[2] * lo[2]))

    def two_prod(a):
        p = a * a
        c = a * 4097.0
        hi = c - (c - a)
        low = a - hi
        return p, ((hi * hi - p) + 2.0 * hi * low) + low * low

    p0, e0 = two_prod(h[0])
    p1, e1 = two_prod(h[1])
    p2, e2 = two_prod(h[2])
    r2 = r * r
    rc = r * 4097.0
    rhi = rc - (rc - r)
    rlo = r - rhi
    er = ((rhi * rhi - r2) + 2.0 * rhi * rlo) + rlo * rlo

    def two_sum(a, b_):
        s = a + b_
        bv = s - a
        return s, (a - (s - bv)) + (b_ - bv)

    s1, t1 = two_sum(p0, p1)
    s2, t2 = two_sum(s1, p2)
    s3, t3 = two_sum(s2, -r2)
    corr = (
        (t1 + t2 + t3)
        + (e0 + e1 + e2 - er)
        + 2.0 * (h[0] * lo[0] + h[1] * lo[1] + h[2] * lo[2])
        + (lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2])
    )
    return _roots(b, s3 + corr, faraway)


def _sweep(o, d, geom, s_cheap, faraway, update):
    """``update(k, t_k, carry)`` over every sphere: cheap tier, then exact."""
    carry = None
    for k in range(geom.shape[0]):
        fn = _sphere_t if k < s_cheap else _sphere_t_exact
        carry = update(k, fn(o, d, geom[k, 0], geom[k, 1], geom[k, 2], geom[k, 3], faraway), carry)
    return carry


def ggx_continuation(d, normal, refl, alpha, xi) -> SimpleNamespace:
    """The glossy continuation of the JAX kernel bodies: reflect ``d`` about
    a GGX-sampled microfacet around ``normal`` (``ops.vecmath.
    ggx_perturb_reflect`` term for term, ``alpha = roughness^2``) and keep
    the mirror ``refl`` where the sample leaves below the surface.  Rows are
    3-tuples of (N,); ``xi = (xi1, xi2)`` (N,) uniforms.  Returns ``dout``
    and every intermediate the smooth adjoint reads."""
    g = SimpleNamespace(xi=xi)
    xi1, xi2 = xi
    g.t2q = ipow(alpha, 2) * xi1 / torch.clamp_min(1.0 - xi1, 1e-8)
    g.cos_t = 1.0 / sqrt(1.0 + g.t2q)
    g.sin_t = sqrt(torch.clamp_min(1.0 - ipow(g.cos_t, 2), 0.0))
    phi = (2.0 * math.pi) * xi2
    g.cphi = torch.cos(phi)
    g.sphi = torch.sin(phi)
    one = torch.ones_like(normal[2])
    g.s_sign = torch.where(normal[2] >= 0, one, -one)
    g.a_b = -1.0 / (g.s_sign + normal[2])
    b_b = normal[0] * normal[1] * g.a_b
    g.t1v = (1.0 + g.s_sign * normal[0] * normal[0] * g.a_b, g.s_sign * b_b, -g.s_sign * normal[0])
    g.t2v = (b_b, g.s_sign + normal[1] * normal[1] * g.a_b, -normal[1])
    g.sc = g.sin_t * g.cphi
    g.ss = g.sin_t * g.sphi
    g.hvec, g.hw_mag = norm3(tuple(g.t1v[i] * g.sc + g.t2v[i] * g.ss + normal[i] * g.cos_t for i in range(3)))
    g.dhn = 2.0 * _dot3(d, g.hvec)
    g.r_pert, g.r_mag = norm3(tuple(d[i] - g.hvec[i] * g.dhn for i in range(3)))
    # Below-surface samples keep the mirror; the gate is piecewise constant.
    g.pert = _dot3(g.r_pert, normal) > 0
    g.dout = tuple(torch.where(g.pert, g.r_pert[i], refl[i]) for i in range(3))
    return g


def image_texels(normal, m, tex, tex_hw, texels=None):
    """The atlas mode's texture step of the JAX kernel bodies: ``(tex, flat,
    is_image)``, the diffuse texture ``tex`` (3-tuple of (N,)) zeroed on
    image lanes and their flat texel ids (0 elsewhere).  Given the texel
    table ``texels`` (T * Hpad * Wpad, 3), image lanes take their texel as
    the diffuse texture instead, as the lane-layout kernel does
    (``ops/pallas_bounce.py`` :227-260)."""
    is_image = m(KIND) == 2.0
    flat = torch.where(is_image, flat_texel(normal, m(TID), m(TEXH), m(TEXW), tex_hw), 0)
    if texels is None:
        tex = tuple(torch.where(is_image, torch.zeros_like(t), t) for t in tex)
    else:
        img = texels[flat.long()].T
        tex = tuple(torch.where(is_image, img[i], t) for i, t in enumerate(tex))
    return tex, flat, is_image


def shade_color(p, normal, to_light, to_cam, in_light, m, const, tex_hw=None, texels=None):
    """The local color of a hit, the JAX kernel bodies' shading
    (``ops/shading.py`` term for term) on rows: ``p``, ``normal``,
    ``to_light``, ``to_cam`` 3-tuples of (N,), ``in_light`` (N,), ``m(col)``
    the winner's material column, ``const(i)`` a scene constant.  With the
    atlas's slot extents ``tex_hw`` returns ``(color, flat, is_image,
    diffuse_w)``: image lanes' diffuse texture is left to the caller, or,
    given the texel table ``texels``, is their texel, inside the sum."""
    n_dot_l = torch.clamp_min(_dot3(normal, to_light), 0.0)
    cx_i = torch.trunc(p[0] * 2.0).to(torch.int32) % 2
    cz_i = torch.trunc(p[2] * 2.0).to(torch.int32) % 2
    checker = (cx_i == cz_i).to(p[0].dtype)
    is_checker = m(KIND) == 1.0
    tex = tuple(torch.where(is_checker, checker, m(c)) for c in (DCR, DCG, DCB))
    if tex_hw is not None:
        tex, flat, is_image = image_texels(normal, m, tex, tex_hw, texels)

    diffuse_w = n_dot_l * in_light * m(DG)

    dome_up = torch.clamp_min(normal[1], 0.0) * const(9)
    dome = (const(6) * dome_up, const(7) * dome_up, const(8) * dome_up)

    L = to_light
    V = to_cam
    H = _normalize3(tuple(L[i] + V[i] for i in range(3)))
    n_dot_v = torch.clamp(_dot3(normal, V), 0.0, 1.0)
    n_dot_h = torch.clamp(_dot3(normal, H), 0.0, 1.0)
    v_dot_h = torch.clamp(_dot3(V, H), 0.0, 1.0)
    n_dot_l_c = torch.clamp(_dot3(normal, L), 0.0, 1.0)
    ior = m(IOR)
    f0 = ipow((ior - 1.0) / (ior + 1.0), 2)
    fresnel = f0 + (1.0 - f0) * ipow(1.0 - v_dot_h, 5)
    alpha = ipow(m(ROUGH), 2)
    alpha2 = ipow(alpha, 2)
    denom = ipow(n_dot_h, 2) * (alpha2 - 1.0) + 1.0
    dist = alpha2 / (math.pi * (ipow(denom, 2) + SHADING_EPS))

    def g1(x):
        return 2.0 * x / (x + sqrt(alpha2 + (1.0 - alpha2) * ipow(x, 2)) + SHADING_EPS)

    geom_term = g1(n_dot_l_c) * g1(n_dot_v)
    spec_base = (fresnel * dist * geom_term) / (4.0 * n_dot_v + SHADING_EPS)
    glint = torch.pow(1.0 - n_dot_v, GLINT_EXPONENT) * n_dot_l_c
    spec = torch.where(n_dot_v <= 0, 0.0, spec_base + m(SG) * glint)
    spec_term = spec * m(SG) * in_light

    view_angle = torch.clamp(_dot3(normal, to_cam), 0.0, 1.0)
    angle_factor = torch.abs(view_angle - 0.5) * 2.0
    phase = angle_factor * math.pi * m(TFT) * 10.0
    ip = torch.sin(phase)
    hue = (m(TFI) - 1.0) / 2.0
    irid_w = m(TFW) * m(IG)
    irid = (
        (ip * hue + (1.0 - hue) * (1.0 - ip)) * irid_w,
        (ip * (1.0 - hue) + hue * (1.0 - ip)) * irid_w,
        (0.5 + 0.5 * ip) * irid_w,
    )

    color = tuple(AMBIENT + tex[i] * diffuse_w + dome[i] + spec_term + irid[i] for i in range(3))
    return color if tex_hw is None else (color, flat, is_image, diffuse_w)


def bounce_math(o, d, thr, alive, geom, mat, consts, xi=None, *, faraway: float, s_cheap: int, tex_hw=None):
    """One hard bounce on rows ``o``/``d`` (3-tuples of (N,)), ``thr`` and
    ``alive`` (N,); ``xi`` (two (N,) rows) makes the continuation glossy.
    Returns ``(acc_add, o_next, d_next, thr_next, alive_next, flat, dww)``;
    ``flat`` and ``dww`` (the atlas mode's texel ids and weights, given the
    atlas's slot extents ``tex_hw``) are None without an atlas."""
    dtype = o[0].dtype
    far = torch.tensor(faraway, dtype=dtype, device=o[0].device)

    def near_update(k, t_k, carry):
        if carry is None:
            return t_k, torch.full_like(t_k, k, dtype=torch.int32)
        tmin, imin = carry
        take = t_k < tmin
        return torch.where(take, t_k, tmin), torch.where(take, k, imin)

    tmin, idx = _sweep(o, d, geom, s_cheap, far, near_update)
    hit = (tmin != far).to(dtype)
    idx = torch.where(tmin == far, 0, idx)
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

    light = (const(3), const(4), const(5))
    cam = (const(0), const(1), const(2))
    to_light = _normalize3(tuple(light[i] - p[i] for i in range(3)))
    to_cam = _normalize3(tuple(cam[i] - p[i] for i in range(3)))
    p_n = tuple(p[i] + normal[i] * NUDGE for i in range(3))

    # Hard shadow: lit iff own sphere nearest along the light ray.
    big = torch.tensor(_BIG, dtype=dtype, device=o[0].device)

    def shadow_update(k, t_k, carry):
        if carry is None:
            carry = (torch.full_like(t_k, _BIG), torch.full_like(t_k, _BIG))
        t_others, t_self = carry
        is_self = idx == k
        return (
            torch.minimum(t_others, torch.where(is_self, big, t_k)),
            torch.where(is_self, torch.minimum(t_self, t_k), t_self),
        )

    t_others, t_self = _sweep(p_n, to_light, geom, s_cheap, far, shadow_update)
    in_light = (t_self <= t_others).to(dtype)

    flat = dww = None
    color = shade_color(p, normal, to_light, to_cam, in_light, m, const, tex_hw)
    if tex_hw is not None:
        color, flat, is_image, diffuse_w = color
        dww = torch.where(is_image, diffuse_w * thr * coverage, torch.zeros_like(thr))

    w = thr * coverage
    refl_coeff = 0.5 * m(SG) * in_light
    thr_next = w * refl_coeff
    alive_next = alive * hit

    ddn = 2.0 * _dot3(d, normal)
    refl = _normalize3(tuple(d[i] - normal[i] * ddn for i in range(3)))
    if xi is not None:
        refl = ggx_continuation(d, normal, refl, ipow(m(ROUGH), 2), xi).dout

    acc_add = tuple(color[i] * w for i in range(3))
    return acc_add, p_n, refl, thr_next, alive_next, flat, dww


def trace_deep_plain(o, d, geom, mat, consts, xi=None, *, depth: int, faraway: float, s_cheap: int, tex_hw=None):
    """Plain version of ``trace_deep``: ``depth`` bounces from unit
    throughput, bounce ``k`` glossy with rows ``2k, 2k+1`` of ``xi`` when
    given; returns acc (3, N), and with ``tex_hw`` also every bounce's flat
    texel ids (depth, N) int32 and dww weights (depth, N)."""
    thr = torch.ones_like(d[0])
    alive = torch.ones_like(d[0])
    acc = [torch.zeros_like(d[0]) for _ in range(3)]
    o3, d3 = tuple(o), tuple(d)
    flats, dwws = [], []
    for dep in range(depth):
        xi_k = None if xi is None else (xi[2 * dep], xi[2 * dep + 1])
        acc_add, o3, d3, thr, alive, flat, dww = bounce_math(
            o3, d3, thr, alive, geom, mat, consts, xi_k, faraway=faraway, s_cheap=s_cheap, tex_hw=tex_hw
        )
        acc = [acc[i] + acc_add[i] for i in range(3)]
        flats.append(flat)
        dwws.append(dww)
    if tex_hw is None:
        return torch.stack(acc)
    return torch.stack(acc), torch.stack(flats), torch.stack(dwws)


def bounce_step_plain(o, d, thr, alive, acc, geom, mat, consts, xi=None, *, faraway: float, s_cheap: int,
                      tex_hw=None):
    """Plain version of ``bounce_step``: returns ``(o, d, thr, alive, acc)``,
    and with ``tex_hw`` also the bounce's flat texel ids and dww (N,)."""
    acc_add, o_n, d_n, thr_n, alive_n, flat, dww = bounce_math(
        tuple(o), tuple(d), thr, alive, geom, mat, consts, None if xi is None else (xi[0], xi[1]),
        faraway=faraway, s_cheap=s_cheap, tex_hw=tex_hw,
    )
    acc_n = torch.stack([acc[i] + acc_add[i] for i in range(3)])
    out = (torch.stack(o_n), torch.stack(d_n), thr_n, alive_n, acc_n)
    return out if tex_hw is None else out + (flat, dww)


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, kernel launch on CUDA tensors.
# ---------------------------------------------------------------------------


def _check(rays: dict, lanes: dict, geom, mat, consts, s_cheap: int, xi=None, xi_rows: int = 2) -> torch.device:
    """Validate what the kernels take; returns the common device."""
    tensors = {**rays, **lanes, "geom": geom, "mat": mat, "consts": consts}
    if xi is not None:
        tensors["xi"] = xi
    ref = next(iter(rays.values()))
    n = ref.shape[-1]
    s = geom.shape[0]
    for name, t in tensors.items():
        if t.requires_grad:
            raise ValueError(f"{name}: the hard bounce kernels have no gradient; pass a detached tensor")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: expected {ref.dtype} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, t in rays.items():
        if t.shape != (3, n):
            raise ValueError(f"{name}: expected shape (3, {n}), got {tuple(t.shape)}")
    for name, t in lanes.items():
        if t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if xi is not None and xi.shape != (xi_rows, n):
        raise ValueError(f"xi: expected shape ({xi_rows}, {n}), got {tuple(xi.shape)}")
    if geom.shape != (s, 4) or mat.shape != (s, MAT_COLS) or consts.shape != (1, N_CONST):
        raise ValueError("tables: expected geom (S, 4), mat (S, 19) and consts (1, 16)")
    if not 1 <= s <= MAX_SUB_SPHERES:
        raise ValueError(f"the bounce kernels take 1..{MAX_SUB_SPHERES} spheres, got {s}")
    if not 0 <= s_cheap <= s:
        raise ValueError(f"s_cheap must lie in 0..{s}, got {s_cheap}")
    if n == 0:
        raise ValueError("no rays to trace")
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ref.dtype}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    return ref.device


# C signatures of the entries in csrc/bounce_sub.cu, before the trailing
# stream: p = pointer, i = int, r = the dtype's real.
_SIGNATURES = {
    # o, d, acc, geom, mat, consts, xi (or null), flat and dww (or null);
    # n, s_cheap, s_total, depth; faraway; the atlas's slot extents
    "trace_deep": "ppppppp" "pp" "iiii" "r" "ii",
    # o, d, thr, alive, acc, their five outputs, geom, mat, consts, xi (or
    # null), flat and dww (or null); n, s_cheap, s_total; faraway; the
    # atlas's slot extents
    "bounce_step": "ppppp" "ppppp" "pppp" "pp" "iii" "r" "ii",
}


def _launch(name: str, dtype: torch.dtype, *args, atlas: bool = False) -> None:
    """Launch kernel ``name`` on the current stream and count it (its atlas
    mode in :data:`ATLAS_LAUNCHES`)."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    (ATLAS_LAUNCHES if atlas else LAUNCHES)[name] += 1


def trace_deep(o, d, geom, mat, consts, xi=None, *, depth: int, faraway: float, s_cheap: int, tex_hw=None):
    """The whole bounce chain in one launch: acc (3, N) of ``depth`` bounces;
    ``xi`` (2 * depth, N) makes every bounce glossy.  With the atlas's slot
    extents ``tex_hw`` (the atlas mode) returns ``(acc, flat, dww)``, each
    bounce's texel ids and weights (depth, N)."""
    device = _check({"o": o, "d": d}, {}, geom, mat, consts, s_cheap, xi, 2 * depth)
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    kw = dict(depth=depth, faraway=faraway, s_cheap=s_cheap, tex_hw=tex_hw)
    if device.type == "cpu":
        return trace_deep_plain(o, d, geom, mat, consts, xi, **kw)
    n = o.shape[1]
    with torch.cuda.device(device):
        acc = torch.empty_like(o)
        tex = () if tex_hw is None else (
            torch.empty((depth, n), dtype=torch.int32, device=device), torch.empty((depth, n), dtype=o.dtype, device=device)
        )
        _launch(
            "trace_deep", o.dtype, o, d, acc, geom, mat, consts, xi, *(tex or (None, None)),
            n, s_cheap, geom.shape[0], depth, float(faraway), *slot_args(tex_hw), atlas=bool(tex),
        )
    return acc if tex_hw is None else (acc, *tex)


def bounce_step(o, d, thr, alive, acc, geom, mat, consts, xi=None, *, faraway: float, s_cheap: int, tex_hw=None):
    """One bounce per launch: returns the next ``(o, d, thr, alive, acc)``;
    ``xi`` (2, N) makes the bounce glossy.  With the atlas's slot extents
    ``tex_hw`` (the atlas mode) also the bounce's texel ids and dww (N,)."""
    device = _check({"o": o, "d": d, "acc": acc}, {"thr": thr, "alive": alive}, geom, mat, consts, s_cheap, xi)
    kw = dict(faraway=faraway, s_cheap=s_cheap, tex_hw=tex_hw)
    if device.type == "cpu":
        return bounce_step_plain(o, d, thr, alive, acc, geom, mat, consts, xi, **kw)
    n = o.shape[1]
    with torch.cuda.device(device):
        out = (
            torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr),
            torch.empty_like(alive), torch.empty_like(acc),
        )
        tex = () if tex_hw is None else (torch.empty((n,), dtype=torch.int32, device=device), torch.empty_like(thr))
        _launch(
            "bounce_step", o.dtype, o, d, thr, alive, acc, *out, geom, mat, consts, xi,
            *(tex or (None, None)), n, s_cheap, geom.shape[0], float(faraway), *slot_args(tex_hw), atlas=bool(tex),
        )
    return out + tex


def trace_fused_sub(
    origin: torch.Tensor,  # (3,) camera position
    dirs_t: torch.Tensor,  # (3, N) unit directions
    scene,
    cfg,
    *,
    route: str = "auto",
    key=None,
) -> torch.Tensor:
    """Hard-visibility trace through the bounce kernels; (N, 3) colors.

    ``route="auto"`` takes ``trace_deep`` for depth >= 2 and ``bounce_step``
    per bounce for depth 1; a caller may force either.  With
    ``cfg.stochastic_roughness`` and a seed ``key`` the bounces are glossy:
    ``trace_deep`` takes every bounce's xi drawn up front, ``bounce_step``
    one bounce's at a time, both over exactly N rays.  An atlas scene takes
    the kernels' atlas mode and composes the texels in depth order: after
    ``trace_deep`` every bounce's at once, after each ``bounce_step`` that
    bounce's, as the JAX package does.
    """
    if scene.spheres.count > MAX_SUB_SPHERES:
        raise ValueError(
            f"{scene.spheres.count} spheres: the bounce kernels take at most {MAX_SUB_SPHERES}; render() sends "
            "bigger scenes to ops.culled.trace_fused_culled or render.trace"
        )
    if route == "auto":
        route = "trace_deep" if cfg.max_depth >= 2 else "bounce_step"
    if route not in ("trace_deep", "bounce_step"):
        raise ValueError(f"unknown route {route!r}")
    dtype = cfg.dtype
    d = dirs_t.to(dtype).contiguous()
    o = origin.to(dtype).reshape(3, 1).expand(d.shape).contiguous()
    geom = geometry_table(scene, dtype)
    mat = material_table(scene, dtype)
    consts = consts_row(scene, dtype)
    s_cheap = scene.spheres.count - scene.spheres.n_exact
    n, depth = d.shape[1], cfg.max_depth
    xis = [None] * depth
    if cfg.stochastic_roughness and key is not None:
        xis = bounce_xi(key, n, depth, dtype, d.device)
    texels, tex_hw = atlas_texels(scene, dtype)
    kw = dict(faraway=cfg.faraway, s_cheap=s_cheap, tex_hw=tex_hw)
    if route == "trace_deep":
        xi = None if xis[0] is None else torch.cat(xis)
        acc = trace_deep(o, d, geom, mat, consts, xi, depth=depth, **kw)
        if tex_hw is not None:
            acc, flats, dwws = acc
            for dep in range(depth):
                acc = compose_texels(acc, texels, flats[dep], dwws[dep])
    else:
        thr = torch.ones_like(d[0])
        alive = torch.ones_like(d[0])
        acc = torch.zeros_like(d)
        for xi in xis:
            o, d, thr, alive, acc, *tex = bounce_step(o, d, thr, alive, acc, geom, mat, consts, xi, **kw)
            if tex:
                acc = compose_texels(acc, texels, *tex)
    return acc.T
