"""Smooth-visibility bounce kernels: plain versions, wrappers and autograd.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_bounce_smooth_sub`, mirror
and stochastic glossy continuations, with and without an image atlas.  Five TPU kernels become CUDA kernels in
``csrc/bounce_smooth_sub.cu``, one thread per ray over the (3, N) layout
of :func:`..camera.ray_directions_t`:

* ``_fwd_kernel_sub_deep`` -> ``smooth_fwd_deep``: the whole smooth bounce
  chain, acc plus the per-depth residuals the adjoint replays from;
* ``_bwd_kernel_sub_deep`` -> ``smooth_bwd_deep``: the reverse adjoint
  chain from those residuals: ray and table gradients;
* ``_train_kernel_sub_deep`` -> ``train_deep``: forward chain, the L2
  loss's cotangent and the reverse adjoint in one launch; returns the SSE
  and every gradient and writes no residuals;
* ``_fwd_kernel_sub`` -> ``smooth_fwd_step``: one bounce, the state
  ``(o, d, thr, alive, acc)`` in and out, plus its residuals;
* ``_bwd_kernel_sub`` -> ``smooth_bwd_step``: that bounce's adjoint from
  the cotangents of all five outputs.

None has a sphere cap: the geometry table sits in shared memory up to
64 KB (4096 spheres in f32, 2048 in f64) and is read from global memory
past that, the winner's material row is read from global memory, and the
table-gradient partials take ``(23 S + 17) * min(ceil(N / 32),
PARTIAL_COLS)`` values in ``smooth_bwd_deep`` and ``train_deep``
(:func:`partials_bytes`) and ``(19 S + 16)`` a row, one row a CTA of
``STEP_RAY_WARPS`` ray-warps, in ``smooth_bwd_step``
(:func:`step_rows_bytes`), whatever the frame.  ``smooth_bwd_step``'s warps
pass the shadow spheres that reach none of their rays
(:func:`shadow_terms`: those terms are exactly +-0).  Above
4096 spheres, where the JAX package runs its lane pair
(:func:`python_ray_tracer_tpu.ops.pallas_bounce_smooth.trace_fused_smooth`),
the renderer takes ``smooth_fwd_step``/``smooth_bwd_step`` once per bounce.

Each takes an optional xi, (2 * depth, N) or (2, N) uniforms drawn on the
JAX package's schedule (:func:`.rng.bounce_xi`), that makes the
continuation reflect about a GGX-sampled microfacet.  All but
``train_deep`` (which the JAX package keeps off atlas scenes) have an atlas
mode, given the atlas's slot extents ``tex_hw``: the forward kernels also
return each bounce's flat texel ids and ``dww`` weights, the backward ones
take ``g_dww``, the cotangent of the weights, and the trace composes the
texels outside the kernels (:func:`.texture.compose_texels`), as the JAX
package does.  Beside the kernels
sit their plain PyTorch versions: :func:`fwd_sub_math` is the body of the
JAX ``_FwdSub`` (unrolled mode) and :func:`adjoint_bounce` its handwritten
adjoint (Phases A-G), term for term, over (N,) rows.  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel
or raises.  Table gradients come back as ``geom`` (S, 4), ``mat`` (S, 19)
and ``consts`` (1, 16) tensors; autograd carries them through the table
builders onto the scene's parameters, as JAX transposes them onto its
scene arrays.

:class:`_TraceSubDeep` pairs ``smooth_fwd_deep`` with ``smooth_bwd_deep``
and :class:`_BounceSub` ``smooth_fwd_step`` with ``smooth_bwd_step`` (any
loss through ``render()``); :class:`_TrainLossSubDeep` wraps
``train_deep``, whose backward is a scalar multiply of the gradients its
forward already computed.  :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import torch

from . import _build
from .bounce_smooth import (
    EPS_DEN, b_cterm_plain, compensated_b_cterm, dot3, norm3, quad_sol_disc, sig, sol_disc_adjoint,
    sol_disc_exact, sol_disc_plain,
)
from .bounce_sub import ggx_continuation, image_texels
from .intersect_fused import WARP, _skip_code, line_test, warp_bundles, winner_test
from .rng import bounce_xi
from .shading import AMBIENT, GLINT_EXPONENT, NUDGE, SHADING_EPS
from .tables import (
    CX, CY, CZ, DCB, DCG, DCR, DG, IG, IOR, KIND, MAT_COLS, N_CONST, RAD, ROUGH, SG, TFI, TFT, TFW,
    consts_row, geometry_table, material_table,
)
from .texture import atlas_texels, compose_texels, slot_args
from .vecmath import ipow, sqrt

# Columns of the table-gradient partials at most: a gradient kernel is
# given the partials' column count and runs that many warps, warp c walking
# the groups of 32 rays c, c + cols, ... in order and summing into column
# c.  A constant, not the card's occupancy: 2048 left 960x540 frames 512
# blocks, 1.3 waves on an H100 (PERF.md, Findings).
PARTIAL_COLS = 4096

# smooth_bwd_step's layout (csrc/bounce_smooth_sub.cu kStep*): a CTA of
# STEP_RAY_WARPS ray-warps, each over STEP_SPLIT warps that split its
# spheres, owns one row of table gradients; at most STEP_MAX_ROWS CTAs walk
# the ray-warps in rounds (one round up to 960x540: 1024 rows, four rounds,
# ran the 3-sphere case 13% slower on an H100; PERF.md, Findings).
STEP_RAY_WARPS = 4
STEP_SPLIT = 1
STEP_THREADS = STEP_RAY_WARPS * STEP_SPLIT * 32
STEP_MAX_ROWS = 4096
STEP_MAT = 15  # material columns CX..TFI that take gradients

# train_deep keeps each bounce's replay state in a per-thread array of this
# many entries (csrc/bounce_smooth_sub.cu kMaxTrainDepth); deeper L2 losses
# take the two-launch pair through render().
MAX_TRAIN_DEPTH = 64

LAUNCHES = {"smooth_fwd_deep": 0, "smooth_bwd_deep": 0, "train_deep": 0, "smooth_fwd_step": 0, "smooth_bwd_step": 0}
# Launches of the atlas mode (train_deep has none).
ATLAS_LAUNCHES = {"smooth_fwd_deep": 0, "smooth_bwd_deep": 0, "smooth_fwd_step": 0, "smooth_bwd_step": 0}

_SOURCE = "bounce_smooth_sub.cu"

_NEG_BIG = -3.0e38  # max-disc fallback sentinel of the JAX kernel body

# Below lo the shadow sigmoid is exactly 0 (csrc/smooth_math.cuh SigEdge):
# exp(-x) overflows in the dtype.
SIG_EDGE = {torch.float32: -89.0, torch.float64: -710.0}

# smooth_fwd_step's skip (csrc/bounce_smooth_sub.cu kStepSkipMinCheap):
# "auto" takes it from this many cheap-tier spheres on.
STEP_SKIP_MIN_CHEAP = 16


# ---------------------------------------------------------------------------
# Plain versions: the JAX kernel bodies, term for term, on (N,) rows.
# ---------------------------------------------------------------------------


def _sphere(geom, k):
    return (geom[k, 0], geom[k, 1], geom[k, 2]), geom[k, 3]


def _sphere_fn(k: int, s_cheap: int):
    return sol_disc_plain if k < s_cheap else sol_disc_exact


def shadow_spheres(geom, s_cheap: int, cand_sh=None, n: int = 0):
    """The spheres of a bounce's shadow loops, in the kernels' visiting
    order: ``(sid, center, radius, sol_disc_fn, active)`` per slot.

    Without ``cand_sh`` every sphere in index order (``active`` None).  With
    ``cand_sh = (cand, cnt_cand, cnt_full, tile_rays)`` the culled kernels'
    order: each lane's tile's candidates (per-lane ids, ``active`` the lanes
    whose list is that long), then its full-tier fallback, then the exact
    tier.  Each lane's counts are clamped as the kernels clamp them.
    """
    if cand_sh is None:
        for k in range(geom.shape[0]):
            c, r = _sphere(geom, k)
            yield k, c, r, _sphere_fn(k, s_cheap), None
        return
    cand, cnt_cand, cnt_full, tile_rays = cand_sh
    tile = torch.arange(n, device=geom.device) // tile_rays
    cc = torch.clamp(cnt_cand.long()[tile], 0, cand.shape[1])
    cf = torch.clamp(cnt_full.long()[tile], 0, s_cheap)
    for j in range(int(cc.max())):
        sid = cand[tile, j]
        g = geom[sid.long()]
        yield sid, (g[:, 0], g[:, 1], g[:, 2]), g[:, 3], sol_disc_plain, j < cc
    for k in range(int(cf.max())):
        c, r = _sphere(geom, k)
        yield k, c, r, sol_disc_plain, k < cf
    for k in range(s_cheap, geom.shape[0]):
        c, r = _sphere(geom, k)
        yield k, c, r, sol_disc_exact, None


def fwd_sub_math(o, d, thr, alive, geom, mat, consts, xi=None, *, faraway, s_cheap, sharp_e, sharp_s, saved=None,
                 known=None, cand_sh=None, tex_hw=None, shadow_keep=None, winner_keep=None):
    """One smooth bounce (``_FwdSub``): every intermediate the adjoint reads.

    ``o``/``d`` are 3-tuples of (N,) rows, ``thr``/``alive`` (N,).  With
    ``saved = (idx, hit, clear)`` the winner and shadow sweeps are skipped
    and their saved results used, as the backward kernels replay; with
    ``known = (idx, hit)`` only the winner sweep is.  ``cand_sh`` gives the
    shadow loops a tile's list (:func:`shadow_spheres`).  With ``xi = (xi1,
    xi2)`` ((N,) uniforms) the continuation ``dout`` reflects about a
    GGX-sampled microfacet; otherwise it is the mirror ``refl``.  With the
    atlas's slot extents ``tex_hw`` (the atlas mode) image lanes' diffuse
    texture is zero and ``f.flat``/``f.dww`` hold their texel ids and
    ``dw * w`` weights.  ``shadow_keep(f)``, once ``f.p_n`` and ``f.L`` are
    known, gives ``keep(sid, disc)``: (N,) the lanes whose shadow product
    takes that sphere's factor (a skip that drops only factors of exactly 1
    leaves the product bitwise as it is).  ``winner_keep(k)``: (N,) the lanes
    whose winner sweep takes sphere k; elsewhere it counts as a miss with
    disc -inf (a skip that drops only spheres that cannot win leaves the
    winner as it is).
    """
    f = SimpleNamespace()
    f.tex_hw = tex_hw
    dtype = o[0].dtype
    s_total = geom.shape[0]
    f.dtype, f.thr, f.alive = dtype, thr, alive
    f.sharp_e, f.sharp_s = sharp_e, sharp_s
    f.cand_sh = cand_sh

    saved_clear = None
    if saved is not None:
        f.idx, f.hit, saved_clear = saved
    elif known is not None:
        f.idx, f.hit = known
    else:
        far = torch.full_like(o[0], faraway)
        tmin = far
        imin = torch.zeros(o[0].shape, dtype=torch.int32, device=o[0].device)
        dmax = torch.full_like(o[0], _NEG_BIG)
        idmax = imin
        for k in range(s_total):
            c, r = _sphere(geom, k)
            sol, disc, t, _, _ = _sphere_fn(k, s_cheap)(o, d, c, r, faraway)
            if winner_keep is not None:
                kept = winner_keep(k)
                t = torch.where(kept, t, far)
                disc = torch.where(kept, disc, torch.full_like(disc, -math.inf))
            take = t < tmin  # strict: lowest index wins exact ties
            tmin = torch.where(take, t, tmin)
            imin = torch.where(take, k, imin)
            taked = disc > dmax
            dmax = torch.where(taked, disc, dmax)
            idmax = torch.where(taked, k, idmax)
        f.hit = tmin != faraway
        f.idx = torch.where(f.hit, imin, idmax).to(torch.int32)

    rows = mat[f.idx.long()].T  # (19, N): each lane's winner row

    def m(col):
        return rows[col]

    f.m = m
    f.c_w = (m(CX), m(CY), m(CZ))
    f.r_w = m(RAD)

    # Winner-only per-lane quadratic, tier-matched to the sweep.
    if s_cheap == s_total:
        f.b_w, f.ct_w = b_cterm_plain(o, d, f.c_w, f.r_w)
    elif s_cheap == 0:
        f.b_w, f.ct_w = compensated_b_cterm(o, d, f.c_w, f.r_w)
    else:
        # Each lane evaluates its winner's tier only, as the kernels branch;
        # the values are those of the JAX kernel's select over both tiers.
        is_exact = f.idx >= s_cheap
        f.b_w, f.ct_w = torch.empty_like(f.r_w), torch.empty_like(f.r_w)
        for tier, lanes in ((b_cterm_plain, ~is_exact), (compensated_b_cterm, is_exact)):
            sub = [tuple(v[i][lanes] for i in range(3)) for v in (o, d, f.c_w)]
            f.b_w[lanes], f.ct_w[lanes] = tier(*sub, f.r_w[lanes])
    f.sol_w, f.disc_w, _ = quad_sol_disc(f.b_w, f.ct_w, faraway)

    f.sig_de = sig(sharp_e * f.disc_w)
    f.sig_se = sig(sharp_e * f.sol_w)
    f.cov_w = f.sig_de * f.sig_se
    f.coverage = f.cov_w * alive

    f.t_safe = torch.where(f.hit, f.sol_w, torch.ones_like(f.sol_w))
    f.p = tuple(o[i] + d[i] * f.t_safe for i in range(3))
    f.inv_r = 1.0 / f.r_w
    f.normal = tuple((f.p[i] - f.c_w[i]) * f.inv_r for i in range(3))

    f.cam = (consts[0, 0], consts[0, 1], consts[0, 2])
    f.light = (consts[0, 3], consts[0, 4], consts[0, 5])
    f.dome_c = (consts[0, 6], consts[0, 7], consts[0, 8])
    f.dome_t = consts[0, 9]

    f.L, f.l_mag = norm3(tuple(f.light[i] - f.p[i] for i in range(3)))
    f.V, f.v_mag = norm3(tuple(f.cam[i] - f.p[i] for i in range(3)))
    f.p_n = tuple(f.p[i] + f.normal[i] * NUDGE for i in range(3))

    if saved_clear is not None:
        f.clear = saved_clear
    else:
        clear = torch.ones_like(o[0])
        keep = None if shadow_keep is None else shadow_keep(f)
        for k, c, r, fn, active in shadow_spheres(geom, s_cheap, cand_sh, o[0].shape[0]):
            sol, disc, _, _, _ = fn(f.p_n, f.L, c, r, faraway)
            occl = sig(sharp_s * disc) * sig(sharp_s * sol)
            factor = clear * torch.where(f.idx == k, torch.ones_like(occl), 1.0 - occl)
            if keep is not None:
                active = keep(k, disc) if active is None else active & keep(k, disc)
            clear = factor if active is None else torch.where(active, factor, clear)
        f.clear = clear

    f.n_dot_l = torch.clamp_min(dot3(f.normal, f.L), 0.0)
    cx = torch.trunc(f.p[0] * 2.0).to(torch.int32) % 2
    cz = torch.trunc(f.p[2] * 2.0).to(torch.int32) % 2
    f.checker = (cx == cz).to(dtype)
    f.is_checker = m(KIND) == 1.0
    f.tex = tuple(torch.where(f.is_checker, f.checker, m(c)) for c in (DCR, DCG, DCB))
    if tex_hw is not None:
        f.tex, f.flat, f.is_image = image_texels(f.normal, m, f.tex, tex_hw)
    f.dw = f.n_dot_l * f.clear * m(DG)

    f.relu_ny = torch.clamp_min(f.normal[1], 0.0)
    f.dome_up = f.relu_ny * f.dome_t
    f.dome = tuple(f.dome_c[i] * f.dome_up for i in range(3))

    f.H, f.h_mag = norm3(tuple(f.L[i] + f.V[i] for i in range(3)))
    f.nv_raw = dot3(f.normal, f.V)
    f.nh_raw = dot3(f.normal, f.H)
    f.vh_raw = dot3(f.V, f.H)
    f.nl_raw = dot3(f.normal, f.L)
    f.n_dot_v = torch.clamp(f.nv_raw, 0.0, 1.0)
    f.n_dot_h = torch.clamp(f.nh_raw, 0.0, 1.0)
    f.v_dot_h = torch.clamp(f.vh_raw, 0.0, 1.0)
    f.n_dot_l_c = torch.clamp(f.nl_raw, 0.0, 1.0)
    ior = m(IOR)
    f.f0 = ipow((ior - 1.0) / (ior + 1.0), 2)
    f.one_m_vdh5 = ipow(1.0 - f.v_dot_h, 5)
    f.fresnel = f.f0 + (1.0 - f.f0) * f.one_m_vdh5
    f.alpha = ipow(m(ROUGH), 2)
    f.ggx_den = ipow(f.n_dot_h, 2) * (ipow(f.alpha, 2) - 1.0) + 1.0
    f.dist = ipow(f.alpha, 2) / (math.pi * (ipow(f.ggx_den, 2) + SHADING_EPS))

    def g1(x):
        root = sqrt(ipow(f.alpha, 2) + (1.0 - ipow(f.alpha, 2)) * ipow(x, 2))
        return 2.0 * x / (x + root + SHADING_EPS), root

    f.g1l, f.g1l_root = g1(f.n_dot_l_c)
    f.g1v, f.g1v_root = g1(f.n_dot_v)
    f.geom = f.g1l * f.g1v
    f.spec_den = 4.0 * f.n_dot_v + SHADING_EPS
    f.spec_base = (f.fresnel * f.dist * f.geom) / f.spec_den
    f.one_m_ndv = 1.0 - f.n_dot_v
    f.glint = torch.pow(f.one_m_ndv, GLINT_EXPONENT) * f.n_dot_l_c
    f.spec_gate = f.n_dot_v > 0
    f.spec = torch.where(f.spec_gate, f.spec_base + m(SG) * f.glint, torch.zeros_like(f.glint))
    f.spec_term = f.spec * m(SG) * f.clear

    f.view_angle = torch.clamp(f.nv_raw, 0.0, 1.0)
    f.angle_factor = torch.abs(f.view_angle - 0.5) * 2.0
    f.phase = f.angle_factor * math.pi * m(TFT) * 10.0
    f.ip = torch.sin(f.phase)
    f.hue = (m(TFI) - 1.0) / 2.0
    f.irid_w = m(TFW) * m(IG)
    f.irid_base = (
        f.ip * f.hue + (1.0 - f.hue) * (1.0 - f.ip),
        f.ip * (1.0 - f.hue) + f.hue * (1.0 - f.ip),
        0.5 + 0.5 * f.ip,
    )
    f.irid = tuple(f.irid_base[i] * f.irid_w for i in range(3))

    f.color = tuple(AMBIENT + f.tex[i] * f.dw + f.dome[i] + f.spec_term + f.irid[i] for i in range(3))

    f.w = thr * f.coverage
    if tex_hw is not None:
        f.dww = torch.where(f.is_image, f.dw * f.w, torch.zeros_like(f.w))
    f.refl_coeff = 0.5 * m(SG) * f.clear
    f.thr_out = f.w * f.refl_coeff

    f.ddn = 2.0 * dot3(d, f.normal)
    f.refl, f.u_mag = norm3(tuple(d[i] - f.normal[i] * f.ddn for i in range(3)))

    # Stochastic glossy continuation, every intermediate kept for the adjoint.
    f.xi = xi
    if xi is None:
        f.dout = f.refl
    else:
        vars(f).update(vars(ggx_continuation(d, f.normal, f.refl, f.alpha, xi)))
    return f


def _ggx_adjoint(f, d, g_dout):
    """The glossy continuation's adjoint: splits ``g_dout`` by the ``pert``
    gate and chains the microfacet branch back to ``d``, the normal and
    alpha.  Returns ``(g_refl, g_d_p, g_n_p, g_A_pert)``, ``g_refl`` the
    mirror branch's share."""
    zero = torch.zeros_like(f.w)
    g_refl = tuple(torch.where(f.pert, zero, g_dout[i]) for i in range(3))
    g_r = tuple(torch.where(f.pert, g_dout[i], zero) for i in range(3))
    # r_pert = ur/|ur|, ur = d - hvec dhn, dhn = 2 d.hvec
    rdotp = dot3(f.r_pert, g_r)
    inv_rmag = 1.0 / torch.clamp_min(f.r_mag, EPS_DEN)
    g_ur = tuple((g_r[i] - f.r_pert[i] * rdotp) * inv_rmag for i in range(3))
    g_d_p = list(g_ur)
    g_dhn = -dot3(f.hvec, g_ur)
    g_h = [-f.dhn * g_ur[i] for i in range(3)]
    for i in range(3):
        g_d_p[i] = g_d_p[i] + 2.0 * f.hvec[i] * g_dhn
        g_h[i] = g_h[i] + 2.0 * d[i] * g_dhn
    # hvec = hw/|hw|, hw = t1v sc + t2v ss + normal cos_t
    hdotp = dot3(f.hvec, g_h)
    inv_wmag = 1.0 / torch.clamp_min(f.hw_mag, EPS_DEN)
    g_wv = tuple((g_h[i] - f.hvec[i] * hdotp) * inv_wmag for i in range(3))
    g_sc = dot3(f.t1v, g_wv)
    g_ss = dot3(f.t2v, g_wv)
    g_cos = dot3(f.normal, g_wv)
    g_t1 = tuple(f.sc * g_wv[i] for i in range(3))
    g_t2 = tuple(f.ss * g_wv[i] for i in range(3))
    g_n_p = [f.cos_t * g_wv[i] for i in range(3)]
    # Branchless tangent frame: s piecewise constant, a = -1/(s+nz) with
    # da/dnz = a^2, b = nx ny a.
    sgn, ab, nrm = f.s_sign, f.a_b, f.normal
    g_bb = sgn * g_t1[1] + g_t2[0]
    g_ab = sgn * nrm[0] * nrm[0] * g_t1[0] + nrm[1] * nrm[1] * g_t2[1] + nrm[0] * nrm[1] * g_bb
    g_n_p[0] = g_n_p[0] + 2.0 * sgn * nrm[0] * ab * g_t1[0] - sgn * g_t1[2] + nrm[1] * ab * g_bb
    g_n_p[1] = g_n_p[1] + nrm[0] * ab * g_bb + 2.0 * nrm[1] * ab * g_t2[1] - g_t2[2]
    g_n_p[2] = g_n_p[2] + ab * ab * g_ab
    # sin_t = sqrt(max(0, 1 - cos^2)), gated at sin_t > 1e-6 (the sample is
    # then the mirror, whose slope the mirror branch carries).
    g_sin = f.cphi * g_sc + f.sphi * g_ss
    slope = torch.where(f.sin_t > 1e-6, -f.cos_t / torch.clamp_min(f.sin_t, 1e-6), zero)
    g_cos = g_cos + slope * g_sin
    # cos_t = (1 + t2q)^(-1/2), t2q = alpha^2 xi1 / max(1 - xi1, 1e-8)
    g_t2q = -0.5 * ipow(f.cos_t, 3) * g_cos
    xi1 = f.xi[0]
    g_A_pert = 2.0 * f.alpha * xi1 / torch.clamp_min(1.0 - xi1, 1e-8) * g_t2q
    return g_refl, g_d_p, g_n_p, g_A_pert


def shadow_terms(f, k, c, r, fn, g_cc, faraway, active=None):
    """Phase C's terms of one shadow sphere (center ``c``, radius ``r``,
    tier ``fn``, index ``k``) on every lane: what it adds to g_pn_s, as
    ``2 L g_b`` then ``2 oc g_ct`` (3 each), to g_L (``2 oc g_b``, 3), and
    its table row (4) before the sum over lanes.  ``g_cc`` is the lanes'
    ``g_clear * clear``; ``active`` masks a culled list's slots past a lane's
    list.  Where the sphere is the lane's winner, or its shadow sigmoid
    ``sig(sharp_s * disc)`` is exactly 0, every term is exactly +-0: the
    kernels' warps pass such spheres (``shadow_reaches``)."""
    zero = torch.zeros_like(g_cc)
    sol, disc, _, b, ct = fn(f.p_n, f.L, c, r, faraway)
    sd = sig(f.sharp_s * disc)
    ss = sig(f.sharp_s * sol)
    occl = sd * ss
    is_self = f.idx == k
    fac = torch.where(is_self, torch.ones_like(occl), 1.0 - occl)
    g_fac = g_cc / torch.clamp_min(fac, EPS_DEN)
    g_occl = torch.where(is_self, zero, -g_fac)
    g_disc_j = g_occl * ss * sd * (1.0 - sd) * f.sharp_s
    g_sol_j = g_occl * sd * ss * (1.0 - ss) * f.sharp_s
    g_b, g_ct = sol_disc_adjoint(b, ct, g_sol_j, g_disc_j)
    if active is not None:  # a slot past the lane's list: no contribution
        g_b, g_ct = torch.where(active, g_b, zero), torch.where(active, g_ct, zero)
    oc = tuple(f.p_n[i] - c[i] for i in range(3))
    row = [-2.0 * f.L[i] * g_b - 2.0 * oc[i] * g_ct for i in range(3)] + [-2.0 * r * g_ct]
    pn_b = [2.0 * f.L[i] * g_b for i in range(3)]
    pn_ct = [2.0 * oc[i] * g_ct for i in range(3)]
    l_b = [2.0 * oc[i] * g_b for i in range(3)]
    return pn_b, pn_ct, l_b, row


def adjoint_bounce(f, o, d, cots, geom, ggeom, gmat, gconst, *, faraway, s_cheap):
    """One bounce's handwritten adjoint (``_adjoint_bounce``, Phases A-G).

    ``cots = (g_o_out, g_dout, g_thr_out, g_alive_out, g_acc)``, the
    cotangents of the bounce's outputs, and in the atlas mode ``g_dww`` after
    them.  Returns those of its inputs ``(g_o, g_d, g_thr, g_alive)``; the
    table gradients are added into ``ggeom`` (S, 4), ``gmat`` (S, 19) and
    ``gconst`` (1, 16) in place.
    """
    g_o_out, g_dout, g_thr_o, g_alive_o, g_acc, *g_dww_raw = cots
    dtype = f.dtype
    m = f.m
    s_total = geom.shape[0]
    zero = torch.zeros_like(f.w)

    # --- Phase A: top level and shading ---
    g_color = tuple(g_acc[i] * f.w for i in range(3))
    g_w = g_acc[0] * f.color[0] + g_acc[1] * f.color[1] + g_acc[2] * f.color[2]
    g_w = g_w + g_thr_o * f.refl_coeff
    atlas = f.tex_hw is not None
    if atlas:
        # The external texel term acc += texel * dww, dww = dw * w on image lanes.
        g_dww = torch.where(f.is_image, g_dww_raw[0], zero)
        g_w = g_w + g_dww * f.dw
    g_rc = g_thr_o * f.w
    g_sg = 0.5 * f.clear * g_rc
    g_clear = 0.5 * m(SG) * g_rc
    g_coverage = g_alive_o + g_w * f.thr
    g_thr_in = g_w * f.coverage

    # continuation direction: dout = refl = u / |u|, or where(pert, r_pert, refl)
    g_refl, g_A = g_dout, zero
    if f.xi is not None:
        g_refl, g_d_p, g_n_p, g_A = _ggx_adjoint(f, d, g_dout)
    rdot = dot3(f.refl, g_refl)
    inv_umag = 1.0 / torch.clamp_min(f.u_mag, EPS_DEN)
    g_u = tuple((g_refl[i] - f.refl[i] * rdot) * inv_umag for i in range(3))
    g_d_acc = list(g_u)
    g_ddn = -dot3(f.normal, g_u)
    g_n_acc = [-f.ddn * g_u[i] for i in range(3)]
    for i in range(3):
        g_d_acc[i] = g_d_acc[i] + 2.0 * f.normal[i] * g_ddn
        g_n_acc[i] = g_n_acc[i] + 2.0 * d[i] * g_ddn
    if f.xi is not None:
        for i in range(3):
            g_d_acc[i] = g_d_acc[i] + g_d_p[i]
            g_n_acc[i] = g_n_acc[i] + g_n_p[i]

    g_tex = tuple(g_color[i] * f.dw for i in range(3))
    g_dw = g_color[0] * f.tex[0] + g_color[1] * f.tex[1] + g_color[2] * f.tex[2]
    if atlas:
        g_dw = g_dw + g_dww * f.w
    g_spec_term = g_color[0] + g_color[1] + g_color[2]
    g_irid_w = g_color[0] * f.irid_base[0] + g_color[1] * f.irid_base[1] + g_color[2] * f.irid_base[2]
    g_ip = f.irid_w * (
        g_color[0] * (2.0 * f.hue - 1.0) + g_color[1] * (1.0 - 2.0 * f.hue) + g_color[2] * 0.5
    )
    g_hue = f.irid_w * (g_color[0] * (2.0 * f.ip - 1.0) + g_color[1] * (1.0 - 2.0 * f.ip))
    g_tfw = g_irid_w * m(IG)
    g_ig = g_irid_w * m(TFW)
    g_tfi = g_hue * 0.5
    g_phase = torch.cos(f.phase) * g_ip
    g_af = math.pi * 10.0 * m(TFT) * g_phase
    g_tft = f.angle_factor * math.pi * 10.0 * g_phase
    g_va = 2.0 * torch.sign(f.view_angle - 0.5) * g_af
    gate_nv = ((f.nv_raw > 0) & (f.nv_raw < 1)).to(dtype)
    g_nv_raw = g_va * gate_nv
    g_spec = g_spec_term * m(SG) * f.clear
    g_sg = g_sg + g_spec_term * f.spec * f.clear
    g_clear = g_clear + g_spec_term * f.spec * m(SG)
    g_spec = torch.where(f.spec_gate, g_spec, zero)
    g_spec_base = g_spec
    g_sg = g_sg + g_spec * f.glint
    g_glint = g_spec * m(SG)
    g_one_m_ndv = g_glint * GLINT_EXPONENT * torch.pow(f.one_m_ndv, GLINT_EXPONENT - 1.0) * f.n_dot_l_c
    g_ndv = -g_one_m_ndv
    g_nlc = g_glint * torch.pow(f.one_m_ndv, GLINT_EXPONENT)
    inv_sden = 1.0 / f.spec_den
    g_fres = g_spec_base * f.dist * f.geom * inv_sden
    g_dist = g_spec_base * f.fresnel * f.geom * inv_sden
    g_geom = g_spec_base * f.fresnel * f.dist * inv_sden
    g_sden = -g_spec_base * f.spec_base * inv_sden
    g_ndv = g_ndv + 4.0 * g_sden
    A = f.alpha
    g_g1l = g_geom * f.g1v
    g_g1v = g_geom * f.g1l

    def g1_adj(x, R, g_g1):
        Rs = torch.clamp_min(R, EPS_DEN)
        den = x + R + SHADING_EPS
        Rp = (1.0 - ipow(A, 2)) * x / Rs
        gx = g_g1 * 2.0 * (R + SHADING_EPS - x * Rp) / (den * den)
        dRdA = A * (1.0 - x * x) / Rs
        gA = g_g1 * (-2.0 * x / (den * den)) * dRdA
        return gx, gA

    gx_l, gA_l = g1_adj(f.n_dot_l_c, f.g1l_root, g_g1l)
    gx_v, gA_v = g1_adj(f.n_dot_v, f.g1v_root, g_g1v)
    g_nlc = g_nlc + gx_l
    g_ndv = g_ndv + gx_v
    g_A = g_A + gA_l + gA_v
    Dq = f.ggx_den
    denD = math.pi * (Dq * Dq + SHADING_EPS)
    g_A = g_A + g_dist * 2.0 * A / denD
    g_Dq = g_dist * (-(A * A) * 2.0 * Dq * math.pi) / (denD * denD)
    g_ndh = g_Dq * 2.0 * f.n_dot_h * (A * A - 1.0)
    g_A = g_A + g_Dq * ipow(f.n_dot_h, 2) * 2.0 * A
    g_f0 = g_fres * (1.0 - f.one_m_vdh5)
    g_vdh = -g_fres * (1.0 - f.f0) * 5.0 * ipow(1.0 - f.v_dot_h, 4)
    ior = m(IOR)
    ratio = (ior - 1.0) / (ior + 1.0)
    g_ior = g_f0 * 2.0 * ratio * (2.0 / ipow(ior + 1.0, 2))
    g_rough = 2.0 * m(ROUGH) * g_A
    g_ndv_raw = g_ndv * gate_nv + g_nv_raw
    g_ndh_raw = g_ndh * ((f.nh_raw > 0) & (f.nh_raw < 1)).to(dtype)
    g_vdh_raw = g_vdh * ((f.vh_raw > 0) & (f.vh_raw < 1)).to(dtype)
    g_nlc_raw = g_nlc * ((f.nl_raw > 0) & (f.nl_raw < 1)).to(dtype)
    g_dome_c = tuple(g_color[i] * f.dome_up for i in range(3))
    g_dome_up = g_color[0] * f.dome_c[0] + g_color[1] * f.dome_c[1] + g_color[2] * f.dome_c[2]
    g_relu_ny = g_dome_up * f.dome_t
    g_dome_t = g_dome_up * f.relu_ny
    g_n_acc[1] = g_n_acc[1] + g_relu_ny * (f.normal[1] > 0).to(dtype)
    g_ndl = g_dw * f.clear * m(DG)
    g_clear = g_clear + g_dw * f.n_dot_l * m(DG)
    g_dg = g_dw * f.n_dot_l * f.clear
    g_nl_relu = g_ndl * (f.nl_raw > 0).to(dtype)
    # Constant-color lanes only: the checker is piecewise constant, and an
    # image lane's diffuse texture is the external texel's.
    is_const = (~f.is_checker & ~f.is_image if atlas else ~f.is_checker).to(dtype)
    g_dcc = tuple(g_tex[i] * is_const for i in range(3))
    g_cov_w = g_coverage * f.alive
    g_alive_in = g_coverage * f.cov_w
    g_disc_w = g_cov_w * f.sig_se * f.sig_de * (1.0 - f.sig_de) * f.sharp_e
    g_sol_w = g_cov_w * f.sig_de * f.sig_se * (1.0 - f.sig_se) * f.sharp_e

    g_L_acc = [f.normal[i] * (g_nlc_raw + g_nl_relu) for i in range(3)]
    g_V_acc = [f.normal[i] * g_ndv_raw + f.H[i] * g_vdh_raw for i in range(3)]
    g_H_acc = [f.normal[i] * g_ndh_raw + f.V[i] * g_vdh_raw for i in range(3)]
    for i in range(3):
        g_n_acc[i] = g_n_acc[i] + f.V[i] * g_ndv_raw + f.H[i] * g_ndh_raw + f.L[i] * (g_nlc_raw + g_nl_relu)

    # --- Phase B: H = (L + V) / |L + V| ---
    hdot = dot3(f.H, g_H_acc)
    inv_hmag = 1.0 / torch.clamp_min(f.h_mag, EPS_DEN)
    for i in range(3):
        g_lv = (g_H_acc[i] - f.H[i] * hdot) * inv_hmag
        g_L_acc[i] = g_L_acc[i] + g_lv
        g_V_acc[i] = g_V_acc[i] + g_lv

    # --- Phase C: shadow-product adjoint, one sphere at a time ---
    g_pn_s = [zero, zero, zero]
    g_cc = g_clear * f.clear
    for k, c, r, fn, active in shadow_spheres(geom, s_cheap, f.cand_sh, zero.shape[0]):
        pn_b, pn_ct, l_b, row = shadow_terms(f, k, c, r, fn, g_cc, faraway, active)
        for i in range(3):
            g_pn_s[i] = g_pn_s[i] + pn_b[i] + pn_ct[i]
            g_L_acc[i] = g_L_acc[i] + l_b[i]
        if isinstance(k, int):
            for i in range(4):
                ggeom[k, i] += torch.sum(row[i])
        else:  # a tile's candidate: each tile's sum into its sphere's row
            tile_rays = f.cand_sh[3]
            per_tile = torch.stack(row, dim=1).reshape(-1, tile_rays, 4).sum(1)
            ggeom.index_add_(0, k[::tile_rays].long(), per_tile)

    # --- Phase D: p_n, L, V unit-vector transposes ---
    g_pn = [g_o_out[i] + g_pn_s[i] for i in range(3)]
    g_p = list(g_pn)
    for i in range(3):
        g_n_acc[i] = g_n_acc[i] + NUDGE * g_pn[i]
    ldot = dot3(f.L, g_L_acc)
    inv_lmag = 1.0 / torch.clamp_min(f.l_mag, EPS_DEN)
    g_light = []
    for i in range(3):
        g_lv = (g_L_acc[i] - f.L[i] * ldot) * inv_lmag
        g_light.append(g_lv)
        g_p[i] = g_p[i] - g_lv
    vdot = dot3(f.V, g_V_acc)
    inv_vmag = 1.0 / torch.clamp_min(f.v_mag, EPS_DEN)
    g_cam = []
    for i in range(3):
        g_vv = (g_V_acc[i] - f.V[i] * vdot) * inv_vmag
        g_cam.append(g_vv)
        g_p[i] = g_p[i] - g_vv

    # --- Phase E: normal, p, winner quadratic ---
    g_cw = [zero, zero, zero]
    g_rw = -dot3(f.normal, g_n_acc) * f.inv_r
    for i in range(3):
        g_p[i] = g_p[i] + g_n_acc[i] * f.inv_r
        g_cw[i] = g_cw[i] - g_n_acc[i] * f.inv_r
    g_o_in = list(g_p)
    g_t = dot3(d, g_p)
    for i in range(3):
        g_d_acc[i] = g_d_acc[i] + g_p[i] * f.t_safe
    g_sol_w = g_sol_w + torch.where(f.hit, g_t, zero)
    g_bw, g_ctw = sol_disc_adjoint(f.b_w, f.ct_w, g_sol_w, g_disc_w)
    oc_w = tuple(o[i] - f.c_w[i] for i in range(3))
    for i in range(3):
        g_o_in[i] = g_o_in[i] + 2.0 * d[i] * g_bw + 2.0 * oc_w[i] * g_ctw
        g_d_acc[i] = g_d_acc[i] + 2.0 * oc_w[i] * g_bw
        g_cw[i] = g_cw[i] - 2.0 * d[i] * g_bw - 2.0 * oc_w[i] * g_ctw
    g_rw = g_rw - 2.0 * f.r_w * g_ctw

    # --- Phase F: per-lane material gradients into their winner's row ---
    cols = (CX, CY, CZ, RAD, DG, DCR, DCG, DCB, SG, ROUGH, IG, IOR, TFW, TFT, TFI)
    vals = torch.stack([
        g_cw[0], g_cw[1], g_cw[2], g_rw, g_dg, g_dcc[0], g_dcc[1], g_dcc[2],
        g_sg, g_rough, g_ig, g_ior, g_tfw, g_tft, g_tfi,
    ])  # (15, N)
    for k in range(s_total):
        gmat[k, list(cols)] += torch.sum(vals[:, f.idx == k], dim=1)

    # --- Phase G: scene constants ---
    const_vals = (*g_cam, *g_light, *g_dome_c, g_dome_t)
    gconst[0, : len(const_vals)] += torch.stack([torch.sum(v) for v in const_vals])

    return tuple(g_o_in), tuple(g_d_acc), g_thr_in, g_alive_in


def _xi_pair(xi, dep: int):
    """Bounce ``dep``'s ``(xi1, xi2)`` rows of a (2 * depth, N) stack, or None."""
    return None if xi is None else (xi[2 * dep], xi[2 * dep + 1])


def smooth_fwd_deep_plain(o, d, geom, mat, consts, xi=None, *, depth, faraway, s_cheap, sharp_e, sharp_s,
                          tex_hw=None):
    """Plain version of ``smooth_fwd_deep``: ``depth`` smooth bounces from
    unit throughput, bounce ``k`` glossy with rows ``2k, 2k+1`` of ``xi``
    when given.  Returns ``(acc, osave, dsave, thrsave, alivesave, idx,
    hit, clear)``: acc (3, N); the state entering bounces 1..depth-1,
    (3*(depth-1), N) for o and d and (depth-1, N) for thr and alive; and
    per bounce (depth, N) the winner (int32), hit (0/1) and shadow clear.
    With ``tex_hw`` (the atlas mode) also each bounce's flat texel ids
    (depth, N) int32 and dww weights (depth, N)."""
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw)
    n = d.shape[1]
    o3, d3 = tuple(o), tuple(d)
    thr = torch.ones_like(d[0])
    alive = torch.ones_like(d[0])
    acc = [torch.zeros_like(d[0]) for _ in range(3)]
    osave, dsave, thrsave, alivesave, idx, hit, clear, flat, dww = [], [], [], [], [], [], [], [], []
    for dep in range(depth):
        if dep > 0:
            osave += list(o3)
            dsave += list(d3)
            thrsave.append(thr)
            alivesave.append(alive)
        f = fwd_sub_math(o3, d3, thr, alive, geom, mat, consts, _xi_pair(xi, dep), **kw)
        acc = [acc[i] + f.color[i] * f.w for i in range(3)]
        idx.append(f.idx)
        hit.append(f.hit.to(d.dtype))
        clear.append(f.clear)
        if tex_hw is not None:
            flat.append(f.flat)
            dww.append(f.dww)
        o3, d3, thr, alive = f.p_n, f.dout, f.thr_out, f.coverage

    def stack(xs, dt=d.dtype):
        return torch.stack(xs) if xs else torch.empty((0, n), dtype=dt, device=d.device)

    outs = (
        torch.stack(acc), stack(osave), stack(dsave), stack(thrsave), stack(alivesave),
        stack(idx, torch.int32), stack(hit), stack(clear),
    )
    return outs if tex_hw is None else outs + (stack(flat, torch.int32), stack(dww))


def _reverse_chain(states, g_acc, geom, mat, consts, kw):
    """The adjoint chain in reverse depth order over replayed bounces.

    ``states[dep] = (o, d, thr, alive, saved, xi, g_dww)``, ``g_dww`` the
    cotangent of the bounce's dww in the atlas mode (else None).  The trace
    discards the last bounce's ``(o, d, thr, alive)``, so their cotangents
    start at zero; ``g_acc`` is the same for every bounce (acc is a pure
    accumulator)."""
    ggeom, gmat, gconst = torch.zeros_like(geom), torch.zeros_like(mat), torch.zeros_like(consts)
    zero = torch.zeros_like(g_acc[0])
    g_o, g_d, g_thr, g_alive = (zero, zero, zero), (zero, zero, zero), zero, zero
    for o3, d3, thr, alive, saved, xi, g_dww in reversed(states):
        f = fwd_sub_math(o3, d3, thr, alive, geom, mat, consts, xi, saved=saved, **kw)
        g_o, g_d, g_thr, g_alive = adjoint_bounce(
            f, o3, d3, (g_o, g_d, g_thr, g_alive, g_acc) + (() if g_dww is None else (g_dww,)),
            geom, ggeom, gmat, gconst, faraway=kw["faraway"], s_cheap=kw["s_cheap"],
        )
    return torch.stack(g_o), torch.stack(g_d), ggeom, gmat, gconst


def smooth_bwd_deep_plain(
    o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, consts, g_acc, xi=None,
    *, depth, faraway, s_cheap, sharp_e, sharp_s, g_dww=None, tex_hw=None,
):
    """Plain version of ``smooth_bwd_deep``: from the forward's residuals
    and acc's cotangent (3, N) (and in the atlas mode the dww cotangents
    ``g_dww`` (depth, N)), returns ``(g_o, g_d, g_geom, g_mat, g_consts)``."""
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw)
    ones = torch.ones_like(d[0])
    states = []
    for dep in range(depth):
        if dep == 0:
            o3, d3, thr, alive = tuple(o), tuple(d), ones, ones
        else:
            j = 3 * (dep - 1)
            o3, d3 = tuple(osave[j : j + 3]), tuple(dsave[j : j + 3])
            thr, alive = thrsave[dep - 1], alivesave[dep - 1]
        states.append((o3, d3, thr, alive, (idx[dep], hit[dep] != 0, clear[dep]), _xi_pair(xi, dep),
                       None if g_dww is None else g_dww[dep]))
    return _reverse_chain(states, tuple(g_acc), geom, mat, consts, kw)


def clip_gate(x, lo: float, hi: float):
    """d/dx of ``jnp.clip(x, lo, hi)`` with JAX's 0.5 split at exact boundaries."""
    dt = x.dtype
    g_lo = 0.5 * ((x >= lo).to(dt) + (x > lo).to(dt))
    y = torch.clamp_min(x, lo)
    g_hi = 0.5 * ((y <= hi).to(dt) + (y < hi).to(dt))
    return g_lo * g_hi


def train_deep_plain(o, d, tgt, geom, mat, consts, xi=None, *, depth, faraway, s_cheap, sharp_e, sharp_s):
    """Plain version of ``train_deep``: ``sum((clip(acc, 0, 1) - tgt)^2)``
    over all (3, N) values and its gradients.  Returns ``(sse, g_o, g_d,
    g_geom, g_mat, g_consts)``; the 1/(3N) of the mean is the caller's."""
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s)
    o3, d3 = tuple(o), tuple(d)
    thr = torch.ones_like(d[0])
    alive = torch.ones_like(d[0])
    acc = [torch.zeros_like(d[0]) for _ in range(3)]
    states = []
    for dep in range(depth):
        f = fwd_sub_math(o3, d3, thr, alive, geom, mat, consts, _xi_pair(xi, dep), **kw)
        acc = [acc[i] + f.color[i] * f.w for i in range(3)]
        states.append((o3, d3, thr, alive, (f.idx, f.hit, f.clear), f.xi, None))
        o3, d3, thr, alive = f.p_n, f.dout, f.thr_out, f.coverage
    sse = torch.zeros_like(d[0])
    g_acc = []
    for i in range(3):
        e = torch.clamp(acc[i], 0.0, 1.0) - tgt[i]
        sse = sse + e * e
        g_acc.append(2.0 * e * clip_gate(acc[i], 0.0, 1.0))
    return (torch.sum(sse), *_reverse_chain(states, tuple(g_acc), geom, mat, consts, kw))


def shadow_reach(p_n, to_light, light, geom, s_cheap: int, sharp_s: float) -> torch.Tensor:
    """(W, S) the (warp, sphere) pairs a shadow product with the skip visits
    (``csrc/smooth_math.cuh`` ``shadow_skip_product``) for shadow rays
    ``p_n``/``to_light`` (N, 3) aimed at ``light`` (3,) or None: the
    cheap-tier spheres whose ``r_eff`` some line of the warp may reach
    (:func:`.intersect_fused.line_test`, ``r_eff^2 = r^2 + |SIG_EDGE| / (4
    sharp_s)``; beyond it the shadow sigmoid is exactly 0 and the factor
    exactly 1), every exact-tier sphere, and every sphere of a warp whose
    bound is not ``ok`` or where ``sharp_s`` is not a positive finite number
    in the dtype."""
    dtype = geom.dtype
    b = warp_bundles(p_n, to_light, light)
    reach = torch.ones((b.ok.shape[0], geom.shape[0]), dtype=torch.bool, device=p_n.device)
    sharp = torch.tensor(sharp_s, dtype=dtype)
    if 0 < sharp < math.inf:
        edge = torch.tensor(-SIG_EDGE[dtype], dtype=dtype) / (4 * sharp)
        reach[:, :s_cheap] = line_test(b, geom[:s_cheap], edge.to(p_n.device)) | ~b.ok[:, None]
    return reach


def shadow_keep(reach_of, sharp_s: float, dtype: torch.dtype):
    """``fwd_sub_math``'s ``shadow_keep`` for a kernel's shadow skip: a lane
    takes sphere k's factor where its warp's bound reaches k (``reach_of(p_n,
    to_light)``, (W, S) from (N, 3) rows), k is not its winner, and (with
    ``sharp_s`` finite in the dtype) the pair's ``sig(sharp_s * disc)`` is
    not exactly 0 (``csrc/smooth_math.cuh`` ``shadow_fold``)."""
    finite = bool(torch.isfinite(torch.tensor(sharp_s, dtype=dtype)))

    def keep_of(f):
        n = f.p_n[0].shape[0]
        reach = reach_of(torch.stack(f.p_n, 1), torch.stack(f.L, 1))
        warp = torch.arange(n, device=reach.device) // WARP

        def keep(k, disc):
            sid = k.long() if torch.is_tensor(k) else torch.full((n,), k, dtype=torch.long, device=reach.device)
            kept = reach[warp, sid] & (f.idx.long() != sid)
            return kept & (sig(sharp_s * disc) != 0) if finite else kept

        return keep

    return keep_of


def winner_reach(o, d, geom, s_cheap: int, faraway: float, chunk: int = 4096) -> torch.Tensor:
    """(W, S) the (warp, sphere) pairs the winner sweep with the skip visits
    (``csrc/smooth_math.cuh`` ``SkipAll::sweep``) for rays ``o``/``d`` (N,
    3): every exact-tier sphere, every sphere of a warp whose bound is not
    ``ok``, and the cheap-tier spheres :func:`.intersect_fused.winner_test`
    keeps, each chunk of 32 against the least over the warp's lanes of the
    running dmax before it.  A sphere the test leaves out cannot change
    dmax, so that running dmax is the maximum of every earlier cheap
    sphere's disc (and the sentinel), as the full sweep has it; it is taken
    here over ``chunk`` rays at a time."""
    n, s = o.shape[0], geom.shape[0]
    b = warp_bundles(o, d)
    reach = torch.ones((b.ok.shape[0], s), dtype=torch.bool, device=o.device)
    if s_cheap == 0:
        return reach
    chunks = -(-s_cheap // WARP)
    neg_big = torch.tensor(_NEG_BIG, dtype=o.dtype, device=o.device)
    c = tuple(geom[None, :s_cheap, i] for i in range(3))
    r = geom[None, :s_cheap, 3]
    mins = []
    for a in range(0, n, chunk):
        rows = slice(a, min(n, a + chunk))
        _, disc, _, _, _ = sol_disc_plain(tuple(o[rows, i, None] for i in range(3)),
                                          tuple(d[rows, i, None] for i in range(3)), c, r, faraway)
        disc = torch.where(torch.isnan(disc), torch.full_like(disc, -math.inf), disc)
        pad = chunks * WARP - s_cheap
        disc = torch.cat([disc, disc.new_full((disc.shape[0], pad), -math.inf)], 1) if pad else disc
        best = torch.cummax(torch.amax(disc.reshape(-1, chunks, WARP), 2), 1).values
        before = torch.cat([neg_big.expand(best.shape[0], 1), torch.maximum(best[:, :-1], neg_big)], 1)
        lanes = (-before.shape[0]) % WARP  # the ragged warp's missing lanes: its bound is not ok
        before = torch.cat([before, before.new_full((lanes, chunks), math.inf)]) if lanes else before
        mins.append(torch.amin(before.reshape(-1, WARP, chunks), 1))
    m = torch.cat(mins).repeat_interleave(WARP, 1)[:, :s_cheap]  # (W, s_cheap): each sphere's chunk's least dmax
    reach[:, :s_cheap] = winner_test(b, geom[:s_cheap], m) | ~b.ok[:, None]
    return reach


def smooth_fwd_step_plain(o, d, thr, alive, acc, geom, mat, consts, xi=None, *, faraway, s_cheap, sharp_e, sharp_s,
                          tex_hw=None, skip: bool = False):
    """Plain version of ``smooth_fwd_step``: one smooth bounce from the state
    ``(o, d, thr, alive, acc)``, glossy with ``xi`` (2, N) when given.
    Returns the next state and the bounce's residuals: ``(o, d, thr, alive,
    acc, idx, hit, clear)``, idx int32 and hit 0/1, each (N,); with
    ``tex_hw`` (the atlas mode) also the flat texel ids and dww (N,).
    ``skip``: the winner sweep over the pairs :func:`winner_reach` keeps and
    the shadow product over those :func:`shadow_keep` keeps
    (:func:`shadow_reach`, the light ``consts[0, 3:6]`` its apex), as the
    kernel's skip visits them, bitwise the plain version without; only the
    tests and the card check's counts run it."""
    winner_keep = keep = None
    if skip:
        reach = winner_reach(o.T.contiguous(), d.T.contiguous(), geom, s_cheap, faraway)
        warp = torch.arange(d.shape[1], device=d.device) // WARP
        winner_keep = lambda k: reach[warp, k]  # noqa: E731
        keep = shadow_keep(lambda p_n, to_light: shadow_reach(p_n, to_light, consts[0, 3:6], geom, s_cheap, sharp_s),
                           sharp_s, d.dtype)
    f = fwd_sub_math(
        tuple(o), tuple(d), thr, alive, geom, mat, consts, _xi_pair(xi, 0),
        faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw, shadow_keep=keep,
        winner_keep=winner_keep,
    )
    acc_n = torch.stack([acc[i] + f.color[i] * f.w for i in range(3)])
    outs = (
        torch.stack(f.p_n), torch.stack(f.dout), f.thr_out, f.coverage, acc_n,
        f.idx, f.hit.to(d.dtype), f.clear,
    )
    return outs if tex_hw is None else outs + (f.flat, f.dww)


def smooth_bwd_step_plain(
    o, d, thr, alive, idx, hit, clear, geom, mat, consts, g_o, g_d, g_thr, g_alive, g_acc, xi=None,
    *, faraway, s_cheap, sharp_e, sharp_s, g_dww=None, tex_hw=None,
):
    """Plain version of ``smooth_bwd_step``: the adjoint of one bounce, from
    its inputs, its residuals and the cotangents of its five outputs (and in
    the atlas mode of its dww, ``g_dww`` (N,)).  Returns ``(g_o, g_d, g_thr,
    g_alive, g_geom, g_mat, g_consts)``; acc's cotangent passes through
    unchanged and is the caller's."""
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw)
    o3, d3 = tuple(o), tuple(d)
    f = fwd_sub_math(o3, d3, thr, alive, geom, mat, consts, _xi_pair(xi, 0), saved=(idx, hit != 0, clear), **kw)
    ggeom, gmat, gconst = torch.zeros_like(geom), torch.zeros_like(mat), torch.zeros_like(consts)
    cots = (tuple(g_o), tuple(g_d), g_thr, g_alive, tuple(g_acc)) + (() if g_dww is None else (g_dww,))
    g_o3, g_d3, g_thr_in, g_alive_in = adjoint_bounce(
        f, o3, d3, cots, geom, ggeom, gmat, gconst, faraway=faraway, s_cheap=s_cheap,
    )
    return torch.stack(g_o3), torch.stack(g_d3), g_thr_in, g_alive_in, ggeom, gmat, gconst


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, kernel launch on CUDA tensors.
# ---------------------------------------------------------------------------


def _check(
    rays: dict, geom, mat, consts, *, s_cheap: int, depth: int, stacks: dict | None = None, lanes: dict | None = None,
) -> torch.device:
    """Validate what the kernels take; returns the common device.  ``stacks``
    maps a name to ``(tensor or None, rows)`` of a (rows, N) input; ``lanes``
    to an (N,) input.  ``idx`` must be int32, the rest the rays' dtype."""
    stacks = {k: v for k, v in (stacks or {}).items() if v[0] is not None}
    lanes = lanes or {}
    tensors = {**rays, **{k: v for k, (v, _) in stacks.items()}, **lanes, "geom": geom, "mat": mat, "consts": consts}
    ref = next(iter(rays.values()))
    n = ref.shape[-1]
    s = geom.shape[0]
    for name, t in tensors.items():
        want_dt = torch.int32 if name == "idx" else ref.dtype
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(
                f"{name}: the kernels compute their own gradients; call them through "
                "_TraceSubDeep/_BounceSub/_TrainLossSubDeep or pass a detached tensor"
            )
        if t.device != ref.device or t.dtype != want_dt:
            raise ValueError(f"{name}: expected {want_dt} on {ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, t in rays.items():
        if t.shape != (3, n):
            raise ValueError(f"{name}: expected shape (3, {n}), got {tuple(t.shape)}")
    for name, (t, rows) in stacks.items():
        if t.shape != (rows, n):
            raise ValueError(f"{name}: expected shape ({rows}, {n}), got {tuple(t.shape)}")
    for name, t in lanes.items():
        if t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if geom.shape != (s, 4) or mat.shape != (s, MAT_COLS) or consts.shape != (1, N_CONST):
        raise ValueError("tables: expected geom (S, 4), mat (S, 19) and consts (1, 16)")
    if s < 1:
        raise ValueError("the smooth kernels need at least one sphere")
    if not 0 <= s_cheap <= s:
        raise ValueError(f"s_cheap must lie in 0..{s}, got {s_cheap}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if n == 0:
        raise ValueError("no rays to trace")
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ref.dtype}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    return ref.device


# C signatures of the entries in csrc/bounce_smooth_sub.cu, before the
# trailing stream: p = pointer, i = int, r = the dtype's real.  Every entry
# takes xi as a pointer that may be null (the deterministic kernel); all
# but train_deep take the atlas mode's flat and dww outputs (or g_dww) as
# pointers that may be null (no atlas) and the atlas's slot extents last.
_SIGNATURES = {
    # o, d, geom, mat, consts, xi, acc, osave, dsave, thrsave, alivesave,
    # idx, hit, clear, flat, dww; n, s_cheap, s_total, depth; faraway,
    # sharp_e, sharp_s; tex_h, tex_w
    "smooth_fwd_deep": "pppppp" "pppppppp" "pp" "iiii" "rrr" "ii",
    # o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat,
    # consts, xi, g_acc, g_dww, g_o, g_d, partials, table grads; n, n_cols,
    # s_cheap, s_total, depth; faraway, sharp_e, sharp_s; tex_h, tex_w
    "smooth_bwd_deep": "ppppppppp" "pppp" "pp" "pppp" "iiiii" "rrr" "ii",
    # o, d, tgt, geom, mat, consts, xi, g_o, g_d, partials, sse + table
    # grads; n, n_cols, s_cheap, s_total, depth; faraway, sharp_e, sharp_s
    "train_deep": "ppp" "pppp" "pppp" "iiiii" "rrr",
    # o, d, thr, alive, acc, geom, mat, consts, xi, their five outputs, idx,
    # hit, clear, flat, dww; n, s_cheap, s_total; faraway, sharp_e,
    # sharp_s; tex_h, tex_w; skip
    "smooth_fwd_step": "ppppp" "pppp" "ppppp" "ppp" "pp" "iii" "rrr" "ii" "i",
    # o, d, thr, alive, idx, hit, clear, geom, mat, consts, xi, cotangents
    # g_o, g_d, g_thr, g_alive, g_acc, g_dww, the four input cotangents,
    # the rows' geometry, material and constants, table grads; n, rows,
    # s_cheap, s_total; faraway, sharp_e, sharp_s; tex_h, tex_w
    "smooth_bwd_step": "ppppppp" "pppp" "pppppp" "pppp" "pppp" "iiii" "rrr" "ii",
}

# Per-column partial sums of the table gradients: 4 + 19 values per
# sphere, 16 scene constants, and the SSE (train_deep only).
_WARP = 32


def _n_vals(s: int) -> int:
    return (4 + MAT_COLS) * s + N_CONST + 1


def _n_cols(n: int) -> int:
    return min((n + _WARP - 1) // _WARP, PARTIAL_COLS)


def partials_bytes(n: int, s: int, dtype: torch.dtype) -> int:
    """Bytes of the partials smooth_bwd_deep and train_deep take for ``n``
    rays and ``s`` spheres: ``(23 s + 17) * min(ceil(n / 32), PARTIAL_COLS)``
    values."""
    return _n_vals(s) * _n_cols(n) * torch.empty((), dtype=dtype).element_size()


def step_rows(n: int) -> int:
    """smooth_bwd_step's rows for ``n`` rays: one a CTA, ``min(ceil(ceil(n /
    32) / STEP_RAY_WARPS), STEP_MAX_ROWS)``."""
    if n < 1:
        raise ValueError("no rays to trace")
    ray_warps = -(-n // _WARP)
    return min(-(-ray_warps // STEP_RAY_WARPS), STEP_MAX_ROWS)


def step_rows_bytes(n: int, s: int, dtype: torch.dtype) -> int:
    """Bytes of smooth_bwd_step's rows for ``n`` rays and ``s`` spheres:
    ``step_rows(n) * (19 s + 16)`` values (geometry (s, 4), material (s, 15),
    16 constants a row)."""
    return step_rows(n) * ((4 + STEP_MAT) * s + N_CONST) * torch.empty((), dtype=dtype).element_size()


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def blocks_per_sm(name: str, dtype: torch.dtype, glossy: bool, s: int, skip: bool = False) -> int:
    """Resident blocks per SM of kernel ``name``'s instantiation for ``s``
    spheres on the current card (staged or global geometry as it launches);
    ``skip``: smooth_fwd_step's with its skip."""
    if skip and name != "smooth_fwd_step":
        raise ValueError(f"{name} has no skip")
    which = 5 if skip else tuple(LAUNCHES).index(name)
    blocks = getattr(_build.load_library(_SOURCE), f"prt_smooth_blocks_per_sm_{_suffix(dtype)}")(which, int(glossy), s)
    if blocks < 0:
        raise RuntimeError(f"occupancy query of {name} failed: CUDA error {-blocks}")
    return blocks


def shared_bytes(dtype: torch.dtype, s: int) -> int:
    """Shared memory a block of any of the five kernels takes for ``s``
    spheres: the consts row, plus the geometry where it is staged."""
    return getattr(_build.load_library(_SOURCE), f"prt_smooth_shared_bytes_{_suffix(dtype)}")(s)


def _launch(name: str, dtype: torch.dtype, *args, atlas: bool = False) -> None:
    """Launch kernel ``name`` on the current stream and count it (its atlas
    mode in :data:`ATLAS_LAUNCHES`)."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    (ATLAS_LAUNCHES if atlas else LAUNCHES)[name] += 1


def _scalars(n, s, s_cheap, depth, faraway, sharp_e, sharp_s, cols=None):
    """The trailing scalars of an entry: n, the partials' columns or rows
    (gradient kernels), s_cheap, s_total, depth (the deep kernels), the reals."""
    scalars = (n,) + (() if cols is None else (cols,)) + (s_cheap, s)
    return scalars + (() if depth is None else (depth,)) + (float(faraway), float(sharp_e), float(sharp_s))


def _grad_buffers(n: int, s: int, like: torch.Tensor):
    """The (values, columns) partials (zeroed) and the reduced flat values."""
    partials = torch.zeros((_n_vals(s), _n_cols(n)), dtype=like.dtype, device=like.device)
    return partials, torch.empty((_n_vals(s),), dtype=like.dtype, device=like.device)


def _split_grads(flat, s: int):
    """(n_vals,) reduced partials -> (g_geom, g_mat, g_consts, sse)."""
    g_geom = flat[: 4 * s].reshape(s, 4)
    g_mat = flat[4 * s : (4 + MAT_COLS) * s].reshape(s, MAT_COLS)
    g_consts = flat[(4 + MAT_COLS) * s : (4 + MAT_COLS) * s + N_CONST].reshape(1, N_CONST)
    return g_geom, g_mat, g_consts, flat[-1]


def smooth_fwd_deep(o, d, geom, mat, consts, xi=None, *, depth, faraway, s_cheap, sharp_e, sharp_s, tex_hw=None):
    """The smooth chain in one launch, glossy with ``xi`` (2 * depth, N) when
    given, in the atlas mode with ``tex_hw``; outputs as
    :func:`smooth_fwd_deep_plain`."""
    kw = dict(depth=depth, faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw)
    device = _check({"o": o, "d": d}, geom, mat, consts, s_cheap=s_cheap, depth=depth, stacks={"xi": (xi, 2 * depth)})
    if device.type == "cpu":
        return smooth_fwd_deep_plain(o, d, geom, mat, consts, xi, **kw)
    n, s = d.shape[1], geom.shape[0]
    with torch.cuda.device(device):
        e = functools.partial(torch.empty, dtype=d.dtype, device=device)
        ids = functools.partial(torch.empty, dtype=torch.int32, device=device)
        outs = (
            e((3, n)), e((3 * (depth - 1), n)), e((3 * (depth - 1), n)), e((depth - 1, n)),
            e((depth - 1, n)), ids((depth, n)), e((depth, n)), e((depth, n)),
        )
        tex = () if tex_hw is None else (ids((depth, n)), e((depth, n)))
        _launch("smooth_fwd_deep", d.dtype, o, d, geom, mat, consts, xi, *outs, *(tex or (None, None)),
                *_scalars(n, s, s_cheap, depth, faraway, sharp_e, sharp_s), *slot_args(tex_hw), atlas=bool(tex))
    return outs + tex


def smooth_bwd_deep(
    o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, consts, g_acc, xi=None,
    *, depth, faraway, s_cheap, sharp_e, sharp_s, g_dww=None, tex_hw=None,
):
    """The reverse adjoint chain in one launch (plus the fixed-order
    reduction of the table gradients), in the atlas mode with ``g_dww``
    (depth, N) and ``tex_hw``; outputs as :func:`smooth_bwd_deep_plain`."""
    kw = dict(depth=depth, faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, g_dww=g_dww,
              tex_hw=tex_hw)
    if (g_dww is None) != (tex_hw is None):
        raise ValueError("the atlas mode takes both g_dww and tex_hw")
    stacks = {
        "osave": (osave, 3 * (depth - 1)), "dsave": (dsave, 3 * (depth - 1)),
        "thrsave": (thrsave, depth - 1), "alivesave": (alivesave, depth - 1),
        "idx": (idx, depth), "hit": (hit, depth), "clear": (clear, depth), "xi": (xi, 2 * depth),
        "g_dww": (g_dww, depth),
    }
    device = _check({"o": o, "d": d, "g_acc": g_acc}, geom, mat, consts, s_cheap=s_cheap, depth=depth, stacks=stacks)
    if device.type == "cpu":
        return smooth_bwd_deep_plain(
            o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, consts, g_acc, xi, **kw
        )
    n, s = d.shape[1], geom.shape[0]
    with torch.cuda.device(device):
        g_o, g_d = torch.empty_like(d), torch.empty_like(d)
        partials, flat = _grad_buffers(n, s, d)
        _launch("smooth_bwd_deep", d.dtype, o, d, osave, dsave, thrsave, alivesave, idx, hit, clear,
                geom, mat, consts, xi, g_acc, g_dww, g_o, g_d, partials, flat,
                *_scalars(n, s, s_cheap, depth, faraway, sharp_e, sharp_s, partials.shape[1]), *slot_args(tex_hw),
                atlas=g_dww is not None)
    g_geom, g_mat, g_consts, _ = _split_grads(flat, s)
    return g_o, g_d, g_geom, g_mat, g_consts


def train_deep(o, d, tgt, geom, mat, consts, xi=None, *, depth, faraway, s_cheap, sharp_e, sharp_s):
    """Loss and every gradient in one launch (plus the fixed-order reduction
    of the table gradients and the SSE); outputs as :func:`train_deep_plain`."""
    kw = dict(depth=depth, faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s)
    device = _check(
        {"o": o, "d": d, "tgt": tgt}, geom, mat, consts, s_cheap=s_cheap, depth=depth, stacks={"xi": (xi, 2 * depth)}
    )
    if depth > MAX_TRAIN_DEPTH:
        raise ValueError(f"train_deep takes depth <= {MAX_TRAIN_DEPTH}, got {depth}")
    if device.type == "cpu":
        return train_deep_plain(o, d, tgt, geom, mat, consts, xi, **kw)
    n, s = d.shape[1], geom.shape[0]
    with torch.cuda.device(device):
        g_o, g_d = torch.empty_like(d), torch.empty_like(d)
        partials, flat = _grad_buffers(n, s, d)
        _launch("train_deep", d.dtype, o, d, tgt, geom, mat, consts, xi, g_o, g_d, partials, flat,
                *_scalars(n, s, s_cheap, depth, faraway, sharp_e, sharp_s, partials.shape[1]))
    g_geom, g_mat, g_consts, sse = _split_grads(flat, s)
    return sse, g_o, g_d, g_geom, g_mat, g_consts


def smooth_fwd_step(o, d, thr, alive, acc, geom, mat, consts, xi=None, *, faraway, s_cheap, sharp_e, sharp_s,
                    tex_hw=None, skip: str = "auto"):
    """One smooth bounce per launch, glossy with ``xi`` (2, N) when given, in
    the atlas mode with ``tex_hw``; outputs as :func:`smooth_fwd_step_plain`.
    ``skip`` ("auto", "on", "off") picks the kernel whose winner sweep and
    shadow product leave out the spheres that cannot change them, or the
    kernel without; the outputs are the same bitwise.  "auto" takes it from
    STEP_SKIP_MIN_CHEAP cheap-tier spheres on."""
    code = _skip_code(skip)
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tex_hw=tex_hw)
    device = _check(
        {"o": o, "d": d, "acc": acc}, geom, mat, consts, s_cheap=s_cheap, depth=1,
        stacks={"xi": (xi, 2)}, lanes={"thr": thr, "alive": alive},
    )
    if device.type == "cpu":
        return smooth_fwd_step_plain(o, d, thr, alive, acc, geom, mat, consts, xi, **kw)
    n, s = d.shape[1], geom.shape[0]
    with torch.cuda.device(device):
        outs = (
            torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr), torch.empty_like(alive),
            torch.empty_like(acc), torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty_like(thr), torch.empty_like(thr),
        )
        tex = () if tex_hw is None else (torch.empty((n,), dtype=torch.int32, device=device), torch.empty_like(thr))
        _launch("smooth_fwd_step", d.dtype, o, d, thr, alive, acc, geom, mat, consts, xi, *outs, *(tex or (None, None)),
                *_scalars(n, s, s_cheap, None, faraway, sharp_e, sharp_s), *slot_args(tex_hw), code, atlas=bool(tex))
    return outs + tex


def smooth_bwd_step(
    o, d, thr, alive, idx, hit, clear, geom, mat, consts, g_o, g_d, g_thr, g_alive, g_acc, xi=None,
    *, faraway, s_cheap, sharp_e, sharp_s, g_dww=None, tex_hw=None,
):
    """The adjoint of one bounce in one launch (plus the fixed-order
    reduction of the table gradients), in the atlas mode with ``g_dww`` (N,)
    and ``tex_hw``; outputs as :func:`smooth_bwd_step_plain`."""
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, g_dww=g_dww, tex_hw=tex_hw)
    if (g_dww is None) != (tex_hw is None):
        raise ValueError("the atlas mode takes both g_dww and tex_hw")
    lanes = {"thr": thr, "alive": alive, "idx": idx, "hit": hit, "clear": clear, "g_thr": g_thr, "g_alive": g_alive}
    if g_dww is not None:
        lanes["g_dww"] = g_dww
    device = _check(
        {"o": o, "d": d, "g_o": g_o, "g_d": g_d, "g_acc": g_acc}, geom, mat, consts, s_cheap=s_cheap, depth=1,
        stacks={"xi": (xi, 2)}, lanes=lanes,
    )
    if device.type == "cpu":
        return smooth_bwd_step_plain(
            o, d, thr, alive, idx, hit, clear, geom, mat, consts, g_o, g_d, g_thr, g_alive, g_acc, xi, **kw
        )
    n, s = d.shape[1], geom.shape[0]
    with torch.cuda.device(device):
        outs = (torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr), torch.empty_like(alive))
        rows = step_rows(n)
        # The geometry and constant rows are written whole; the material
        # rows are added into at each CTA's winners.
        e = functools.partial(torch.empty, dtype=d.dtype, device=device)
        pg, pc, flat = e((rows, s, 4)), e((rows, N_CONST)), e((_n_vals(s),))
        pm = torch.zeros((rows, s, STEP_MAT), dtype=d.dtype, device=device)
        _launch("smooth_bwd_step", d.dtype, o, d, thr, alive, idx, hit, clear, geom, mat, consts, xi,
                g_o, g_d, g_thr, g_alive, g_acc, g_dww, *outs, pg, pm, pc, flat,
                *_scalars(n, s, s_cheap, None, faraway, sharp_e, sharp_s, rows), *slot_args(tex_hw),
                atlas=g_dww is not None)
    g_geom, g_mat, g_consts, _ = _split_grads(flat, s)
    return (*outs, g_geom, g_mat, g_consts)


# ---------------------------------------------------------------------------
# Autograd: the kernels' own adjoints stand in for torch's.  xi is a random
# sample, a constant of the loss: its cotangent is None, as the JAX custom
# VJPs give it zero.
# ---------------------------------------------------------------------------


class _TraceSubDeep(torch.autograd.Function):
    """acc (3, N) of the smooth chain, and in the atlas mode (``kw["tex_hw"]``)
    each bounce's flat texel ids and dww (depth, N); backward launches
    ``smooth_bwd_deep`` with acc's cotangent and dww's.  The ids are
    selectors: no cotangent."""

    @staticmethod
    def forward(ctx, o, d, geom, mat, consts, xi, kw):
        acc, *res = smooth_fwd_deep(o, d, geom, mat, consts, xi, **kw)
        tex = tuple(res[7:])
        ctx.kw = kw
        ctx.save_for_backward(o, d, *res[:7], geom, mat, consts, xi)
        if tex:
            ctx.mark_non_differentiable(tex[0])
        return (acc, *tex) if tex else acc

    @staticmethod
    def backward(ctx, g_acc, *g_tex):
        *saved, xi = ctx.saved_tensors
        kw = dict(ctx.kw)
        if g_tex:
            kw["g_dww"] = g_tex[1].contiguous()
        g_o, g_d, g_geom, g_mat, g_consts = smooth_bwd_deep(*saved, g_acc.contiguous(), xi, **kw)
        return g_o, g_d, g_geom, g_mat, g_consts, None, None


class _BounceSub(torch.autograd.Function):
    """One smooth bounce, ``(o, d, thr, alive, acc)`` in and out, and in the
    atlas mode (``kw["tex_hw"]``) its flat texel ids and dww (N,); backward
    launches ``smooth_bwd_step``, and acc's cotangent passes through."""

    @staticmethod
    def forward(ctx, o, d, thr, alive, acc, geom, mat, consts, xi, kw):
        o_n, d_n, thr_n, alive_n, acc_n, idx, hit, clear, *tex = smooth_fwd_step(
            o, d, thr, alive, acc, geom, mat, consts, xi, **kw
        )
        ctx.kw = kw
        ctx.save_for_backward(o, d, thr, alive, idx, hit, clear, geom, mat, consts, xi)
        if tex:
            ctx.mark_non_differentiable(tex[0])
        return (o_n, d_n, thr_n, alive_n, acc_n, *tex)

    @staticmethod
    def backward(ctx, g_o, g_d, g_thr, g_alive, g_acc, *g_tex):
        *saved, xi = ctx.saved_tensors
        cots = tuple(g.contiguous() for g in (g_o, g_d, g_thr, g_alive, g_acc))
        kw = dict(ctx.kw)
        if g_tex:
            kw["g_dww"] = g_tex[1].contiguous()
        g_o_in, g_d_in, g_thr_in, g_alive_in, g_geom, g_mat, g_consts = smooth_bwd_step(*saved, *cots, xi, **kw)
        return g_o_in, g_d_in, g_thr_in, g_alive_in, cots[4], g_geom, g_mat, g_consts, None, None


class _TrainLossSubDeep(torch.autograd.Function):
    """SSE of the clipped chain against ``tgt``; the forward's one
    ``train_deep`` launch already computed every gradient, so backward only
    scales them.  The target is a constant of the loss: its cotangent is
    zero by contract, as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, o, d, tgt, geom, mat, consts, xi, kw):
        sse, *grads = train_deep(o, d, tgt, geom, mat, consts, xi, **kw)
        ctx.save_for_backward(*grads)
        return sse

    @staticmethod
    def backward(ctx, g):
        g_o, g_d, g_geom, g_mat, g_consts = ctx.saved_tensors
        return g * g_o, g * g_d, None, g * g_geom, g * g_mat, g * g_consts, None, None


def _kernel_inputs(origin, dirs_t, scene, cfg):
    """(o, d) (3, N), the three tables and the scalar parameters."""
    dtype = cfg.dtype
    d = dirs_t.to(dtype).contiguous()
    o = origin.to(dtype).reshape(3, -1).expand(d.shape).contiguous()
    tables = (geometry_table(scene, dtype), material_table(scene, dtype), consts_row(scene, dtype))
    kw = dict(
        depth=cfg.max_depth, faraway=cfg.faraway, s_cheap=scene.spheres.count - scene.spheres.n_exact,
        sharp_e=float(cfg.edge_sharpness), sharp_s=float(cfg.shadow_sharpness),
    )
    return o, d, tables, kw


def _xi_stack(key, n: int, cfg, device):
    """Every bounce's xi stacked (2 * depth, N), or None off the stochastic path."""
    if not cfg.stochastic_roughness or key is None:
        return None
    return torch.cat(bounce_xi(key, n, cfg.max_depth, cfg.dtype, device))


def trace_fused_smooth_sub(origin, dirs_t, scene, cfg, *, route: str = "auto", key=None) -> torch.Tensor:
    """Smooth-visibility trace through the kernels; (N, 3) colors.

    ``route="auto"`` takes the depth-fused pair (``smooth_fwd_deep`` /
    ``smooth_bwd_deep``) for depth >= 2 and the one-bounce pair
    (``smooth_fwd_step`` / ``smooth_bwd_step``) once per bounce for depth
    1, as the JAX package does; a caller may force ``"deep"`` or
    ``"step"``.  With ``cfg.stochastic_roughness`` and a seed ``key`` the
    bounces are glossy, xi drawn on the JAX package's schedule.  An atlas
    scene takes the kernels' atlas mode and adds the texels in depth order:
    every bounce's after the deep pair, each bounce's after its step.
    """
    if route == "auto":
        route = "deep" if cfg.max_depth >= 2 else "step"
    if route not in ("deep", "step"):
        raise ValueError(f"unknown route {route!r}")
    o, d, tables, kw = _kernel_inputs(origin, dirs_t, scene, cfg)
    xi = _xi_stack(key, d.shape[1], cfg, d.device)
    texels, kw["tex_hw"] = atlas_texels(scene, cfg.dtype)
    if route == "deep":
        acc = _TraceSubDeep.apply(o, d, *tables, xi, kw)
        if texels is not None:
            acc, flats, dwws = acc
            for dep in range(cfg.max_depth):
                acc = compose_texels(acc, texels, flats[dep], dwws[dep])
        return acc.T
    step_kw = {k: v for k, v in kw.items() if k != "depth"}
    thr, alive, acc = torch.ones_like(d[0]), torch.ones_like(d[0]), torch.zeros_like(d)
    for dep in range(cfg.max_depth):
        xi_k = None if xi is None else xi[2 * dep : 2 * dep + 2]
        o, d, thr, alive, acc, *tex = _BounceSub.apply(o, d, thr, alive, acc, *tables, xi_k, step_kw)
        if tex:
            acc = compose_texels(acc, texels, *tex)
    return acc.T


def fused_train_l2(origin, dirs_t, target, scene, cfg, key=None) -> torch.Tensor:
    """L2 pixel loss (mean over N*3 values of the CLIPPED render against
    ``target`` (N, 3)) through the single-launch train kernel, glossy with
    xi from ``key`` on the stochastic path.

    The gradient flows to the scene (rays, sphere tables, lights, camera)
    only: ``target`` and xi are constants of the loss, and their
    cotangents are zero by contract.
    """
    o, d, tables, kw = _kernel_inputs(origin, dirs_t, scene, cfg)
    n = d.shape[1]
    tgt = target.detach().to(cfg.dtype).reshape(n, 3).T.contiguous()
    return _TrainLossSubDeep.apply(o, d, tgt, *tables, _xi_stack(key, n, cfg, d.device), kw) / (n * 3)
