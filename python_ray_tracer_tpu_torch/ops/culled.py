"""Culled big-scene hard render: candidate lists, the kernel pair, the trace.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_culled`, the route the JAX
renderer takes for hard scenes of :data:`MIN_CULL_SPHERES` and more (BASELINE
config 4: 1024 spheres, 1920x1080, depth 4).  Per bounce:

* conservative per-tile candidate lists (:func:`candidate_lists`): every
  64-ray bound group (:data:`_BOUND_G`) gets an interval box test and a
  point-apex cone test against every cheap-tier sphere (shadow lists also a
  double cone with its apex at the light), and a tile's list is the union
  of its groups', ascending sphere ids, so lowest-index-wins ties survive;
* ``near_culled`` (CUDA, ``csrc/culled.cu``): the nearest hit over a tile's
  candidates (or the full table when the list overflowed or the bounce is a
  full-sweep one), naive roots for selection, the winner's t recomputed
  exactly; it writes t, idx, the hit point and the normal;
* the glue between the kernels (nudged origin, direction to the light,
  shadow-list bounds over the live hit lanes);
* ``shade_culled`` (CUDA): the candidate shadow sweep, the shading and the
  mirror continuation; on an atlas scene its atlas mode also returns each
  image lane's flat texel id and ``dww`` weight, and the glue adds the
  texels (:func:`.texture.compose_texels`) right after it, in the bounce's
  ray order, as the JAX package does.

Reflected bounces first re-sort 32-ray groups (:data:`_SORT_G`) by the
live-weighted centroid's (origin cell, direction bin) key
(:func:`ray_sort_keys`), so tiles become coherent cones again and spent rays
compact into tiles the energy cut (:data:`DEAD_THR`) skips; a group id
undoes the permutation at the end.  From bounce :data:`FULL_SWEEP_FROM_BOUNCE`
on, live tiles sweep the whole table.

The TPU's (8, 128) tile packing is not kept, but its partition is: the rays
stay in flat order on the (3, N) layout, a tile is :data:`CULL_BLOCK_RAYS`
consecutive rays, a bound group 64 and a sort group 32, so every candidate
list and every energy-cut decision covers the same rays as in JAX.

Beside each kernel sits its plain PyTorch version; a wrapper given CPU
tensors runs it, given CUDA tensors it launches the kernel or raises.
:data:`LAUNCHES` counts the launches.  Hard visibility has no gradient.
"""

from __future__ import annotations

import torch

from . import _build
from .bounce_sub import _dot3, _normalize3, _sphere_t, _sphere_t_exact, shade_color
from .shading import NUDGE
from .tables import MAT_COLS, N_CONST, SG, consts_row, geometry_table, material_table
from .texture import atlas_texels, compose_texels, slot_args
from .vecmath import sqrt

# Routing scope of the JAX package's culled routes (render._render_sample,
# ops/pallas_culled.py; the smooth route adds ops/culled_smooth.py's).
MIN_CULL_SPHERES = 96
MAX_CULL_EXACT = 8  # exact-tier spheres are swept unconditionally
MAX_CULL_DEPTH = 4096

CULL_BLOCK_RAYS = 4096  # rays per tile: one candidate list and one energy-cut decision
_BOUND_G = 64  # rays per bound group of the candidate masks
_SORT_G = 32  # rays per group moved by the reflected-bounce re-sort
FULL_SWEEP_FROM_BOUNCE = 2
MAX_CAND = 1024  # candidate ids per tile; a longer list sweeps the full table
DEAD_THR = 2e-4  # below this throughput a bounce cannot move a uint8 value
_DEAD_KEY = 1 << 24  # sorts spent ray groups to the tail
_BIG = 3.0e38  # shadow-sweep sentinel of the JAX kernel, in both dtypes

LAUNCHES = {"near_culled": 0, "shade_culled": 0}
# Launches of the atlas mode (shade_culled only: near_culled takes no atlas).
ATLAS_LAUNCHES = {"shade_culled": 0}

_SOURCE = "culled.cu"


# ---------------------------------------------------------------------------
# Candidate-list glue, the JAX functions term for term.
# ---------------------------------------------------------------------------


def _interval_prod(al, ah, bl, bh):
    p1, p2, p3, p4 = al * bl, al * bh, ah * bl, ah * bh
    lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    return lo, hi


def interval_hit_mask(o_lo, o_hi, d_lo, d_hi, center, radius, t_margin: float = 0.0, both_nappes: bool = False):
    """(T, S) bool: could any ray in a tile's interval box hit sphere s?

    ``o_lo``/``o_hi``/``d_lo``/``d_hi`` (T, 3) bound the origins and unit
    directions, ``center`` (S, 3), ``radius`` (S,).  Interval lower bound of
    the squared line distance ``|oc|^2 - (d.oc)^2`` against r^2, and a
    forward clause (``t_margin`` widens it; ``both_nappes`` keeps the line
    test alone), as the JAX function documents.
    """
    oc_l = o_lo[:, None, :] - center[None, :, :]  # (T, S, 3)
    oc_h = o_hi[:, None, :] - center[None, :, :]
    straddle = (oc_l <= 0) & (oc_h >= 0)
    comp_min2 = torch.where(straddle, 0.0, torch.minimum(oc_l * oc_l, oc_h * oc_h))
    n2_lo = comp_min2[..., 0] + comp_min2[..., 1] + comp_min2[..., 2]  # lower bound of |oc|^2
    s_lo = torch.zeros_like(n2_lo)
    s_hi = torch.zeros_like(n2_lo)
    for i in range(3):
        lo, hi = _interval_prod(d_lo[:, None, i], d_hi[:, None, i], oc_l[..., i], oc_h[..., i])
        s_lo = s_lo + lo
        s_hi = s_hi + hi
    dist2_lo = n2_lo - torch.maximum(s_lo * s_lo, s_hi * s_hi)
    r2 = (radius * radius)[None, :]
    if both_nappes:
        return dist2_lo <= r2
    rt2 = ((radius + t_margin) * (radius + t_margin))[None, :] if t_margin else r2
    return (dist2_lo <= r2) & ((s_lo < 0) | (n2_lo <= rt2))


def _tile_bounds(v, tile_rays: int, valid=None):
    """Per-tile componentwise (lo, hi) of a (3, N) array -> (T, 3) each;
    ``valid`` (N,) keeps lanes out of the bounds (an all-invalid tile gets
    lo > hi, an empty candidate set)."""
    t = v.shape[1] // tile_rays
    v = v.reshape(3, t, tile_rays)
    if valid is None:
        return v.amin(2).T, v.amax(2).T
    vm = valid.reshape(1, t, tile_rays)
    return torch.where(vm, v, 1.0e30).amin(2).T, torch.where(vm, v, -1.0e30).amax(2).T


def _group_cull_mask(o, d, center, radius, tile_rays: int, valid=None, light=None,
                     t_margin: float = 0.0, both_nappes: bool = False):
    """(T, S) candidate mask: the union over a tile's 64-ray bound groups of
    (interval box test AND point-apex cone test), each group's rays
    consecutive in ``o``/``d`` (3, N); with ``light`` (3,), AND the double
    cone with its apex at the light (shadow lists)."""
    ng = o.shape[1] // _BOUND_G
    s = center.shape[0]
    og = o.reshape(3, ng, _BOUND_G)
    dg = d.reshape(3, ng, _BOUND_G)
    if valid is None:
        vg = None
        o_lo, o_hi, d_lo, d_hi = og.amin(-1), og.amax(-1), dg.amin(-1), dg.amax(-1)
        live_g = torch.ones((ng,), dtype=torch.bool, device=o.device)
    else:
        vg = valid.reshape(1, ng, _BOUND_G)
        o_lo = torch.where(vg, og, 1.0e30).amin(-1)
        o_hi = torch.where(vg, og, -1.0e30).amax(-1)
        d_lo = torch.where(vg, dg, 1.0e30).amin(-1)
        d_hi = torch.where(vg, dg, -1.0e30).amax(-1)
        live_g = vg[0].any(-1)

    # Cone per group: apex the origin box's center, its half-diagonal
    # folded into the sphere radius, axis the mean direction, half-angle
    # from the worst live ray.
    apex = 0.5 * (o_lo + o_hi)
    ext = o_hi - o_lo
    pad = 0.5 * sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    axis = d_lo + d_hi
    a_n = sqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2])
    axis = axis / torch.clamp_min(a_n, 1e-9)
    cosang = sum(dg[i] * axis[i][..., None] for i in range(3))
    if vg is not None:
        cosang = torch.where(vg[0], cosang, 1.0)
    cos_t = torch.clamp(cosang.amin(-1), -1.0, 1.0)
    sin_t = sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))

    n2_lo = torch.zeros((ng, s), dtype=o.dtype, device=o.device)
    s_lo, s_hi, vdotu, d2 = (torch.zeros_like(n2_lo) for _ in range(4))
    for i in range(3):
        oc_l = o_lo[i][:, None] - center[None, :, i]
        oc_h = o_hi[i][:, None] - center[None, :, i]
        straddle = (oc_l <= 0) & (oc_h >= 0)
        n2_lo += torch.where(straddle, 0.0, torch.minimum(oc_l * oc_l, oc_h * oc_h))
        plo, phi = _interval_prod(d_lo[i][:, None], d_hi[i][:, None], oc_l, oc_h)
        s_lo += plo
        s_hi += phi
        v_i = center[None, :, i] - apex[i][:, None]
        vdotu += v_i * axis[i][:, None]
        d2 += v_i * v_i
    r2 = (radius * radius)[None, :]
    rt2 = ((radius + t_margin) * (radius + t_margin))[None, :] if t_margin else r2
    box = n2_lo - torch.maximum(s_lo * s_lo, s_hi * s_hi) <= r2
    if not both_nappes:
        box = box & ((s_lo < 0) | (n2_lo <= rt2))

    dist = sqrt(d2)
    rr = radius[None, :] + pad[:, None]
    sfr = torch.clamp_max(rr / torch.clamp_min(dist, 1e-9), 1.0)
    cos_phi = sqrt(torch.clamp_min(1.0 - sfr * sfr, 0.0))
    ct = cos_t[:, None]
    st = sin_t[:, None]
    # beta <= theta + phi as cos(beta) >= cos(theta + phi), with the wrap
    # case theta + phi >= pi admitted unconditionally.
    edge = torch.clamp_min(dist, 1e-9) * (ct * cos_phi - st * sfr - 1e-6)
    cone = (vdotu >= edge) | (dist <= rr + t_margin) | (ct < -cos_phi)
    if both_nappes:
        cone = cone | (-vdotu >= edge)
    mask_g = box & cone & live_g[:, None]

    if light is not None:
        # Shadow lines all pass (within NUDGE) through the point light: a
        # double cone with its apex there; both nappes, since occluders
        # beyond the light block too.
        lg_v = tuple(apex[i] - light[i] for i in range(3))
        lg_d = sqrt(lg_v[0] * lg_v[0] + lg_v[1] * lg_v[1] + lg_v[2] * lg_v[2])
        lg_inv = 1.0 / torch.clamp_min(lg_d, 1e-9)
        sg_sin = torch.clamp_max((pad + NUDGE) * lg_inv, 1.0)
        sg_cos = sqrt(torch.clamp_min(1.0 - sg_sin * sg_sin, 0.0))
        ls_dot = torch.zeros_like(n2_lo)
        ls_d2 = torch.zeros_like(n2_lo)
        for i in range(3):
            v_i = center[None, :, i] - light[i]
            ls_dot += v_i * (lg_v[i] * lg_inv)[:, None]
            ls_d2 += v_i * v_i
        ls_d = sqrt(ls_d2)
        r_sl = radius[None, :] + NUDGE
        ss_sin = torch.clamp_max(r_sl / torch.clamp_min(ls_d, 1e-9), 1.0)
        ss_cos = sqrt(torch.clamp_min(1.0 - ss_sin * ss_sin, 0.0))
        rhs = sg_cos[:, None] * ss_cos - sg_sin[:, None] * ss_sin - 1e-6
        mask_g &= (torch.abs(ls_dot) >= torch.clamp_min(ls_d, 1e-9) * rhs) | (ls_d <= r_sl)

    return mask_g.reshape(-1, tile_rays // _BOUND_G, s).any(1)


def candidate_lists(o, d, center, radius, tile_rays: int, valid=None, light=None,
                    t_margin: float = 0.0, both_nappes: bool = False):
    """Per-tile capped candidate ids and loop counts for ``o``/``d`` (3, N).

    Returns ``(cand, cnt_cand, cnt_full)``: ``cand`` (T, MAX_CAND) int32,
    ascending sphere ids first (the rest of a row is the other ids, then
    zeros), ``cnt_cand`` and ``cnt_full`` (T,) int32: a tile loops its
    ``cnt_cand`` candidates, or ``cnt_full`` = S full-table spheres when the
    list overflowed :data:`MAX_CAND`.  Group tests when a tile's 8 TPU rows
    split into whole bound groups (as the JAX package decides), else one
    interval box per tile.
    """
    s_cheap = center.shape[0]
    if tile_rays % (8 * _BOUND_G) == 0:
        mask = _group_cull_mask(o, d, center, radius, tile_rays, valid, light, t_margin, both_nappes)
    else:
        o_lo, o_hi = _tile_bounds(o, tile_rays, valid)
        d_lo, d_hi = _tile_bounds(d, tile_rays, valid)
        mask = interval_hit_mask(o_lo, o_hi, d_lo, d_hi, center, radius, t_margin, both_nappes)
    order = torch.argsort(torch.where(mask, 0, 1), dim=1, stable=True).to(torch.int32)
    width = min(s_cheap, MAX_CAND)
    cand = order[:, :width]
    if width < MAX_CAND:
        cand = torch.cat([cand, torch.zeros((cand.shape[0], MAX_CAND - width), dtype=torch.int32, device=o.device)], 1)
    counts = mask.sum(1).to(torch.int32)
    overflow = counts > MAX_CAND
    cnt_cand = torch.where(overflow, 0, counts).to(torch.int32)
    cnt_full = torch.where(overflow, s_cheap, 0).to(torch.int32)
    return cand.contiguous(), cnt_cand, cnt_full


def full_sweep_lists(live, s_cheap: int):
    """Lists of a full-sweep bounce: no candidates, ``cnt_full`` = S for the
    live tiles of ``live`` (T,) bool."""
    cand = torch.zeros((live.shape[0], MAX_CAND), dtype=torch.int32, device=live.device)
    cnt = torch.zeros((live.shape[0],), dtype=torch.int32, device=live.device)
    return cand, cnt, torch.where(live, s_cheap, 0).to(torch.int32)


def ray_sort_keys(o, d, live, bb_lo, bb_hi):
    """Spatial-directional bin key per ray of ``o``/``d`` (3, N), dead rays
    last: dead(1) | cell x, z, y (4 bits each, over the cheap-tier box
    ``bb_lo``..``bb_hi``) | direction bins x, y, z (4 bits each).  int64
    holds the 25-bit key (torch has no full uint32 arithmetic)."""
    inv = 15.0 / torch.clamp_min(bb_hi - bb_lo, 1e-6)
    cell = [torch.clamp((o[a] - bb_lo[a]) * inv[a], 0.0, 15.0).to(torch.int64) for a in range(3)]
    dbin = [torch.clamp((d[a] + 1.0) * 8.0, 0.0, 15.0).to(torch.int64) for a in range(3)]
    key = (cell[0] << 20) | (cell[2] << 16) | (cell[1] << 12) | (dbin[0] << 8) | (dbin[1] << 4) | dbin[2]
    return torch.where(live, key, key | _DEAD_KEY)


# ---------------------------------------------------------------------------
# Plain versions of the kernels: the JAX kernel bodies on (N,) rows.
# ---------------------------------------------------------------------------


def _sphere_sol_fast(o, d, cx, cy, cz, r):
    """Naive-root hit distance for sweep selection: ``(sol, valid)``; a
    negative discriminant gives NaN and so ``valid`` false."""
    ocx = o[0] - cx
    ocy = o[1] - cy
    ocz = o[2] - cz
    b = d[0] * ocx + d[1] * ocy + d[2] * ocz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    sq = sqrt(b * b - c2)
    t0 = -b - sq
    sol = torch.where(t0 > 0, t0, sq - b)
    return sol, sol > 0


def _sweep_lanes(o, d, cand, cnt_cand, cnt_full, geom, s_cheap, tile_rays, update, carry):
    """``update(take_mask_fn, sid, g, t_k_or_sol, valid, carry)`` over each
    lane's candidates, then its full sweep: the kernels' two cheap-tier
    loops, evaluated slot by slot for all lanes with the inactive masked.
    Each lane's counts are its tile's, clamped as the kernels clamp them."""
    n = o[0].shape[0]
    tile = torch.arange(n, device=cand.device) // tile_rays
    cc = torch.clamp(cnt_cand.long()[tile], 0, cand.shape[1])
    cf = torch.clamp(cnt_full.long()[tile], 0, s_cheap)
    for j in range(int(cc.max()) if n else 0):
        sid = cand[tile, j]
        g = geom[sid.long()]
        sol, valid = _sphere_sol_fast(o, d, g[:, 0], g[:, 1], g[:, 2], g[:, 3])
        carry = update(j < cc, sid, tuple(g[:, c] for c in range(4)), sol, valid, carry)
    for k in range(int(cf.max()) if n else 0):
        g = geom[k]
        sol, valid = _sphere_sol_fast(o, d, g[0], g[1], g[2], g[3])
        sid = torch.full_like(tile, k, dtype=torch.int32)
        carry = update(k < cf, sid, tuple(g[c].expand(n) for c in range(4)), sol, valid, carry)
    return carry


def near_culled_plain(o, d, cand, cnt_cand, cnt_full, geom, *, faraway: float, s_cheap: int, tile_rays: int):
    """Plain version of ``near_culled``: ``(t, idx, p, normal)``, t and idx
    (N,), the hit point and ``(p - c) / r`` (3, N); a miss has t = faraway,
    idx 0 and sphere 0's geometry."""
    dtype = o.dtype
    n = o.shape[1]
    far = torch.tensor(faraway, dtype=dtype, device=o.device)
    o3, d3 = tuple(o), tuple(d)

    def select(take, sid, g, t_k, carry):
        tmin, imin, cw = carry
        return (
            torch.where(take, t_k, tmin),
            torch.where(take, sid, imin),
            tuple(torch.where(take, g[c], cw[c]) for c in range(4)),
        )

    def cheap(active, sid, g, sol, valid, carry):
        return select(active & valid & (sol < carry[0]), sid, g, sol, carry)

    carry = (
        far.expand(n).clone(),
        torch.zeros((n,), dtype=torch.int32, device=o.device),
        tuple(geom[0, c].expand(n) for c in range(4)),
    )
    carry = _sweep_lanes(o3, d3, cand, cnt_cand, cnt_full, geom, s_cheap, tile_rays, cheap, carry)
    for k in range(s_cheap, geom.shape[0]):  # exact tier: always swept
        g = tuple(geom[k, c].expand(n) for c in range(4))
        t_k = _sphere_t_exact(o3, d3, *g, far)
        carry = select(t_k < carry[0], torch.full((n,), k, dtype=torch.int32, device=o.device), g, t_k, carry)
    t_sel, imin, cw = carry
    # The winner's t once more with the exact forms, on its carried geometry.
    t_win = _sphere_t(o3, d3, *cw, far)
    if s_cheap < geom.shape[0]:
        t_win = torch.where(imin >= s_cheap, _sphere_t_exact(o3, d3, *cw, far), t_win)
    tmin = torch.where(t_sel != far, t_win, far)
    hit = tmin != far
    t_safe = torch.where(hit, tmin, 1.0)
    p = torch.stack([o[c] + d[c] * t_safe for c in range(3)])
    normal = torch.stack([(p[c] - cw[c]) / cw[3] for c in range(3)])
    return tmin, torch.where(hit, imin, 0), p, normal


def shade_culled_plain(o, d, thr, alive, acc, t, idx, p_n, normal, to_light, mat, cand, cnt_cand, cnt_full,
                       geom, consts, *, faraway: float, s_cheap: int, tile_rays: int, tex_hw=None):
    """Plain version of ``shade_culled``: the candidate shadow sweep, the
    shading and the mirror continuation; returns the next ``(o, d, thr,
    alive, acc)``, and with the atlas's slot extents ``tex_hw`` also each
    lane's flat texel id and dww (N,)."""
    dtype = o.dtype
    n = o.shape[1]
    far = torch.tensor(faraway, dtype=dtype, device=o.device)
    big = torch.tensor(_BIG, dtype=dtype, device=o.device)
    hit = (t != far).to(dtype)
    coverage = hit * alive
    t_safe = torch.where(hit > 0, t, 1.0)
    rows = mat[idx.long()].T  # (MAT_COLS, N): the winner's material row

    def m(col):
        return rows[col]

    def const(i):
        return consts[0, i]

    o3, d3, pn3, n3, l3 = (tuple(x) for x in (o, d, p_n, normal, to_light))
    p = tuple(o3[i] + d3[i] * t_safe for i in range(3))
    to_cam = _normalize3(tuple(const(i) - p[i] for i in range(3)))

    def shadow(active, sid, t_k, carry):
        t_others, t_self = carry
        is_self = idx == sid
        new_others = torch.minimum(t_others, torch.where(is_self, big, t_k))
        new_self = torch.where(is_self, torch.minimum(t_self, t_k), t_self)
        return torch.where(active, new_others, t_others), torch.where(active, new_self, t_self)

    def cheap(active, sid, g, sol, valid, carry):
        # The miss sentinel is faraway, as the exact tier's: all-miss lanes tie.
        return shadow(active, sid, torch.where(valid, sol, far), carry)

    carry = (big.expand(n), big.expand(n))
    carry = _sweep_lanes(pn3, l3, cand, cnt_cand, cnt_full, geom, s_cheap, tile_rays, cheap, carry)
    everywhere = torch.ones((n,), dtype=torch.bool, device=o.device)
    for k in range(s_cheap, geom.shape[0]):
        carry = shadow(everywhere, k, _sphere_t_exact(pn3, l3, *(geom[k, c] for c in range(4)), far), carry)
    t_others, t_self = carry
    in_light = (t_self <= t_others).to(dtype)

    color = shade_color(p, n3, l3, to_cam, in_light, m, const, tex_hw)
    tex = ()
    if tex_hw is not None:
        color, flat, is_image, diffuse_w = color
        tex = (flat, torch.where(is_image, diffuse_w * thr * coverage, torch.zeros_like(thr)))
    w = thr * coverage
    thr_next = w * (0.5 * m(SG) * in_light)
    ddn = 2.0 * _dot3(d3, n3)
    refl = _normalize3(tuple(d3[i] - n3[i] * ddn for i in range(3)))
    acc_next = torch.stack([acc[i] + color[i] * w for i in range(3)])
    return (p_n.clone(), torch.stack(refl), thr_next, alive * hit, acc_next, *tex)


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, kernel launch on CUDA tensors.
# ---------------------------------------------------------------------------


def _check(o, rays: dict, lanes: dict, ints: dict, cand, cnt_cand, cnt_full, geom, tile_rays: int, s_cheap: int,
           tables: dict | None = None) -> torch.device:
    """Validate what the culled kernels take; returns the common device."""
    n = o.shape[-1]
    s = geom.shape[0]
    floats = {**rays, **lanes, "geom": geom, **(tables or {})}
    for name, x in {**floats, **ints, "cand": cand, "cnt_cand": cnt_cand, "cnt_full": cnt_full}.items():
        if x.requires_grad:
            raise ValueError(f"{name}: the culled kernels have no gradient; pass a detached tensor")
        if x.device != o.device:
            raise ValueError(f"{name}: expected a tensor on {o.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, x in floats.items():
        if x.dtype != o.dtype:
            raise ValueError(f"{name}: expected {o.dtype}, got {x.dtype}")
    for name, x in {**ints, "cand": cand, "cnt_cand": cnt_cand, "cnt_full": cnt_full}.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {x.dtype}")
    for name, x in rays.items():
        if x.shape != (3, n):
            raise ValueError(f"{name}: expected shape (3, {n}), got {tuple(x.shape)}")
    for name, x in {**lanes, **ints}.items():
        if x.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(x.shape)}")
    if n == 0 or tile_rays < 1:
        raise ValueError("no rays to trace, or no rays per tile")
    n_tiles = -(-n // tile_rays)
    if cand.dim() != 2 or cand.shape[0] != n_tiles or cnt_cand.shape != (n_tiles,) or cnt_full.shape != (n_tiles,):
        raise ValueError(f"candidate lists: expected cand (T, C) and counts (T,) for T = {n_tiles} tiles")
    if geom.shape != (s, 4) or s < 1:
        raise ValueError("geom: expected (S, 4) with S >= 1")
    if tables is not None and (tables["mat"].shape != (s, MAT_COLS) or tables["consts"].shape != (1, N_CONST)):
        raise ValueError("tables: expected mat (S, 19) and consts (1, 16)")
    if not 0 <= s_cheap <= s:
        raise ValueError(f"s_cheap must lie in 0..{s}, got {s_cheap}")
    if o.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {o.dtype}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")
    if o.device.type == "cuda" and 4 * s * o.element_size() > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{s} spheres do not fit the kernels' shared-memory geometry table")
    return o.device


# C signatures of the entries in csrc/culled.cu, before the trailing stream:
# p = pointer, i = int, r = the dtype's real.
_SIGNATURES = {
    # o, d, cand, cnt_cand, cnt_full, geom; t, idx, p, normal; n, s_cheap,
    # s_total, tile_rays, cand_stride; faraway
    "near_culled": "pppppp" "pppp" "iiiii" "r",
    # o, d, thr, alive, acc, t, idx, p_n, normal, to_light, mat, cand,
    # cnt_cand, cnt_full, geom, consts; their five outputs; flat and dww
    # (or null); n, s_cheap, s_total, tile_rays, cand_stride; faraway; the
    # atlas's slot extents
    "shade_culled": "pppppppppppppppp" "ppppp" "pp" "iiiii" "r" "ii",
}


def _launch(name: str, dtype: torch.dtype, *args, atlas: bool = False) -> None:
    """Launch kernel ``name`` on the current stream and count it (its atlas
    mode in :data:`ATLAS_LAUNCHES`)."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    (ATLAS_LAUNCHES if atlas else LAUNCHES)[name] += 1


def near_culled(o, d, cand, cnt_cand, cnt_full, geom, *, faraway: float, s_cheap: int, tile_rays: int):
    """The culled nearest hit of rays ``o``/``d`` (3, N): ``(t, idx, p,
    normal)``.  Tile ``i // tile_rays`` of ray ``i`` loops its candidates
    ``cand[tile, :cnt_cand[tile]]``, then ``cnt_full[tile]`` full-table
    spheres, then the exact tier ``s_cheap..S``."""
    device = _check(o, {"o": o, "d": d}, {}, {}, cand, cnt_cand, cnt_full, geom, tile_rays, s_cheap)
    kw = dict(faraway=faraway, s_cheap=s_cheap, tile_rays=tile_rays)
    if device.type == "cpu":
        return near_culled_plain(o, d, cand, cnt_cand, cnt_full, geom, **kw)
    n = o.shape[1]
    with torch.cuda.device(device):
        t = torch.empty((n,), dtype=o.dtype, device=device)
        idx = torch.empty((n,), dtype=torch.int32, device=device)
        p, normal = torch.empty_like(o), torch.empty_like(o)
        _launch(
            "near_culled", o.dtype, o, d, cand, cnt_cand, cnt_full, geom, t, idx, p, normal,
            n, s_cheap, geom.shape[0], tile_rays, cand.shape[1], float(faraway),
        )
    return t, idx, p, normal


def shade_culled(o, d, thr, alive, acc, t, idx, p_n, normal, to_light, mat, cand, cnt_cand, cnt_full, geom,
                 consts, *, faraway: float, s_cheap: int, tile_rays: int, tex_hw=None):
    """The culled shadow sweep, shading and mirror continuation of the hits
    ``near_culled`` found; returns the next ``(o, d, thr, alive, acc)``, and
    with the atlas's slot extents ``tex_hw`` (the atlas mode) also each
    lane's flat texel id and dww (N,)."""
    device = _check(
        o, {"o": o, "d": d, "acc": acc, "p_n": p_n, "normal": normal, "to_light": to_light},
        {"thr": thr, "alive": alive, "t": t}, {"idx": idx}, cand, cnt_cand, cnt_full, geom, tile_rays, s_cheap,
        {"mat": mat, "consts": consts},
    )
    kw = dict(faraway=faraway, s_cheap=s_cheap, tile_rays=tile_rays, tex_hw=tex_hw)
    args = (o, d, thr, alive, acc, t, idx, p_n, normal, to_light, mat, cand, cnt_cand, cnt_full, geom, consts)
    if device.type == "cpu":
        return shade_culled_plain(*args, **kw)
    with torch.cuda.device(device):
        out = (torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr), torch.empty_like(alive),
               torch.empty_like(acc))
        tex = () if tex_hw is None else (torch.empty_like(idx), torch.empty_like(thr))
        _launch(
            "shade_culled", o.dtype, *args, *out, *(tex or (None, None)),
            o.shape[1], s_cheap, geom.shape[0], tile_rays, cand.shape[1], float(faraway),
            *slot_args(tex_hw), atlas=bool(tex),
        )
    return out + tex


# ---------------------------------------------------------------------------
# The trace.
# ---------------------------------------------------------------------------


def _group_take(x, perm):
    """Move whole _SORT_G-ray groups of ``x`` (C, N) or (N,) into ``perm`` order."""
    flat = x.reshape(-1, perm.shape[0], _SORT_G)
    return flat[:, perm].reshape(x.shape)


def trace_fused_culled(origin, dirs_t, scene, cfg) -> torch.Tensor:
    """Hard-visibility trace with per-tile candidate-list culling: (N, 3)
    colors of the rays ``dirs_t`` (3, N) from ``origin`` (3,) or (3, N).
    An atlas scene adds each bounce's texels right after its shade launch."""
    dtype = cfg.dtype
    block = max(cfg.block_rays, CULL_BLOCK_RAYS)
    if block % 8 or block % _SORT_G:
        raise ValueError(f"block_rays must be a multiple of 8 and of {_SORT_G}")
    d = dirs_t.to(dtype)
    n = d.shape[1]
    o = origin.to(dtype).reshape(3, -1).expand(3, n)
    n_pad = -(-n // block) * block
    if n_pad != n:  # pad with copies of ray 0
        o = torch.cat([o, o[:, :1].expand(3, n_pad - n)], dim=1)
        d = torch.cat([d, d[:, :1].expand(3, n_pad - n)], dim=1)
    o, d = o.contiguous(), d.contiguous()
    device = d.device

    geom = geometry_table(scene, dtype)
    mat = material_table(scene, dtype)
    consts = consts_row(scene, dtype)
    texels, tex_hw = atlas_texels(scene, dtype)
    light = scene.lights.point_position.to(dtype)
    s_cheap = scene.spheres.count - scene.spheres.n_exact
    center = scene.spheres.center[:s_cheap].to(dtype)
    radius = scene.spheres.radius[:s_cheap].to(dtype)
    # Cheap-tier box for the re-sort keys (the exact tier would flatten it).
    bb_lo = torch.amin(center - radius[:, None], dim=0)
    bb_hi = torch.amax(center + radius[:, None], dim=0)
    far = cfg.faraway
    kw = dict(faraway=far, s_cheap=s_cheap, tile_rays=block)
    shade_kw = dict(kw, tex_hw=tex_hw)
    ng = n_pad // _SORT_G

    def bounce(state, primary: bool, full_sweep: bool = False):
        o, d, thr, alive, acc, pix = state
        lane_valid = None
        if not primary:
            # Re-sort 32-ray groups by their live-weighted centroid's key.
            lg = ((thr * alive) > DEAD_THR).to(dtype).reshape(ng, _SORT_G)
            wsum = torch.clamp_min(lg.sum(1), 1.0)
            cent = (torch.cat([o, d]).reshape(6, ng, _SORT_G) * lg).sum(2) / wsum
            perm = torch.argsort(ray_sort_keys(cent[0:3], cent[3:6], (lg != 0).any(1), bb_lo, bb_hi), stable=True)
            o, d, thr, alive, acc = (_group_take(x, perm) for x in (o, d, thr, alive, acc))
            pix = pix[perm]
            lane_valid = (thr * alive) > DEAD_THR
        live = thr.reshape(-1, block).amax(1) > DEAD_THR  # the energy cut, per tile
        if full_sweep:
            lists_a = full_sweep_lists(live, s_cheap)
        else:
            cand, cnt, cnt_full = candidate_lists(o, d, center, radius, block, valid=lane_valid)
            lists_a = (cand, torch.where(live, cnt, 0).to(torch.int32), torch.where(live, cnt_full, 0).to(torch.int32))
        t, idx, p, normal = near_culled(o, d, *lists_a, geom, **kw)

        hit = t != far
        p_n = p + normal * NUDGE
        lv = light[:, None] - p
        to_light = lv / sqrt(lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2])[None, :]
        if full_sweep:
            lists_b = lists_a
        else:
            # Shadow bounds over the lanes that hit and carry visible energy.
            shadow_valid = hit & ((thr * alive) > DEAD_THR)
            cand, cnt, cnt_full = candidate_lists(p_n, to_light, center, radius, block, valid=shadow_valid, light=light)
            lists_b = (cand, torch.where(live, cnt, 0).to(torch.int32), torch.where(live, cnt_full, 0).to(torch.int32))
        o, d, thr, alive, acc, *tex = shade_culled(
            o, d, thr, alive, acc, t, idx, p_n, normal, to_light, mat, *lists_b, geom, consts, **shade_kw
        )
        if tex:
            acc = compose_texels(acc, texels, *tex)
        return o, d, thr, alive, acc, pix

    ones = torch.ones((n_pad,), dtype=dtype, device=device)
    state = (o, d, ones, ones.clone(), torch.zeros_like(o), torch.arange(ng, device=device))
    state = bounce(state, primary=True)
    n_cull = max(0, min(FULL_SWEEP_FROM_BOUNCE, cfg.max_depth) - 1)
    for k in range(cfg.max_depth - 1):
        state = bounce(state, primary=False, full_sweep=k >= n_cull)
    acc = state[4]
    if cfg.max_depth > 1:  # undo the re-sorts, group by group
        acc = _group_take(acc, torch.argsort(state[5]))
    return acc.T[:n]
