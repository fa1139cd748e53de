"""Culled smooth route: the differentiable trace of big scenes at big frames.

Port of :mod:`python_ray_tracer_tpu.ops.pallas_culled_smooth`, the route the
JAX renderer takes for smooth frames where :func:`cull_smooth_ok` holds
(BASELINE config 4's training step: 1024 spheres, 1920x1080).  Per bounce:

* the nearest lists: :func:`.culled.candidate_lists` with the cheap-tier
  radius inflated to ``sqrt(r^2 + m/4)``, ``m = 90 / edge_sharpness``, a
  pure line test (``both_nappes``), behind-clauses widened by ``m``;
* ``near_cs`` (CUDA, ``csrc/culled_smooth.cu``): the smooth winner selectors
  over a tile's list (the max-disc fallback included), the winner's hit
  point and normal, and ``sval``, the lanes whose coverage and throughput
  are not exactly zero.  Forward only: its inputs are detached;
* the shadow lists from the nudged hit points towards the light
  (``light=`` double cone, ``m = 90 / shadow_sharpness``, ``sval`` lanes);
* ``fwd_cs``/``bwd_cs`` (CUDA), paired by :class:`_BounceCS`: the smooth
  bounce with the winner known and the shadow product over the tile's list,
  and its adjoint.  On an atlas scene they run in their atlas mode and the
  bounce's texels are added right after ``fwd_cs``, in the bounce's ray
  order (:func:`.texture.compose_texels`), as the JAX package does.

The culling is exact in f32: ``sigmoid(x)`` is exactly 0 for ``x < -88.72``
(``exp`` overflows), so a sphere outside the list has a shadow factor of
exactly 1 and no gradient, and the culled frame equals the unculled one.  In
f64 the factor is 1 - ~1e-39: the f64 route is held against JAX's culled
route and the culled plain versions, not the unculled route.

Every bounce is culled, as in JAX (its ``SMOOTH_CULL_BOUNCES`` is
``1 << 30``); before each reflected one the rays are re-sorted in 32-ray
groups by their live rays' centroid (:class:`_PermuteGroups`, whose backward
is the inverse gather), and the accumulated permutation is undone at the
end.  xi, on the stochastic path,
is drawn over the unpadded rays in flat order and follows the sorts.

Beside each kernel sits its plain PyTorch version; a wrapper given CPU
tensors runs it, given CUDA tensors it launches the kernel or raises.
:data:`LAUNCHES` counts the launches.
"""

from __future__ import annotations

import torch

from ..config import VISIBILITY_SMOOTH
from . import _build
from .bounce_smooth import b_cterm_plain, compensated_b_cterm, quad_sol_disc, sig, sol_disc_exact, sol_disc_plain
from .bounce_smooth_sub import _NEG_BIG, _xi_pair, adjoint_bounce, fwd_sub_math
from .culled import (
    CULL_BLOCK_RAYS,
    MAX_CULL_EXACT,
    MIN_CULL_SPHERES,
    _SORT_G,
    _group_take,
    candidate_lists,
    ray_sort_keys,
)
from .rng import fold_seed, uniform2
from .shading import NUDGE
from .tables import MAT_COLS, N_CONST, consts_row, geometry_table, material_table
from .texture import atlas_texels, compose_texels, slot_args
from .vecmath import sqrt

# Routing scope of the JAX culled smooth route (pallas_culled_smooth.py
# cull_smooth_ok): below this many rays a tile is too wide a slice of the
# frustum to cull, and above MAX_BLK_SPHERES_SMOOTH spheres the JAX package
# takes its lane kernels.
MIN_CULL_SMOOTH_RAYS = 518_400  # 960x540
MAX_BLK_SPHERES_SMOOTH = 4096
# f32 sigmoid(x) == 0.0 exactly for x < -88.73; 90 leaves slack.
_SIG_UNDERFLOW = 90.0

LAUNCHES = {"near_cs": 0, "fwd_cs": 0, "bwd_cs": 0}
# Launches of the atlas mode (near_cs takes no atlas).
ATLAS_LAUNCHES = {"fwd_cs": 0, "bwd_cs": 0}

_SOURCE = "culled_smooth.cu"
# Threads per block of bwd_cs, whose CTA is one tile: a tile of the main
# path is 4096 rays, 16 per thread.
_BWD_THREADS = 256
_WARPS_PER_TILE = _BWD_THREADS // 32
_MAT_GRADS = 15  # material columns CX..TFI that take gradients


def cull_smooth_ok(scene, cfg, n_rays: int) -> bool:
    """Would the JAX package take its culled smooth route here?  (Its
    stochastic flag, ``CULL_SMOOTH_STOCHASTIC``, is on.)"""
    return (
        cfg.use_pallas
        and cfg.visibility == VISIBILITY_SMOOTH
        and MIN_CULL_SPHERES <= scene.spheres.count <= MAX_BLK_SPHERES_SMOOTH
        and scene.spheres.n_exact <= MAX_CULL_EXACT
        and n_rays >= MIN_CULL_SMOOTH_RAYS
    )


# ---------------------------------------------------------------------------
# Plain versions of the kernels: the JAX kernel bodies on (N,) rows.
# ---------------------------------------------------------------------------


def near_cs_plain(o, d, thr, alive, cand, cnt_cand, cnt_full, geom, *, faraway, s_cheap, sharp_e, tile_rays):
    """Plain version of ``near_cs``: ``(idx, hit, p, normal, sval)``, idx int32
    and hit, sval 0/1 (N,), the hit point and ``(p - c) * (1 / r)`` (3, N).

    Tile ``i // tile_rays`` of ray ``i`` sweeps its candidates, then its
    ``cnt_full`` full-tier spheres, then the exact tier, with the smooth
    formulas and tie rules of the unculled sweep."""
    n = o.shape[1]
    o3, d3 = tuple(o), tuple(d)
    tile = torch.arange(n, device=o.device) // tile_rays
    cc = torch.clamp(cnt_cand.long()[tile], 0, cand.shape[1])
    cf = torch.clamp(cnt_full.long()[tile], 0, s_cheap)
    tmin = torch.full_like(o[0], faraway)
    imin = torch.zeros((n,), dtype=torch.int32, device=o.device)
    dmax = torch.full_like(o[0], _NEG_BIG)
    idmax = imin

    def take(active, sid, c, r, fn, carry):
        tmin, imin, dmax, idmax = carry
        _, disc, t, _, _ = fn(o3, d3, c, r, faraway)
        t_take = t < tmin  # strict: lowest index wins exact ties
        d_take = disc > dmax
        if active is not None:
            t_take, d_take = t_take & active, d_take & active
        return (torch.where(t_take, t, tmin), torch.where(t_take, sid, imin),
                torch.where(d_take, disc, dmax), torch.where(d_take, sid, idmax))

    carry = (tmin, imin, dmax, idmax)
    for j in range(int(cc.max())):
        sid = cand[tile, j]
        g = geom[sid.long()]
        carry = take(j < cc, sid, (g[:, 0], g[:, 1], g[:, 2]), g[:, 3], sol_disc_plain, carry)
    for k in range(int(cf.max())):
        carry = take(k < cf, k, tuple(geom[k, :3]), geom[k, 3], sol_disc_plain, carry)
    for k in range(s_cheap, geom.shape[0]):  # exact tier: always swept
        carry = take(None, k, tuple(geom[k, :3]), geom[k, 3], sol_disc_exact, carry)
    tmin, imin, _, idmax = carry
    hit = tmin != faraway
    idx = torch.where(hit, imin, idmax).to(torch.int32)

    g = geom[idx.long()]
    c_w, r_w = (g[:, 0], g[:, 1], g[:, 2]), g[:, 3]
    # The winner's tier-matched quadratic: both tiers, then a select (the JAX
    # kernel's form; the CUDA kernel evaluates each lane's tier only).
    b_p, ct_p = b_cterm_plain(o3, d3, c_w, r_w)
    b_e, ct_e = compensated_b_cterm(o3, d3, c_w, r_w)
    is_exact = idx >= s_cheap
    b_w, ct_w = torch.where(is_exact, b_e, b_p), torch.where(is_exact, ct_e, ct_p)
    sol_w, disc_w, _ = quad_sol_disc(b_w, ct_w, faraway)
    cov_w = sig(sharp_e * disc_w) * sig(sharp_e * sol_w)
    t_safe = torch.where(hit, sol_w, torch.ones_like(sol_w))
    inv_r = 1.0 / r_w
    p = torch.stack([o[i] + d[i] * t_safe for i in range(3)])
    normal = torch.stack([(p[i] - c_w[i]) * inv_r for i in range(3)])
    sval = ((cov_w > 0) & (thr > 0) & (alive > 0)).to(o.dtype)
    return idx, hit.to(o.dtype), p, normal, sval


def fwd_cs_plain(o, d, thr, alive, acc, idx, hit, cand, cnt_cand, cnt_full, geom, mat, consts, xi=None, *,
                 faraway, s_cheap, sharp_e, sharp_s, tile_rays, tex_hw=None):
    """Plain version of ``fwd_cs``: the smooth bounce from the state ``(o, d,
    thr, alive, acc)`` with the winner ``(idx, hit)`` known and the shadow
    loops over the tile's list; glossy with ``xi`` (2, N).  Returns the next
    ``(o, d, thr, alive, acc)`` and the shadow ``clear`` (N,), and with the
    atlas's slot extents ``tex_hw`` also the flat texel ids and dww (N,)."""
    f = fwd_sub_math(
        tuple(o), tuple(d), thr, alive, geom, mat, consts, _xi_pair(xi, 0), faraway=faraway, s_cheap=s_cheap,
        sharp_e=sharp_e, sharp_s=sharp_s, known=(idx, hit != 0), cand_sh=(cand, cnt_cand, cnt_full, tile_rays),
        tex_hw=tex_hw,
    )
    acc_n = torch.stack([acc[i] + f.color[i] * f.w for i in range(3)])
    outs = (torch.stack(f.p_n), torch.stack(f.dout), f.thr_out, f.coverage, acc_n, f.clear)
    return outs if tex_hw is None else outs + (f.flat, f.dww)


def bwd_cs_plain(o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af, geom, mat,
                 consts, g_o, g_d, g_thr, g_alive, g_acc, xi=None, *, faraway, s_cheap, sharp_e, sharp_s, tile_rays,
                 g_dww=None, tex_hw=None):
    """Plain version of ``bwd_cs``: the adjoint of one culled bounce, Phase C
    over the tile's shadow list (in the atlas mode with dww's cotangent
    ``g_dww`` (N,)).  Returns ``(g_o, g_d, g_thr, g_alive, g_geom, g_mat,
    g_consts)``; acc's cotangent passes through.  The nearest lists
    (``cand_a``...) only bound the kernel's winner scatter: here each
    sphere's material gradient sums the lanes it won."""
    o3, d3 = tuple(o), tuple(d)
    f = fwd_sub_math(
        o3, d3, thr, alive, geom, mat, consts, _xi_pair(xi, 0), faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e,
        sharp_s=sharp_s, saved=(idx, hit != 0, clear), cand_sh=(cand_b, cnt_b, cnt_bf, tile_rays), tex_hw=tex_hw,
    )
    ggeom, gmat, gconst = torch.zeros_like(geom), torch.zeros_like(mat), torch.zeros_like(consts)
    cots = (tuple(g_o), tuple(g_d), g_thr, g_alive, tuple(g_acc)) + (() if g_dww is None else (g_dww,))
    g_o3, g_d3, g_thr_in, g_alive_in = adjoint_bounce(
        f, o3, d3, cots, geom, ggeom, gmat, gconst, faraway=faraway, s_cheap=s_cheap,
    )
    return torch.stack(g_o3), torch.stack(g_d3), g_thr_in, g_alive_in, ggeom, gmat, gconst


# ---------------------------------------------------------------------------
# Wrappers: plain version on CPU tensors, kernel launch on CUDA tensors.
# ---------------------------------------------------------------------------


def _check(rays: dict, lanes: dict, lists: list, geom, tables: dict | None, xi, s_cheap: int, tile_rays: int):
    """Validate what the culled smooth kernels take; returns the device.
    ``lists`` holds ``(cand, cnt_cand, cnt_full)`` triples; ``idx`` and the
    lists are int32, the rest the rays' dtype."""
    ref = next(iter(rays.values()))
    n, s = ref.shape[-1], geom.shape[0]
    n_tiles = -(-n // tile_rays) if tile_rays > 0 else 0
    floats = {**rays, **{k: v for k, v in lanes.items() if k != "idx"}, "geom": geom, **(tables or {})}
    if xi is not None:
        floats["xi"] = xi
    ints = {"idx": lanes["idx"]} if "idx" in lanes else {}
    for j, (cand, cnt, cnt_full) in enumerate(lists):
        ints.update({f"cand{j}": cand, f"cnt_cand{j}": cnt, f"cnt_full{j}": cnt_full})
    for name, t in {**floats, **ints}.items():
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"{name}: the culled smooth kernels compute their own gradients; "
                             "call them through _BounceCS or pass a detached tensor")
        if t.device != ref.device:
            raise ValueError(f"{name}: expected a tensor on {ref.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        want = torch.int32 if name in ints else ref.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: expected {want}, got {t.dtype}")
    for name, t in rays.items():
        if t.shape != (3, n):
            raise ValueError(f"{name}: expected shape (3, {n}), got {tuple(t.shape)}")
    for name, t in lanes.items():
        if t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got {tuple(t.shape)}")
    if xi is not None and xi.shape != (2, n):
        raise ValueError(f"xi: expected shape (2, {n}), got {tuple(xi.shape)}")
    if n == 0 or tile_rays < 1 or n % tile_rays:
        raise ValueError(f"{n} rays: expected whole tiles of tile_rays = {tile_rays} rays")
    for cand, cnt, cnt_full in lists:
        if cand.dim() != 2 or cand.shape[0] != n_tiles or cnt.shape != (n_tiles,) or cnt_full.shape != (n_tiles,):
            raise ValueError(f"candidate lists: expected cand (T, C) and counts (T,) for T = {n_tiles} tiles")
    if geom.shape != (s, 4) or s < 1:
        raise ValueError("geom: expected (S, 4) with S >= 1")
    if tables is not None and (tables["mat"].shape != (s, MAT_COLS) or tables["consts"].shape != (1, N_CONST)):
        raise ValueError("tables: expected mat (S, 19) and consts (1, 16)")
    if not 0 <= s_cheap <= s:
        raise ValueError(f"s_cheap must lie in 0..{s}, got {s_cheap}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ref.dtype}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    if ref.device.type == "cuda":
        if (4 * s + N_CONST) * ref.element_size() > _build.MAX_SHARED_BYTES:
            raise ValueError(f"{s} spheres do not fit the kernels' shared-memory geometry table")
        if tile_rays % _BWD_THREADS:
            raise ValueError(f"tile_rays must be a multiple of {_BWD_THREADS}, got {tile_rays}")
    return ref.device


# C signatures of the entries in csrc/culled_smooth.cu, before the trailing
# stream: p = pointer, i = int, r = the dtype's real.
_SIGNATURES = {
    # o, d, thr, alive, cand, cnt, cnt_full, geom; idx, hit, p, normal,
    # sval; n, s_cheap, s_total, tile_rays, cand_stride; faraway, sharp_e
    "near_cs": "pppppppp" "ppppp" "iiiii" "rr",
    # o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat,
    # consts, xi; o, d, thr, alive, acc, clear out; flat and dww (or null);
    # n, s_cheap, s_total, tile_rays, cand_stride; faraway, sharp_e,
    # sharp_s; the atlas's slot extents
    "fwd_cs": "pppppppppppppp" "pppppp" "pp" "iiiii" "rrr" "ii",
    # o, d, thr, alive, idx, hit, clear, shadow lists, nearest lists, geom,
    # mat, consts, xi, cotangents g_o, g_d, g_thr, g_alive, g_acc, g_dww (or
    # null); the four input cotangents; the rows pg, pm, pc and the reduced
    # values; n, s_cheap, s_total, tile_rays, cand_stride; faraway,
    # sharp_e, sharp_s; the atlas's slot extents
    "bwd_cs": "ppppppp" "ppp" "ppp" "pppp" "pppppp" "pppp" "pppp" "iiiii" "rrr" "ii",
}


def _launch(name: str, dtype: torch.dtype, *args, atlas: bool = False) -> None:
    """Launch kernel ``name`` on the current stream and count it (its atlas
    mode in :data:`ATLAS_LAUNCHES`)."""
    _build.launch(_SOURCE, name, _SIGNATURES[name], dtype, *args)
    (ATLAS_LAUNCHES if atlas else LAUNCHES)[name] += 1


def grad_rows_bytes(n_rays: int, s: int, tile_rays: int, dtype: torch.dtype) -> int:
    """Bytes of ``bwd_cs``'s per-warp table-gradient rows for one launch:
    each warp of a tile owns (S, 4) shadow-slot, (S, 15) nearest-slot and 16
    constant values."""
    rows = (n_rays // tile_rays) * _WARPS_PER_TILE
    return rows * ((4 + _MAT_GRADS) * s + N_CONST) * torch.empty((), dtype=dtype).element_size()


def near_cs(o, d, thr, alive, cand, cnt_cand, cnt_full, geom, *, faraway, s_cheap, sharp_e, tile_rays):
    """The culled smooth winner of rays ``o``/``d`` (3, N); outputs as
    :func:`near_cs_plain`."""
    device = _check({"o": o, "d": d}, {"thr": thr, "alive": alive}, [(cand, cnt_cand, cnt_full)], geom, None, None,
                    s_cheap, tile_rays)
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, tile_rays=tile_rays)
    if device.type == "cpu":
        return near_cs_plain(o, d, thr, alive, cand, cnt_cand, cnt_full, geom, **kw)
    n = o.shape[1]
    with torch.cuda.device(device):
        idx = torch.empty((n,), dtype=torch.int32, device=device)
        hit, sval = torch.empty_like(thr), torch.empty_like(thr)
        p, normal = torch.empty_like(o), torch.empty_like(o)
        _launch("near_cs", o.dtype, o, d, thr, alive, cand, cnt_cand, cnt_full, geom, idx, hit, p, normal, sval,
                n, s_cheap, geom.shape[0], tile_rays, cand.shape[1], float(faraway), float(sharp_e))
    return idx, hit, p, normal, sval


def fwd_cs(o, d, thr, alive, acc, idx, hit, cand, cnt_cand, cnt_full, geom, mat, consts, xi=None, *,
           faraway, s_cheap, sharp_e, sharp_s, tile_rays, tex_hw=None):
    """One culled smooth bounce per launch, in the atlas mode with the
    atlas's slot extents ``tex_hw``; outputs as :func:`fwd_cs_plain`."""
    device = _check({"o": o, "d": d, "acc": acc}, {"thr": thr, "alive": alive, "idx": idx, "hit": hit},
                    [(cand, cnt_cand, cnt_full)], geom, {"mat": mat, "consts": consts}, xi, s_cheap, tile_rays)
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tile_rays=tile_rays, tex_hw=tex_hw)
    args = (o, d, thr, alive, acc, idx, hit, cand, cnt_cand, cnt_full, geom, mat, consts)
    if device.type == "cpu":
        return fwd_cs_plain(*args, xi, **kw)
    n = o.shape[1]
    with torch.cuda.device(device):
        outs = (torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr), torch.empty_like(alive),
                torch.empty_like(acc), torch.empty_like(thr))
        tex = () if tex_hw is None else (torch.empty_like(idx), torch.empty_like(thr))
        _launch("fwd_cs", o.dtype, *args, xi, *outs, *(tex or (None, None)), n, s_cheap, geom.shape[0], tile_rays,
                cand.shape[1], float(faraway), float(sharp_e), float(sharp_s), *slot_args(tex_hw), atlas=bool(tex))
    return outs + tex


def bwd_cs(o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af, geom, mat, consts,
           g_o, g_d, g_thr, g_alive, g_acc, xi=None, *, faraway, s_cheap, sharp_e, sharp_s, tile_rays, g_dww=None,
           tex_hw=None):
    """The adjoint of one culled bounce in one launch (plus the fixed-order
    reduction of the table gradients), in the atlas mode with dww's
    cotangent ``g_dww`` (N,) and ``tex_hw``; outputs as :func:`bwd_cs_plain`."""
    if (g_dww is None) != (tex_hw is None):
        raise ValueError("the atlas mode takes both g_dww and tex_hw")
    lanes = {"thr": thr, "alive": alive, "idx": idx, "hit": hit, "clear": clear, "g_thr": g_thr, "g_alive": g_alive}
    if g_dww is not None:
        lanes["g_dww"] = g_dww
    device = _check(
        {"o": o, "d": d, "g_o": g_o, "g_d": g_d, "g_acc": g_acc}, lanes,
        [(cand_b, cnt_b, cnt_bf), (cand_a, cnt_a, cnt_af)], geom, {"mat": mat, "consts": consts}, xi, s_cheap,
        tile_rays,
    )
    kw = dict(faraway=faraway, s_cheap=s_cheap, sharp_e=sharp_e, sharp_s=sharp_s, tile_rays=tile_rays, g_dww=g_dww,
              tex_hw=tex_hw)
    args = (o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af, geom, mat, consts)
    cots = (g_o, g_d, g_thr, g_alive, g_acc)
    if device.type == "cpu":
        return bwd_cs_plain(*args, *cots, xi, **kw)
    if cand_a.shape[1] != cand_b.shape[1]:
        raise ValueError("the nearest and shadow lists must have the same width")
    n, s = o.shape[1], geom.shape[0]
    rows = (n // tile_rays) * _WARPS_PER_TILE
    with torch.cuda.device(device):
        outs = (torch.empty_like(o), torch.empty_like(d), torch.empty_like(thr), torch.empty_like(alive))
        like = dict(dtype=o.dtype, device=device)
        pg = torch.zeros((rows, s, 4), **like)  # each warp's shadow-slot rows
        pm = torch.zeros((rows, s, _MAT_GRADS), **like)  # its nearest-slot rows
        pc = torch.zeros((rows, N_CONST), **like)
        flat = torch.empty(((4 + MAT_COLS) * s + N_CONST,), **like)
        _launch("bwd_cs", o.dtype, *args, xi, *cots, g_dww, *outs, pg, pm, pc, flat, n, s_cheap, s, tile_rays,
                cand_b.shape[1], float(faraway), float(sharp_e), float(sharp_s), *slot_args(tex_hw),
                atlas=g_dww is not None)
    g_geom = flat[: 4 * s].reshape(s, 4)
    g_mat = flat[4 * s : (4 + MAT_COLS) * s].reshape(s, MAT_COLS)
    g_consts = flat[(4 + MAT_COLS) * s :].reshape(1, N_CONST)
    return (*outs, g_geom, g_mat, g_consts)


# ---------------------------------------------------------------------------
# Autograd: the kernels' adjoint stands in for torch's.
# ---------------------------------------------------------------------------


class _BounceCS(torch.autograd.Function):
    """One culled smooth bounce, ``(o, d, thr, alive, acc)`` in and out, and
    in the atlas mode (``kw["tex_hw"]``) its flat texel ids and dww (N,);
    backward launches ``bwd_cs``.  The winner ``(idx, hit)`` and the texel
    ids are selectors and the lists are conservative sets: their cotangents
    are zero, as are xi's (a constant sample); acc's passes through."""

    @staticmethod
    def forward(ctx, o, d, thr, alive, acc, idx, hit, lists_a, lists_b, geom, mat, consts, xi, kw):
        o_n, d_n, thr_n, alive_n, acc_n, clear, *tex = fwd_cs(
            o, d, thr, alive, acc, idx, hit, *lists_b, geom, mat, consts, xi, **kw
        )
        ctx.kw = kw
        ctx.save_for_backward(o, d, thr, alive, idx, hit, clear, *lists_b, *lists_a, geom, mat, consts, xi)
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
        g_o_in, g_d_in, g_thr_in, g_alive_in, g_geom, g_mat, g_consts = bwd_cs(*saved, *cots, xi, **kw)
        return (g_o_in, g_d_in, g_thr_in, g_alive_in, cots[4], None, None, None, None, g_geom, g_mat, g_consts,
                None, None)


class _PermuteGroups(torch.autograd.Function):
    """``y = P x`` over whole 32-ray groups of ``x`` (C, N); the backward
    gathers by the precomputed inverse permutation, ``P^T y_bar``."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return _group_take(x, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _group_take(g.contiguous(), inv), None, None


# ---------------------------------------------------------------------------
# The trace.
# ---------------------------------------------------------------------------


def trace_culled_smooth(origin, dirs_t, scene, cfg, key=None) -> torch.Tensor:
    """Differentiable smooth trace with per-tile candidate culling: (N, 3)
    colors of the rays ``dirs_t`` (3, N) from ``origin`` (3,) or (3, N);
    glossy with the seed ``key`` when ``cfg.stochastic_roughness``."""
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

    s_total = scene.spheres.count
    s_cheap = s_total - scene.spheres.n_exact
    geom = geometry_table(scene, dtype)
    mat = material_table(scene, dtype)
    consts = consts_row(scene, dtype)
    center = scene.spheres.center[:s_cheap].detach().to(dtype)
    radius = scene.spheres.radius[:s_cheap].detach().to(dtype)
    light = scene.lights.point_position.detach().to(dtype)

    # Exact culling margins: the radius inflated for the disc sigmoid, the
    # behind-clauses widened for the sol sigmoid.
    m_e = _SIG_UNDERFLOW / float(cfg.edge_sharpness)
    m_s = _SIG_UNDERFLOW / float(cfg.shadow_sharpness)
    r_eff_e = sqrt(radius * radius + m_e / 4.0)
    r_eff_s = sqrt(radius * radius + m_s / 4.0)
    texels, tex_hw = atlas_texels(scene, dtype)
    kw = dict(faraway=cfg.faraway, s_cheap=s_cheap, sharp_e=float(cfg.edge_sharpness),
              sharp_s=float(cfg.shadow_sharpness), tile_rays=block)
    near_kw = {k: v for k, v in kw.items() if k != "sharp_s"}
    kw["tex_hw"] = tex_hw
    stochastic = key is not None and cfg.stochastic_roughness

    # Cheap-tier box for the re-sort keys (the exact tier would flatten it).
    bb_lo = torch.amin(center - radius[:, None], dim=0)
    bb_hi = torch.amax(center + radius[:, None], dim=0)
    ng = n_pad // _SORT_G
    gid = torch.arange(ng, device=device)  # the accumulated group permutation
    thr = torch.ones((n_pad,), dtype=dtype, device=device)
    alive = torch.ones((n_pad,), dtype=dtype, device=device)
    acc = torch.zeros_like(o)
    k_seed = key
    for b in range(cfg.max_depth):
        if b > 0:
            # Re-sort 32-ray groups by the centroid of their live rays: a
            # pure permutation, differentiable through _PermuteGroups.
            state = torch.cat([o, d, thr[None], alive[None], acc])  # (11, N_pad)
            st = state.detach()
            lg = ((st[6] * st[7]) > 0).to(dtype).reshape(ng, _SORT_G)
            wsum = torch.clamp_min(lg.sum(1), 1.0)
            cent = (st[:6].reshape(6, ng, _SORT_G) * lg).sum(2) / wsum
            perm = torch.argsort(ray_sort_keys(cent[0:3], cent[3:6], (lg != 0).any(1), bb_lo, bb_hi), stable=True)
            inv = torch.argsort(perm)
            state = _PermuteGroups.apply(state, perm, inv)
            gid = gid[perm]
            o, d, acc = state[0:3].contiguous(), state[3:6].contiguous(), state[8:11].contiguous()
            thr, alive = state[6].contiguous(), state[7].contiguous()
        xi = None
        if stochastic:
            # The JAX schedule: fold per bounce, uniforms over the unpadded
            # rays in flat order (pad 0.5), then through the group sorts.
            k_seed, k_bounce = fold_seed(k_seed, 1), fold_seed(k_seed, 2)
            xi_t = uniform2(k_bounce, n, dtype, device=device).T
            if n_pad != n:
                xi_t = torch.cat([xi_t, torch.full((2, n_pad - n), 0.5, dtype=dtype, device=device)], dim=1)
            xi = (_group_take(xi_t, gid) if b > 0 else xi_t).contiguous()
        o_sg, d_sg, thr_sg, alive_sg = (x.detach() for x in (o, d, thr, alive))
        # Lanes with exactly zero throughput or aliveness never contribute:
        # leaving them out of the bounds is exact.  The nearest list is a
        # pure line test: the miss lanes' max-disc fallback races over every
        # sphere the line pierces, in front of the origin or behind it.
        valid = None if b == 0 else (thr_sg > 0) & (alive_sg > 0)
        lists_a = candidate_lists(o_sg, d_sg, center, r_eff_e, block, valid=valid, t_margin=m_e, both_nappes=True)
        idx, hit, p, normal, sval = near_cs(o_sg, d_sg, thr_sg, alive_sg, *lists_a, geom.detach(), **near_kw)
        p_n = p + normal * NUDGE
        lv = light[:, None] - p
        to_light = lv / sqrt(lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2])[None, :]
        lists_b = candidate_lists(p_n, to_light, center, r_eff_s, block, valid=sval > 0, light=light, t_margin=m_s)
        o, d, thr, alive, acc, *tex = _BounceCS.apply(o, d, thr, alive, acc, idx, hit, lists_a, lists_b, geom, mat,
                                                      consts, xi, kw)
        if tex:
            acc = compose_texels(acc, texels, *tex)
    if cfg.max_depth > 1:  # undo the re-sorts, group by group
        order = torch.argsort(gid)
        acc = _PermuteGroups.apply(acc, order, gid)
    return acc.T[:n]
