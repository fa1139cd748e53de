"""The shadow skip of ``fwd_cs`` (``csrc/culled_smooth.cu`` ``SkipList``,
``csrc/bundle_math.cuh`` ``line_reaches``, ``csrc/smooth_math.cuh``
``shadow_fold``).

``fwd_cs`` multiplies each lane's shadow product over its tile's list; the
skip leaves out the factors that are exactly 1: per lane a pair whose
``sig(sharp_s * disc)`` is exactly 0 (or the lane's own winner), and per
warp a listed cheap-tier sphere that no shadow line of the warp comes within
``r_eff`` of, ``r_eff^2 = r^2 + |SigEdge lo| / (4 sharp_s)``.  Here, with the
plain versions (``culled_smooth.fwd_cs_reach``, ``intersect_fused.line_test``,
``fwd_cs_plain(skip=True)``), in f32 and f64:

(a) every (lane, sphere) pair the warp bound rejects has ``sig(sharp_s *
    disc) == 0`` exactly, on the culled smooth route's shadow rays (mirror,
    glossy, atlas; 64x32, depth 3) and on fans of lines tangent to ``r_eff``
    from far origins; without the margin the f32 fans are not all 0;
(b) where the shadow sigmoid is exactly 0 the other factor is no NaN, so the
    pair's factor is exactly 1;
(c) ``fwd_cs_plain`` with the skip is bitwise ``fwd_cs_plain`` without it;
(d) the wrapper takes ``skip=`` on the CPU, and the constants and the
    margin's terms are the source's.

No JAX, no kernel: the kernels run on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from python_ray_tracer_tpu_torch import RenderConfig  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene, textured_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled_smooth as cs  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as f  # noqa: E402
from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, quad_sol_disc, sig  # noqa: E402
from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import fwd_sub_math  # noqa: E402
from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root  # noqa: E402

DTYPES = (torch.float32, torch.float64)
IDS = ("f32", "f64")
SHARP = 200.0  # RenderConfig's shadow_sharpness
WIDTH, HEIGHT = 64, 32  # 2048 rays: one 4096-ray tile once padded


def _record(dtype, case):
    """fwd_cs's calls (args, kwargs) over the 3 bounces of a culled smooth
    frame: ``mirror`` and ``glossy`` (seed 7) on random_spheres_scene(96),
    ``atlas`` on textured_spheres_scene(96) (32x32 textures)."""
    if case == "atlas":
        scene = textured_spheres_scene(96, WIDTH, HEIGHT, tex_side=32, dtype=dtype)
    else:
        scene = random_spheres_scene(96, WIDTH, HEIGHT, seed=5, dtype=dtype)
    glossy = case == "glossy"
    cfg = RenderConfig(max_depth=3, dtype=dtype, visibility="smooth", use_pallas=True, stochastic_roughness=glossy,
                       rng_seed=7)
    key = fold_seed(fold_seed(seed_root(7), 0), 4) if glossy else None
    calls = []
    mp = pytest.MonkeyPatch()
    real = cs.fwd_cs
    mp.setattr(cs, "fwd_cs", lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw))
    with torch.no_grad():
        cs.trace_culled_smooth(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg, key=key)
    mp.undo()
    assert len(calls) == 3
    return calls


@pytest.fixture(scope="module", params=[(d, c) for d in DTYPES for c in ("mirror", "glossy", "atlas")],
                ids=[f"{i}-{c}" for i in IDS for c in ("mirror", "glossy", "atlas")])
def cs_calls(request):
    dtype, case = request.param
    return dtype, case, _record(dtype, case)


def _shadow_rays(args, kw):
    """The lanes' shadow rays (p_n, L) as fwd_cs computes them, (N, 3) each."""
    o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat, consts = args[:13]
    with torch.no_grad():
        fs = fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, faraway=kw["faraway"],
                          s_cheap=kw["s_cheap"], sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"],
                          saved=(idx, hit != 0, torch.ones_like(thr)), tex_hw=kw.get("tex_hw"))
    return torch.stack(fs.p_n, 1), torch.stack(fs.L, 1)


def _sig_args(p_n, light_dir, geom):
    """(N, S) sharp_s * disc of every lane and sphere, the kernel's cheap-tier
    arithmetic (b_cterm_plain, then b^2 - 4 ct)."""
    o = tuple(p_n[:, i, None] for i in range(3))
    dl = tuple(light_dir[:, i, None] for i in range(3))
    b, ct = b_cterm_plain(o, dl, tuple(geom[None, :, i] for i in range(3)), geom[None, :, 3])
    return b * b - 4.0 * ct


def _rejected_not_zero(p_n, light_dir, light, geom, sharp_s, tile_rays=4096, reach=None):
    """(lane-sphere pairs the warp bound rejects, how many of them have a
    shadow sigmoid that is not exactly 0)."""
    s = geom.shape[0]
    if reach is None:
        reach = cs.fwd_cs_reach(p_n, light_dir, light, geom, s, sharp_s, tile_rays)
    lanes = reach[torch.arange(p_n.shape[0]) // f.WARP]
    live = sig(sharp_s * _sig_args(p_n, light_dir, geom)) != 0
    return int((~lanes).sum()), int((~lanes & live).sum())


def test_rejected_pairs_shade_nothing_on_route_rays(cs_calls):
    """(a) On each bounce's shadow rays, no pair the warp bound rejects has a
    shadow sigmoid that is not exactly 0; the bound rejects some pairs."""
    dtype, case, calls = cs_calls
    rejected = 0
    for args, kw in calls:
        p_n, light_dir = _shadow_rays(args, kw)
        geom, consts = args[10], args[12]
        n_rej, bad = _rejected_not_zero(p_n, light_dir, consts[0, 3:6], geom[:kw["s_cheap"]], kw["sharp_s"],
                                        kw["tile_rays"])
        assert bad == 0, case
        rejected += n_rej
    assert rejected > 0


def _fans(dtype, seed=3, warps=12, far=50.0):
    """Shadow lines aimed through a light, each warp a narrow fan on one side
    of a sphere (r = 0.3 .. 0.8) passing at distances D with D^2 = r^2 + 89 /
    (4 * 200) + delta, delta 1e-5 .. 2e-3 (f32) over the lanes: beyond r_eff
    by less than the rounding of disc from origins ``far`` past the sphere.
    Returns (p_n, L, light, geom), the lanes' L the kernel's normalised
    light - p_n."""
    rng = np.random.default_rng(seed)
    light = np.array([-8.0, 10.0, -2.0])
    p_n, spheres = [], []
    scale = 1e-3 if dtype == torch.float32 else 1e-12
    for w in range(warps):
        a0 = rng.normal(size=3)
        a0 /= np.linalg.norm(a0)
        n1 = np.cross(a0, rng.normal(size=3))
        n1 /= np.linalg.norm(n1)
        n2 = np.cross(a0, n1)
        dist = rng.uniform(5.0, 15.0)
        g = light + dist * a0
        r = rng.uniform(0.3, 0.8)
        spheres.append((*g, r))
        delta = np.linspace(0.01, 2.0, 32) * scale
        dd = np.sqrt(r * r + 89.0 / (4 * SHARP) + delta)
        alpha = np.arcsin(dd / dist)
        e = np.cos(alpha)[:, None] * a0 + np.sin(alpha)[:, None] * n1 + (1e-7 * np.arange(32))[:, None] * n2
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        p_n.append(light - (dist + far + w) * e)
    p_n = torch.tensor(np.concatenate(p_n), dtype=dtype)
    light_t = torch.tensor(light, dtype=dtype)
    v = light_t - p_n
    mag = torch.sqrt(torch.sum(v * v, 1, keepdim=True))
    return p_n, v * (1.0 / mag), light_t, torch.tensor(spheres, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_rejected_pairs_shade_nothing_on_tangent_fans(dtype):
    """(a) Fans just beyond r_eff from far origins: no rejected pair has a
    shadow sigmoid that is not exactly 0, and the bound rejects some."""
    p_n, light_dir, light, geom = _fans(dtype)
    n_rej, bad = _rejected_not_zero(p_n, light_dir, light, geom, SHARP)
    assert bad == 0
    assert n_rej > 0


def test_tangent_fans_need_the_margin(monkeypatch):
    """(a) Without the margin (the cone's cosine not lowered, every term in u
    of the bound dropped) the f32 fans have rejected pairs whose sigmoid is
    not 0: the margin, not only r_eff, holds (a)."""
    dtype = torch.float32
    p_n, light_dir, light, geom = _fans(dtype)
    b = f.warp_bundles(p_n, light_dir, light)
    cos_t = b.cos_t + 64 * f.UNIT_ROUNDOFF[dtype]
    b = b._replace(cos_t=cos_t, sin_t=f.sqrt((1.0 - cos_t) * (1.0 + cos_t)))
    monkeypatch.setitem(f.UNIT_ROUNDOFF, dtype, 0.0)
    edge = torch.tensor(89.0, dtype=dtype) / (4 * torch.tensor(SHARP, dtype=dtype))
    reach = f.line_test(b, geom, edge) | ~b.ok[:, None]
    assert bool(b.ok.all())
    assert _rejected_not_zero(p_n, light_dir, light, geom, SHARP, reach=reach)[1] > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_a_zero_shadow_sigmoid_makes_the_factor_exactly_one(dtype):
    """(b) Wherever sig(sharp_s * disc) is exactly 0 (disc no NaN, sharp_s
    finite), sig(sharp_s * sol) is no NaN, so 1 - sd * ss is exactly 1: on
    seeded (b, c_term) pairs with zeros, huge and infinite c_terms, and
    sharpnesses of either sign."""
    rng = np.random.default_rng(9)
    big = float(torch.finfo(dtype).max)
    b = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, size=4000), [0.0, -0.0, 1.0, -1.0]])
    ct = np.concatenate([np.abs(rng.normal(size=4000)) * 10.0 ** rng.integers(-30, 30, size=4000),
                         [np.inf, big, 0.0, 1e-30]])
    b, ct = torch.tensor(b, dtype=dtype), torch.tensor(ct, dtype=dtype)
    zeros = 0
    for sharp in (200.0, 1e-3, 1e6, -200.0):
        sol, disc, _ = quad_sol_disc(b, ct, 1e30)
        sd, ss = sig(sharp * disc), sig(sharp * sol)
        zero = (sd == 0) & ~torch.isnan(disc)
        zeros += int(zero.sum())
        assert not bool(torch.isnan(ss[zero]).any())
        assert bool(torch.all(1.0 - sd[zero] * ss[zero] == 1.0))
    assert zeros > 0


def test_plain_with_the_skip_is_bitwise_without(cs_calls):
    """(c) fwd_cs_plain over the pairs the skip keeps only gives every output
    bitwise as over every listed pair, on each bounce."""
    dtype, case, calls = cs_calls
    for args, kw in calls:
        full, skipped = cs.fwd_cs_plain(*args, **kw), cs.fwd_cs_plain(*args, **kw, skip=True)
        for name, a, b in zip(("o", "d", "thr", "alive", "acc", "clear", "flat", "dww"), full, skipped):
            assert torch.equal(a, b), f"{case} {name}"


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_wrapper_takes_the_skip_on_the_cpu(dtype):
    """(d) On CPU tensors fwd_cs takes every value of ``skip`` (the plain
    version over every pair), the same bitwise; a bad value raises."""
    calls = _record(dtype, "mirror")
    args, kw = calls[1]
    outs = {skip: cs.fwd_cs(*args, **kw, skip=skip) for skip in f.SKIP}
    for skip in ("on", "auto"):
        assert all(torch.equal(a, b) for a, b in zip(outs[skip], outs["off"]))
    with pytest.raises(ValueError, match="skip"):
        cs.fwd_cs(*args, **kw, skip="sometimes")


def test_python_constants_mirror_the_source():
    """(d) The sigmoid edges, the skip's codes and rule, and the margin's
    terms of the plain bound are the CUDA source's."""
    smooth = (_build.CSRC / "smooth_math.cuh").read_text()
    for name, dtype in (("float", torch.float32), ("double", torch.float64)):
        lo = re.search(rf"struct SigEdge<{name}> \{{\n  static constexpr {name} lo = (-?[\d.]+)f?", smooth).group(1)
        assert float(lo) == cs.SIG_EDGE[dtype]
    culled = (_build.CSRC / "culled_smooth.cu").read_text()
    for term in ("inline bool fwd_takes_skip(int skip) { return skip != 0; }", "fwd_takes_skip(skip)",
                 "skip < -1 || skip > 1", "tile_rays % kWarp == 0", "T(-SigEdge<T>::lo) / (T(4) * sc.sharp_s)",
                 "finite && sc.sharp_s > T(0) ? warp_bundle(p_n, L, light, slot)",
                 "const bool finite = sc.sharp_s - sc.sharp_s == T(0);"):
        assert term in culled, term
    assert (f.SKIP["auto"], f.SKIP["off"], f.SKIP["on"]) == (-1, 0, 1)
    assert "if (finite && sig_is_zero(x)) return;" in smooth
    bundle = (_build.CSRC / "bundle_math.cuh").read_text()
    body = bundle[bundle.index("bool line_reaches"):]
    for term in ("(g[3] * g[3] + edge) * (T(1) + T(64) * u) + T(256) * u * (w * w)", "rules_out(b, g, true,"):
        assert term in body, term
    rules = bundle[bundle.index("bool rules_out"):bundle.index("bool bundle_reaches")]
    for term in ("outside_cone(v, v2, vl, r_b + q + T(64) * u * w, a, cos_t, sin_t, doubled)",
                 "b.s[12] + q + T(64) * u * (w + vpl), a, cos_t, sin_t, true)"):
        assert term in rules, term
