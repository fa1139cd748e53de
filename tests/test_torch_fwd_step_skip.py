"""The skips of ``smooth_fwd_step`` and ``clear_fwd`` (``csrc/smooth_math.cuh``
``SkipAll``, ``shadow_skip_product`` and ``winner_reaches``).

``smooth_fwd_step`` sweeps every sphere twice a ray: for its winner (the
nearest hit, and the max-discriminant fallback) and for its shadow product;
``clear_fwd`` is that product on one sphere shard.  Their skips leave out of
the shadow product the factors that are exactly 1 (per lane a pair whose
``sig(sharp_s * disc)`` is exactly 0; per warp a cheap-tier sphere no
shadow line comes within ``r_eff`` of, ``bounce_smooth_sub.shadow_reach``),
and out of the winner sweep the cheap-tier spheres that no half-line of the
warp can hit and whose disc cannot exceed any lane's running dmax
(``bounce_smooth_sub.winner_reach``, ``intersect_fused.winner_test``).
Here, with the plain versions, in f32 and f64:

(a) every (lane, sphere) pair the shadow bound rejects has ``sig(sharp_s *
    disc) == 0`` exactly, on the one-bounce pair's shadow rays
    (``random_spheres_scene(96)`` and ``textured_spheres_scene(96)`` at
    64x32, depth 3: mirror, glossy, atlas) and on fans of lines tangent to
    ``r_eff`` from far origins;
(b) every winner-sweep pair the warp rules reject is a miss whose disc is
    at most the lane's dmax before the sphere's chunk, on the same bounces'
    rays and on fans at the dmax edge from far origins, which without the
    margin have rejected pairs whose disc exceeds it;
(c) ``smooth_fwd_step_plain(skip=True)`` is bitwise ``skip=False``;
(d) ``clear_fwd_plain(skip=True)`` is bitwise without the skip, with the
    light as the bound's apex and without one;
(e) the wrappers take ``skip=`` and ``light=`` on the CPU, and the Python
    constants are the source's.

No JAX, no kernel: the kernels run on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from python_ray_tracer_tpu_torch import RenderConfig  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene, textured_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as f  # noqa: E402
from python_ray_tracer_tpu_torch.ops import smooth_parts as sp  # noqa: E402
from python_ray_tracer_tpu_torch.ops.bounce_smooth import sig, sol_disc_plain  # noqa: E402
from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root  # noqa: E402

from .test_torch_cs_skip import _fans  # noqa: E402

DTYPES = (torch.float32, torch.float64)
IDS = ("f32", "f64")
CASES = ("mirror", "glossy", "atlas")
SHARP = 200.0  # RenderConfig's shadow_sharpness
WIDTH, HEIGHT = 64, 32


def _record(dtype, case):
    """The one-bounce pair's forward calls over 3 bounces of a smooth frame
    (``route="step"``), each ``(args, kwargs, outputs)``: ``mirror`` and
    ``glossy`` (seed 7) on random_spheres_scene(96), ``atlas`` on
    textured_spheres_scene(96) (32x32 textures)."""
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
    real = bss.smooth_fwd_step
    mp.setattr(bss, "smooth_fwd_step", lambda *a, **kw: calls.append((a, kw, real(*a, **kw))) or calls[-1][2])
    with torch.no_grad():
        bss.trace_fused_smooth_sub(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg,
                                   route="step", key=key)
    mp.undo()
    assert len(calls) == 3
    return calls


@pytest.fixture(scope="module", params=[(d, c) for d in DTYPES for c in CASES],
                ids=[f"{i}-{c}" for i in IDS for c in CASES])
def step_calls(request):
    dtype, case = request.param
    return dtype, case, _record(dtype, case)


def _shadow_rays(args, kw, outs):
    """The lanes' shadow rays (p_n, L), (N, 3) each, as the bounce computes them."""
    o, d, thr, alive, _, geom, mat, consts = args[:8]
    fs = bss.fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, faraway=kw["faraway"],
                          s_cheap=kw["s_cheap"], sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"],
                          saved=(outs[5], outs[6] != 0, outs[7]), tex_hw=kw.get("tex_hw"))
    return torch.stack(fs.p_n, 1), torch.stack(fs.L, 1)


def _shadow_misses(p_n, light_dir, light, geom, reach=None):
    """(lane-sphere pairs the shadow bound rejects, how many of them have a
    shadow sigmoid that is not exactly 0), every sphere in the cheap tier."""
    if reach is None:
        reach = bss.shadow_reach(p_n, light_dir, light, geom, geom.shape[0], SHARP)
    o = tuple(p_n[:, i, None] for i in range(3))
    dl = tuple(light_dir[:, i, None] for i in range(3))
    _, disc, _, _, _ = sol_disc_plain(o, dl, tuple(geom[None, :, i] for i in range(3)), geom[None, :, 3], 1e30)
    rejected = ~reach[torch.arange(p_n.shape[0]) // f.WARP]
    return int(rejected.sum()), int((rejected & (sig(SHARP * disc) != 0)).sum())


def _winner_misses(o, d, geom, s_cheap, faraway, reach):
    """(cheap-tier lane-sphere pairs the winner rules reject, how many of
    them are a hit or have a disc above the lane's dmax before the sphere's
    chunk of 32), the sweep's own arithmetic and running dmax."""
    c = tuple(geom[None, :s_cheap, i] for i in range(3))
    _, disc, t, _, _ = sol_disc_plain(tuple(o[:, i, None] for i in range(3)), tuple(d[:, i, None] for i in range(3)),
                                      c, geom[None, :s_cheap, 3], faraway)
    dmax = torch.full_like(disc[:, 0], bss._NEG_BIG)
    before = torch.empty_like(disc)
    for k in range(s_cheap):
        if k % f.WARP == 0:
            chunk_dmax = dmax.clone()
        before[:, k] = chunk_dmax
        dmax = torch.where(disc[:, k] > dmax, disc[:, k], dmax)
    rejected = ~reach[torch.arange(o.shape[0]) // f.WARP, :s_cheap]
    return int(rejected.sum()), int((rejected & ((t != faraway) | (disc > before))).sum())


def test_rejected_pairs_change_nothing_on_bounce_rays(step_calls):
    """(a), (b) On each bounce's rays no winner-sweep pair the warp rules
    reject could change the winner, and no shadow pair the warp bound
    rejects has a shadow sigmoid that is not exactly 0; both reject some."""
    dtype, case, calls = step_calls
    rejected = {"winner": 0, "shadow": 0}
    for args, kw, outs in calls:
        o, d, geom, s_cheap = args[0].T.contiguous(), args[1].T.contiguous(), args[5], kw["s_cheap"]
        reach = bss.winner_reach(o, d, geom, s_cheap, kw["faraway"])
        n_rej, bad = _winner_misses(o, d, geom, s_cheap, kw["faraway"], reach)
        assert bad == 0, case
        rejected["winner"] += n_rej
        p_n, light_dir = _shadow_rays(args, kw, outs)
        n_rej, bad = _shadow_misses(p_n, light_dir, args[7][0, 3:6], geom[:s_cheap])
        assert bad == 0, case
        rejected["shadow"] += n_rej
    assert min(rejected.values()) > 0, rejected


def _dmax_fans(dtype, seed=5, warps=12):
    """Warps at the dmax edge: each warp's 32 rays leave one origin (50 + w
    from a probe sphere, which lies behind them: no half-line hits it) in a
    narrow fan whose lines pass the probe's centre at D with D^2 = p +
    delta, delta 1e-5 .. 2e-3 (f32) over the lanes; sphere 0 is centred on
    the origin (every lane's disc exactly 4 R0^2, the dmax the probe's chunk
    starts from), spheres 1..31 and 33..47 lie far off (r = 2 > R0: room
    for a margin), and the probe, sphere 32, has r^2 = p + R0^2: its true
    disc 4 (R0^2 - delta) just below that dmax, within the rounding of disc
    from the far origin.  Returns (o, d, geom) of every warp's rays and its
    own 48-sphere table."""
    rng = np.random.default_rng(seed)
    scale = 1e-3 if dtype == torch.float32 else 1e-12
    out = []
    for w in range(warps):
        a0 = rng.normal(size=3)
        a0 /= np.linalg.norm(a0)
        n1 = np.cross(a0, rng.normal(size=3))
        n1 /= np.linalg.norm(n1)
        n2 = np.cross(a0, n1)
        origin = rng.uniform(-5.0, 5.0, 3)
        dist, r0, p = 50.0 + w, rng.uniform(0.5, 1.0), rng.uniform(0.2, 0.6)
        probe = origin + dist * a0
        dd = np.sqrt(p + np.linspace(0.01, 2.0, 32) * scale)
        alpha = np.arcsin(dd / dist)
        e = np.cos(alpha)[:, None] * a0 + np.sin(alpha)[:, None] * n1 + (1e-7 * np.arange(32))[:, None] * n2
        far = np.c_[origin + 1e3 * (n2 + rng.uniform(0.5, 1.0, (46, 3))), np.full(46, 2.0)]
        geom = np.concatenate([[[*origin, r0]], far[:31], [[*probe, np.sqrt(p + r0 * r0)]], far[31:]])
        out.append((np.repeat(origin[None], 32, 0), -e / np.linalg.norm(e, axis=1, keepdims=True), geom))
    return [tuple(torch.tensor(x, dtype=dtype) for x in warp) for warp in out]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_rejected_pairs_change_nothing_on_edge_fans(dtype):
    """(a), (b) Fans just beyond r_eff from far origins (the shadow bound)
    and just beyond the dmax edge (the winner rules): no rejected pair could
    change anything, and both reject some."""
    p_n, light_dir, light, geom = _fans(dtype)
    n_rej, bad = _shadow_misses(p_n, light_dir, light, geom)
    assert bad == 0 and n_rej > 0
    rejected = 0
    for o, d, geom in _dmax_fans(dtype):
        reach = bss.winner_reach(o, d, geom, geom.shape[0], 1e30)
        n_rej, bad = _winner_misses(o, d, geom, geom.shape[0], 1e30, reach)
        assert bad == 0
        rejected += n_rej
    assert rejected > 0


@pytest.mark.parametrize("bound", ("shadow", "winner"))
def test_edge_fans_need_the_margin(bound, monkeypatch):
    """(a), (b) Without the margin (the cone's cosine not lowered, every term
    in u of the bound dropped) the f32 fans have rejected pairs that shade,
    or whose disc exceeds the lane's dmax: the margin, not only r_eff or
    the dmax edge, holds (a) and (b)."""
    dtype = torch.float32
    u = f.UNIT_ROUNDOFF[dtype]

    def bare(o, d, apex=None):
        b = f.warp_bundles(o, d, apex)
        cos_t = b.cos_t + 64 * u
        return b._replace(cos_t=cos_t, sin_t=f.sqrt((1.0 - cos_t) * (1.0 + cos_t)))

    if bound == "shadow":
        p_n, light_dir, light, geom = _fans(dtype)
        b = bare(p_n, light_dir, light)
        monkeypatch.setitem(f.UNIT_ROUNDOFF, dtype, 0.0)
        edge = torch.tensor(89.0, dtype=dtype) / (4 * torch.tensor(SHARP, dtype=dtype))
        assert bool(b.ok.all())
        assert _shadow_misses(p_n, light_dir, light, geom, f.line_test(b, geom, edge))[1] > 0
        return
    bad = 0
    for o, d, geom in _dmax_fans(dtype):
        reach = bss.winner_reach(o, d, geom, geom.shape[0], 1e30)  # for the chunk's dmax, with the margin
        b = bare(o, d)
        assert bool(b.ok.all())
        m = (4.0 * (geom[0, 3] * geom[0, 3])).expand(1, geom.shape[0])  # sphere 0's disc on every lane
        with monkeypatch.context() as mp:
            mp.setitem(f.UNIT_ROUNDOFF, dtype, 0.0)
            reach[:, 32] = f.winner_test(b, geom[32:33], m[:, 32:33])[:, 0]
        bad += _winner_misses(o, d, geom, geom.shape[0], 1e30, reach)[1]
    assert bad > 0


def test_plain_with_the_skips_is_bitwise_without(step_calls):
    """(c), (d) smooth_fwd_step_plain over the pairs its skips keep gives
    every output bitwise as over every pair, on each bounce; clear_fwd_plain
    over the pairs its skip keeps (the light as apex, and none) gives the
    product bitwise as over every pair, on the bounce's shadow rays."""
    dtype, case, calls = step_calls
    for args, kw, outs in calls:
        skipped = bss.smooth_fwd_step_plain(*args, **kw, skip=True)
        names = ("o", "d", "thr", "alive", "acc", "idx", "hit", "clear", "flat", "dww")
        for name, a, b in zip(names, outs, skipped):
            assert torch.equal(a, b), f"{case} {name}"
        p_n, light_dir = _shadow_rays(args, kw, outs)
        ckw = dict(faraway=kw["faraway"], sharpness=kw["sharp_s"], s_cheap=kw["s_cheap"])
        full = sp.clear_fwd_plain(p_n, light_dir, args[5], outs[5], **ckw)
        assert torch.equal(full, outs[7]), case  # the bounce's own product
        for light in (args[7][0, 3:6], None):
            assert torch.equal(sp.clear_fwd_plain(p_n, light_dir, args[5], outs[5], **ckw, skip=True, light=light),
                               full), case


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_wrappers_take_skip_and_light_on_the_cpu(dtype):
    """(e) On CPU tensors smooth_fwd_step and clear_fwd take every value of
    ``skip`` and clear_fwd a light (the plain versions over every pair), the
    same bitwise; a bad value raises."""
    scene = random_spheres_scene(24, 32, 16, seed=5, dtype=dtype)
    cfg = RenderConfig(max_depth=1, dtype=dtype, visibility="smooth", use_pallas=True)
    o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)
    kw.pop("depth")
    ones = torch.ones_like(d[0])
    state = (o, d, ones, ones, torch.zeros_like(d))
    outs = {skip: bss.smooth_fwd_step(*state, *tables, **kw, skip=skip) for skip in f.SKIP}
    for skip in ("on", "auto"):
        assert all(torch.equal(a, b) for a, b in zip(outs[skip], outs["off"]))
    with pytest.raises(ValueError, match="skip"):
        bss.smooth_fwd_step(*state, *tables, **kw, skip="sometimes")
    p_n, light_dir = o.T.contiguous(), d.T.contiguous()
    geom, self_idx = tables[0], outs["off"][5]
    ckw = dict(faraway=kw["faraway"], sharpness=SHARP, s_cheap=kw["s_cheap"])
    want = sp.clear_fwd(p_n, light_dir, geom, self_idx, **ckw)
    for skip in f.SKIP:
        assert torch.equal(sp.clear_fwd(p_n, light_dir, geom, self_idx, **ckw, skip=skip, light=(1.0, 9.0, 2.0)), want)
    assert torch.equal(sp.smooth_clear_parts(p_n, light_dir, geom, self_idx, **ckw, light=tables[2][0, 3:6]), want)
    with pytest.raises(ValueError, match="light"):
        sp.clear_fwd(p_n, light_dir, geom, self_idx, **ckw, light=(1.0, 2.0))
    with pytest.raises(ValueError, match="skip"):
        sp.clear_fwd(p_n, light_dir, geom, self_idx, **ckw, skip="sometimes")


def test_python_constants_mirror_the_source():
    """(e) The launch rules, the skip codes and the bundle slots, and the
    winner rules' sentinel and margin, are the CUDA source's."""
    step = (_build.CSRC / "bounce_smooth_sub.cu").read_text()
    assert int(re.search(r"constexpr int kStepSkipMinCheap = (\d+);", step).group(1)) == bss.STEP_SKIP_MIN_CHEAP
    for term in ("skip < 0 ? s_cheap >= kStepSkipMinCheap : skip == 1", "skip < -1 || skip > 1",
                 "constexpr int kStepBundleValues = 2 * kBundleValues * kWarpsPerBlock;",
                 "slots + 2 * kBundleValues * (threadIdx.x / kWarp), warp_full"):
        assert term in step, term
    parts = (_build.CSRC / "smooth_parts.cu").read_text()
    assert int(re.search(r"constexpr int kClearSkipMinCheap = (\d+);", parts).group(1)) == sp.CLEAR_SKIP_MIN_CHEAP
    assert "skip < 0 ? s_cheap >= kClearSkipMinCheap : skip == 1" in parts
    smooth = (_build.CSRC / "smooth_math.cuh").read_text()
    assert float(re.search(r"constexpr double kNegBig = (-?[\d.e+]+);", smooth).group(1)) == bss._NEG_BIG
    for dtype in DTYPES:
        assert f.NEG_BIG[dtype] == float(torch.tensor(bss._NEG_BIG, dtype=dtype))
    body = smooth[smooth.index("bool winner_reaches"):]
    for term in ("bundle_reaches(b, g) || !(m > T(kNegBig) && m - m == T(0))", "const T p = r2 - m * T(0.25);",
                 "!(p > T(0)) || !rules_out(b, g, true,",
                 "p * (T(1) + T(64) * u) + T(16) * u * r2 + T(256) * u * (w * w)"):
        assert term in body, term
    product = smooth[smooth.index("T shadow_skip_product"):]
    for term in ("warp_full && finite && sc.sharp_s > T(0) ? warp_bundle(p_n, L, apex, slot)",
                 "T(-SigEdge<T>::lo) / (T(4) * sc.sharp_s)", "line_reaches(b, g, edge)"):
        assert term in product, term
