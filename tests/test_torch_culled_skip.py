"""The warp-bundle skips of ``near_cs`` and ``shade_culled`` over a tile's
candidate list (``csrc/culled_smooth.cu`` ``winner_skip_list``,
``csrc/culled.cu`` ``list_minima_skip``).

``near_cs`` sweeps each lane's smooth winner over its tile's nearest list;
the skip leaves out, a chunk of 32 list slots at a time, the listed
cheap-tier spheres that no half-line of the warp can hit and whose disc
cannot exceed the least of the warp's running dmax
(``intersect_fused.winner_test``).  ``shade_culled`` takes each lane's two
shadow minima over its tile's shadow list; the skip leaves out the listed
spheres that no shadow ray of the warp can hit (``bundle_test``, the light
the apex), each folding faraway as a miss would.  Here, with the plain
versions (``culled_smooth.near_cs_reach``, ``culled.shade_culled_reach``,
the plain kernels with ``skip=True``), in f32 and f64:

(a) every (lane, slot) pair ``near_cs_reach`` rejects is a miss whose disc
    is at most the lane's running dmax at the start of the slot's chunk, on
    the culled smooth route's rays (mirror, glossy; 64x32, depth 3);
(b) every pair ``shade_culled_reach`` rejects is a ``sol_fast`` miss, on the
    culled hard route's shadow rays (mirror, atlas; 64x32, depth 4) and on
    fans of shadow lines tangent to r from far origins; without the margin
    the f32 fans are not all misses;
(c) ``near_cs_plain(skip=True)`` and ``shade_culled_plain(skip=True)``
    (mirror and atlas) are bitwise their skip-off selves;
(d) the wrappers take ``skip=`` on the CPU, and the Python constants and
    rules mirror the source's.

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
from python_ray_tracer_tpu_torch.ops import culled  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled_smooth as cs  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as f  # noqa: E402
from python_ray_tracer_tpu_torch.ops.bounce_smooth import sol_disc_plain  # noqa: E402
from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root  # noqa: E402

DTYPES = (torch.float32, torch.float64)
IDS = ("f32", "f64")
WIDTH, HEIGHT = 64, 32  # 2048 rays: one 4096-ray tile once padded


def _scene(dtype, case):
    if case == "atlas":
        return textured_spheres_scene(96, WIDTH, HEIGHT, tex_side=32, dtype=dtype)
    return random_spheres_scene(96, WIDTH, HEIGHT, seed=5, dtype=dtype)


def _record(module, name, trace):
    """The calls (args, kwargs) of ``module.name`` while ``trace()`` runs."""
    calls = []
    mp = pytest.MonkeyPatch()
    real = getattr(module, name)
    mp.setattr(module, name, lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw))
    try:
        with torch.no_grad():
            trace()
    finally:
        mp.undo()
    return calls


def _near_calls(dtype, case):
    """near_cs's calls over the 3 bounces of a culled smooth frame on
    random_spheres_scene(96): ``mirror``, or ``glossy`` at seed 7."""
    scene = _scene(dtype, "mirror")
    glossy = case == "glossy"
    cfg = RenderConfig(max_depth=3, dtype=dtype, visibility="smooth", use_pallas=True, stochastic_roughness=glossy,
                       rng_seed=7)
    key = fold_seed(fold_seed(seed_root(7), 0), 4) if glossy else None
    calls = _record(cs, "near_cs", lambda: cs.trace_culled_smooth(
        scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg, key=key))
    assert len(calls) == 3
    return calls


def _shade_calls(dtype, case):
    """shade_culled's calls over the 4 bounces of a culled hard frame:
    ``mirror`` on random_spheres_scene(96), ``atlas`` on
    textured_spheres_scene(96) (the atlas mode)."""
    scene = _scene(dtype, case)
    cfg = RenderConfig(max_depth=4, dtype=dtype, use_pallas=True)
    calls = _record(culled, "shade_culled", lambda: culled.trace_fused_culled(
        scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg))
    assert len(calls) == 4
    return calls


CASES = [(d, c) for d in DTYPES for c in ("mirror", "glossy")]
CASE_IDS = [f"{i}-{c}" for i in IDS for c in ("mirror", "glossy")]
SHADE_CASES = [(d, c) for d in DTYPES for c in ("mirror", "atlas")]
SHADE_IDS = [f"{i}-{c}" for i in IDS for c in ("mirror", "atlas")]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def near_calls(request):
    dtype, case = request.param
    return dtype, case, _near_calls(dtype, case)


@pytest.fixture(scope="module", params=SHADE_CASES, ids=SHADE_IDS)
def shade_calls(request):
    dtype, case = request.param
    return dtype, case, _shade_calls(dtype, case)


def _slots(args, kw):
    """One tile's list (the route's frames are one tile): its sphere ids in
    visiting order (candidates, then the full-tier fallback) and each
    slot's column of ``near_cs_reach`` and first slot of its chunk."""
    cand, cnt, cnt_full = args[4:7]
    nc = int(cnt[0].clamp(0, cand.shape[1]))
    nf = int(cnt_full[0].clamp(0, kw["s_cheap"]))
    ids = [int(x) for x in cand[0, :nc]] + list(range(nf))
    cols = list(range(nc)) + [cand.shape[1] + k for k in range(nf)]
    starts = [j - j % 32 for j in range(nc)] + [nc + k - k % 32 for k in range(nf)]
    return ids, cols, starts


def test_near_rejected_pairs_cannot_change_the_winner(near_calls):
    """(a) Each bounce's nearest list walked slot by slot as the kernel walks
    it: every (lane, slot) pair the warp rule rejects is a miss (t is
    faraway) whose disc is at most the lane's running dmax at the start of
    the slot's chunk, so the strict compares never take it; the rule
    rejects some pairs, and none in the list's first chunk (the sentinel)."""
    dtype, case, calls = near_calls
    rejected = 0
    for args, kw in calls:
        o, d, geom = args[0], args[1], args[7]
        faraway = kw["faraway"]
        n = o.shape[1]
        reach = cs.near_cs_reach(o.T.contiguous(), d.T.contiguous(), *args[4:7], geom, s_cheap=kw["s_cheap"],
                                 faraway=faraway, tile_rays=kw["tile_rays"])
        lanes = torch.arange(n) // f.WARP
        dmax = torch.full((n,), f.NEG_BIG[dtype], dtype=dtype)
        at_start = dmax
        ids, cols, starts = _slots(args, kw)
        for j, (k, col, start) in enumerate(zip(ids, cols, starts)):
            if j == start:
                at_start = dmax.clone()
            g = geom[k]
            _, disc, t, _, _ = sol_disc_plain(tuple(o), tuple(d), tuple(g[:3]), g[3], faraway)
            out = ~reach[lanes, col]
            if start == starts[0]:
                assert not bool(out.any()), f"{case}: a pair of the first chunk was left out"
            assert bool(torch.all(t[out] == faraway)), case
            assert bool(torch.all(disc[out] <= at_start[out])), case
            rejected += int(out.sum())
            dmax = torch.where(disc > dmax, disc, dmax)
    assert rejected > 0


def _shadow_rays(args):
    """shade_culled's shadow rays (p_n, to_light) (N, 3) and its lists."""
    p_n, to_light = args[7], args[9]
    return p_n.T.contiguous(), to_light.T.contiguous()


def _valid(p_n, to_light, geom):
    """(N, S) where sol_fast calls lane and sphere a hit (its shadow sweep's
    cheap-tier arithmetic)."""
    o = tuple(p_n[:, i, None] for i in range(3))
    dl = tuple(to_light[:, i, None] for i in range(3))
    return culled._sphere_sol_fast(o, dl, *(geom[None, :, i] for i in range(4)))[1]


def test_shade_rejected_pairs_are_misses_on_route_rays(shade_calls):
    """(b) On each bounce's shadow rays, no pair the warp bound rejects is a
    sol_fast hit; the bound rejects some pairs."""
    dtype, case, calls = shade_calls
    rejected = 0
    for args, kw in calls:
        p_n, to_light = _shadow_rays(args)
        geom, consts = args[14], args[15]
        s_cheap = kw["s_cheap"]
        reach = culled.shade_culled_reach(p_n, to_light, consts[0, 3:6], geom, s_cheap, kw["tile_rays"])
        out = ~reach[torch.arange(p_n.shape[0]) // f.WARP][:, :s_cheap]
        assert not bool((out & _valid(p_n, to_light, geom[:s_cheap])).any()), case
        rejected += int(out.sum())
    assert rejected > 0


def _fans(dtype, seed=3, warps=12, far=50.0):
    """Shadow lines aimed through a light, each warp a narrow fan on one side
    of a sphere (r = 0.3 .. 0.8) passing at distances D with D^2 = r^2 +
    delta, delta -2e-4 .. 1e-3 (f32; scaled to f64's roundoff) over the
    lanes: at the tangent, within the rounding of b^2 - c2 from origins
    ``far`` past the sphere.  Returns (p_n, to_light, light, geom), each
    lane's to_light its normalised light - p_n."""
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
        delta = np.linspace(-0.2, 1.0, 32) * scale
        alpha = np.arcsin(np.sqrt(r * r + delta) / dist)
        e = np.cos(alpha)[:, None] * a0 + np.sin(alpha)[:, None] * n1 + (1e-7 * np.arange(32))[:, None] * n2
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        p_n.append(light - (dist + far + w) * e)
    p_n = torch.tensor(np.concatenate(p_n), dtype=dtype)
    light_t = torch.tensor(light, dtype=dtype)
    v = light_t - p_n
    mag = torch.sqrt(torch.sum(v * v, 1, keepdim=True))
    return p_n, v * (1.0 / mag), light_t, torch.tensor(spheres, dtype=dtype)


def _fan_reach(p_n, to_light, light, geom):
    """shade_culled_reach over the fans, one tile of every lane."""
    return culled.shade_culled_reach(p_n, to_light, light, geom, geom.shape[0], p_n.shape[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_shade_rejected_pairs_are_misses_on_tangent_fans(dtype):
    """(b) Fans at the tangent from far origins: some lanes are sol_fast
    hits, no rejected pair is one, and the bound rejects some pairs."""
    p_n, to_light, light, geom = _fans(dtype)
    reach = _fan_reach(p_n, to_light, light, geom)
    out = ~reach[torch.arange(p_n.shape[0]) // f.WARP]
    valid = _valid(p_n, to_light, geom)
    assert bool(valid.any())
    assert not bool((out & valid).any())
    assert bool(out.any())


def test_tangent_fans_need_the_margin(monkeypatch):
    """(b) Without the margin (the cone's cosine not lowered, every term in u
    of the bound dropped) the f32 fans have rejected pairs that sol_fast
    calls hits: the margin, not r alone, holds (b)."""
    dtype = torch.float32
    p_n, to_light, light, geom = _fans(dtype)
    b = f.warp_bundles(p_n, to_light, light)
    cos_t = b.cos_t + 64 * f.UNIT_ROUNDOFF[dtype]
    b = b._replace(cos_t=cos_t, sin_t=f.sqrt((1.0 - cos_t) * (1.0 + cos_t)))
    monkeypatch.setitem(f.UNIT_ROUNDOFF, dtype, 0.0)
    reach = f.bundle_test(b, geom) | ~b.ok[:, None]
    assert bool(b.ok.all())
    out = ~reach[torch.arange(p_n.shape[0]) // f.WARP]
    assert bool((out & _valid(p_n, to_light, geom)).any())


def test_near_plain_with_the_skip_is_bitwise_without(near_calls):
    """(c) near_cs_plain over the slots the rule keeps only gives every
    output bitwise as over every listed slot, on each bounce."""
    dtype, case, calls = near_calls
    for args, kw in calls:
        full, skipped = cs.near_cs_plain(*args, **kw), cs.near_cs_plain(*args, **kw, skip=True)
        for name, a, b in zip(("idx", "hit", "p", "normal", "sval"), full, skipped):
            assert torch.equal(a, b), f"{case} {name}"


def test_shade_plain_with_the_skip_is_bitwise_without(shade_calls):
    """(c) shade_culled_plain over the pairs the bound keeps only (a skipped
    pair folding faraway) gives every output bitwise as over every listed
    pair, on each bounce, the atlas mode's texel ids and dww too."""
    dtype, case, calls = shade_calls
    for args, kw in calls:
        full, skipped = culled.shade_culled_plain(*args, **kw), culled.shade_culled_plain(*args, **kw, skip=True)
        for name, a, b in zip(("o", "d", "thr", "alive", "acc", "flat", "dww"), full, skipped):
            assert torch.equal(a, b), f"{case} {name}"


def test_shade_plain_with_the_skip_on_rows_out_of_order():
    """(c) The kernel's skip counts the skipped copies of a lane's own sphere
    by a scan of the row, whatever its order; the sweep with the skip stays
    bitwise the sweep without on rows reversed, with repeats, and on a tile
    with both candidates and the full-tier fallback (each bounce of the f32
    mirror frame)."""
    for args, kw in _shade_calls(torch.float32, "mirror"):
        cand, cnt = args[11], args[12]
        nc = int(cnt[0])
        ids = cand[:, :nc].flip(1)
        rows = {"reversed": ids, "repeated": torch.cat([ids, ids], 1),
                "with the fallback": cand[:, :nc]}
        for name, row in rows.items():
            width = cand.shape[1]
            row = torch.cat([row, row.new_zeros((1, width - row.shape[1]))], 1) if row.shape[1] < width else row
            lists = (row.contiguous(), torch.tensor([min(row.shape[1], 2 * nc)], dtype=torch.int32),
                     torch.tensor([kw["s_cheap"] // 2 if name == "with the fallback" else 0], dtype=torch.int32))
            a = (*args[:11], *lists, *args[14:])
            full, skipped = culled.shade_culled_plain(*a, **kw), culled.shade_culled_plain(*a, **kw, skip=True)
            assert all(torch.equal(x, y) for x, y in zip(full, skipped)), name


def test_wrappers_take_the_skip_on_the_cpu():
    """(d) On CPU tensors near_cs and shade_culled take every value of
    ``skip`` (their plain versions over every pair), the same bitwise, f32
    and f64; a bad value raises."""
    for dtype in DTYPES:
        for module, name, calls in ((cs, "near_cs", _near_calls(dtype, "mirror")),
                                    (culled, "shade_culled", _shade_calls(dtype, "atlas"))):
            args, kw = calls[1]
            wrapper = getattr(module, name)
            outs = {skip: wrapper(*args, **kw, skip=skip) for skip in f.SKIP}
            for skip in ("on", "auto"):
                assert all(torch.equal(a, b) for a, b in zip(outs[skip], outs["off"])), name
            with pytest.raises(ValueError, match="skip"):
                wrapper(*args, **kw, skip="sometimes")


def test_python_constants_mirror_the_source():
    """(d) The signatures take the skip code last; the launchers' rules, the
    warp's bound (the light as the apex for the shadow rays, none for the
    winner sweep), the chunk's m, the skipped sphere's fold and the winner
    sweep's exit before any warp collective where a warp is not whole in one
    tile are the source's."""
    assert cs._SIGNATURES["near_cs"].endswith("rri")
    assert culled._SIGNATURES["shade_culled"].endswith("rii" "i")
    smooth = (_build.CSRC / "culled_smooth.cu").read_text()
    body = smooth[smooth.index("void winner_skip_list"):smooth.index("// Stage the geometry table")]
    assert body.index("if (!warp_full) {") < body.index("__ballot_sync"), "collectives before the whole-warp exit"
    for term in ("warp_bundle(o, d, no_apex, slot)", "const T m = warp_min(dmax);",
                 "int j0 = min(list.nc, kWarp);", "int k0 = list.nc > 0 ? 0 : min(list.nf, kWarp);",
                 "!b.ok || k >= sc.s_cheap || winner_reaches(b, geom + 4 * k, m)",
                 "k < list.nf && (!b.ok || winner_reaches(b, geom + 4 * k, m))",
                 "for (int k = sc.s_cheap; k < sc.s_total; ++k) take(k);"):
        assert term in body, term
    for term in ("const auto kernel = near_kernel<T>(fwd_takes_skip(skip));", "tile_rays % kWarp == 0",
                 "inline bool fwd_takes_skip(int skip) { return skip != 0; }"):
        assert term in smooth, term
    hard = (_build.CSRC / "culled.cu").read_text()
    body = hard[hard.index("void list_minima_skip"):hard.index("// kSkip: the shadow sweep")]
    for term in ("k >= s_cheap || bundle_reaches(b, s_geom + 4 * k)", "k < nf && bundle_reaches(b, s_geom + 4 * k)",
                 "const bool own_kept = idx < 0 || idx >= s_cheap || bundle_reaches(b, s_geom + 4 * idx);",
                 "if (own > 0) t_self = vmin(t_self, faraway);",
                 "if (skipped > own) t_others = vmin(t_others, faraway);"):
        assert term in body, term
    for term in ("const V3<T> light = {cst[3], cst[4], cst[5]};", "warp_bundle(p_n, to_light, light, slot)",
                 "inline bool shade_takes_skip(int skip) { return skip != 0; }", "tile_rays % kWarp == 0",
                 "skip < -1 || skip > 1"):
        assert term in hard, term
    assert re.search(r"kShadowBig = 3\.0e38", (_build.CSRC / "sphere_math.cuh").read_text())
    assert (f.SKIP["auto"], f.SKIP["off"], f.SKIP["on"]) == (-1, 0, 1)
