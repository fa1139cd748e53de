"""The warp-bundle sphere skip of ``shadow_sweep`` (both modes),
``nearest_sweep`` and ``bounce_lane`` (``csrc/bundle_math.cuh``,
``csrc/sweep_math.cuh``, ``csrc/intersect_fused.cu``, ``csrc/bounce_lane.cu``).

A warp of 32 consecutive rays bounds its rays by a ball of origins and a
cone of directions, tests each cheap-tier sphere once against that bound,
and sweeps only the spheres it reaches, folding a miss at ``faraway`` for
the rest.  Here the plain version of that test (``intersect_fused.
warp_bundles``, ``bundle_test``, ``bundle_reach``), in f32 and f64:

(a) rejects no (warp, sphere) pair that any of the warp's lanes hits under
    the plain two-tier sweep: on a config-4-like scene's rays of three
    bounces (camera, mirror and shadow rays) and on adversarial rays: tangent
    within a few ulps, origins on, nudged off and inside spheres, the
    r = 99999 giants in either tier, a lane of NaN or inf, a ragged last warp;
(b) leaves the plain sweeps restricted to the reached pairs, with the shadow
    fold, bitwise the full plain sweeps: ``nearest_sweep_plain``,
    ``shadow_sweep_plain``, ``shadow_parts_plain`` (self in and out of range)
    and ``bounce_lane_plain`` (without and with an atlas); without the fold
    the shadow partials differ.

The full plain sweeps are held against JAX elsewhere
(``test_torch_intersect_fused.py``, ``test_torch_lane.py``); no JAX here,
and no kernel: the kernels run on the card (``chip_smoke.py``).
"""

import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from python_ray_tracer_tpu_torch import RenderConfig, render  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions  # noqa: E402
from python_ray_tracer_tpu_torch.io import load_scene  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_lane as bl  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as f  # noqa: E402
from python_ray_tracer_tpu_torch.ops.tables import geometry_table  # noqa: E402

DTYPES = (torch.float32, torch.float64)
IDS = ("f32", "f64")
FARAWAY = {torch.float32: 1.0e30, torch.float64: 1.0e39}
LIGHT = (-8.0, 10.0, -2.0)  # random_spheres_scene's point light
LANE80 = _build.CSRC.parent / "testdata" / "lane80.json"


def _scene(dtype, width=64, height=32):
    return random_spheres_scene(90, width, height, seed=3, dtype=dtype)


def _lane_records(scene, cfg, monkeypatch):
    """Each bounce's bounce_lane arguments of the scene's lane-route frame and
    the rays of every sweep the plain kernel with the skip runs on them:
    ``(o, d, geom, s_cheap, apex)`` of its nearest and shadow bundles."""
    bounces, sweeps = [], []
    real_lane, real_reach = bl.bounce_lane, f.bundle_reach

    def lane(*args, **kw):
        bounces.append((args, kw))
        return real_lane(*args, **kw)

    def reach(o, d, geom, s_cheap, apex=None):
        sweeps.append((o.contiguous(), d.contiguous(), geom, s_cheap, apex))
        return real_reach(o, d, geom, s_cheap, apex)

    monkeypatch.setattr(bl, "bounce_lane", lane)
    with torch.no_grad():
        render(scene, cfg)
        monkeypatch.setattr(f, "bundle_reach", reach)
        for args, kw in bounces:
            bl.bounce_lane_plain(*args, **kw, skip=True)
    monkeypatch.undo()
    return bounces, sweeps


@pytest.fixture(scope="module", params=DTYPES, ids=IDS)
def scene_rays(request):
    """A config-4-like scene (89 random spheres and the r = 99999 ground, 64x32,
    depth 3, mirror): the lane route's bounce arguments and each sweep's rays."""
    dtype = request.param
    mp = pytest.MonkeyPatch()
    scene = _scene(dtype)
    cfg = RenderConfig(max_depth=3, dtype=dtype, use_pallas=True)
    bounces, sweeps = _lane_records(scene, cfg, mp)
    assert len(bounces) == 3 and len(sweeps) == 6
    return dtype, bounces, sweeps


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _perp(w, rng):
    """A unit vector perpendicular to each row of w."""
    p = np.cross(w, rng.normal(size=w.shape))
    return _unit(p)


def _ulps(x, dtype, rng, most=3):
    """x cast to dtype, each value moved by up to ``most`` ulps either way."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    y = x.astype(np_t)
    steps = rng.integers(-most, most + 1, size=y.shape)
    for _ in range(most):
        y = np.where(steps > 0, np.nextafter(y, np_t(np.inf)), np.where(steps < 0, np.nextafter(y, np_t(-np.inf)), y))
        steps = steps - np.sign(steps)
    return y


def _giants(geom64):
    """The config-4 table with 8 more r = 99999 spheres (a far back wall and
    seven under the ground), as chip_smoke's 1032-sphere scene adds them."""
    walls = [(0.0, 0.0, 100060.0)] + [(0.0, -100000.5 - 10.0 * i, 0.0) for i in range(7)]
    return np.concatenate([geom64, [(*c, 99999.0) for c in walls]])


def _adversarial(dtype, seed=11):
    """(name, o, d, geom, s_cheap, self_idx) ray sets, numpy-seeded, each over a
    ragged number of lanes (not a multiple of 32)."""
    rng = np.random.default_rng(seed)
    geom64 = geometry_table(_scene(torch.float64), torch.float64).numpy()
    s = geom64.shape[0]
    cheap = s - 1
    sets = []

    # Tangent rays, 3 ulps either way, and rays that pass up to 1% of the
    # radius outside, where the rounded discriminant of a far grazing ray can
    # still come out positive: each warp grazes one sphere, 1 to 40 away, from
    # one origin (every other warp) or from origins within a unit.
    n = 32 * 24 + 7
    warps = -(-n // 32)
    k = np.repeat(rng.integers(0, cheap, size=warps), 32)[:n]
    c, r = geom64[k, :3], geom64[k, 3]
    base = _unit(rng.normal(size=(warps, 3)))
    dist = rng.uniform(1.0, 40.0, size=warps)
    spread = np.repeat(np.arange(warps) % 2 * 0.5, 32)[:n, None]
    o = c + np.repeat(base * dist[:, None], 32, axis=0)[:n] + spread * rng.uniform(-1.0, 1.0, size=(n, 3))
    w = c - o
    wl = np.linalg.norm(w, axis=1)
    outside = np.repeat(np.where(np.arange(warps) % 4 < 2, 0.0, 10.0 ** rng.uniform(-9, -2, size=warps)), 32)[:n]
    sin_a = np.clip(r * (1.0 + outside) / wl, 0.0, 1.0)
    side = np.where(spread > 0, _perp(w, rng), np.repeat(_perp(w[::32], rng), 32, axis=0)[:n])
    d = _unit(w) * np.sqrt(1.0 - sin_a**2)[:, None] + side * sin_a[:, None]
    sets.append(("tangent", _ulps(o, dtype, rng), _ulps(_unit(d), dtype, rng), geom64, cheap, k))

    # Fans: a warp's rays from one origin spread over 0.3 rad away from a
    # sphere 10 to 40 away, the edge ray grazing it (as above), so that the
    # sphere sits on the edge of a wide cone, where only the margin keeps it.
    n = 32 * 24 + 5
    warps = -(-n // 32)
    k = np.repeat(rng.integers(0, cheap, size=warps), 32)[:n]
    c, r = geom64[k, :3], geom64[k, 3]
    o = c + np.repeat(_unit(rng.normal(size=(warps, 3))) * rng.uniform(10.0, 40.0, size=(warps, 1)), 32, axis=0)[:n]
    w = _unit(c - o)
    side = np.repeat(_perp(w[::32], rng), 32, axis=0)[:n]
    outside = np.repeat(np.where(np.arange(warps) % 3 == 0, 0.0, 10.0 ** rng.uniform(-9, -2, size=warps)), 32)[:n]
    alpha = np.arcsin(np.clip(r * (1.0 + outside) / np.linalg.norm(c - o, axis=1), 0.0, 1.0))
    turn = np.where(np.arange(n) % 32 == 0, 0.0, rng.uniform(0.0, 0.3, size=n))
    d = w * np.cos(alpha + turn)[:, None] + side * np.sin(alpha + turn)[:, None]
    sets.append(("fans", _ulps(o, dtype, rng, 1), _ulps(d, dtype, rng, 1), geom64, cheap, k))

    # Light fans: shadow rays toward the light from origins 1 to 10 beyond a
    # sphere, spread over 0.3 rad away from it as seen from the light, the
    # edge ray grazing it (as above): the sphere on the edge of the double
    # cone from the light, which only the margin keeps.
    n = 32 * 24 + 9
    warps = -(-n // 32)
    light = np.array(LIGHT)
    k = np.repeat(rng.integers(0, cheap, size=warps), 32)[:n]
    c, r = geom64[k, :3], geom64[k, 3]
    w = _unit(c - light)
    side = np.repeat(_perp(w[::32], rng), 32, axis=0)[:n]
    outside = np.repeat(np.where(np.arange(warps) % 3 == 0, 0.0, 10.0 ** rng.uniform(-9, -2, size=warps)), 32)[:n]
    alpha = np.arcsin(np.clip(r * (1.0 + outside) / np.linalg.norm(c - light, axis=1), 0.0, 1.0))
    turn = np.where(np.arange(n) % 32 == 0, 0.0, rng.uniform(0.0, 0.3, size=n))
    out = w * np.cos(alpha + turn)[:, None] + side * np.sin(alpha + turn)[:, None]
    o = light + out * (np.linalg.norm(c - light, axis=1) + rng.uniform(1.0, 10.0, size=n))[:, None]
    sets.append(("light fans", _ulps(o, dtype, rng, 1), _ulps(_unit(light - o), dtype, rng, 1), geom64, cheap, k))

    # Origins on, nudged 1e-4 off, and inside their own sphere (a patch of it
    # a warp), rays out along the normal, grazing the own sphere, toward the
    # light, or near the patch's axis: one kind a warp.
    n = 32 * 16 + 19
    warps = -(-n // 32)
    k = np.repeat(rng.integers(0, cheap, size=warps), 32)[:n]
    c, r = geom64[k, :3], geom64[k, 3]
    axis = np.repeat(_unit(rng.normal(size=(warps, 3))), 32, axis=0)[:n]
    normal = _unit(axis + 0.2 * rng.normal(size=(n, 3)))
    scale = rng.choice([1.0, 1.0 + 1e-7, 1.0 - 1e-7, 0.5, 0.0], size=n)
    scale = np.where(rng.uniform(size=n) < 0.3, 1.0 + 1e-4 / r, scale)
    o = c + normal * (r * scale)[:, None]
    light = np.array(LIGHT)
    kind = np.repeat(np.arange(warps) % 4, 32)[:n]
    ref = np.repeat(rng.normal(size=(warps, 3)), 32, axis=0)[:n]
    graze = _unit(_unit(np.cross(normal, ref)) + normal * rng.uniform(-1e-6, 1e-6, size=(n, 1)))
    d = np.where((kind == 0)[:, None], normal, np.where((kind == 1)[:, None], graze,
                 np.where((kind == 2)[:, None], _unit(light - o), _unit(axis + 0.1 * rng.normal(size=(n, 3))))))
    sets.append(("surfaces", _ulps(o, dtype, rng, 1), _ulps(d, dtype, rng, 1), geom64, cheap, k))

    # The giants: warps grazing the ground (some from inside it) and the far
    # wall from near the ground, in the exact tier and, past any config's
    # table, in the cheap tier.
    big = _giants(geom64)
    n = 32 * 8 + 3
    warps = -(-n // 32)
    centre = np.stack([rng.uniform(-12, 12, warps), rng.uniform(-0.6, 0.5, warps), rng.uniform(-4, 30, warps)], 1)
    o = np.repeat(centre, 32, axis=0)[:n] + rng.uniform(-0.05, 0.05, size=(n, 3))
    heading = np.stack([rng.normal(size=warps), rng.uniform(-1e-3, 1e-3, warps), rng.normal(size=warps)], 1)
    d = _unit(np.repeat(_unit(heading), 32, axis=0)[:n] + rng.uniform(-1e-3, 1e-3, size=(n, 3)))
    self_idx = rng.integers(-2, big.shape[0] + 2, size=n)
    for name, s_cheap in (("giants exact", cheap), ("giants cheap", big.shape[0])):
        sets.append((name, _ulps(o, dtype, rng, 0), _ulps(d, dtype, rng, 0), big, s_cheap, self_idx))

    # Warps a bad lane opens: NaN, inf, an origin past 2^40, a zero direction.
    n = 32 * 5 + 1
    o = rng.uniform([-12, -0.3, -4], [12, 6, 30], size=(n, 3))
    d = _unit(rng.normal(size=(n, 3)) * 0.05 + np.array([0.0, 0.0, 1.0]))
    o, d = o.astype(np.float64), d.astype(np.float64)
    o[5, 1], d[40, 2], o[70, 0], d[100] = np.nan, np.inf, 2.0**41, 0.0
    sets.append(("bad lanes", _ulps(o, dtype, rng, 0), _ulps(d, dtype, rng, 0), geom64, cheap,
                 rng.integers(-1, s + 1, size=n)))

    out = []
    for name, o, d, geom, s_cheap, self_idx in sets:
        out.append((name, torch.as_tensor(o, dtype=dtype), torch.as_tensor(d, dtype=dtype),
                    torch.as_tensor(geom, dtype=dtype), int(s_cheap), torch.as_tensor(self_idx, dtype=torch.int32)))
    return out


@pytest.fixture(scope="module", params=DTYPES, ids=IDS)
def adversarial(request):
    return request.param, _adversarial(request.param)


def _misses_outside(o, d, geom, s_cheap, faraway, apex=None):
    """(rejected pairs, rejected pairs some lane hits, reached pairs some lane
    hits, the reach table) of the plain bundle test on these rays."""
    reach = f.bundle_reach(o, d, geom, s_cheap, apex)
    t = f._t_table(o, d, geom, faraway, s_cheap)
    pad = (-o.shape[0]) % 32
    hit = torch.cat([t != faraway, torch.zeros((pad, geom.shape[0]), dtype=torch.bool)])
    warp_hit = hit.reshape(-1, 32, geom.shape[0]).any(1)
    return int((~reach).sum()), int((~reach & warp_hit).sum()), int((reach & warp_hit).sum()), reach


def test_rejected_pairs_are_misses_on_scene_rays(scene_rays):
    """(a) On every sweep of three bounces (camera and mirror rays, shadow
    rays from the hit points), no rejected (warp, sphere) pair is a hit of
    any lane, and the test rejects most pairs."""
    dtype, _, sweeps = scene_rays
    rejected = pairs = 0
    for o, d, geom, s_cheap, apex in sweeps:
        n_rej, bad, _, reach = _misses_outside(o, d, geom, s_cheap, FARAWAY[dtype], apex)
        assert bad == 0
        assert bool(reach[:, s_cheap:].all())  # the exact tier is always swept
        if apex is not None:  # the apex bound alone rejects no hit either, and adds rejections
            b = f.warp_bundles(o, d, apex)
            cone = f.bundle_test(b._replace(p=torch.full_like(b.p, float("nan"))), geom[:s_cheap]) | ~b.ok[:, None]
            assert int((~cone).sum()) < int((~reach[:, :s_cheap]).sum())
        rejected += n_rej
        pairs += reach.numel()
    assert rejected > 0.5 * pairs


def test_rejected_pairs_are_misses_on_adversarial_rays(adversarial):
    """(a) Tangent rays within a few ulps, origins on, nudged off and inside
    spheres, the giants in either tier, bad lanes, ragged warps: no rejected
    pair is hit.  The tangent and surface sets reach spheres their lanes hit
    while rejecting others; a warp with a bad lane sweeps every sphere."""
    dtype, sets = adversarial
    apexes = (None, torch.tensor(LIGHT, dtype=dtype), torch.tensor((3.0, 1.0, 12.0), dtype=dtype))
    for name, o, d, geom, s_cheap, _ in sets:
        for apex in apexes:  # no apex, the light, a point the rays do not aim at
            assert _misses_outside(o, d, geom, s_cheap, FARAWAY[dtype], apex)[1] == 0, (name, apex)
        n_rej, bad, hit_reached, reach = _misses_outside(o, d, geom, s_cheap, FARAWAY[dtype])
        assert bad == 0, name
        assert o.shape[0] % 32 != 0 and not bool(f.warp_bundles(o, d).ok[-1]), name
        if name in ("tangent", "fans", "light fans", "surfaces", "giants exact", "giants cheap"):
            assert n_rej > 0 and hit_reached > 0, name
        if name == "bad lanes":
            ok = f.warp_bundles(o, d).ok
            assert ok.tolist() == [False, False, False, False, True, False], name


def test_fans_come_within_the_margin(adversarial, monkeypatch):
    """The fan set reaches into the margin: without it (the cone's cosine
    not lowered, every term in u of the test dropped) some rejected pair is
    a hit, so (a) above holds the margin and not only the bound."""
    dtype, sets = adversarial
    _, o, d, geom, s_cheap, _ = next(s for s in sets if s[0] == "fans")
    b = f.warp_bundles(o, d)
    cos_t = b.cos_t + 64 * f.UNIT_ROUNDOFF[dtype]
    b = b._replace(cos_t=cos_t, sin_t=f.sqrt((1.0 - cos_t) * (1.0 + cos_t)))
    t = f._t_table(o, d, geom, FARAWAY[dtype], s_cheap)
    hit = torch.cat([t != FARAWAY[dtype], torch.zeros(((-o.shape[0]) % 32, geom.shape[0]), dtype=torch.bool)])
    monkeypatch.setitem(f.UNIT_ROUNDOFF, dtype, 0.0)
    reach = f.bundle_test(b, geom) | ~b.ok[:, None]
    assert int((~reach & hit.reshape(-1, 32, geom.shape[0]).any(1)).sum()) > 0


def _sweeps_agree(o, d, geom, s_cheap, self_idx, faraway, light=None):
    """The plain sweeps with the skip (the shadow's apex ``light``) bitwise
    without it; returns the shadow's reach."""
    kw = dict(faraway=faraway, s_cheap=s_cheap)
    skip = dict(skip=True, light=light)
    for full, restricted in ((f.nearest_sweep_plain(o, d, geom, **kw), f.nearest_sweep_plain(o, d, geom, **kw, skip=True)),
                             (f.shadow_parts_plain(o, d, geom, self_idx, **kw),
                              f.shadow_parts_plain(o, d, geom, self_idx, **kw, **skip))):
        for a, b in zip(full, restricted):
            assert torch.equal(a, b)
    assert torch.equal(f.shadow_sweep_plain(o, d, geom, self_idx, **kw),
                       f.shadow_sweep_plain(o, d, geom, self_idx, **kw, **skip))
    return f.bundle_reach(o, d, geom, s_cheap, light)


def _unfolded_parts(o, d, geom, s_cheap, self_idx, reach, faraway):
    """shadow_parts_plain over the reached pairs WITHOUT the fold: each
    minimum over what it swept, from the sentinel."""
    big = f._BIG[o.dtype]
    t = f._t_table(o, d, geom, faraway, s_cheap)
    is_self = torch.arange(geom.shape[0], dtype=torch.int32)[None, :] == self_idx[:, None]
    kept = f._lane_reach(reach, 0, o.shape[0])
    others = torch.amin(torch.where(is_self | ~kept, big, t), 1).clamp(max=big)
    selfs = torch.amin(torch.where(is_self & kept, t, big), 1).clamp(max=big)
    return others, selfs


def test_restricted_sweeps_are_bitwise_the_full_ones_on_scene_rays(scene_rays):
    """(b) On each sweep's rays, the nearest sweep, the shadow partials (self
    the lane's own sphere, and a seeded self in and out of range) and the lit
    test over the reached pairs with the fold are bitwise the full sweeps;
    without the fold the partials of the shadow rays differ."""
    dtype, bounces, sweeps = scene_rays
    faraway = FARAWAY[dtype]
    rng = np.random.default_rng(5)
    unfolded_differ = False
    for (o, d, geom, s_cheap, light), (args, kw) in zip(sweeps[1::2], bounces):
        own = f.nearest_sweep_plain(args[0].T, args[1].T, geom, faraway=faraway, s_cheap=s_cheap)[1]
        seeded = torch.as_tensor(rng.integers(-3, geom.shape[0] + 3, size=o.shape[0]), dtype=torch.int32)
        for self_idx in (own, seeded):
            reach = _sweeps_agree(o, d, geom, s_cheap, self_idx, faraway, light)
        full = f.shadow_parts_plain(o, d, geom, own, faraway=faraway, s_cheap=s_cheap)
        unfolded = _unfolded_parts(o, d, geom, s_cheap, own, reach, faraway)
        unfolded_differ |= any(not torch.equal(a, b) for a, b in zip(full, unfolded))
    for o, d, geom, s_cheap, _ in sweeps[0::2]:
        _sweeps_agree(o, d, geom, s_cheap, torch.zeros(o.shape[0], dtype=torch.int32), faraway)
    assert unfolded_differ


def test_restricted_sweeps_are_bitwise_the_full_ones_on_adversarial_rays(adversarial):
    """(b) The same on the adversarial sets, with their own or seeded selves."""
    dtype, sets = adversarial
    for _, o, d, geom, s_cheap, self_idx in sets:
        for light in (None, torch.tensor(LIGHT, dtype=dtype)):
            _sweeps_agree(o, d, geom, s_cheap, self_idx, FARAWAY[dtype], light)


def test_bounce_lane_plain_with_the_skip_is_bitwise_without(scene_rays):
    """(b) bounce_lane_plain with each sweep restricted to its bundle's reach
    gives all five outputs bitwise as without, on every bounce."""
    _, bounces, _ = scene_rays
    for args, kw in bounces:
        full = bl.bounce_lane_plain(*args, **kw)
        skipped = bl.bounce_lane_plain(*args, **kw, skip=True)
        for name, a, b in zip(("o", "d", "thr", "alive", "acc"), full, skipped):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_bounce_lane_plain_atlas_with_the_skip_is_bitwise_without(dtype, monkeypatch):
    """(b) The atlas mode: lane80 (80 spheres, texels read in the sum) at
    64x36, depth 2."""
    scene = load_scene(LANE80, width=64, height=36, dtype=dtype, device="cpu")
    bounces, sweeps = _lane_records(scene, RenderConfig(max_depth=2, dtype=dtype, use_pallas=True), monkeypatch)
    assert len(bounces) == 2 and bounces[0][0][8] is not None
    for args, kw in bounces:
        full = bl.bounce_lane_plain(*args, **kw)
        skipped = bl.bounce_lane_plain(*args, **kw, skip=True)
        for name, a, b in zip(("o", "d", "thr", "alive", "acc"), full, skipped):
            assert torch.equal(a, b), name
    for o, d, geom, s_cheap, apex in sweeps:
        assert _misses_outside(o, d, geom, s_cheap, FARAWAY[dtype], apex)[1] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_wrappers_take_the_skip_on_the_cpu(dtype):
    """On CPU tensors the wrappers take every value of ``skip`` (and run the
    plain version over every pair), the same bitwise; a bad value raises."""
    sets = _adversarial(dtype, seed=2)
    _, o, d, geom, s_cheap, self_idx = sets[1]
    kw = dict(faraway=FARAWAY[dtype], s_cheap=s_cheap, light=torch.tensor(LIGHT))
    outs = {skip: (f.shadow_sweep(o, d, geom, self_idx, **kw, skip=skip),
                   *f.shadow_parts(o, d, geom, self_idx, **kw, skip=skip)) for skip in f.SKIP}
    for skip in ("on", "auto"):
        assert all(torch.equal(a, b) for a, b in zip(outs[skip], outs["off"]))
    with pytest.raises(ValueError, match="skip"):
        f.shadow_sweep(o, d, geom, self_idx, **kw, skip="yes")
    rays, lanes = torch.zeros((3, 4), dtype=dtype), torch.zeros(4, dtype=dtype)
    with pytest.raises(ValueError, match="skip"):
        bl.bounce_lane(rays, rays, lanes, lanes, rays, geom, None, None, faraway=FARAWAY[dtype], s_cheap=1,
                       skip="maybe")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_nearest_skip_on_glossy_rays_is_bitwise_the_full_sweep(dtype, monkeypatch):
    """(b) On every bounce of the glossy frame's kernel branch (render.trace,
    seed 7: GGX draws scatter a warp's rays past the first bounce) the plain
    nearest sweep with the skip is bitwise the full one, and the wrapper takes
    every value of ``skip`` on the CPU, the same bitwise; a bad value raises."""
    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    calls = []
    real = render_mod.nearest_sweep
    monkeypatch.setattr(render_mod, "nearest_sweep", lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw))
    scene = _scene(dtype)
    cfg = RenderConfig(max_depth=3, dtype=dtype, use_pallas=True, stochastic_roughness=True, rng_seed=7)
    with torch.no_grad():
        render_mod.trace(scene.camera.position, ray_directions(scene.camera, dtype), scene, cfg,
                         key=render_mod.fold_seed(render_mod.seed_root(7), 4))
    assert len(calls) == 3
    reached = []
    for (o, d, geom), kw in calls:
        full = f.nearest_sweep_plain(o, d, geom, **kw)
        for a, b in zip(full, f.nearest_sweep_plain(o, d, geom, **kw, skip=True)):
            assert torch.equal(a, b)
        reached.append(float(f.bundle_reach(o, d, geom, kw["s_cheap"]).float().mean()))
        for skip in f.SKIP:
            near = f.nearest_sweep(o, d, geom, **kw, skip=skip)
            assert torch.equal(near.t, full[0]) and torch.equal(near.idx, full[1])
    assert min(reached) < 1.0
    with pytest.raises(ValueError, match="skip"):
        f.nearest_sweep(o, d, geom, **kw, skip="never")


def test_python_constants_mirror_the_source():
    """The launch rules, the limits and the margin's coefficients of the
    plain test are the CUDA source's."""
    sweep = (_build.CSRC / "sweep_math.cuh").read_text()
    bundle = (_build.CSRC / "bundle_math.cuh").read_text()
    assert re.search(r"enum Skip \{ kSkipAuto = (-?\d+), kSkipOff = (\d+), kSkipOn = (\d+) \};", sweep).groups() == (
        str(f.SKIP["auto"]), str(f.SKIP["off"]), str(f.SKIP["on"]))
    for src in ("intersect_fused.cu", "bounce_lane.cu"):
        assert "takes_skip(skip, s_cheap)" in (_build.CSRC / src).read_text()
    assert "takes_skip(skip, s_cheap, kNearestSkipMinCheap)" in (_build.CSRC / "intersect_fused.cu").read_text()
    for name, want in (("kSkipMinCheap", f.SKIP_MIN_CHEAP), ("kNearestSkipMinCheap", f.NEAREST_SKIP_MIN_CHEAP)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", sweep).group(1)) == want
    assert float(re.search(r"kBundleMaxCoord = ([\d.]+);", bundle).group(1)) == f.BUNDLE_MAX_COORD
    assert float(re.search(r"kBundleMaxV2 = ([\d.]+);", bundle).group(1)) == f.BUNDLE_MAX_V2
    for name, want in (("float", 2.0**-24), ("double", 2.0**-53)):
        got = re.search(rf"unit_roundoff<{name}>\(\) {{ return ([\d.e-]+)f?; }}", bundle).group(1)
        assert float(got) == want
    body = bundle[bundle.index("bool outside_cone"):bundle.index("// Whether some lane's line")]
    for term in ("T(1) + T(16) * u", "T(256) * u * (w * w)", "r_b + q + T(64) * u * w", "T(8) * u * (v2 + rho2)",
                 "T(64) * u * (vl + rho)", "b.s[12] + q + T(64) * u * (w + vpl)", "doubled ? m_abs(av) : av"):
        assert term in body, term
    bundle = bundle[bundle.index("Bundle<T> warp_bundle"):bundle.index("// Whether the sphere lies outside")]
    for term in ("T(32) * u", "(T(1) + T(16) * u)", "- T(64) * u", "cos_t > T(0)",
                 "m_sqrt(dot3(f, f)) + T(16) * u * m_sqrt(dot3(w, w))"):
        assert term in bundle, term
