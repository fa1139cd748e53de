"""The port's lane-layout hard bounce against the JAX package.

``ops/bounce_lane.py``'s plain version of ``bounce_lane`` (what the wrapper
runs on CPU tensors) through ``render()`` with ``use_pallas``, against the
JAX package's lane route (``ops/pallas_bounce.py`` ``_bounce_kernel``) in
interpret mode, as ``tests/test_pallas.py`` runs it: 16x8, depth 3, float32,
on the three kinds of scene the JAX renderer sends there (80 mirror spheres;
96 spheres with 9 in the exact tier; 80 spheres with a 4,096-texel atlas,
texels sampled in the kernel).  The JAX oracles compile with XLA's fusion
pass off (no FMA contraction), so every value agrees within 1e-6 (readings:
1.9e-9; the two sides evaluate the same operations, and JAX's float32
one-hot gathers are exact).  Also: the tie rule (lowest index) whatever
JAX's ``block_spheres``, the routing, and what the wrapper refuses.  The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.  The float64 frames are in ``test_torch_render.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_lane  # noqa: E402
from python_ray_tracer_tpu_torch.ops.tables import consts_row, geometry_table, material_table  # noqa: E402
from python_ray_tracer_tpu_torch.ops.texture import MAX_FUSED_TEXELS  # noqa: E402
from python_ray_tracer_tpu_torch.render import hard_route  # noqa: E402

W, H, DEPTH = 16, 8, 3
# Every value of the port's frame within this of JAX's (float32).
ATOL = 1e-6


def _rows(make_row, n_spheres: int, n_exact: int, atlas: bool):
    """A grid of glossy spheres (every 4th image-textured with ``atlas``),
    iridescent every 5th, then ``n_exact`` r = 99999 ground spheres."""
    rows = [
        make_row((float(i % 12) - 6.0, 0.3 * (i % 3), 5.0 + i // 12), 0.3 + 0.02 * (i % 5), specular_gain=0.8,
                 diffuse_gain=0.7, iridescence_gain=0.3 * (i % 5 == 0), diffuse_color=(0.2 + 0.01 * i, 0.5, 0.9),
                 texture_kind=2 if atlas and i % 4 == 0 else 0)
        for i in range(n_spheres - n_exact)
    ]
    rows += [make_row((0.0, -99999.5 - i, 0.0), 99999.0, diffuse_gain=1.0, specular_gain=0.3, texture_kind=1)
             for i in range(n_exact)]
    return rows


def _scenes(n_spheres: int, n_exact: int, texels: int = 0, rows=None):
    """(JAX scene, port scene) of the same float32 arrays; ``texels`` > 0
    adds a seeded (1, 64, texels / 64, 3) atlas."""
    rows = rows or (lambda mk: _rows(mk, n_spheres, n_exact, texels > 0))
    atlas = np.random.default_rng(3).uniform(0.0, 1.0, (1, 64, texels // 64, 3)) if texels else None
    js = J.make_scene(J.build_spheres(rows(J.make_sphere_row)), J.build_lights((-2.0, 1.0, 2.0)), (0.0, 0.2, -2.0),
                      W, H, texture_atlas=atlas)
    ts = T.make_scene(T.build_spheres(rows(T.make_sphere_row)), T.build_lights((-2.0, 1.0, 2.0)), (0.0, 0.2, -2.0),
                      W, H, texture_atlas=atlas)
    return js, ts


def _jax_lane(js, **kw):
    """JAX's lane route in interpret mode, compiled without fusion."""
    cfg = J.RenderConfig(max_depth=DEPTH, use_pallas=True, pallas_interpret=True, **kw)
    fn = jax.jit(lambda s: J.render(s, cfg))
    return np.asarray(fn.lower(js).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})(js))


LANE_SCENES = {"mirror80": (80, 1, 0), "exact96": (96, 9, 0), "atlas80": (80, 1, 4096)}


@pytest.mark.parametrize("name", LANE_SCENES)
def test_lane_route_matches_jax_interpret(name):
    """render() with use_pallas takes the lane route and gives JAX's lane
    route's frame; on the CPU nothing launches."""
    js, ts = _scenes(*LANE_SCENES[name])
    cfg = T.RenderConfig(max_depth=DEPTH, use_pallas=True)
    assert hard_route(ts, cfg, None) == "lane"
    before = (dict(bounce_lane.LAUNCHES), dict(bounce_lane.ATLAS_LAUNCHES))
    got = T.render(ts, cfg).numpy()
    assert (bounce_lane.LAUNCHES, bounce_lane.ATLAS_LAUNCHES) == before
    want = _jax_lane(js)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got).max() > 0.1


def test_lane_ties_do_not_depend_on_block_spheres():
    """A sphere duplicated bitwise in another JAX sphere block (rows 3 and
    70, block_spheres 8) but coloured otherwise: the lowest index wins, in
    JAX's blocked sweep and in the port's sequential one."""

    def rows(mk):
        r = _rows(mk, 80, 1, False)
        r[70] = dict(r[3], diffuse_color=np.asarray((1.0, 0.0, 0.0)))
        return r

    js, ts = _scenes(80, 1, rows=rows)
    got = T.render(ts, T.RenderConfig(max_depth=DEPTH, use_pallas=True)).numpy()
    want = _jax_lane(js, block_spheres=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Rendered without the duplicate, the frame is the same: it never wins.
    _, alone = _scenes(80, 1)
    np.testing.assert_array_equal(got, T.render(alone, T.RenderConfig(max_depth=DEPTH, use_pallas=True)).numpy())


ROUTES = [
    (80, 1, 0, None, "lane"), (95, 1, 0, None, "lane"), (96, 9, 0, None, "lane"), (1024, 9, 0, None, "lane"),
    (80, 1, 4096, None, "lane"), (80, 1, MAX_FUSED_TEXELS, None, "lane"), (80, 1, MAX_FUSED_TEXELS + 64, None, "sweeps"),
    (96, 9, MAX_FUSED_TEXELS + 64, None, "sweeps"), (80, 1, 0, 7, "sweeps"), (96, 1, 0, None, "culled"),
    (64, 9, 0, None, "sub"),
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: "-".join(map(str, c)))
def test_lane_routing(case):
    """The JAX renderer's lane-kernel scenes take "lane"; an atlas over
    MAX_FUSED_TEXELS texels, or a key, takes the sweeps instead."""
    n_spheres, n_exact, texels, key, want = case
    _, ts = _scenes(n_spheres, n_exact, texels)
    cfg = T.RenderConfig(max_depth=4, use_pallas=True, stochastic_roughness=key is not None)
    assert hard_route(ts, cfg, key) == want


def _lane_args(texels: bool = False):
    _, ts = _scenes(80, 1, 4096 if texels else 0)
    d = torch.nn.functional.normalize(torch.randn(3, 32, generator=torch.Generator().manual_seed(0)), dim=0)
    o = torch.zeros(3, 32)
    lanes = (torch.ones(32), torch.ones(32), torch.zeros(3, 32))
    tables = (geometry_table(ts, torch.float32), material_table(ts, torch.float32), consts_row(ts, torch.float32))
    tex = (ts.texture_atlas.reshape(-1, 3).contiguous(),) if texels else ()
    kw = dict(faraway=1e30, s_cheap=79, tex_hw=(64, 64) if texels else None)
    return [o, d, *lanes, *tables, *tex], kw


REFUSALS = {
    "requires_grad": lambda a, kw: a.__setitem__(1, a[1].clone().requires_grad_(True)),
    "rows_not_lanes": lambda a, kw: a.__setitem__(0, a[0].T.contiguous()),
    "thr_shape": lambda a, kw: a.__setitem__(2, a[2][None]),
    "dtype": lambda a, kw: a.__setitem__(4, a[4].double()),
    "texels_without_extents": lambda a, kw: kw.update(tex_hw=None),
    "too_many_texels": lambda a, kw: a.__setitem__(8, torch.zeros(MAX_FUSED_TEXELS + 4096, 3)),
    "s_cheap": lambda a, kw: kw.update(s_cheap=81),
    "geometry": lambda a, kw: kw.update(geometry="texture"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_bounce_lane_refuses(case):
    """The wrapper raises on what the kernel does not take, before any launch."""
    args, kw = _lane_args(texels=case in ("texels_without_extents", "too_many_texels"))
    REFUSALS[case](args, kw)
    with pytest.raises(ValueError):
        bounce_lane.bounce_lane(*args, **kw)


def test_bounce_lane_plain_is_one_bounce_of_the_trace():
    """The wrapper on CPU tensors is the plain version, and trace_fused_lane
    its depth-fold loop from unit throughput (atlas mode)."""
    args, kw = _lane_args(texels=True)
    got = bounce_lane.bounce_lane(*args, **kw)
    want = bounce_lane.bounce_lane_plain(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _, ts = _scenes(80, 1, 4096)
    from python_ray_tracer_tpu_torch.camera import ray_directions_t

    cfg = T.RenderConfig(max_depth=2)
    dirs = ray_directions_t(ts.camera, torch.float32)
    acc = bounce_lane.trace_fused_lane(ts.camera.position, dirs, ts, cfg)
    o = ts.camera.position.reshape(3, 1).expand(dirs.shape).contiguous()
    state = (o, dirs, torch.ones(dirs.shape[1]), torch.ones(dirs.shape[1]), torch.zeros_like(dirs))
    for _ in range(2):
        state = bounce_lane.bounce_lane_plain(*state, *args[5:], faraway=cfg.faraway, s_cheap=79, tex_hw=(64, 64))
    torch.testing.assert_close(acc, state[4].T, rtol=0, atol=0)
