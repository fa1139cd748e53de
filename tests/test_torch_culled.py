"""The culled big-scene hard route of the port against the JAX package.

``random_spheres_scene`` bit for bit; the candidate-list glue
(``interval_hit_mask``, ``_group_cull_mask``, ``candidate_lists``,
``ray_sort_keys``) bitwise against the JAX functions on the same inputs;
the port's ``trace_fused_culled`` on CPU tensors (the plain versions of
``near_culled``/``shade_culled``) against JAX's with ``pallas_interpret``;
and the hard routing table against the routes JAX's ``_render_sample``
takes.  The JAX oracles compile once each, with XLA's fusion (FMA
contraction) and algebraic simplifier (``x / sqrt`` into ``rsqrt``) off.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.camera import ray_directions_t as jax_rays_t  # noqa: E402
from python_ray_tracer_tpu.models.scenes import random_spheres_scene as jax_random_scene  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_culled as jcul  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled as tcul  # noqa: E402
from python_ray_tracer_tpu_torch.render import hard_route  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8  # noqa: E402

ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion,algsimp"}
TILE = tcul.CULL_BLOCK_RAYS
# The culled route's frame: five 4,096-ray tiles, so that a primary and a
# re-sorted culled bounce, two full-sweep bounces and the energy cut (a
# live but dim tile at the last bounce) all run.
S_ROUTE, W_ROUTE, H_ROUTE, DEPTH = 128, 160, 128, 4


def _oracle(fn, *args):
    """``fn(*args)`` compiled once by XLA without fusion and algsimp."""
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)(*args)


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


@pytest.mark.parametrize("n_spheres,seed", [(96, 0), (1024, 0), (200, 5)])
def test_random_spheres_scene_matches_jax(n_spheres, seed):
    """Same draws in the same order: every f64 table equal, n_exact 1."""
    js = jax_random_scene(n_spheres, 16, 8, seed, dtype=jnp.float64)
    ts = random_spheres_scene(n_spheres, 16, 8, seed, dtype=torch.float64)
    got, want = scene_to_numpy(ts), _jax_leaves(js)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ts.spheres.n_exact == js.spheres.n_exact == 1
    assert ts.spheres.count - ts.spheres.n_exact == n_spheres - 1


# --- the candidate-list glue, bitwise ------------------------------------------


def _cheap_tier(n_spheres=160):
    js = jax_random_scene(n_spheres, 16, 8, dtype=jnp.float32)
    s_cheap = js.spheres.count - js.spheres.n_exact
    return np.asarray(js.spheres.center[:s_cheap]), np.asarray(js.spheres.radius[:s_cheap]), np.asarray(js.lights.point_position)


def _rays(kind: str, n_tiles: int = 3, seed: int = 0):
    """(3, N) f32 origins and unit directions of ``n_tiles`` tiles: camera
    rays (``primary``) or rays from scattered points (``scattered``), and a
    seeded lane mask."""
    rng = np.random.default_rng(seed)
    n = n_tiles * TILE
    if kind == "primary":
        o = np.broadcast_to(np.array([[0.0], [1.0], [-4.0]]), (3, n)) + rng.normal(0.0, 1e-3, (3, n))
        d = np.stack([np.linspace(-0.6, 0.6, n), rng.uniform(-0.3, 0.3, n), np.ones(n)])
    else:
        o = rng.uniform([[-12.0], [-0.3], [1.0]], [[12.0], [6.0], [30.0]], (3, n))
        o = np.sort(o, axis=1)  # neighbouring rays nearby: coherent groups
        d = rng.normal(0.0, 0.05, (3, n)) + np.array([[0.2], [0.1], [1.0]])
    d = d / np.linalg.norm(d, axis=0, keepdims=True)
    valid = rng.uniform(size=n) < 0.9
    valid[TILE : TILE + TILE // 2] = False  # half a tile with no valid lane
    return o.astype(np.float32), d.astype(np.float32), valid


def _pack(x):
    return jcul.pack_tiles(jnp.asarray(x).reshape(-1, x.shape[-1]), TILE // 8)


@pytest.mark.parametrize("t_margin,both_nappes", [(0.0, False), (0.05, False), (0.05, True)])
def test_interval_hit_mask_bitwise(t_margin, both_nappes):
    center, radius, _ = _cheap_tier()
    rng = np.random.default_rng(1)
    lo = rng.uniform([-14.0, -1.0, -5.0], [10.0, 5.0, 28.0], (40, 3)).astype(np.float32)
    o_lo, o_hi = lo, lo + rng.uniform(0.0, 3.0, (40, 3)).astype(np.float32)
    d_lo = rng.uniform(-1.0, 0.8, (40, 3)).astype(np.float32)
    d_hi = np.minimum(d_lo + rng.uniform(0.0, 0.5, (40, 3)), 1.0).astype(np.float32)
    args = (o_lo, o_hi, d_lo, d_hi, center, radius)
    want = np.asarray(_oracle(lambda *a: jcul.interval_hit_mask(*a, t_margin, both_nappes), *map(jnp.asarray, args)))
    got = tcul.interval_hit_mask(*map(torch.tensor, args), t_margin, both_nappes).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


GROUP_CASES = {
    "primary": ("primary", False, False, 0.0, False),
    "valid": ("scattered", True, False, 0.0, False),
    "shadow": ("scattered", True, True, 0.0, False),
    "smooth_nearest": ("scattered", True, False, 0.05, True),
}


@pytest.mark.parametrize("case", GROUP_CASES)
def test_group_cull_mask_bitwise(case):
    """The (T, S) mask of 64-ray group tests, with and without a lane mask
    and the light's double cone."""
    kind, use_valid, use_light, t_margin, both_nappes = GROUP_CASES[case]
    center, radius, light = _cheap_tier()
    o, d, valid = _rays(kind)
    if use_light:
        d = (light[:, None] - o) / np.linalg.norm(light[:, None] - o, axis=0, keepdims=True)
        d = d.astype(np.float32)

    def jax_mask(o3, d3, c, r, v, lt):
        return jcul._group_cull_mask(o3, d3, c, r, TILE // 8, v, lt, t_margin, both_nappes)

    jv = _pack(valid[None])[0] if use_valid else None
    jl = jnp.asarray(light) if use_light else None
    want = np.asarray(_oracle(jax_mask, _pack(o), _pack(d), jnp.asarray(center), jnp.asarray(radius), jv, jl))
    got = tcul._group_cull_mask(
        torch.tensor(o), torch.tensor(d), torch.tensor(center), torch.tensor(radius), TILE,
        torch.tensor(valid) if use_valid else None, torch.tensor(light) if use_light else None, t_margin, both_nappes,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("max_cand", [1024, 16])
def test_candidate_lists_bitwise(monkeypatch, max_cand):
    """Ascending ids, counts and, with a 16-id cap, the overflow to a full
    sweep; both modules read MAX_CAND when called."""
    monkeypatch.setattr(jcul, "MAX_CAND", max_cand)
    monkeypatch.setattr(tcul, "MAX_CAND", max_cand)
    center, radius, light = _cheap_tier()
    o, d, valid = _rays("scattered", seed=2)
    want = _oracle(
        lambda o3, d3, c, r, v: jcul.candidate_lists(o3, d3, c, r, TILE // 8, v),
        _pack(o), _pack(d), jnp.asarray(center), jnp.asarray(radius), _pack(valid[None])[0],
    )
    got = tcul.candidate_lists(torch.tensor(o), torch.tensor(d), torch.tensor(center), torch.tensor(radius), TILE,
                               valid=torch.tensor(valid))
    cand, cnt, full = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), cand)
    np.testing.assert_array_equal(got[1].numpy(), cnt[0])
    np.testing.assert_array_equal(got[2].numpy(), full[0])
    assert got[0].shape == (3, max_cand)
    if max_cand == 16:
        assert (full[0] == center.shape[0]).any() and (cnt[0] == 0).any()


def test_ray_sort_keys_bitwise():
    center, radius, _ = _cheap_tier()
    bb_lo = (center - radius[:, None]).min(0)
    bb_hi = (center + radius[:, None]).max(0)
    rng = np.random.default_rng(3)
    o = rng.uniform(-20.0, 40.0, (3, 5000)).astype(np.float32)  # some outside the box: clamped cells
    d = rng.normal(size=(3, 5000))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    live = rng.uniform(size=5000) < 0.7
    args = (o, d, live, bb_lo, bb_hi)
    want = np.asarray(_oracle(jcul.ray_sort_keys, *map(jnp.asarray, args)))
    got = tcul.ray_sort_keys(*map(torch.tensor, args)).numpy()
    assert want.dtype == np.uint32 and got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() >= tcul._DEAD_KEY > got.min()


# --- the culled route against JAX's in interpret mode ---------------------------


def _recording(fn, calls: list):
    """``fn``, appending each call's positional arguments to ``calls``."""

    def wrapper(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    return wrapper


@pytest.fixture(scope="module")
def jax_culled_frame():
    js = jax_random_scene(S_ROUTE, W_ROUTE, H_ROUTE, dtype=jnp.float32)
    cfg = J.RenderConfig(max_depth=DEPTH, dtype=jnp.float32, use_pallas=True, pallas_interpret=True)
    return np.asarray(_oracle(
        lambda sc: jcul.trace_fused_culled(sc.camera.position, jax_rays_t(sc.camera, jnp.float32), sc, cfg, transposed=True),
        js,
    ))


def test_culled_route_matches_jax(jax_culled_frame, monkeypatch):
    """The port's trace on CPU tensors (plain kernels) against JAX's culled
    kernels in interpret mode: every value within 1e-6 and at most 0.5% of
    them not bitwise (reading: 32 of 61,440 off, by at most 6e-8: the
    32-ray centroid sums of the re-sort add in another order)."""
    ts = random_spheres_scene(S_ROUTE, W_ROUTE, H_ROUTE, dtype=torch.float32)
    record = {"near": [], "shade": []}
    for name, calls in record.items():
        monkeypatch.setattr(tcul, f"{name}_culled", _recording(getattr(tcul, f"{name}_culled"), calls))
    before = dict(tcul.LAUNCHES)
    got = tcul.trace_fused_culled(
        ts.camera.position, ray_directions_t(ts.camera, torch.float32), ts, T.RenderConfig(max_depth=DEPTH, use_pallas=True)
    ).numpy()
    assert tcul.LAUNCHES == before  # CPU tensors: plain versions, no launch
    diff = np.abs(got - jax_culled_frame)
    assert got.shape == (W_ROUTE * H_ROUTE, 3)
    assert diff.max() <= 1e-6, diff.max()
    assert (diff > 0).mean() <= 5e-3, (diff > 0).sum()
    # What ran: culled lists on bounces 0-1, full sweeps on 2-3, and the
    # energy cut on a tile whose rays are all dim but not all dead.
    assert len(record["near"]) == len(record["shade"]) == DEPTH
    counts = [(args[3], args[4]) for args in record["near"]]
    assert all(int(c.sum()) > 0 and int(f.sum()) == 0 for c, f in counts[:2])
    assert all(int(c.sum()) == 0 and int(f.sum()) > 0 for c, f in counts[2:])
    thr = record["shade"][-1][2].reshape(-1, TILE).amax(1)
    cut = (thr > 0) & (thr <= tcul.DEAD_THR)
    assert bool(cut.any()) and int(counts[-1][1][cut].sum()) == 0


def test_render_and_trace_take_the_culled_route(jax_culled_frame):
    """render() and trace() with use_pallas route a 128-sphere mirror frame
    to the culled trace, as JAX's _render_sample and trace do."""
    ts = random_spheres_scene(S_ROUTE, W_ROUTE, H_ROUTE, dtype=torch.float32)
    cfg = T.RenderConfig(max_depth=DEPTH, use_pallas=True)
    img = T.render(ts, cfg).numpy()
    assert np.abs(img.reshape(-1, 3) - jax_culled_frame).max() <= 1e-6
    dirs = T.camera.ray_directions(ts.camera, torch.float32)
    np.testing.assert_array_equal(T.trace(ts.camera.position, dirs, ts, cfg).numpy(), img.reshape(-1, 3))


# --- the routing table -----------------------------------------------------------


class _Took(Exception):
    pass


def _rows(make_row, n_spheres: int, n_exact: int):
    rows = [make_row((float(i % 16) - 8.0, 0.3 * (i // 16), 6.0 + i // 16), 0.3) for i in range(n_spheres - n_exact)]
    rows += [make_row((0.0, -99999.5 - 10.0 * i, 0.0), 99999.0) for i in range(n_exact)]
    return rows


def _jax_route(monkeypatch, n_spheres, n_exact, depth, key):
    """Which kernels JAX's _render_sample reaches first, caught at the call."""
    from python_ray_tracer_tpu.ops import pallas_bounce, pallas_bounce_sub, pallas_intersect

    jrender = importlib.import_module("python_ray_tracer_tpu.render")  # the package exports a render function

    def took(name):
        def fn(*a, **k):
            raise _Took(name)
        return fn

    monkeypatch.setattr(jcul, "trace_fused_culled", took("culled"))
    monkeypatch.setattr(pallas_bounce_sub, "trace_fused_sub", took("sub"))
    monkeypatch.setattr(pallas_bounce, "trace_fused", took("_bounce_kernel"))
    monkeypatch.setattr(pallas_intersect, "nearest_hit_pallas", took("sweeps"))
    rows = _rows(J.make_sphere_row, n_spheres, n_exact)
    scene = J.make_scene(J.build_spheres(rows), J.build_lights((-2.0, 3.0, 0.0)), (0.0, 0.5, -3.0), 8, 4)
    assert scene.spheres.n_exact == n_exact
    cfg = J.RenderConfig(max_depth=depth, use_pallas=True, stochastic_roughness=key is not None)
    with pytest.raises(_Took) as took_exc:
        jrender._render_sample(scene, cfg, None, None if key is None else jnp.uint32(key))
    return str(took_exc.value)


ROUTE_CASES = [
    (s, e, depth, key)
    for s in (64, 65, 95, 96, 1024)
    for e in (1, 9)
    for depth in (1, 4)
    for key in (None, 5)
]


@pytest.mark.parametrize("n_spheres,n_exact,depth,key", ROUTE_CASES)
def test_hard_route_matches_jax(monkeypatch, n_spheres, n_exact, depth, key):
    """The port takes JAX's kernel route, and refuses the lane kernel's
    scenes (65-95 spheres, or more than 8 exact-tier spheres, mirror)."""
    want = _jax_route(monkeypatch, n_spheres, n_exact, depth, key)
    rows = _rows(T.make_sphere_row, n_spheres, n_exact)
    scene = T.make_scene(T.build_spheres(rows), T.build_lights((-2.0, 3.0, 0.0)), (0.0, 0.5, -3.0), 8, 4)
    cfg = T.RenderConfig(max_depth=depth, use_pallas=True, stochastic_roughness=key is not None)
    if want == "_bounce_kernel":
        with pytest.raises(NotImplementedError, match="_bounce_kernel"):
            hard_route(scene, cfg, key)
        with pytest.raises(NotImplementedError, match="_bounce_kernel"):
            T.render(scene, cfg)
    else:
        assert hard_route(scene, cfg, key) == want


# --- the CLI ---------------------------------------------------------------------


def test_cli_renders_random1024(tmp_path):
    """``--builtin random1024`` on the CPU writes the pure-torch render of the
    1024-sphere scene."""
    out = tmp_path / "big.png"
    assert cli.main(["render", "--builtin", "random1024", "--width", "24", "--height", "16", "--depth", "2",
                     "--device", "cpu", "-o", str(out)]) == 0
    want = T.render(random_spheres_scene(1024, 24, 16), T.RenderConfig(max_depth=2))
    np.testing.assert_array_equal(load_png(out), to_uint8(want))


@pytest.mark.parametrize("name,waits", [("textured1024", "atlases"), ("inverse64", "inverse_task_scene")])
def test_cli_refuses_unported_builtins(tmp_path, name, waits):
    with pytest.raises(NotImplementedError, match=waits):
        cli.main(["render", "--builtin", name, "--width", "8", "--height", "4", "--device", "cpu",
                  "-o", str(tmp_path / "x.png")])
