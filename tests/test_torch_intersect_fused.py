"""The standalone sweeps and the stochastic big-scene route against JAX.

The plain versions of ``nearest_sweep``/``shadow_sweep`` against
``nearest_hit_pallas``/``shadow_hard_pallas`` run in interpret mode, f32
and f64, with the r = 99999 ground in the exact tier; then a stochastic
glossy frame above 64 spheres, which takes ``render.trace`` with the two
sweeps in both packages.  The JAX oracles compile once each, with XLA's
fusion (FMA contraction) and algebraic simplifier (``1 / sqrt`` into
``rsqrt`` in the glossy continuation) off.  The CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.models.scenes import random_spheres_scene as jax_random_scene  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_intersect import nearest_hit_pallas, shadow_hard_pallas  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as tif  # noqa: E402
from python_ray_tracer_tpu_torch.ops.tables import geometry_table  # noqa: E402

ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion,algsimp"}
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
N_SPHERES = 96


def _oracle(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)(*args)


def _rays(n=3000, seed=0):
    """Seeded rays from the camera's side of the scene, most of them hitting
    a sphere or the ground."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-6.0, 0.0, -5.0], [6.0, 4.0, 0.0], (n, 3))
    d = rng.normal(0.0, 0.4, (n, 3)) + np.array([0.0, -0.2, 1.0])
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def sweeps():
    """For each dtype: the inputs and JAX's nearest (t, idx) and shadow
    visibility, the shadow rays from the nearest hits toward the light."""
    out = {}
    for name, (jdt, _) in DTYPES.items():
        js = jax_random_scene(N_SPHERES, 16, 8, dtype=jdt)
        c, r = np.asarray(js.spheres.center), np.asarray(js.spheres.radius)
        far = J.faraway(jdt)
        n_exact = js.spheres.n_exact
        o, d = _rays()
        t, idx = _oracle(
            lambda o_, d_, c_, r_: tuple(nearest_hit_pallas(o_, d_, c_, r_, far, n_exact=n_exact, interpret=True))[:2],
            *(jnp.asarray(a, jdt) for a in (o, d, c, r)),
        )
        t, idx = np.asarray(t), np.asarray(idx)
        hit = t != far
        p = o + d * np.where(hit, t, 1.0)[:, None]
        nrm = (p - c[idx]) / r[idx][:, None]
        so = (p + nrm * 1e-4).astype(o.dtype)
        light = np.asarray(js.lights.point_position)
        sd = (light - p) / np.linalg.norm(light - p, axis=1, keepdims=True)
        lit = np.asarray(_oracle(
            lambda o_, d_, c_, r_, i_: shadow_hard_pallas(o_, d_, c_, r_, i_, far, n_exact=n_exact, interpret=True),
            *(jnp.asarray(a, jdt) for a in (so, sd, c, r)), jnp.asarray(idx),
        ))
        out[name] = dict(o=o, d=d, t=t, idx=idx, so=so, sd=sd, lit=lit, far=far, scene=js)
    return out


def _port_args(case, name):
    tdt = DTYPES[name][1]
    ts = random_spheres_scene(N_SPHERES, 16, 8, dtype=tdt)
    kw = dict(faraway=case["far"], s_cheap=ts.spheres.count - ts.spheres.n_exact)
    return geometry_table(ts, tdt), kw, tdt


@pytest.mark.parametrize("name", DTYPES)
def test_nearest_sweep_matches_jax_kernel(sweeps, name):
    """t bitwise, idx exact, on rays that hit cheap spheres, the ground and nothing."""
    case = sweeps[name]
    geom, kw, tdt = _port_args(case, name)
    near = tif.nearest_sweep(torch.tensor(case["o"], dtype=tdt), torch.tensor(case["d"], dtype=tdt), geom, **kw)
    np.testing.assert_array_equal(near.t.numpy(), case["t"])
    np.testing.assert_array_equal(near.idx.numpy(), case["idx"])
    hit = case["t"] != case["far"]
    ground = case["idx"] == N_SPHERES - 1
    assert hit.any() and (~hit).any() and (ground & hit).any() and (~ground & hit).any()
    assert tif.LAUNCHES == {"nearest_sweep": 0, "shadow_sweep": 0}


@pytest.mark.parametrize("name", DTYPES)
def test_shadow_sweep_matches_jax_kernel(sweeps, name):
    """in_light exact, lit and shadowed lanes both present."""
    case = sweeps[name]
    geom, kw, tdt = _port_args(case, name)
    lit = tif.shadow_sweep(
        torch.tensor(case["so"], dtype=tdt), torch.tensor(case["sd"], dtype=tdt), geom,
        torch.tensor(case["idx"], dtype=torch.int32), **kw,
    )
    assert lit.dtype == tdt
    np.testing.assert_array_equal(lit.numpy(), case["lit"])
    assert 0 < case["lit"].sum() < case["lit"].size


def test_sweep_plain_versions_chunk_exactly(sweeps, monkeypatch):
    """Chunking the plain versions' (N, S) tables over rays changes nothing."""
    case = sweeps["float32"]
    geom, kw, tdt = _port_args(case, "float32")
    o, d = torch.tensor(case["o"], dtype=tdt), torch.tensor(case["d"], dtype=tdt)
    whole = tif.nearest_sweep_plain(o, d, geom, **kw)
    monkeypatch.setattr(tif, "_CHUNK_PAIRS", 7 * N_SPHERES)
    chunked = tif.nearest_sweep_plain(o, d, geom, **kw)
    assert len(tif._chunks(o.shape[0], N_SPHERES)) > 100
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize(
    "fault", ["requires_grad", "dtype", "noncontiguous", "shape", "self_idx_dtype", "s_cheap"]
)
def test_sweep_wrappers_refuse_what_the_kernels_do_not_take(fault):
    ts = random_spheres_scene(N_SPHERES, 16, 8)
    geom = geometry_table(ts, torch.float32)
    o, d = (torch.tensor(x, dtype=torch.float32) for x in _rays(64))
    idx = torch.zeros((64,), dtype=torch.int32)
    kw = dict(faraway=1e30, s_cheap=N_SPHERES - 1)
    if fault == "requires_grad":
        d = d.clone().requires_grad_(True)
    elif fault == "dtype":
        d = d.double()
    elif fault == "noncontiguous":
        d = d.T.contiguous().T
    elif fault == "shape":
        d = d[:-1]
    elif fault == "self_idx_dtype":
        idx = idx.long()
    else:
        kw["s_cheap"] = N_SPHERES + 1
    with pytest.raises(ValueError):
        tif.shadow_sweep(o, d, geom, idx, **kw)
    if fault != "self_idx_dtype":
        with pytest.raises(ValueError):
            tif.nearest_sweep(o, d, geom, **kw)
    assert tif.LAUNCHES == {"nearest_sweep": 0, "shadow_sweep": 0}


def test_stochastic_big_scene_render_matches_jax():
    """A glossy frame of 112 spheres: JAX's render falls back to trace with
    nearest_hit_pallas/shadow_hard_pallas (interpret), the port's to trace
    with the sweep plain versions.  Every value within 1e-6 (reading: 10 of
    4,608 values off, by at most 1.2e-7)."""
    w, h, depth = 48, 32, 3
    js = jax_random_scene(112, w, h, dtype=jnp.float32)
    cfg = J.RenderConfig(max_depth=depth, use_pallas=True, pallas_interpret=True, stochastic_roughness=True, rng_seed=7)
    want = np.asarray(_oracle(lambda sc: J.render(sc, cfg), js))
    ts = random_spheres_scene(112, w, h, dtype=torch.float32)
    got = T.render(ts, T.RenderConfig(max_depth=depth, use_pallas=True, stochastic_roughness=True, rng_seed=7)).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The glossy continuation moved the frame off the mirror one.
    mirror = T.render(ts, T.RenderConfig(max_depth=depth, use_pallas=True)).numpy()
    assert np.abs(got - mirror).max() > 1e-3
