"""The bounce kernels' plain versions against the JAX kernel body.

``_bounce_math`` (``ops/pallas_bounce_sub.py``) accepts plain ``jnp``
arrays for its tables, so it runs eagerly with no Pallas at all: looped
over depth it is exactly what ``_trace_kernel_sub_deep`` and a chain of
``_bounce_kernel_sub`` launches compute.  The port's ``trace_fused_sub`` on
CPU tensors runs the plain versions of its CUDA kernels, route by route.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.

Each JAX chain runs once per module, to the deepest depth any case needs;
the accumulated color after bounce k is the depth-k render.  The glossy
cases feed both sides the same xi, drawn by the port on the JAX package's
schedule (``tests/test_torch_sampling.py`` holds the draw bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from python_ray_tracer_tpu.camera import ray_directions_t as jax_rays_t  # noqa: E402
from python_ray_tracer_tpu.config import faraway as jax_faraway  # noqa: E402
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_bounce import _material_table  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_bounce_sub import _bounce_math, _consts_row, _geometry_table  # noqa: E402
from python_ray_tracer_tpu_torch import RenderConfig  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_sub  # noqa: E402
from python_ray_tracer_tpu_torch.ops.rng import bounce_xi  # noqa: E402
from python_ray_tracer_tpu_torch.ops.tables import consts_row, geometry_table, material_table  # noqa: E402

W, H = 64, 32
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
GLOSSY_KEY = 99
# Depth 12 (the reference scene's --depth auto) runs in float64 only: an
# eager JAX bounce costs ~0.3 s here, and the CUDA kernels are held at
# depth 12 in float32 against these plain versions by chip_smoke.py.
CASES = [
    ("reference", 3, "trace_deep", "float64"),
    ("reference", 3, "bounce_step", "float64"),
    ("reference", 1, "bounce_step", "float64"),
    ("reference", 12, "bounce_step", "float64"),
    ("reference", 12, "trace_deep", "float64"),
    ("all_effects", 3, "trace_deep", "float64"),
    ("all_effects", 3, "bounce_step", "float64"),
    ("reference", 3, "trace_deep", "float32"),
    ("reference", 3, "bounce_step", "float32"),
    ("reference", 1, "bounce_step", "float32"),
    ("all_effects", 3, "trace_deep", "float32"),
    ("all_effects", 3, "bounce_step", "float32"),
    ("reference", 3, "trace_deep", "float64-glossy"),
    ("reference", 3, "bounce_step", "float64-glossy"),
]
# Deepest depth each (scene, dtype) chain needs.
CHAIN_DEPTH = {(n, dt): max(c[1] for c in CASES if c[0] == n and c[3] == dt) for n, _, _, dt in CASES}


def _xis(dt: str, n: int, depth: int) -> list:
    """Each bounce's (2, N) xi for the glossy cases, else Nones."""
    if not dt.endswith("-glossy"):
        return [None] * depth
    return bounce_xi(GLOSSY_KEY, n, depth, DTYPES[dt.split("-")[0]][1])


def _jax_chain(name: str, dt: str) -> list[np.ndarray]:
    """(N, 3) accumulated color after each bounce of the eager JAX kernel body."""
    jdt = DTYPES[dt.split("-")[0]][0]
    scene = getattr(jscenes, f"{name}_scene")(W, H, dtype=jdt)
    d_t = jax_rays_t(scene.camera, jdt)
    n = d_t.shape[1]
    o = tuple(jnp.broadcast_to(jnp.asarray(scene.camera.position, jdt)[i], (n,)) for i in range(3))
    d = (d_t[0], d_t[1], d_t[2])
    s = scene.spheres.count
    tables = (_geometry_table(scene, jdt), _material_table(scene, jdt)[:s], _consts_row(scene, jdt))
    thr = alive = jnp.ones((n,), jdt)
    acc = [jnp.zeros((n,), jdt)] * 3
    out = []
    for xi in _xis(dt, n, CHAIN_DEPTH[(name, dt)]):
        add, o, d, thr, alive, _, _ = _bounce_math(
            o, d, thr, alive, *tables, faraway=jax_faraway(jdt), s_cheap=s - scene.spheres.n_exact,
            s_total=s, parts="full", tex_hw=None, xi=None if xi is None else (jnp.asarray(xi[0].numpy()), jnp.asarray(xi[1].numpy())),
        )
        acc = [acc[i] + add[i] for i in range(3)]
        out.append(np.stack([np.asarray(a) for a in acc], axis=1))
    return out


@pytest.fixture(scope="module")
def jax_chains():
    cache = {}

    def get(name, dt):
        if (name, dt) not in cache:
            cache[(name, dt)] = _jax_chain(name, dt)
        return cache[(name, dt)]

    return get


@pytest.mark.parametrize("name,depth,route,dt", CASES)
def test_plain_kernels_match_jax_body(jax_chains, name, depth, route, dt):
    """f64: within 1e-12.  f32: at least 99.9% of values within 1e-5 (eager
    and jitted JAX themselves part by up to 5.8e-4 on a few f32 values)."""
    tdt = DTYPES[dt.split("-")[0]][1]
    want = jax_chains(name, dt)[depth - 1]
    scene = getattr(tscenes, f"{name}_scene")(W, H, dtype=tdt)
    glossy = dt.endswith("-glossy")
    got = bounce_sub.trace_fused_sub(
        scene.camera.position, ray_directions_t(scene.camera, tdt), scene,
        RenderConfig(max_depth=depth, dtype=tdt, stochastic_roughness=glossy), route=route,
        key=GLOSSY_KEY if glossy else None,
    ).numpy()
    assert got.shape == want.shape == (W * H, 3)
    diff = np.abs(got - want)
    if dt.startswith("float64"):
        assert diff.max() <= 1e-12, diff.max()
    else:
        share = float((diff <= 1e-5).mean())
        assert share >= 0.999, f"{share:.5f} within 1e-5; max {diff.max():.3e}"
    assert bounce_sub.LAUNCHES == {"trace_deep": 0, "bounce_step": 0}


def _inputs():
    scene = tscenes.reference_scene(8, 5)
    d = ray_directions_t(scene.camera, torch.float32)
    o = scene.camera.position.reshape(3, 1).expand(d.shape).contiguous()
    tables = (geometry_table(scene, torch.float32), material_table(scene, torch.float32), consts_row(scene, torch.float32))
    return o, d, tables


def test_tables_match_jax():
    """The kernel side tables carry the JAX tables' values and column order."""
    for name in ("reference", "all_effects"):
        js = getattr(jscenes, f"{name}_scene")(W, H, dtype=jnp.float64)
        ts = getattr(tscenes, f"{name}_scene")(W, H, dtype=torch.float64)
        s = js.spheres.count
        np.testing.assert_array_equal(geometry_table(ts, torch.float64).numpy(), np.asarray(_geometry_table(js, jnp.float64)))
        np.testing.assert_array_equal(material_table(ts, torch.float64).numpy(), np.asarray(_material_table(js, jnp.float64))[:s])
        np.testing.assert_array_equal(consts_row(ts, torch.float64).numpy(), np.asarray(_consts_row(js, jnp.float64)))


@pytest.mark.parametrize(
    "fault", ["requires_grad", "dtype", "noncontiguous", "shape", "too_many_spheres", "s_cheap", "depth", "route"]
)
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    o, d, (geom, mat, consts) = _inputs()
    kw = dict(depth=2, faraway=1e30, s_cheap=2)
    if fault == "requires_grad":
        d = d.clone().requires_grad_(True)
    elif fault == "dtype":
        d = d.double()
    elif fault == "noncontiguous":
        d = d.T.contiguous().T
    elif fault == "shape":
        d = d[:, :-1].contiguous()
    elif fault == "too_many_spheres":
        geom, mat = geom.repeat(22, 1), mat.repeat(22, 1)
    elif fault == "s_cheap":
        kw["s_cheap"] = 4
    elif fault == "depth":
        kw["depth"] = 0
    else:
        scene = tscenes.reference_scene(8, 5)
        with pytest.raises(ValueError, match="route"):
            bounce_sub.trace_fused_sub(scene.camera.position, d, scene, RenderConfig(), route="scan")
        return
    with pytest.raises(ValueError):
        bounce_sub.trace_deep(o, d, geom, mat, consts, **kw)
    assert bounce_sub.LAUNCHES == {"trace_deep": 0, "bounce_step": 0}
