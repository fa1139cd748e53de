"""The PyTorch port against the JAX package: scene, camera, intersection,
the pure-torch render slice, the CLI and the port's scope.

Inputs come from the JAX builders or from seeded numpy, and the same arrays
go to both sides.  Frames are 64x32 and every JAX oracle is built once per
module, to keep the suite's CPU budget.
"""

import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu import camera as jcam  # noqa: E402
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.ops import intersect as jint  # noqa: E402
from python_ray_tracer_tpu.render import auto_max_depth as jax_auto_max_depth  # noqa: E402
from python_ray_tracer_tpu.utils.image import save_png as jax_save_png  # noqa: E402
from python_ray_tracer_tpu.utils.image import to_uint8 as jax_to_uint8  # noqa: E402
from python_ray_tracer_tpu_torch import camera as tcam  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_from_numpy, scene_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_lane, bounce_sub  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect as tint  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8  # noqa: E402

W, H = 64, 32
SCENES = ("reference", "all_effects")
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
PORT_ROOT = Path(T.__file__).resolve().parent


def _jax_scene(name, dtype):
    return getattr(jscenes, f"{name}_scene")(W, H, dtype=dtype)


def _port_scene(name, dtype):
    return getattr(tscenes, f"{name}_scene")(W, H, dtype=dtype)


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    """A JAX scene as {leaf path: numpy array}, the convert module's keys."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


def _assert_scene_equal(a, b):
    np.testing.assert_equal(scene_to_numpy(a), scene_to_numpy(b))
    assert a.spheres.n_exact == b.spheres.n_exact
    assert (a.camera.width, a.camera.height) == (b.camera.width, b.camera.height)
    for x, y in zip(scene_to_numpy(a).values(), scene_to_numpy(b).values()):
        assert x.dtype == y.dtype


@pytest.mark.parametrize("name", SCENES)
def test_convert_round_trip_matches_builders(name):
    """A JAX f64 scene carried across equals the port's own builder, n_exact included."""
    js = _jax_scene(name, jnp.float64)
    arrays = _jax_leaves(js)
    got = scene_from_numpy(
        arrays, width=W, height=H, n_exact=js.spheres.n_exact, device="cpu", dtype=torch.float64
    )
    mine = _port_scene(name, torch.float64)
    _assert_scene_equal(got, mine)
    assert mine.spheres.n_exact == js.spheres.n_exact == 1
    back = scene_to_numpy(mine)
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert back[k].dtype == arrays[k].dtype, k


def _unfused(fn, *args):
    """``fn`` compiled by XLA with its fusion pass off, applied to ``args``.

    XLA's CPU loop fusion contracts ``a*b + c`` into FMAs (it moves the f64
    reference image by ~2.5e-12, on the reference form's 1e10-scale
    cancellation).  Unfused, XLA evaluates each operation alone with one
    IEEE rounding, bit for bit as eager JAX does, and compiles once where
    eager JAX compiles every primitive.
    """
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})(*args)


@pytest.mark.parametrize("dt", DTYPES)
def test_camera_rays_bitwise(dt):
    jdt, tdt = DTYPES[dt]
    js, ts = _jax_scene("reference", jdt), _port_scene("reference", tdt)
    want, want_t = _unfused(lambda c: (jcam.ray_directions(c, jdt), jcam.ray_directions_t(c, jdt)), js.camera)
    np.testing.assert_array_equal(tcam.ray_directions(ts.camera, tdt).numpy(), np.asarray(want))
    np.testing.assert_array_equal(tcam.ray_directions_t(ts.camera, tdt).numpy(), np.asarray(want_t))


def _seeded_rays(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    d = rng.normal(size=(n, 3))
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fn", ["intersect_all", "intersect_two_tier", "intersect_all_stable"])
def test_intersect_matches_jax(fn, dt):
    """2,000 seeded rays against the reference spheres, r = 99999 ground included."""
    jdt, tdt = DTYPES[dt]
    js = _jax_scene("reference", jnp.float64)
    o, d = _seeded_rays()
    c, r = np.asarray(js.spheres.center), np.asarray(js.spheres.radius)
    far = J.faraway(jdt)
    extra = (js.spheres.n_exact,) if fn == "intersect_two_tier" else ()
    want = _unfused(lambda *a: getattr(jint, fn)(*a, far, *extra), *(jnp.asarray(a, jdt) for a in (o, d, c, r)))
    got = getattr(tint, fn)(*(torch.tensor(a, dtype=tdt) for a in (o, d, c, r)), far, *extra)
    want_near = jint.nearest_hit(want.t, far)
    got_near = tint.nearest_hit(got.t, far)
    np.testing.assert_array_equal(got_near.idx.numpy(), np.asarray(want_near.idx))
    np.testing.assert_array_equal(got_near.hit.numpy(), np.asarray(want_near.hit))
    assert got_near.hit.any() and not got_near.hit.all()
    if dt == "float64":
        for field in ("t", "sol", "disc"):
            np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name,depth", [("reference", 3), ("reference", 6), ("all_effects", 3)])
def test_render_matches_xla_f64(name, depth):
    """The pure-torch slice against the JAX XLA render in f64."""
    cfg = J.RenderConfig(max_depth=depth, dtype=jnp.float64)
    want = np.asarray(_unfused(lambda sc: J.render(sc, cfg), _jax_scene(name, jnp.float64)))
    got = T.render(_port_scene(name, torch.float64), T.RenderConfig(max_depth=depth, dtype=torch.float64)).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(to_uint8(got), jax_to_uint8(want))


@pytest.mark.parametrize("name", SCENES)
def test_auto_max_depth_matches_jax(name):
    assert T.auto_max_depth(_port_scene(name, torch.float32)) == jax_auto_max_depth(_jax_scene(name, jnp.float32))


def test_cli_render_png_matches_jax(tmp_path):
    """The CLI on --device cpu writes the JAX render's to_uint8, and a PNG
    that PIL reads back the same; load_png reads PIL's own (filtered) PNGs."""
    from PIL import Image

    out, metrics = tmp_path / "r.png", tmp_path / "m.jsonl"
    rc = cli.main(
        ["render", "--builtin", "reference", "--width", str(W), "--height", str(H),
         "--device", "cpu", "-o", str(out), "--metrics", str(metrics)]
    )
    assert rc == 0
    want = jax_to_uint8(np.asarray(J.render_jit(_jax_scene("reference", jnp.float32), J.RenderConfig(max_depth=3))))
    np.testing.assert_array_equal(load_png(out), want)
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), want)
    assert '"event": "render"' in metrics.read_text()
    jax_png = tmp_path / "jax.png"
    jax_save_png(np.random.default_rng(0).uniform(-0.1, 1.1, (H, W, 3)), jax_png)
    np.testing.assert_array_equal(load_png(jax_png), np.asarray(Image.open(jax_png).convert("RGB")))


def test_cli_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--width", "8", "--height", "4", "-o", str(tmp_path / "x.png")])


def _kernel_rows(make_row, n_spheres: int, n_exact: int, atlas: bool):
    """The lane kernel's scenes: a grid of spheres (every 4th image-textured
    with ``atlas``), then ``n_exact`` r = 99999 spheres in the exact tier."""
    rows = [make_row((float(i % 12) - 6.0, 0.0, 5.0 + i // 12), 0.3, specular_gain=0.5, diffuse_gain=0.8,
                     texture_kind=2 if atlas and i % 4 == 0 else 0) for i in range(n_spheres - n_exact)]
    rows += [make_row((0.0, -99999.5 - i, 0.0), 99999.0, diffuse_gain=1.0) for i in range(n_exact)]
    return rows


def _ninety_six_spheres(make_row=T.make_sphere_row):
    """96 spheres, 9 of them in the exact tier: the JAX renderer sends this
    mirror scene to its lane kernel."""
    return _kernel_rows(make_row, 96, 9, False), None


def _eighty_atlas_spheres(make_row=T.make_sphere_row):
    """80 spheres with a 4,096-texel atlas: the JAX renderer sends this hard
    scene to its lane kernel, which samples atlases of up to
    MAX_FUSED_TEXELS texels in-kernel."""
    return _kernel_rows(make_row, 80, 1, True), np.random.default_rng(2).uniform(0.0, 1.0, (1, 64, 64, 3))


def _tied_spheres(make_row=T.make_sphere_row):
    """A scene that really ties: sphere 1 duplicated bitwise as sphere 3 with
    another colour, so every lane that hits it has two winners at one t."""
    rows = [
        make_row((0.0, -99999.5, 0.0), 99999.0, diffuse_gain=1.0, texture_kind=1, specular_gain=0.3),
        make_row((-0.4, 0.1, 1.0), 0.5, diffuse_gain=0.9, diffuse_color=(0.2, 0.4, 0.9), specular_gain=0.6),
        make_row((0.6, 0.2, 1.6), 0.45, diffuse_gain=0.8, specular_gain=0.9, iridescence_gain=0.5),
    ]
    rows.append(dict(rows[1], diffuse_color=np.asarray((0.9, 0.3, 0.1)), specular_gain=0.8))
    return rows, None


# Each route of the JAX renderer, by the options it takes (and its scene).
# Every one but interpret mode renders the JAX package's frame (float64,
# every value within 1e-12); the kernel routes run their plain versions on
# the CPU, against JAX's float64 XLA route with the kernels' two-tier sweep.
_ROUTES = {
    "tie_sum": dict(tie_mode="sum"),
    "ray_chunk": dict(ray_chunk=16),
    "stochastic_ray_chunk": dict(stochastic_roughness=True, ray_chunk=16),
    "remat": dict(remat=True),
    "atlas": {},
    "spp2_atlas": dict(samples_per_pixel=2),
    "96_spheres_kernels": dict(use_pallas=True),
    "80_spheres_atlas_kernels": dict(use_pallas=True),
    "tie_sum_duplicate": dict(tie_mode="sum"),
    "ray_chunk_12": dict(ray_chunk=12),
    "smooth_ray_chunk_kernels": dict(visibility="smooth", use_pallas=True, ray_chunk=16),
    "96_spheres_ray_chunk_kernels": dict(use_pallas=True, ray_chunk=12),
    "interpret": dict(pallas_interpret=True),
}
# The kernel function each chunked kernel case reaches once per tile (and
# per bounce), counted at the call: 32 rays in tiles of 16 or 12.
_CHUNK_CALLS = {"smooth_ray_chunk_kernels": ("trace_fused_smooth_sub", 2),
                "96_spheres_ray_chunk_kernels": ("nearest_sweep", 3 * 3)}
_SCENES = {"96_spheres_kernels": _ninety_six_spheres, "80_spheres_atlas_kernels": _eighty_atlas_spheres,
           "tie_sum_duplicate": _tied_spheres, "96_spheres_ray_chunk_kernels": _ninety_six_spheres}


def _atlas_reference_scenes():
    """The reference scene at 8x4 with its red sphere image-textured from a
    seeded 4x4 atlas: (JAX scene, port scene), the same arrays, float64."""
    js = jscenes.reference_scene(8, 4, dtype=jnp.float64)
    js = dataclasses.replace(
        js,
        spheres=dataclasses.replace(js.spheres, texture_kind=js.spheres.texture_kind.at[1].set(2)),
        texture_atlas=jnp.asarray(np.random.default_rng(0).uniform(0.0, 1.0, (1, 4, 4, 3))),
        texture_hw=jnp.asarray([[4, 4]], jnp.int32),
    )
    return js, _port_of(js)


def _port_of(js):
    return scene_from_numpy(_jax_leaves(js), width=js.camera.width, height=js.camera.height,
                            n_exact=js.spheres.n_exact, device="cpu", dtype=torch.float64)


def _route_scenes(route):
    """(JAX scene, port scene) of a route's case, float64, 8x4."""
    if route in ("atlas", "spp2_atlas"):
        return _atlas_reference_scenes()
    if route in _SCENES:
        from python_ray_tracer_tpu.scene import build_lights, build_spheres, make_scene, make_sphere_row

        rows, atlas = _SCENES[route](make_sphere_row)
        js = make_scene(build_spheres(rows, dtype=jnp.float64), build_lights((-2.0, 1.0, 2.0), dtype=jnp.float64),
                        (0.0, 0.2, -2.0), 8, 4, texture_atlas=atlas, dtype=jnp.float64)
        return js, _port_of(js)
    js = jscenes.reference_scene(8, 4, dtype=jnp.float64)
    return js, _port_of(js)


@pytest.mark.parametrize("route", _ROUTES)
def test_unported_routes_raise(route, monkeypatch):
    """Each route of the JAX renderer renders the JAX frame (float64, within
    1e-12), and nothing launches a kernel on the CPU; interpret mode, which
    a CUDA kernel has no counterpart for, still raises.  The tie scene does
    tie (its tie_mode="sum" frame is not its "first" one), ray_chunk 12
    pads its last tile (32 rays), and chunked kernel frames take their
    kernels' plain versions tile by tile: the smooth kernel route, and the
    sweeps on a scene that unchunked takes the lane kernel."""
    launches = (bounce_sub.LAUNCHES, bounce_lane.LAUNCHES, bounce_lane.ATLAS_LAUNCHES)
    before = tuple(dict(c) for c in launches)
    js, ts = _route_scenes(route)
    kw = dict(_ROUTES[route], max_depth=3)
    if route == "interpret":
        with pytest.raises(NotImplementedError, match="interpret"):
            T.render(ts, T.RenderConfig(dtype=torch.float64, **kw))
        return
    jax_kw = {k: v for k, v in kw.items() if k != "use_pallas"}
    if route.endswith("_kernels"):
        jax_kw.update(intersect_mode="stable")
    want = np.asarray(_unfused(lambda s: J.render(s, J.RenderConfig(dtype=jnp.float64, **jax_kw)), js))
    calls = []
    if route in _CHUNK_CALLS:
        render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
        name, expected = _CHUNK_CALLS[route]
        real = getattr(render_mod, name)
        monkeypatch.setattr(render_mod, name, lambda *a, **k: calls.append(name) or real(*a, **k))
    got = T.render(ts, T.RenderConfig(dtype=torch.float64, **kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tuple(launches) == before
    if route in _CHUNK_CALLS:
        assert len(calls) == expected
    if route == "tie_sum_duplicate":
        first = T.render(ts, T.RenderConfig(dtype=torch.float64, max_depth=3)).numpy()
        assert np.abs(first - got).max() > 0.1


def test_remat_gradients_bitwise():
    """``remat`` recomputes each bounce of the pure-torch trace in the
    backward pass: every gradient equal bitwise with and without it
    (smooth, float64).  The kernel routes have their own backward passes and
    ignore it, as the JAX package's do: their frames are unchanged."""
    from python_ray_tracer_tpu_torch.optim import combine, scene_to_params

    scene = tscenes.reference_scene(8, 4, dtype=torch.float64)
    grads = []
    for remat in (False, True):
        params = scene_to_params(scene)
        cfg = T.RenderConfig(dtype=torch.float64, visibility="smooth", max_depth=3, remat=remat)
        loss = torch.sum(T.render(combine(params, scene), cfg) ** 2)
        grads.append(torch.autograd.grad(loss, list(params.values()), allow_unused=True))
    assert any(g is not None and bool(g.abs().max() > 0) for g in grads[0])
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
    for vis in ("hard", "smooth"):
        cfg = T.RenderConfig(dtype=torch.float64, visibility=vis, max_depth=3, use_pallas=True)
        with torch.no_grad():
            plain = T.render(scene, cfg)
            remat = T.render(scene, dataclasses.replace(cfg, remat=True))
        assert torch.equal(plain, remat)


def test_image_texture_kind_raises():
    """Formerly refused: the image texture kind now renders, the JAX frame of
    one image-textured sphere (float64, within 1e-12)."""
    from python_ray_tracer_tpu.scene import build_lights, build_spheres, make_scene, make_sphere_row

    atlas = np.random.default_rng(1).uniform(0.0, 1.0, (1, 8, 16, 3))
    rows = [make_sphere_row((0.0, 0.0, 3.0), 1.0, diffuse_gain=1.0, texture_kind=2)]
    js = make_scene(build_spheres(rows, dtype=jnp.float64), build_lights((0.0, 2.0, -1.0), dtype=jnp.float64),
                    (0.0, 0.0, -2.0), 8, 4, texture_atlas=atlas, dtype=jnp.float64)
    ts = scene_from_numpy(_jax_leaves(js), width=8, height=4, n_exact=0, device="cpu", dtype=torch.float64)
    want = np.asarray(jax.jit(lambda s: J.render(s, J.RenderConfig(dtype=jnp.float64)))(js))
    got = T.render(ts, T.RenderConfig(dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(got).max() > 0.1


def test_port_never_imports_jax():
    """An AST scan of every module of the port (sys.modules cannot tell:
    the JAX package is already imported in this process)."""
    offenders = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("jax", "jaxlib", "python_ray_tracer_tpu")]
    scanned = {path.relative_to(PORT_ROOT).as_posix() for path in PORT_ROOT.rglob("*.py")}
    assert {"io/scene_json.py", "io/__init__.py", "utils/denoise.py", "utils/metrics.py", "ops/bounce_lane.py"} <= scanned
    assert len(scanned) >= 15
    assert offenders == []
