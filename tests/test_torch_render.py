"""The PyTorch port against the JAX package: scene, camera, intersection,
the pure-torch render slice, the CLI and the port's scope.

Inputs come from the JAX builders or from seeded numpy, and the same arrays
go to both sides.  Frames are 64x32 and every JAX oracle is built once per
module, to keep the suite's CPU budget.
"""

import ast
import dataclasses
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
from python_ray_tracer_tpu_torch.ops import bounce_sub  # noqa: E402
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


def _ninety_six_spheres():
    """96 spheres, 9 of them in the exact tier: the JAX renderer sends this
    mirror scene to its lane kernel, which the port does not have."""
    rows = [T.make_sphere_row((float(i % 12) - 6.0, 0.0, 5.0 + i // 12), 0.3) for i in range(87)]
    rows += [T.make_sphere_row((0.0, -99999.5 - i, 0.0), 99999.0) for i in range(9)]
    spheres = T.build_spheres(rows, dtype=torch.float32)
    lights = T.build_lights((-2.0, 1.0, 2.0), dtype=torch.float32)
    return T.make_scene(spheres, lights, (0.0, 0.2, -2.0), 8, 4, dtype=torch.float32)


def _eighty_atlas_spheres():
    """80 spheres with a 4,096-texel atlas: the JAX renderer sends this hard
    scene to its lane kernel, which samples atlases of up to
    MAX_FUSED_TEXELS texels in-kernel."""
    rows = [T.make_sphere_row((float(i % 12) - 6.0, 0.0, 5.0 + i // 12), 0.3,
                              texture_kind=T.TEXTURE_IMAGE if i % 4 == 0 else 0) for i in range(79)]
    rows.append(T.make_sphere_row((0.0, -99999.5, 0.0), 99999.0))
    atlas = np.full((1, 64, 64, 3), 0.5)
    return T.make_scene(T.build_spheres(rows), T.build_lights((-2.0, 1.0, 2.0)), (0.0, 0.2, -2.0), 8, 4,
                        texture_atlas=atlas)


_UNPORTED = {
    "tie_sum": dict(tie_mode="sum"),
    "ray_chunk": dict(ray_chunk=16),
    "stochastic_ray_chunk": dict(stochastic_roughness=True, ray_chunk=16),
    "remat": dict(remat=True),
    "atlas": {},
    "spp2_atlas": dict(samples_per_pixel=2),
    "96_spheres_kernels": dict(use_pallas=True),
    "80_spheres_atlas_kernels": dict(use_pallas=True),
}
# Routes of the table above that the port has since taken over: they render
# the JAX package's frame (float64, every value within 1e-12).
_PORTED = ("atlas", "spp2_atlas")


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
    return js, scene_from_numpy(_jax_leaves(js), width=8, height=4, n_exact=js.spheres.n_exact, device="cpu",
                                dtype=torch.float64)


@pytest.mark.parametrize("route", _UNPORTED)
def test_unported_routes_raise(route):
    """Each route the port does not have yet raises; none falls back, and
    nothing launches a kernel on the CPU.  The image-atlas routes, ported
    since, render the JAX frame instead (one sample and two jittered ones)."""
    before = dict(bounce_sub.LAUNCHES)
    scene = tscenes.reference_scene(8, 4)
    if route in _PORTED:
        js, ts = _atlas_reference_scenes()
        kw = dict(_UNPORTED[route], max_depth=3)
        want = np.asarray(jax.jit(lambda s: J.render(s, J.RenderConfig(dtype=jnp.float64, **kw)))(js))
        got = T.render(ts, T.RenderConfig(dtype=torch.float64, **kw)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert bounce_sub.LAUNCHES == before == {"trace_deep": 0, "bounce_step": 0}
        return
    if route == "96_spheres_kernels":
        scene = _ninety_six_spheres()
    elif route == "80_spheres_atlas_kernels":
        scene = _eighty_atlas_spheres()
    match = "_bounce_kernel" if route.endswith("_kernels") else "python_ray_tracer_tpu"
    with pytest.raises(NotImplementedError, match=match):
        T.render(scene, T.RenderConfig(**_UNPORTED[route]))
    assert bounce_sub.LAUNCHES == before == {"trace_deep": 0, "bounce_step": 0}


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
    assert len(list(PORT_ROOT.rglob("*.py"))) >= 15
    assert offenders == []
