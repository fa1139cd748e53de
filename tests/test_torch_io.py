"""The port's files and CLI surface against the JAX package.

``io/scene_json.py`` (``load_scene``: every leaf bitwise, mixed-size image
textures padded into one atlas with their native extents kept; and
``load_settings``), ``utils/denoise.py`` (``nl_means_denoise``: float64
within 1e-12, float32 within 1e-6; its two borders differ, a reflect pad for
the shifted copies and a zero pad for the patch box sum), and the ``render``
CLI's ``--scene``/``--settings``/``--denoise``/``--profile`` and
``optimize --scene --settings`` on ``--device cpu``.
"""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.io import load_scene as jax_load_scene  # noqa: E402
from python_ray_tracer_tpu.io import load_settings as jax_load_settings  # noqa: E402
from python_ray_tracer_tpu.utils.denoise import nl_means_denoise as jax_denoise  # noqa: E402
from python_ray_tracer_tpu.utils.image import to_uint8 as jax_to_uint8  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.io import load_scene, load_settings  # noqa: E402
from python_ray_tracer_tpu_torch.utils.denoise import nl_means_denoise  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png, save_png, to_uint8  # noqa: E402

TESTDATA = Path(T.__file__).resolve().parent / "testdata"
LANE80, LANE80_SETTINGS = TESTDATA / "lane80.json", TESTDATA / "lane80_settings.json"
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}


def _mixed_scene(tmp_path: Path) -> Path:
    """A scene file with every object type, a checker, a constant and two
    differently-sized image textures (8x16 and 32x64)."""
    rng = np.random.default_rng(11)
    save_png(rng.uniform(0.2, 1.0, (8, 16, 3)), tmp_path / "small.png")
    save_png(rng.uniform(0.2, 1.0, (32, 64, 3)), tmp_path / "big.png")
    objs = [
        {"type": "Camera", "positionXYZ": [0.1, 0.3, -2.5]},
        {"type": "Sphere", "centerXYZ": [0.0, 0.0, 3.0], "radius": 1.0, "texture": "small.png", "diffuse_gain": 0.9,
         "specular_gain": 0.4, "thin_film_ior": 1.3},
        {"type": "Sphere", "centerXYZ": [1.5, 0.2, 4.0], "radius": 0.6, "texture": "big.png", "reflection": 0.2},
        {"type": "Sphere", "centerXYZ": [-1.2, 0.0, 2.0], "radius": 0.4, "colorRGB": [1.0, 0.0, 0.0],
         "roughness": 0.1, "specular_gain": 1.0, "iridescence_gain": 0.5, "specular_ior": 1.7,
         "thin_film_weight": 0.2, "thin_film_thickness": 0.4},
        {"type": "Sphere", "centerXYZ": [0.0, -99999.5, 0.0], "radius": 99999.0, "texture": "checker",
         "specular_gain": 0.1, "roughness": 0.5},
        {"type": "Light", "centerXYZ": [-2.0, 2.5, 0.0], "intensityRGB": [1, 1, 1]},
        {"type": "DomeLight", "intensity": 0.2, "colorRGB": [0.9, 0.9, 1.0]},
        {"type": "DomeLight", "intensity": 0.1},
    ]
    path = tmp_path / "mixed.json"
    path.write_text(json.dumps(objs))
    return path


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("which", ["mixed", "lane80"])
def test_load_scene_matches_jax(tmp_path, which, dt):
    """Every leaf bitwise and of the same dtype, n_exact and frame size too."""
    jdt, tdt = DTYPES[dt]
    path = _mixed_scene(tmp_path) if which == "mixed" else LANE80
    js = jax_load_scene(path, width=24, height=16, dtype=jdt)
    ts = load_scene(path, width=24, height=16, dtype=tdt, device="cpu")
    want, got = _jax_leaves(js), scene_to_numpy(ts)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert (ts.spheres.n_exact, ts.camera.width, ts.camera.height) == (js.spheres.n_exact, 24, 16)
    if which == "mixed":
        assert ts.texture_atlas.shape == (2, 32, 64, 3)
        assert ts.texture_hw.tolist() == [[8, 16], [32, 64]]


def test_load_scene_needs_device():
    """The device is the caller's to name: no default puts a scene on the CPU
    unasked, where the kernels' wrappers would run their plain versions."""
    with pytest.raises(TypeError, match="device"):
        load_scene(LANE80, width=16, height=8)


SETTINGS = {
    "defaults": {},
    "lane80": json.loads(LANE80_SETTINGS.read_text()),
    "every_key": {"image_width": 40, "image_height": 20, "max_specular_depth": 5, "dtype": "float64",
                  "visibility": "smooth", "use_pallas": True, "max_samples_per_pixel": 4,
                  "stochastic_roughness": True, "rng_seed": 9, "denoise": True, "output_path": "x.png"},
}


@pytest.mark.parametrize("name", SETTINGS)
def test_load_settings_matches_jax(tmp_path, name):
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(SETTINGS[name]))
    jcfg, jextras = jax_load_settings(path)
    cfg, extras = load_settings(path)
    assert extras == jextras
    for field in ("max_depth", "visibility", "use_pallas", "samples_per_pixel", "stochastic_roughness", "rng_seed",
                  "ray_chunk", "remat", "tie_mode", "intersect_mode"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


DENOISE = [("float64", {}, 1e-12), ("float32", {}, 1e-6),
           ("float64", dict(strength=0.1, patch_size=4, search_radius=2), 1e-12)]


@pytest.mark.parametrize("dt,kw,atol", DENOISE, ids=["f64", "f32", "f64_even_patch"])
def test_nl_means_denoise_matches_jax(dt, kw, atol):
    """A seeded 24x16 image with a bright block touching two borders, where
    the reflect pad and the zero-padded box sum both matter."""
    jdt, tdt = DTYPES[dt]
    image = np.random.default_rng(4).uniform(0.0, 1.0, (16, 24, 3)) * 0.3
    image[:5, 18:] += 0.6
    want = np.asarray(jax_denoise(jnp.asarray(image, jdt), **kw))
    got = nl_means_denoise(torch.tensor(image, dtype=tdt), **kw).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _settings(tmp_path: Path, **extra) -> Path:
    path = tmp_path / "settings.json"
    path.write_text(json.dumps({**SETTINGS["lane80"], "image_width": 16, "image_height": 8, **extra}))
    return path


def _port_frame() -> torch.Tensor:
    cfg, _ = load_settings(LANE80_SETTINGS)
    with torch.no_grad():
        return T.render(load_scene(LANE80, width=16, height=8, device="cpu"), cfg)


def test_cli_render_scene_settings(tmp_path, monkeypatch):
    """``render --scene --settings --device cpu``: the settings file's frame,
    depth and use_pallas (the lane route, its plain version here, once per
    render of the two the CLI makes), the port's frame and within one uint8
    level of JAX's lane route's (interpret mode, unfused: the same
    polynomial UV); without ``-o`` the file's output_path."""
    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    calls = []
    real = render_mod.trace_fused_lane
    monkeypatch.setattr(render_mod, "trace_fused_lane", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tmp_path / "from_settings.png"
    settings = _settings(tmp_path, output_path=str(out))
    assert cli.main(["render", "--scene", str(LANE80), "--settings", str(settings), "--device", "cpu"]) == 0
    assert len(calls) == 2
    got = load_png(out)
    np.testing.assert_array_equal(got, to_uint8(_port_frame()))
    js = jax_load_scene(LANE80, width=16, height=8, dtype=jnp.float32)
    jcfg = J.RenderConfig(max_depth=4, use_pallas=True, pallas_interpret=True)
    fn = jax.jit(lambda s: J.render(s, jcfg)).lower(js).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
    want = jax_to_uint8(np.asarray(fn(js)))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("how", ["flag", "settings_key"])
def test_cli_render_denoise(tmp_path, how):
    """``--denoise``, or the settings file's ``denoise`` key: the port's
    denoise of the clipped frame."""
    settings = _settings(tmp_path, denoise=how == "settings_key")
    out = tmp_path / "d.png"
    args = ["render", "--scene", str(LANE80), "--settings", str(settings), "--device", "cpu", "-o", str(out)]
    assert cli.main(args + (["--denoise"] if how == "flag" else [])) == 0
    np.testing.assert_array_equal(load_png(out), to_uint8(nl_means_denoise(torch.clamp(_port_frame(), 0.0, 1.0))))


def test_cli_render_profile(tmp_path):
    """``--profile DIR`` writes a torch.profiler Chrome trace of the timed render."""
    settings = _settings(tmp_path)
    logdir = tmp_path / "prof"
    args = ["render", "--scene", str(LANE80), "--settings", str(settings), "--device", "cpu",
            "-o", str(tmp_path / "p.png"), "--profile", str(logdir)]
    assert cli.main(args) == 0
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_optimize_scene_settings(tmp_path):
    """``optimize --scene --settings``: the file's frame and options (here the
    pure-torch route, use_pallas false), two Adam steps with a finite loss."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps([
        {"type": "Sphere", "centerXYZ": [0.0, 0.0, 3.0], "radius": 1.0, "colorRGB": [0.8, 0.3, 0.2]},
        {"type": "Light", "centerXYZ": [-2.0, 2.0, 0.0]},
    ]))
    settings = tmp_path / "s.json"
    settings.write_text(json.dumps({"image_width": 8, "image_height": 4, "max_specular_depth": 2,
                                    "visibility": "smooth"}))
    save_png(np.full((4, 8, 3), 0.5), tmp_path / "target.png")
    metrics = tmp_path / "m.jsonl"
    assert cli.main(["optimize", "--scene", str(scene), "--settings", str(settings), "--device", "cpu",
                     "--target", str(tmp_path / "target.png"), "--steps", "2", "--metrics", str(metrics)]) == 0
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    assert len(losses) == 2 and all(np.isfinite(losses))
