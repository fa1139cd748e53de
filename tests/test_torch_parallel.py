"""Sharded rendering and training of the PyTorch port against JAX.

The port's ``parallel`` package runs on ``torch.distributed`` ranks; here
they are gloo ranks on the CPU, spawned from this process
(``parallel.distributed.run_local``) once for each mesh, (2, 1), (1, 2)
and (2, 2), each rank running every case (``tests/torch_parallel_worker.py``).
Each sharded frame and gradient is held against JAX's single-device
``render`` and ``jax.grad`` of the single-device loss, at tolerances no
looser than those of JAX's own sharded tests (``tests/test_parallel.py``,
``tests/test_sharded_pallas.py``), and against the port's unsharded render
at tighter ones; every rank must hold the same frame and gradients.  The
kernel cases run the kernels' plain versions (CPU tensors), through the
sharded path's per-shard sweeps.  The frame is 25x13: 325 rays, padded to
326 on two ray shards.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.optim import make_loss_fn as jax_make_loss_fn  # noqa: E402
from python_ray_tracer_tpu.optim import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu.scene import build_lights, build_spheres, make_scene, make_sphere_row  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_from_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.parallel import make_mesh, pad_spheres, render_sharded  # noqa: E402
from python_ray_tracer_tpu_torch.parallel.distributed import run_local  # noqa: E402

from . import torch_parallel_worker  # noqa: E402

W, H = 25, 13
MESHES = ((2, 1), (1, 2), (2, 2))
# The oracles compile without loop fusion (which would contract a*b+c into
# FMAs) and without LLVM optimisation, which halves their compile time.
ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0}
# name: (scene, dtype, RenderConfig options).  The scene: 23 spheres, the
# last (r = 99999 ground) in the exact tier, padded to 24 on two sphere
# shards (the padding row joins the exact tier), or the tie scene.
CASES = {
    "hard_pure": ("random", "float32", dict(max_depth=3)),
    "hard_kernels": ("random", "float32", dict(max_depth=3, use_pallas=True)),
    "smooth_pure": ("random", "float64", dict(max_depth=2, visibility="smooth")),
    "smooth_kernels": ("random", "float64", dict(max_depth=2, visibility="smooth", use_pallas=True)),
    "spp4_stochastic": ("random", "float32", dict(max_depth=2, samples_per_pixel=4, stochastic_roughness=True,
                                                   rng_seed=5)),
    "tie_sum": ("tied", "float64", dict(max_depth=2, tie_mode="sum")),
}
GRAD_CASES = ("smooth_pure", "smooth_kernels")
# Frame tolerances against JAX's single-device render, absolute on colours
# up to ~1: f32 as JAX's own sharded test holds its XLA path (1e-5; the
# kernel cases read 1.5e-8, spp 4 6e-8), f64 1e-10 for the pure route
# (1e-16 read) and 1e-9 for the kernels, whose compensated exact tier
# meets the f64 XLA path's reference form of the ground's quadratic
# (1.8e-10 read).
JAX_ATOL = {"hard_pure": 1e-5, "hard_kernels": 1e-5, "smooth_pure": 1e-10, "smooth_kernels": 1e-9,
            "spp4_stochastic": 1e-5, "tie_sum": 1e-10}
# Against the port's own unsharded render on one process: the same
# operations in the same order, the kernel routes' sums aside (read: 0,
# but 1.5e-8 for the hard kernels and 1.1e-16 for the smooth ones).
PORT_ATOL = {"float32": 1e-6, "float64": 1e-12}
# Gradients, relative to each leaf's largest |value|, and the loss: the
# pure route reads 4.3e-13 (loss 6.6e-16), the kernels 1.3e-10 (loss
# 3.9e-11: the exact tier again).
GRAD_RTOL = {"smooth_pure": 1e-11, "smooth_kernels": 1e-8}
LOSS_RTOL = {"smooth_pure": 1e-13, "smooth_kernels": 1e-10}


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


@functools.cache
def _jax_scene(name: str, dtype: str):
    jdt = getattr(jnp, dtype)
    if name == "random":
        return jscenes.random_spheres_scene(n_spheres=23, width=W, height=H, dtype=jdt)
    # Sphere 0 repeated bitwise as sphere 2 (another colour): the two tie on
    # every lane that hits them, and two sphere shards hold one each.
    rows = [
        make_sphere_row((-0.4, 0.1, 1.0), 0.5, diffuse_gain=0.9, diffuse_color=(0.2, 0.4, 0.9), specular_gain=0.6),
        make_sphere_row((0.6, 0.2, 1.6), 0.45, diffuse_gain=0.8, specular_gain=0.9, iridescence_gain=0.5),
    ]
    rows.append(dict(rows[0], diffuse_color=np.asarray((0.9, 0.3, 0.1)), specular_gain=0.8))
    rows.append(make_sphere_row((0.0, -99999.5, 0.0), 99999.0, diffuse_gain=1.0, texture_kind=1, specular_gain=0.3))
    return make_scene(build_spheres(rows, dtype=jdt), build_lights((-2.0, 1.0, 2.0), dtype=jdt), (0.0, 0.2, -2.0),
                      W, H, dtype=jdt)


def _spec(name: str, dtype: str) -> dict:
    js = _jax_scene(name, dtype)
    return dict(arrays=_jax_leaves(js), width=W, height=H, n_exact=js.spheres.n_exact)


def _port_scene(name: str, dtype: str):
    spec = _spec(name, dtype)
    return scene_from_numpy(spec["arrays"], width=W, height=H, n_exact=spec["n_exact"], device="cpu",
                            dtype=getattr(torch, dtype))


def _unfused(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)(*args)


def _jax_cfg(case: str):
    _, dtype, kw = CASES[case]
    kw = {k: v for k, v in kw.items() if k != "use_pallas"}
    return J.RenderConfig(dtype=getattr(jnp, dtype), **kw)


@pytest.fixture(scope="module")
def target():
    """The smooth f64 frame's clipped values x 0.9, fed to both sides."""
    js = _jax_scene("random", "float64")
    img = np.asarray(_unfused(lambda s: J.render(s, _jax_cfg("smooth_pure")), js))
    return np.clip(img, 0.0, 1.0) * 0.9


@pytest.fixture(scope="module")
def jax_frames():
    return {case: np.asarray(_unfused(lambda s, c=case: J.render(s, _jax_cfg(c)), _jax_scene(CASES[case][0],
                                                                                             CASES[case][1])))
            for case in CASES}


@pytest.fixture(scope="module")
def jax_grads(target):
    js = _jax_scene("random", "float64")
    loss = jax_make_loss_fn(js, jnp.asarray(target), _jax_cfg("smooth_pure"))
    value, grads = _unfused(jax.value_and_grad(loss), jax_scene_to_params(js))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def rank_runs(target):
    """The three meshes' rank processes, started at once; the JAX oracles
    compile in this process while they run."""
    jobs = [dict(name=case, scene=_spec(s, dt), cfg=kw, dtype=dt) for case, (s, dt, kw) in CASES.items()]
    jobs += [dict(name=f"grad_{case}", scene=_spec("random", "float64"), cfg=CASES[case][2], dtype="float64",
                  target=target) for case in GRAD_CASES]
    with ThreadPoolExecutor(len(MESHES)) as pool:
        yield {shape: pool.submit(run_local, torch_parallel_worker.run, shape[0] * shape[1], shape, jobs,
                                  device_type="cpu") for shape in MESHES}


@pytest.fixture(scope="module")
def sharded(rank_runs, jax_frames, jax_grads):
    """Every rank's results, for each mesh (the oracles built meanwhile)."""
    return {shape: run.result() for shape, run in rank_runs.items()}


def test_mesh_layout_and_one_rank_mesh(sharded):
    """Rank r sits at (r // S, r % S), JAX's reshape(R, S); without a process
    group the mesh is one rank and the sharded render is the plain one."""
    for shape, ranks in sharded.items():
        assert [r["coords"] for r in ranks] == [divmod(k, shape[1]) for k in range(len(ranks))]
    mesh = make_mesh()
    assert mesh.shape == {"rays": 1, "spheres": 1} and mesh.size == 1
    scene = _port_scene("random", "float32")
    cfg = T.RenderConfig(max_depth=2)
    np.testing.assert_array_equal(render_sharded(scene, cfg, mesh).numpy(), T.render(scene, cfg).numpy())
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2, 1)


def test_pad_spheres_never_hit():
    """Padding rows are zero-radius spheres far below the scene, in the exact
    tier: the padded scene renders the unpadded frame, hard and smooth."""
    scene = _port_scene("random", "float64")
    padded = pad_spheres(scene.spheres, 7)
    assert padded.count == 28 and padded.n_exact == scene.spheres.n_exact + 5
    assert pad_spheres(scene.spheres, 23) is scene.spheres
    np.testing.assert_array_equal(padded.radius[23:].numpy(), 0.0)
    padded_scene = type(scene)(padded, scene.lights, scene.camera, scene.texture_atlas, scene.texture_hw)
    for vis in ("hard", "smooth"):
        cfg = T.RenderConfig(dtype=torch.float64, max_depth=2, visibility=vis)
        np.testing.assert_allclose(T.render(padded_scene, cfg).numpy(), T.render(scene, cfg).numpy(), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_sharded_frame_matches_jax_and_port(sharded, jax_frames, case, shape):
    """The frame on every rank: equal across ranks, within tolerance of JAX's
    single-device render and of the port's unsharded one."""
    scene_name, dtype, kw = CASES[case]
    frames = [r[case] for r in sharded[shape]]
    for f in frames[1:]:
        np.testing.assert_array_equal(f, frames[0])
    got, want = frames[0], jax_frames[case]
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL[case])
    port = T.render(_port_scene(scene_name, dtype), T.RenderConfig(dtype=getattr(torch, dtype), **kw)).numpy()
    np.testing.assert_allclose(got, port, rtol=0, atol=PORT_ATOL[dtype])
    if case == "tie_sum":
        first = T.render(_port_scene(scene_name, dtype), T.RenderConfig(dtype=torch.float64, max_depth=2)).numpy()
        assert np.abs(got - first).max() > 1e-3, "the tie scene should tie"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", GRAD_CASES)
def test_sharded_gradients_match_jax_grad(sharded, jax_grads, case, shape):
    """``make_loss_fn(..., mesh)``: every rank's loss and gradients equal
    ``jax.grad`` of the single-device loss (f64), and each other."""
    value, want = jax_grads
    ranks = [r[f"grad_{case}"] for r in sharded[shape]]
    for r in ranks[1:]:
        for k in want:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    assert abs(got["loss"] - value) <= LOSS_RTOL[case] * abs(value)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_RTOL[case] * scale, f"{k}: {err:.3e} of {scale:.3e}"
    assert max(float(np.abs(w).max()) for w in want.values()) > 0


def test_sharded_launches_nothing_on_the_cpu(sharded):
    for ranks in sharded.values():
        assert all(not any(r["launches"].values()) for r in ranks)


def test_loss_with_mesh_on_one_rank(target):
    """``make_loss_fn`` takes a mesh: on a one-rank mesh it is the plain loss."""
    scene = _port_scene("random", "float64")
    cfg = T.RenderConfig(dtype=torch.float64, max_depth=2, visibility="smooth")
    tgt = torch.tensor(target)
    a = make_loss_fn(scene, tgt, cfg, make_mesh())(scene_to_params(scene))
    b = make_loss_fn(scene, tgt, cfg)(scene_to_params(scene))
    assert float(a.detach()) == float(b.detach())
