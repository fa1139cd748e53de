"""The culled smooth route of the port (BASELINE config 4's training step).

``inverse_task_scene`` bit for bit; the port's ``trace_culled_smooth`` on
CPU tensors (the plain versions of ``near_cs``/``fwd_cs``/``bwd_cs``)
against JAX's culled smooth route in interpret mode, forward and the
clipped-L2 gradient; the culling's exactness against the port's unculled
smooth route; the glossy route against the pure-torch route with the same
xi; the differentiable re-sort; and the routing of ``render()`` and
``make_loss_fn``.  Sizes are those of the JAX package's own culled smooth
tests: ``inverse_task_scene(128)`` at 96x54.  The JAX oracle compiles once,
with XLA's fusion (FMA contraction) and algebraic simplifier off.  The CUDA
kernels are held against the plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses
import functools
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
from python_ray_tracer_tpu.models.scenes import inverse_task_scene as jax_inverse_scene  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_culled_smooth as jcs  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions, ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import inverse_task_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled_smooth as tcs  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, l2_image_loss, make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8  # noqa: E402

ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion,algsimp", "xla_backend_optimization_level": 0}
W, H, S = 96, 54, 128
SHARP, DEPTH = 200.0, 2  # production sharpness: real culling
SEED = 7


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_inverse_task_scene_matches_jax(dtype):
    """Same draws in the same order: every table equal, no exact tier."""
    js = jax_inverse_scene(S, 16, 8, dtype=getattr(jnp, dtype))
    ts = inverse_task_scene(S, 16, 8, dtype=getattr(torch, dtype))
    got, want = scene_to_numpy(ts), _jax_leaves(js)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ts.spheres.n_exact == js.spheres.n_exact == 0


def _target() -> np.ndarray:
    """A seeded target image (N, 3), fed to both sides."""
    return np.random.default_rng(0).uniform(0.0, 1.0, (W * H, 3))


@pytest.fixture(scope="module")
def jax_culled():
    """JAX's culled smooth route in interpret mode, one compile: the f64
    loss, every ``scene_to_params`` gradient and frame, and the f32 frame."""
    js64 = jax_inverse_scene(S, W, H, dtype=jnp.float64)
    js32 = jax_inverse_scene(S, W, H, dtype=jnp.float32)
    tgt = jnp.asarray(_target())

    def cfg(dtype):
        return J.RenderConfig(max_depth=DEPTH, dtype=dtype, visibility="smooth", edge_sharpness=SHARP,
                              shadow_sharpness=SHARP, use_pallas=True, pallas_interpret=True, block_rays=512)

    def trace(sc, dtype):
        return jcs.trace_culled_smooth(sc.camera.position, jax_rays_t(sc.camera, dtype), sc, cfg(dtype), transposed=True)

    def oracle(params, s32):
        def loss(p):
            img = trace(jax_combine(p, js64), jnp.float64)
            return jnp.mean((jnp.clip(img, 0.0, 1.0) - tgt) ** 2), img

        (value, img64), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return value, grads, img64, trace(s32, jnp.float32)

    params = jax_scene_to_params(js64)
    fn = jax.jit(oracle).lower(params, js32).compile(compiler_options=ORACLE_XLA_OPTIONS)
    value, grads, img64, img32 = fn(params, js32)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(img64), np.asarray(img32)


def _cfg(dtype=torch.float64, sharp=SHARP, depth=DEPTH, **kw):
    return T.RenderConfig(max_depth=depth, dtype=dtype, visibility="smooth", edge_sharpness=sharp,
                          shadow_sharpness=sharp, use_pallas=True, **kw)


def _culled(scene, cfg, key=None):
    return tcs.trace_culled_smooth(scene.camera.position, ray_directions_t(scene.camera, cfg.dtype), scene, cfg, key=key)


def _loss_and_grads(trace_fn, scene, cfg, target):
    """The clipped-L2 loss of ``trace_fn``'s frame and every leaf's gradient."""
    params = scene_to_params(scene)
    img = trace_fn(combine(params, scene), cfg)
    loss = l2_image_loss(img, target)
    loss.backward()
    grads = {k: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))) for k, p in params.items()}
    return float(loss.detach()), grads, img.detach().numpy()


def _assert_grads_close(got, want, rtol, what):
    assert got.keys() == want.keys()
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=rtol * scale, err_msg=f"{what}: {key}")


# The f64 gradient limit, relative to each leaf's largest value.  JAX's
# interpret-mode smooth kernels are not f64-exact in their table-gradient
# sums: on this case JAX's own culled and unculled blocked routes part by up
# to 4.4e-8 (spheres.radius; 1.8e-8 on the centers), where the port's culled
# and unculled plain versions agree to 2e-16.  The port sits as close to
# either JAX route as they sit to each other (3.5e-8, 2.3e-8).
JAX_F64_GRAD_RTOL = 1e-7


def test_culled_route_matches_jax_f64(jax_culled):
    """Forward within 1e-12, the loss within 1e-12 of itself and every
    gradient leaf within JAX_F64_GRAD_RTOL of the leaf's largest value."""
    want_loss, want_grads, want_img, _ = jax_culled
    scene = inverse_task_scene(S, W, H, dtype=torch.float64)
    before = dict(tcs.LAUNCHES)
    loss, grads, img = _loss_and_grads(_culled, scene, _cfg(), torch.tensor(_target()))
    assert tcs.LAUNCHES == before  # CPU tensors: plain versions, no launch
    np.testing.assert_allclose(img, want_img, rtol=0, atol=1e-12)
    assert abs(loss - want_loss) <= 1e-12 * abs(want_loss)
    _assert_grads_close(grads, want_grads, JAX_F64_GRAD_RTOL, "culled f64 vs JAX")
    assert np.abs(grads["spheres.center"]).max() > 0


def test_culled_route_matches_jax_f32(jax_culled):
    scene = inverse_task_scene(S, W, H, dtype=torch.float32)
    with torch.no_grad():
        img = _culled(scene, _cfg(torch.float32)).numpy()
    np.testing.assert_allclose(img, jax_culled[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("sharp,depth", [(200.0, 2), (20.0, 3)])
def test_culling_is_exact_in_f32(sharp, depth):
    """The culled route equals the port's unculled smooth route: the frame
    bit for bit (a culled sphere's factor is exactly 1 in f32), the
    gradients to the order of their sums."""
    scene = inverse_task_scene(S, W, H, dtype=torch.float32)
    cfg = _cfg(torch.float32, sharp, depth)

    def unculled(sc, c):
        return bss.trace_fused_smooth_sub(sc.camera.position, ray_directions_t(sc.camera, torch.float32), sc, c)

    target = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(1))
    _, g_c, img_c = _loss_and_grads(_culled, scene, cfg, target)
    _, g_u, img_u = _loss_and_grads(unculled, scene, cfg, target)
    np.testing.assert_array_equal(img_c, img_u)
    _assert_grads_close(g_c, g_u, 1e-5, "culled vs unculled f32")


def test_fallback_parity_behind_sphere_scene():
    """A sphere behind the camera with the largest disc (line pierced,
    coverage exactly 0) and two front near-misses inside the disc margin:
    the unculled sweep's miss-lane fallback picks the behind sphere, so the
    nearest list must keep it (both nappes).  Culled equals unculled."""
    rows = [
        dict(center=(0.0, 0.25, 9.0), radius=1.0),
        dict(center=(0.56, 0.25, -2.0), radius=0.5),
        dict(center=(-0.56, 0.25, -2.0), radius=0.5),
        dict(center=(0.0, 0.25, -6.0), radius=0.8),
    ]
    spheres = T.build_spheres([T.make_sphere_row(diffuse_gain=1.0, specular_gain=0.4, **r) for r in rows])
    lights = T.build_lights((4.0, 6.0, 6.0), [(0.4, (0.6, 0.7, 0.9))])
    scene = T.make_scene(spheres, lights, (0.0, 0.25, 5.0), 64, 36)
    cfg = _cfg(torch.float32)
    dirs = ray_directions_t(scene.camera, torch.float32)
    with torch.no_grad():
        a = bss.trace_fused_smooth_sub(scene.camera.position, dirs, scene, cfg)
        b = tcs.trace_culled_smooth(scene.camera.position, dirs, scene, cfg)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)
    assert float(a.abs().max()) > 0


def test_glossy_route_matches_pure_torch():
    """Seed 7 through the culled route (xi drawn in flat order, then moved
    with the group sorts) against torch autograd of the pure-torch route,
    which draws the same xi per ray: f64, soft sharpness, depth 3."""
    scene = inverse_task_scene(S, W, H, dtype=torch.float64)
    cfg = _cfg(sharp=20.0, depth=3, stochastic_roughness=True, rng_seed=SEED)
    key = tcs.fold_seed(tcs.fold_seed(SEED, 0), 4)
    target = torch.tensor(_target())

    def pure(sc, c):
        return T.trace(sc.camera.position, ray_directions(sc.camera, torch.float64), sc,
                       dataclasses.replace(c, use_pallas=False), key=key)

    _, g_c, img_c = _loss_and_grads(lambda sc, c: _culled(sc, c, key), scene, cfg, target)
    _, g_p, img_p = _loss_and_grads(pure, scene, cfg, target)
    np.testing.assert_allclose(img_c, img_p, rtol=0, atol=1e-8)
    _assert_grads_close(g_c, g_p, 1e-7, "culled glossy vs pure torch")
    mirror = _culled(scene, _cfg(sharp=20.0, depth=3)).detach().numpy()
    assert np.abs(mirror - img_c).max() > 1e-3  # the glossy frame is not the mirror one


def test_permute_groups_backward_is_the_inverse_gather():
    x = torch.randn((3, 4 * tcs._SORT_G), dtype=torch.float64, requires_grad=True)
    perm = torch.tensor([2, 0, 3, 1])
    inv = torch.argsort(perm)
    y = tcs._PermuteGroups.apply(x, perm, inv)
    np.testing.assert_array_equal(y.detach().reshape(3, 4, -1).numpy(), x.detach().reshape(3, 4, -1)[:, perm].numpy())
    g = torch.randn_like(y)
    y.backward(g)
    np.testing.assert_array_equal(x.grad.reshape(3, 4, -1)[:, perm].numpy(), g.reshape(3, 4, -1).numpy())
    assert torch.autograd.gradcheck(lambda v: tcs._PermuteGroups.apply(v, perm, inv), (x.detach().requires_grad_(),))


@pytest.mark.parametrize("entry", ["render", "loss"])
def test_render_and_loss_take_the_culled_route(monkeypatch, entry):
    """With the ray floor lowered to this frame (as the JAX test does),
    render() and the L2 loss route through trace_culled_smooth, and the
    single-launch train kernel yields to it."""
    from python_ray_tracer_tpu_torch.render import fused_train_l2_ok

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")  # the package exports a render function

    monkeypatch.setattr(tcs, "MIN_CULL_SMOOTH_RAYS", W * H)
    calls = []
    real = render_mod.trace_culled_smooth

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(render_mod, "trace_culled_smooth", spy)
    scene = inverse_task_scene(S, W, H, dtype=torch.float32)
    cfg = _cfg(torch.float32, depth=3)
    assert tcs.cull_smooth_ok(scene, cfg, W * H) and not fused_train_l2_ok(scene, cfg)
    target = torch.tensor(_target().reshape(H, W, 3), dtype=torch.float32)
    if entry == "render":
        with torch.no_grad():
            img = T.render(scene, cfg).reshape(-1, 3)
        np.testing.assert_array_equal(img.numpy(), _culled(scene, cfg).detach().numpy())
    else:
        loss = make_loss_fn(scene, target, cfg)(scene_to_params(scene))
        assert torch.isfinite(loss)
    assert len(calls) == 1


def test_cli_renders_inverse64_smooth(tmp_path):
    """``--builtin inverse64`` on the CPU, smooth visibility: the pure-torch
    render of inverse_task_scene(64)."""
    out = tmp_path / "inv.png"
    assert cli.main(["render", "--builtin", "inverse64", "--width", "24", "--height", "16", "--depth", "2",
                     "--visibility", "smooth", "--device", "cpu", "-o", str(out)]) == 0
    want = T.render(inverse_task_scene(64, 24, 16), T.RenderConfig(max_depth=2, visibility="smooth"))
    np.testing.assert_array_equal(load_png(out), to_uint8(want))


@functools.cache
def _kernel_args():
    """One culled bounce's inputs on a 4,096-ray tile of the f64 scene."""
    scene = inverse_task_scene(S, 64, 64, dtype=torch.float64)
    cfg = _cfg()
    o = scene.camera.position.reshape(3, 1).expand(3, 4096).contiguous()
    d = ray_directions_t(scene.camera, torch.float64).contiguous()
    ones = torch.ones(4096, dtype=torch.float64)
    center, radius = scene.spheres.center, scene.spheres.radius
    lists = tcs.candidate_lists(o, d, center, radius, 4096)
    geom = tcs.geometry_table(scene, torch.float64)
    return o, d, ones, lists, geom, dict(faraway=cfg.faraway, s_cheap=S, sharp_e=SHARP, tile_rays=4096)


@pytest.mark.parametrize("fault,match", [
    ("shape", "expected shape"), ("dtype", "expected torch.int32"), ("tiles", "whole tiles"),
    ("lists", "candidate lists"), ("requires_grad", "compute their own gradients"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault, match):
    o, d, ones, (cand, cnt, full), geom, kw = _kernel_args()
    args = dict(o=o, d=d, thr=ones, alive=ones, cand=cand, cnt_cand=cnt, cnt_full=full, geom=geom)
    if fault == "shape":
        args["thr"] = ones[:-1]
    elif fault == "dtype":
        args["cand"] = cand.long()
    elif fault == "tiles":
        kw = {**kw, "tile_rays": 1000}
    elif fault == "lists":
        args["cnt_cand"] = torch.cat([cnt, cnt])
    else:
        args["geom"] = geom.clone().requires_grad_()
    with pytest.raises(ValueError, match=match):
        tcs.near_cs(*args.values(), **kw)


def test_config4_scene_f64_gradients_match_torch_autograd():
    """BASELINE config 4's 1024 spheres (cut to 32x32 rays, depth 2) in f64:
    the culled route's gradients against torch autograd of the pure-torch
    route, the exact product rule.  The leaves that reach Phase C (centers,
    radii, light, camera) part by what its max(1 - occlusion, 1e-6) divisor
    moves on lanes deep in another sphere's shadow, the rest to roundoff;
    the frame by the exact tier's compensated form on the r = 99999 ground
    (the kernels' plain versions), where the f64 pure route takes the
    reference form."""
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    scene = random_spheres_scene(1024, 32, 32, dtype=torch.float64)
    cfg = _cfg(depth=2)
    target = torch.tensor(np.random.default_rng(2).uniform(0.0, 1.0, (32 * 32, 3)))

    def pure(sc, c):
        return T.trace(sc.camera.position, ray_directions(sc.camera, torch.float64), sc,
                       dataclasses.replace(c, use_pallas=False))

    loss_c, g_c, img_c = _loss_and_grads(_culled, scene, cfg, target)
    loss_p, g_p, img_p = _loss_and_grads(pure, scene, cfg, target)
    np.testing.assert_allclose(img_c, img_p, rtol=0, atol=1e-8)
    assert abs(loss_c - loss_p) <= 1e-9 * loss_p
    clamped = ("spheres.center", "spheres.radius", "lights.point_position", "camera.position")
    for key in g_p:
        scale = max(float(np.abs(g_p[key]).max()), 1e-12)
        err = float(np.abs(g_c[key] - g_p[key]).max()) / scale
        assert err <= (1e-5 if key in clamped else 1e-9), key
