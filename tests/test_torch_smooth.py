"""Smooth visibility and the training step of the PyTorch port against JAX.

The JAX oracle is the XLA smooth path (``use_pallas=False``): the JAX
package's own tests hold its Pallas smooth kernels against it
(``tests/test_fused_smooth.py``).  One jitted ``value_and_grad`` per case
gives the loss, every ``scene_to_params`` gradient and the rendered frame,
built once per module.  On the port's side the same loss goes three ways:
torch autograd through the pure-torch route, the ``train_deep`` plain
version (the single-launch L2 route of ``make_loss_fn``), and the
``smooth_fwd_deep``/``smooth_bwd_deep`` plain pair behind ``render()``.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.  Frames are 32x16 in float64.
"""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.ops import vecmath as jvec  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_bounce_smooth_sub import _clip_gate as jax_clip_gate  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu.optim.train import l2_image_loss as jax_l2_image_loss  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops.vecmath import clip, normalize, relu0, sqrt  # noqa: E402
from python_ray_tracer_tpu_torch.optim import (  # noqa: E402
    adam,
    combine,
    fit,
    init_state,
    l2_image_loss,
    make_loss_fn,
    make_train_step,
    scene_to_params,
)
from python_ray_tracer_tpu_torch.parallel import make_mesh  # noqa: E402
from python_ray_tracer_tpu_torch.render import fused_train_l2_ok  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import save_png  # noqa: E402

W, H = 32, 16
CASES = {"reference_d3": ("reference", 3), "all_effects_d2": ("all_effects", 2)}
ROUTES = ("torch_autograd", "train_deep_plain", "smooth_bwd_deep_plain")
# The oracle is compiled without loop fusion (which would contract a*b+c
# into FMAs) and without LLVM optimisation, which halves its compile time.
ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0}
# Gradient tolerance per route, relative to the largest |gradient| of each
# leaf.  Torch autograd runs the XLA path's operations in the same order;
# only the backward's sums associate differently (measured 3e-12 with
# XLA's fusion on, around the r = 99999 ground sphere's 1e10-scale
# quadratic).  The kernels' plain versions take the compensated exact
# tier for that sphere where the f64 XLA path takes the reference form:
# measured 4e-9.
GRAD_RTOL = {"torch_autograd": 1e-9, "train_deep_plain": 1e-7, "smooth_bwd_deep_plain": 1e-7}
# Frame tolerance (absolute, on colors up to ~2): the same two effects,
# measured 1.2e-11 (pure torch) and 7.6e-10 (kernel plain versions).
IMAGE_ATOL = {"pure": 1e-10, "kernels": 1e-8}
SMOOTH_KERNELS = ("smooth_fwd_deep", "smooth_bwd_deep", "train_deep", "smooth_fwd_step", "smooth_bwd_step")


def _port_scene(name):
    return getattr(tscenes, f"{name}_scene")(W, H, dtype=torch.float64)


@functools.cache
def _target(case) -> np.ndarray:
    """The clipped hard render, made once and fed to both sides."""
    name, depth = CASES[case]
    img = T.render(_port_scene(name), T.RenderConfig(max_depth=depth, dtype=torch.float64))
    return torch.clamp(img, 0.0, 1.0).numpy()


def _cfg(depth, **kw):
    return T.RenderConfig(max_depth=depth, dtype=torch.float64, visibility="smooth", **kw)


@functools.cache
def _jax_value_and_grad(case):
    """(JAX scene, jitted value_and_grad) of the JAX XLA smooth path.

    The function is ``make_loss_fn``'s body for ``mesh=None`` off the fused
    route, ``l2_image_loss(render(combine(params)), target)``, with the
    frame as an auxiliary output; compiled once per case and reused.
    """
    name, depth = CASES[case]
    js = getattr(jscenes, f"{name}_scene")(W, H, dtype=jnp.float64)
    cfg = J.RenderConfig(max_depth=depth, dtype=jnp.float64, visibility="smooth")
    target = jnp.asarray(_target(case))

    def loss_and_image(params):
        image = J.render(jax_combine(params, js), cfg)
        return jax_l2_image_loss(image, target), image

    fn = jax.jit(jax.value_and_grad(loss_and_image, has_aux=True))
    return js, fn.lower(jax_scene_to_params(js)).compile(compiler_options=ORACLE_XLA_OPTIONS)


@functools.cache
def _jax_oracle(case):
    """(loss, {leaf: grad}, frame) at the scene's own parameters."""
    js, value_and_grad = _jax_value_and_grad(case)
    (loss, image), grads = value_and_grad(jax_scene_to_params(js))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(image)


def _port_loss_and_grads(case, route):
    name, depth = CASES[case]
    scene = _port_scene(name)
    target = torch.tensor(_target(case))
    params = scene_to_params(scene)
    if route == "torch_autograd":
        loss = make_loss_fn(scene, target, _cfg(depth))(params)
    elif route == "train_deep_plain":
        cfg = _cfg(depth, use_pallas=True)
        assert fused_train_l2_ok(scene, cfg)
        loss = make_loss_fn(scene, target, cfg)(params)
    else:  # any other loss takes render() -> the fwd/bwd pair; L2 here, written out
        loss = l2_image_loss(T.render(combine(params, scene), _cfg(depth, use_pallas=True)), target)
    loss.backward()
    grads = {k: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))) for k, p in params.items()}
    return float(loss.detach()), grads


@functools.cache
def _torch_autograd(case):
    return _port_loss_and_grads(case, "torch_autograd")


def _assert_grads_close(got, want, rtol, what):
    assert got.keys() == want.keys()
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=rtol * scale, err_msg=f"{what}: {key}")


# --- the two repairs ------------------------------------------------------


def test_sqrt_and_normalize_gradients_are_analytic():
    x = torch.tensor([3.0, 4.0, 0.0], dtype=torch.float64, requires_grad=True)
    normalize(x)[0].backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.128, -0.096, 0.0], rtol=1e-15, atol=1e-17)
    want = jax.grad(lambda v: jvec.normalize(v)[0])(jnp.asarray([3.0, 4.0, 0.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-15, atol=1e-17)
    y = torch.tensor([4.0, 2.0, 1e-6], dtype=torch.float64, requires_grad=True)
    root = sqrt(y)
    np.testing.assert_array_equal(root.detach().numpy(), np.sqrt(y.detach().numpy()))
    root.sum().backward()
    np.testing.assert_array_equal(y.grad.numpy(), np.asarray(jax.grad(lambda v: jnp.sum(jnp.sqrt(v)))(jnp.asarray(y.detach().numpy()))))


def test_clip_and_max_ties_match_jax_grad():
    """At an exact bound jax.grad splits 0.5/0.5; torch.clamp would pass 1."""
    xs = np.array([-0.5, 0.0, 0.25, 1.0, 1.5])
    cases = (
        (lambda v: clip(v, 0.0, 1.0), lambda v: jnp.clip(v, 0.0, 1.0)),
        (relu0, lambda v: jnp.maximum(v, 0.0)),
    )
    for port_fn, jax_fn in cases:
        x = torch.tensor(xs, requires_grad=True)
        port_fn(x).sum().backward()
        want = np.asarray(jax.grad(lambda v: jnp.sum(jax_fn(v)))(jnp.asarray(xs)))
        np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(x.grad.numpy()[1], 0.5)
    np.testing.assert_array_equal(bss.clip_gate(torch.tensor(xs), 0.0, 1.0).numpy(), np.asarray(jax_clip_gate(jnp.asarray(xs), 0.0, 1.0)))
    img = torch.tensor(xs.reshape(1, 5, 1).repeat(3, axis=2), requires_grad=True)
    tgt = np.full((1, 5, 3), 0.3)
    l2_image_loss(img, torch.tensor(tgt)).backward()
    want = jax.grad(jax_l2_image_loss)(jnp.asarray(img.detach().numpy()), jnp.asarray(tgt))
    np.testing.assert_allclose(img.grad.numpy(), np.asarray(want), rtol=1e-15, atol=0)


def test_abs_tie_matches_jax_grad():
    """jax.grad of jnp.abs is 1 at exactly 0, torch's abs gives 0: the
    iridescence term's |view_angle - 0.5| at a view angle of exactly 0.5."""
    from python_ray_tracer_tpu.ops import shading as jshade
    from python_ray_tracer_tpu_torch.ops import shading as tshade
    from python_ray_tracer_tpu_torch.ops.vecmath import abs as vabs

    xs = np.array([-0.5, 0.0, 0.25])
    x = torch.tensor(xs, requires_grad=True)
    vabs(x).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.abs(v)))(jnp.asarray(xs)))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(want, [-1.0, 1.0, 1.0])

    # normal . to_camera == 0.5 exactly, on the iridescent sphere of all_effects.
    normal = np.array([[1.0, 0.0, 0.0]])
    to_cam = np.array([[0.5, 0.75, 0.0]])
    jmat = jshade.gather_material(jscenes.all_effects_scene(W, H, dtype=jnp.float64).spheres, jnp.array([2]))
    want = jax.grad(lambda c: jnp.sum(jshade.iridescence(jnp.asarray(normal), c, jmat)))(jnp.asarray(to_cam))
    tmat = tshade.gather_material(tscenes.all_effects_scene(W, H, dtype=torch.float64).spheres, torch.tensor([2]))
    cam = torch.tensor(to_cam, requires_grad=True)
    tshade.iridescence(torch.tensor(normal), cam, tmat).sum().backward()
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(cam.grad.numpy(), np.asarray(want), rtol=1e-15, atol=0)


# --- render, loss and gradients against the JAX XLA smooth path ----------------


@pytest.mark.parametrize("route", ["pure", "kernels"])
@pytest.mark.parametrize("case", CASES)
def test_smooth_render_matches_xla(case, route):
    """Pure-torch route and the smooth_fwd_deep plain version vs the JAX
    frame, and the kernel route vs the pure-torch route."""
    name, depth = CASES[case]
    with torch.no_grad():
        got = T.render(_port_scene(name), _cfg(depth, use_pallas=route == "kernels")).numpy()
        pure = T.render(_port_scene(name), _cfg(depth)).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, _jax_oracle(case)[2], rtol=0, atol=IMAGE_ATOL[route])
    np.testing.assert_allclose(got, pure, rtol=0, atol=IMAGE_ATOL[route])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES)
def test_loss_gradients_match_jax_grad(case, route):
    """Every scene_to_params leaf, each port route against jax.grad, and the
    kernels' plain versions also against torch autograd of the pure route."""
    want_loss, want, _ = _jax_oracle(case)
    loss, grads = _torch_autograd(case) if route == "torch_autograd" else _port_loss_and_grads(case, route)
    assert loss == pytest.approx(want_loss, rel=1e-9)
    _assert_grads_close(grads, want, GRAD_RTOL[route], f"{route} vs jax.grad")
    if route != "torch_autograd":
        _assert_grads_close(grads, _torch_autograd(case)[1], GRAD_RTOL[route], f"{route} vs torch autograd")
    assert any(np.abs(g).max() > 0 for g in grads.values())


# --- Adam, parameters, CLI --------------------------------------------------------


def test_adam_steps_match_optax():
    """3 steps of the port's trainer (torch autograd + torch.optim.Adam)
    against 3 steps of jax.grad + optax.adam from the same parameters."""
    import optax

    case, (name, depth) = "reference_d3", CASES["reference_d3"]
    js, value_and_grad = _jax_value_and_grad(case)
    opt = optax.adam(1e-2)
    p = jax_scene_to_params(js)
    opt_state = opt.init(p)
    jax_losses = []
    for _ in range(3):
        (loss, _), grads = value_and_grad(p)
        updates, opt_state = opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        jax_losses.append(float(loss))
    scene = _port_scene(name)
    step = make_train_step(make_loss_fn(scene, torch.tensor(_target(case)), _cfg(depth)))
    state = init_state(scene_to_params(scene), adam(1e-2))
    losses = []
    for _ in range(3):
        state, loss = step(state)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    for key, want in p.items():
        np.testing.assert_allclose(state.params[key].detach().numpy(), np.asarray(want), rtol=0, atol=1e-9, err_msg=key)


def test_masked_updates_freeze_elements():
    scene = _port_scene("reference")
    params = scene_to_params(scene, sphere_fields=("specular_gain",), light_fields=(), camera=False)
    before = params["spheres.specular_gain"].detach().clone()
    mask = {"spheres.specular_gain": torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)}
    target = torch.tensor(_target("reference_d3")) * 0.9
    step = make_train_step(make_loss_fn(scene, target, _cfg(2)), update_mask=mask)
    state, loss = step(init_state(params, adam(1e-2)))
    after = state.params["spheres.specular_gain"].detach()
    assert state.step == 1 and torch.isfinite(loss)
    assert after[0] == before[0] and after[2] == before[2] and after[1] != before[1]


def test_fit_equals_step_by_step_training():
    """fit's chunked loop (3 steps, a host sync every 2) gives the losses and
    parameters of three make_train_step calls, and calls back once per step."""
    scene = tscenes.reference_scene(12, 8, dtype=torch.float64)
    with torch.no_grad():
        target = T.render(scene, _cfg(2)) * 0.9
    fields = dict(sphere_fields=("center", "specular_gain"), light_fields=(), camera=False)
    seen = []
    params, history = fit(scene, target, _cfg(2), scene_to_params(scene, **fields), steps=3, learning_rate=1e-2,
                          sync_every=2, callback=lambda i, loss: seen.append((i, loss)))
    step = make_train_step(make_loss_fn(scene, target, _cfg(2)))
    state = init_state(scene_to_params(scene, **fields), adam(1e-2))
    losses = []
    for _ in range(3):
        state, loss = step(state)
        losses.append(float(loss))
    assert history == losses and seen == list(enumerate(losses))
    for key, p in params.items():
        assert torch.equal(p, state.params[key]), key


def test_params_round_trip_jax_scene_to_params():
    js = jscenes.reference_scene(W, H, dtype=jnp.float64)
    arrays = {k: np.asarray(v) for k, v in jax_scene_to_params(js).items()}
    got = params_from_numpy(arrays, device="cpu", dtype=torch.float64)
    mine = scene_to_params(_port_scene("reference"))
    assert list(got) == list(mine) and all(p.requires_grad for p in got.values())
    for k in arrays:
        np.testing.assert_array_equal(got[k].detach().numpy(), arrays[k], err_msg=k)
        np.testing.assert_array_equal(mine[k].detach().numpy(), arrays[k], err_msg=k)
    back = params_to_numpy(got)
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)


def _optimize(tmp_path, target, steps, checkpoint, metrics):
    args = [
        "optimize", "--visibility", "smooth", "--device", "cpu", "--width", "12", "--height", "8",
        "--depth", "2", "--dtype", "float64", "--target", str(target), "--steps", str(steps),
        "--lr", "1e-2", "--sync-every", "2", "--checkpoint-every", "2",
        "--checkpoint", str(checkpoint), "--metrics", str(metrics),
        "--train-fields", "spheres.center,spheres.specular_gain,lights.point_position",
    ]
    assert cli.main(args) == 0
    return [json.loads(line) for line in metrics.read_text().splitlines()]


def test_cli_optimize_checkpoints_and_resumes(tmp_path):
    """4 steps in one run, and 2 + 2 across a checkpoint: the same losses."""
    target = tmp_path / "target.png"
    with torch.no_grad():
        save_png(T.render(tscenes.reference_scene(12, 8, dtype=torch.float64), _cfg(2)) * 0.9, target)
    whole = _optimize(tmp_path, target, 4, tmp_path / "a.npz", tmp_path / "a.jsonl")
    first = _optimize(tmp_path, target, 2, tmp_path / "b.npz", tmp_path / "b.jsonl")
    assert (tmp_path / "b.npz").exists()
    resumed = _optimize(tmp_path, target, 4, tmp_path / "b.npz", tmp_path / "c.jsonl")
    assert [r["step"] for r in whole] == [0, 1, 2, 3] and all(r["event"] == "step" for r in whole)
    assert [r["step"] for r in resumed] == [2, 3]
    assert [r["loss"] for r in first + resumed] == [r["loss"] for r in whole]
    assert all(np.isfinite(r["loss"]) for r in whole)
    with pytest.raises(ValueError, match="structure mismatch"):
        cli.main(["optimize", "--visibility", "smooth", "--device", "cpu", "--width", "12", "--height", "8",
                  "--depth", "2", "--target", str(target), "--steps", "6", "--checkpoint", str(tmp_path / "b.npz"),
                  "--train-fields", "spheres.radius"])


# --- scope and the wrappers' contracts -------------------------------------------


def _many_spheres(n, width, height):
    rows = [T.make_sphere_row((float(i % 16) - 8.0, 0.0, 5.0 + i // 16), 0.3) for i in range(n)]
    spheres = T.build_spheres(rows, dtype=torch.float32)
    lights = T.build_lights((-2.0, 1.0, 2.0), dtype=torch.float32)
    return T.make_scene(spheres, lights, (0.0, 0.2, -2.0), width, height, dtype=torch.float32)


class _Took(Exception):
    pass


@pytest.mark.parametrize(
    "route,match",
    [
        ("culled", "trace_culled_smooth"),
        ("too_many_spheres", "pallas_bounce_smooth_sub.trace_fused_smooth_sub in blocked mode"),
        ("lane_kernels", "pallas_bounce_smooth.trace_fused_smooth"),
    ],
)
def test_unported_smooth_routes_raise(monkeypatch, route, match):
    """render() and the training loss take the counterpart of each JAX smooth
    route off the sublane kernels' first range, caught at the port function
    before any ray is traced (the name is kept from when these routes were
    refused): a 96-sphere 960x540 frame reaches ``trace_culled_smooth``;
    257-4096 spheres (JAX's blocked mode) reach ``trace_fused_smooth_sub``'s
    depth-fused pair and the loss ``fused_train_l2`` (``train_deep``); more
    than 4096 (JAX's lane kernels, ``pallas_bounce_smooth.trace_fused_smooth``)
    reach its one-bounce pair, the loss through render().  The sharded loss
    (a one-rank mesh) reaches the same kernels through ``render_sharded``."""
    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")  # the package exports a render function
    lane = "pallas_bounce_smooth.trace_fused_smooth"
    blocked = "pallas_bounce_smooth_sub.trace_fused_smooth_sub in blocked mode"

    def took(label):
        def fn(*args, route="auto", **kwargs):
            raise _Took(lane if route == "step" else label)

        return fn

    monkeypatch.setattr(render_mod, "trace_culled_smooth", took("trace_culled_smooth"))
    monkeypatch.setattr(render_mod, "trace_fused_smooth_sub", took(blocked))
    monkeypatch.setattr(render_mod, "fused_train_l2", took(f"{blocked} (train_deep)"))
    if route == "culled":
        scene = _many_spheres(96, 960, 540)
    else:
        scene = _many_spheres(257 if route == "too_many_spheres" else 4097, 8, 4)
    cfg = T.RenderConfig(visibility="smooth", use_pallas=True)
    target = torch.zeros((scene.camera.height, scene.camera.width, 3))
    with pytest.raises(_Took, match=match):
        T.render(scene, cfg)
    with pytest.raises(_Took, match=match):
        make_loss_fn(scene, target, cfg)(scene_to_params(scene))
    with pytest.raises(_Took, match=match):
        make_loss_fn(scene, target, cfg, mesh=make_mesh())(scene_to_params(scene))
    assert bss.LAUNCHES == dict.fromkeys(SMOOTH_KERNELS, 0)


def _kernel_args():
    """Rays, tables and scalars of the reference scene at 4x2, as the kernels take them."""
    scene = tscenes.reference_scene(4, 2, dtype=torch.float64)
    return bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, torch.float64), scene, _cfg(2))


@pytest.mark.parametrize(
    "fault,match",
    [
        ("shape", "expected shape"),
        ("dtype", "expected torch.float64"),
        ("strided", "contiguous"),
        ("requires_grad", "compute their own gradients"),
        ("depth0", "depth must be"),
        ("s_cheap", "s_cheap"),
        ("too_deep_train", "train_deep takes depth"),
        ("idx_dtype", "expected torch.int32"),
    ],
)
def test_wrappers_refuse_what_the_kernels_do_not_take(fault, match):
    o, d, (geom, mat, consts), kw = _kernel_args()
    if fault == "idx_dtype":
        fwd = bss.smooth_fwd_deep(o, d, geom, mat, consts, **kw)
        res = list(fwd[1:])
        res[4] = res[4].to(torch.int64)
        with pytest.raises(ValueError, match=match):
            bss.smooth_bwd_deep(o, d, *res, geom, mat, consts, torch.ones_like(d), **kw)
        return
    if fault == "shape":
        d = d[:, :-1].contiguous()
    elif fault == "dtype":
        d = d.float()
    elif fault == "strided":
        d = torch.stack([d, d], dim=2)[..., 0]
    elif fault == "requires_grad":
        geom = geom.clone().requires_grad_(True)
    elif fault == "depth0":
        kw["depth"] = 0
    elif fault == "s_cheap":
        kw["s_cheap"] = 4
    elif fault == "too_deep_train":
        kw["depth"] = bss.MAX_TRAIN_DEPTH + 1
        with pytest.raises(ValueError, match=match):
            bss.train_deep(o, d, torch.zeros_like(d), geom, mat, consts, **kw)
        return
    with pytest.raises(ValueError, match=match):
        bss.smooth_fwd_deep(o, d, geom, mat, consts, **kw)
    assert bss.LAUNCHES == dict.fromkeys(SMOOTH_KERNELS, 0)
