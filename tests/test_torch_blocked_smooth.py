"""Smooth training past 256 spheres: the port against the JAX XLA smooth path.

The JAX package runs smooth scenes of 257-4096 spheres off its culled route
through the blocked mode of its sublane kernels, and more than 4096 through
its lane pair; its own tests hold both against the XLA smooth path
(``use_pallas=False``, ``tests/test_fused_smooth.py``), which is the oracle
here too.  The port takes the same kernels at any table size (the CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py``):

* ``inverse_task_scene(300)`` at 32x16, depth 3: the frame, the L2 loss and
  every ``scene_to_params`` gradient through ``train_deep``'s plain version
  (``make_loss_fn``), and a weighted-sum loss through ``render()``'s
  ``smooth_fwd_deep``/``smooth_bwd_deep`` plain pair;
* ``random_spheres_scene(4097)`` at 8x4, depth 2: the frame, and the
  weighted-sum loss and its gradients through ``render()``'s
  ``smooth_fwd_step``/``smooth_bwd_step`` once per bounce.  The L2 loss
  takes the same route there (``make_loss_fn`` calls ``render()``): the
  routing test shows it, without a second run of the plain pair.

Everything is float64.  Each JAX oracle is compiled once per module,
without loop fusion and at XLA backend optimisation level 0 (as in
``test_torch_smooth.py``).
"""

import contextlib
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
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu.optim.train import l2_image_loss as jax_l2_image_loss  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.render import fused_train_l2_ok, smooth_route  # noqa: E402

# name: (scene builder, spheres, width, height, depth, losses held against JAX)
CASES = {
    "blocked_300": ("inverse_task", 300, 32, 16, 3, ("l2", "weighted")),
    "lane_4097": ("random_spheres", 4097, 8, 4, 2, ("weighted",)),
}
ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0}
# test_torch_smooth.py's f64 limits for the kernels' plain versions: the
# frame within 1e-8 (absolute, colors up to ~2) and every gradient leaf
# within 1e-7 of its largest value.  The plain versions take the
# compensated exact tier for the r = 99999 ground sphere of random_spheres
# where the f64 XLA path takes the reference form, and sum the table
# gradients in another order.
IMAGE_ATOL = 1e-8
GRAD_RTOL = 1e-7
LOSS_RTOL = 1e-9
KERNELS = ("smooth_fwd_deep", "smooth_bwd_deep", "train_deep", "smooth_fwd_step", "smooth_bwd_step")


def _cfg(depth, **kw):
    return T.RenderConfig(max_depth=depth, dtype=torch.float64, visibility="smooth", **kw)


def _port_scene(case):
    builder, n, w, h = CASES[case][:4]
    return getattr(tscenes, f"{builder}_scene")(n, w, h, dtype=torch.float64)


@functools.cache
def _target_and_weight(case):
    """The clipped hard render (target of the L2 loss; None where the case
    holds no L2 loss) and a seeded weight (of the weighted-sum loss), made
    once and fed to both sides."""
    _, _, w, h, depth, losses = CASES[case]
    target = None
    if "l2" in losses:
        with torch.no_grad():
            img = T.render(_port_scene(case), T.RenderConfig(max_depth=depth, dtype=torch.float64))
        target = torch.clamp(img, 0.0, 1.0).numpy()
    weight = np.random.default_rng(5).uniform(-1.0, 1.0, size=(h, w, 3))
    return target, weight


@functools.cache
def _jax_oracle(case):
    """JAX's XLA smooth path, one compile: the frame and ``{loss: (value,
    {leaf: grad})}`` for the case's losses (the L2 loss, the weighted sum)."""
    builder, n, w, h, depth, losses = CASES[case]
    js = getattr(jscenes, f"{builder}_scene")(n, w, h, dtype=jnp.float64)
    cfg = J.RenderConfig(max_depth=depth, dtype=jnp.float64, visibility="smooth")
    target, weight = (None if x is None else jnp.asarray(x) for x in _target_and_weight(case))

    def all_losses(params):
        # One forward; each loss's gradient is the render's VJP of that
        # loss's image cotangent, batched over the losses.
        image, vjp = jax.vjp(lambda p: J.render(jax_combine(p, js), cfg), params)
        values, cots = {}, []
        for name in losses:
            fn = (lambda im: jax_l2_image_loss(im, target)) if name == "l2" else (lambda im: jnp.sum(im * weight) / (w * h))
            value, cot = jax.value_and_grad(fn)(image)
            values[name] = value
            cots.append(cot)
        (grads,) = jax.vmap(vjp)(jnp.stack(cots))
        return image, {name: (values[name], jax.tree_util.tree_map(lambda g, i=i: g[i], grads)) for i, name in enumerate(losses)}

    params = jax_scene_to_params(js)
    image, out = jax.jit(all_losses).lower(params).compile(compiler_options=ORACLE_XLA_OPTIONS)(params)
    return np.asarray(image), {k: (float(v), {leaf: np.asarray(x) for leaf, x in g.items()}) for k, (v, g) in out.items()}


@contextlib.contextmanager
def _calls():
    """Count calls of the five kernel wrappers (each launches its kernel on
    a CUDA tensor; here they run their plain versions) and of the
    pure-torch ``trace``."""
    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    counts = dict.fromkeys((*KERNELS, "trace"), 0)
    patched = [(bss, k) for k in KERNELS] + [(render_mod, "trace")]
    real = {k: getattr(m, k) for m, k in patched}

    def spy(name):
        def fn(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)

        return fn

    for m, k in patched:
        setattr(m, k, spy(k))
    try:
        yield counts
    finally:
        for m, k in patched:
            setattr(m, k, real[k])


def _leaf_grads(params):
    return {k: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))) for k, p in params.items()}


@functools.cache
def _port(case, loss):
    """(frame, loss value, {leaf: grad}, wrapper calls) of one port route
    with ``use_pallas``: the L2 loss through ``make_loss_fn``, or the
    weighted-sum loss through ``render()``."""
    _, _, w, h, depth, _ = CASES[case]
    scene = _port_scene(case)
    target, weight = _target_and_weight(case)
    cfg = _cfg(depth, use_pallas=True)
    params = scene_to_params(scene)
    with _calls() as counts:
        if loss == "l2":
            value = make_loss_fn(scene, torch.tensor(target), cfg)(params)
            image = None
        else:
            image = T.render(combine(params, scene), cfg)
            value = torch.sum(image * torch.tensor(weight)) / (w * h)
        value.backward()
    frame = None if image is None else image.detach().numpy()
    return frame, float(value.detach()), _leaf_grads(params), dict(counts)


def _assert_grads_close(got, want, what):
    assert got.keys() == want.keys()
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=GRAD_RTOL * scale, err_msg=f"{what}: {key}")
    assert any(np.abs(g).max() > 0 for g in got.values())


@pytest.mark.parametrize("case", CASES)
def test_frame_matches_xla(case):
    """The frame of the kernels' plain route (``smooth_fwd_deep`` at 300
    spheres, ``smooth_fwd_step`` per bounce at 4097) against the JAX frame."""
    _, _, w, h, _, _ = CASES[case]
    frame = _port(case, "weighted")[0]
    assert frame.shape == (h, w, 3)
    np.testing.assert_allclose(frame, _jax_oracle(case)[0], rtol=0, atol=IMAGE_ATOL)


@pytest.mark.parametrize("case,loss", [(c, loss) for c, spec in CASES.items() for loss in spec[5]])
def test_loss_gradients_match_jax_grad(case, loss):
    """Loss value and every scene_to_params gradient leaf against jax.grad:
    ``train_deep`` (L2) and the deep pair (weighted sum) at 300 spheres, the
    one-bounce pair at 4097."""
    want_val, want_grad = _jax_oracle(case)[1][loss]
    _, value, grads, _ = _port(case, loss)
    assert value == pytest.approx(want_val, rel=LOSS_RTOL)
    _assert_grads_close(grads, want_grad, f"{case} {loss} vs jax.grad")


class _Stop(Exception):
    pass


@pytest.mark.parametrize(
    "case,loss,route,calls",
    [
        ("blocked_300", "l2", "sub", {"train_deep": 1}),
        ("blocked_300", "weighted", "sub", {"smooth_fwd_deep": 1, "smooth_bwd_deep": 1}),
        ("lane_4097", "weighted", "step", {"smooth_fwd_step": 2, "smooth_bwd_step": 2}),
    ],
)
def test_routes_past_256_spheres(case, loss, route, calls):
    """Off the culled route, 257-4096 spheres take the depth-fused pair and,
    for the L2 loss, ``train_deep``; more than 4096 take the one-bounce pair
    once per bounce, forward and backward, and never ``train_deep``: the L2
    loss of ``make_loss_fn`` there starts with ``smooth_fwd_step`` (stopped
    at that call)."""
    scene = _port_scene(case)
    cfg = _cfg(CASES[case][4], use_pallas=True)
    assert smooth_route(scene, cfg, scene.camera.width * scene.camera.height, None) == route
    assert fused_train_l2_ok(scene, cfg) == (route == "sub")
    assert _port(case, loss)[3] == {**dict.fromkeys((*KERNELS, "trace"), 0), **calls}
    if route == "step":
        def stop(*args, **kwargs):
            raise _Stop

        with _calls() as counts, pytest.MonkeyPatch.context() as mp:
            mp.setattr(bss, "smooth_fwd_step_plain", stop)
            with pytest.raises(_Stop):
                make_loss_fn(scene, torch.zeros((4, 8, 3), dtype=torch.float64), cfg)(scene_to_params(scene))
        assert counts == {**dict.fromkeys((*KERNELS, "trace"), 0), "smooth_fwd_step": 1}


def test_stochastic_past_4096_spheres_takes_pure_torch():
    """A stochastic key above 4096 spheres takes the pure-torch ``trace``
    (JAX's key_ok sends it to the XLA path), for render() and the loss, and
    gives the pure-torch route's frame; 4096 spheres keep the kernels."""
    scene = tscenes.random_spheres_scene(4097, 4, 2, dtype=torch.float64)
    kw = dict(stochastic_roughness=True, rng_seed=7)
    cfg = _cfg(1, use_pallas=True, **kw)
    assert smooth_route(scene, cfg, 8, key=1) == "pure"
    assert smooth_route(tscenes.random_spheres_scene(4096, 4, 2, dtype=torch.float64), cfg, 8, key=1) == "sub"
    params = scene_to_params(scene)
    with _calls() as counts:
        image = T.render(combine(params, scene), cfg)
        make_loss_fn(scene, torch.zeros_like(image), cfg)(params).backward()
    assert counts == {**dict.fromkeys(KERNELS, 0), "trace": 2}
    with torch.no_grad():
        pure = T.render(scene, _cfg(1, **kw))
    np.testing.assert_array_equal(image.detach().numpy(), pure.numpy())
