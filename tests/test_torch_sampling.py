"""Sampling in the PyTorch port against the JAX package: the per-ray RNG,
the GGX glossy continuation, jittered camera rays, supersampled and
stochastic renders, and the stochastic training loss.

JAX oracles run the XLA path (``use_pallas=False``), compiled once per
module with loop fusion (FMA contraction) and the algebraic simplifier off:
the simplifier rewrites the continuation's ``1 / sqrt(1 + t2q)`` into
``rsqrt``, which XLA's CPU backend does not round correctly, where the
JAX kernels, eager JAX and the port divide.  Frames are 32x16 in float64;
inputs come from seeded numpy.  The kernel routes of the same paths are in
``tests/test_torch_smooth_step.py``.
"""

import functools

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
from python_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from python_ray_tracer_tpu.ops import vecmath as jvec  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu.optim.train import l2_image_loss as jax_l2_image_loss  # noqa: E402
from python_ray_tracer_tpu_torch import camera as tcam  # noqa: E402
from python_ray_tracer_tpu_torch import cli  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import rng as trng  # noqa: E402
from python_ray_tracer_tpu_torch.ops import vecmath as tvec  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, l2_image_loss, make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.render import fused_train_l2_ok  # noqa: E402
from python_ray_tracer_tpu_torch.utils.image import load_png  # noqa: E402

W, H = 32, 16
ORACLE_XLA_OPTIONS = {
    "xla_disable_hlo_passes": "fusion,algsimp",
    "xla_backend_optimization_level": 0,
}
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
# Where cos/sin enter, XLA's CPU cos/sin and torch's part by an ulp on a few
# values: measured 4.0e-16 of the largest value on 2,000 seeded lanes.
COS_SIN_RTOL = 1e-14
# Pure-torch render vs the JAX XLA render, f64 (measured: at most 1.1e-16).
RENDER_ATOL = 1e-12
# Loss-gradient tolerance per route, relative to each leaf's largest value,
# as in tests/test_torch_smooth.py: torch autograd takes the XLA path's
# operations; the kernels' plain versions take the compensated exact tier
# for the r = 99999 ground sphere where the f64 XLA path takes the plain form.
GRAD_RTOL = {"torch_autograd": 1e-9, "train_deep_plain": 1e-7, "smooth_bwd_deep_plain": 1e-7}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)


def _jax_scene(name="reference"):
    return getattr(jscenes, f"{name}_scene")(W, H, dtype=jnp.float64)


def _port_scene(name="reference"):
    return getattr(tscenes, f"{name}_scene")(W, H, dtype=torch.float64)


# --- ops/rng.py -------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_rng_bitwise(seed, dt):
    """Seeds, folds and (n, 2) draws equal the JAX package's bit for bit,
    with lane offsets (near 2**32 too), from int and 0-d tensor seeds."""
    jdt, tdt = DTYPES[dt]
    jk = jrng.fold_seed(jrng.fold_seed(jrng.seed_root(seed), 3), 2**32 - 1)
    tk = trng.fold_seed(trng.fold_seed(trng.seed_root(seed), 3), 2**32 - 1)
    assert tk == int(jk)
    for offset in (0, 517, 2**32 - 3):
        want = np.asarray(jrng.uniform2(jk, 300, jdt, offset=offset))
        for key in (tk, torch.tensor(tk)):
            got = trng.uniform2(key, 300, tdt, offset=offset).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    if dt == "float32":  # 24-bit draws: the f32 and f64 values are equal
        np.testing.assert_array_equal(trng.uniform01(tk, 300, torch.float32).numpy(), trng.uniform01(tk, 300, torch.float64).numpy())


# --- ops/vecmath.py: the glossy continuation ----------------------------------------


def _ggx_inputs(n=2000):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3))
    nrm = rng.normal(size=(n, 3))
    rough = rng.uniform(0.0, 1.0, n)
    rough[:8], rough[8:16] = 0.0, 1e-4  # the mirror limit must stay finite
    xi = rng.uniform(0.0, 1.0, (n, 2))
    w = rng.uniform(-1.0, 1.0, (n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True), nrm / np.linalg.norm(nrm, axis=1, keepdims=True), rough, xi, w


def _assert_close_rel(got, want, rtol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


def test_ggx_perturb_reflect_values_and_gradients():
    """Values against JAX; torch autograd against jax.grad on every input,
    finite at roughness 0 and 1e-4; the tangent frame bitwise."""
    d, nrm, rough, xi, w = _ggx_inputs()
    jargs = [jnp.asarray(a) for a in (d, nrm, rough, xi)]
    t1, t2 = jvec.orthonormal_basis(jargs[1])
    u1, u2 = tvec.orthonormal_basis(torch.tensor(nrm))
    np.testing.assert_array_equal(u1.numpy(), np.asarray(t1))
    np.testing.assert_array_equal(u2.numpy(), np.asarray(t2))

    def weighted(dd, nn, rr, xx):
        return jnp.sum(jnp.asarray(w) * jvec.ggx_perturb_reflect(dd, nn, rr, xx))

    value, grads = _compile(lambda *a: (jvec.ggx_perturb_reflect(*a), jax.grad(weighted, argnums=(0, 1, 2))(*a)), *jargs)(*jargs)
    targs = [torch.tensor(a, requires_grad=i < 3) for i, a in enumerate((d, nrm, rough, xi))]
    got = tvec.ggx_perturb_reflect(*targs)
    torch.sum(torch.tensor(w) * got).backward()
    _assert_close_rel(got.detach().numpy(), np.asarray(value), COS_SIN_RTOL, "ggx_perturb_reflect")
    for t, g, name in zip(targs, grads, ("direction", "normal", "roughness")):
        assert bool(torch.isfinite(t.grad).all()), name
        _assert_close_rel(t.grad.numpy(), np.asarray(g), COS_SIN_RTOL, f"d/d{name}")
    assert np.all(targs[2].grad.numpy()[:8] == 0.0)


# --- camera.py: jittered rays -------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
def test_jittered_rays_bitwise(dt):
    jdt, tdt = DTYPES[dt]
    jitter = np.random.default_rng(1).uniform(-0.5, 0.5, (W * H, 2)).astype(np.dtype(jdt))
    js, ts = jscenes.reference_scene(W, H, dtype=jdt), tscenes.reference_scene(W, H, dtype=tdt)
    want, want_t = _compile(lambda c, j: (jcam.ray_directions(c, jdt, j), jcam.ray_directions_t(c, jdt, j.T)), js.camera, jnp.asarray(jitter))(js.camera, jnp.asarray(jitter))
    np.testing.assert_array_equal(tcam.ray_directions(ts.camera, tdt, torch.tensor(jitter)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(tcam.ray_directions_t(ts.camera, tdt, torch.tensor(jitter).T).numpy(), np.asarray(want_t))
    assert tcam.pixel_pitch(W, H) == jcam.pixel_pitch(W, H)


# --- render(): the sample loop and the stochastic trace -----------------------------

RENDER_CASES = {
    "hard_stochastic_d2": dict(max_depth=2, stochastic_roughness=True, rng_seed=7),
    "hard_spp4_d2": dict(max_depth=2, samples_per_pixel=4, rng_seed=3),
}


@pytest.mark.parametrize("case", RENDER_CASES)
def test_pure_render_matches_xla(case):
    """The pure-torch render against the JAX XLA render, f64."""
    kw = RENDER_CASES[case]
    cfg = J.RenderConfig(dtype=jnp.float64, **kw)
    want = np.asarray(_compile(lambda sc: J.render(sc, cfg), _jax_scene())(_jax_scene()))
    got = T.render(_port_scene(), T.RenderConfig(dtype=torch.float64, **kw)).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL)
    deterministic = T.render(_port_scene(), T.RenderConfig(dtype=torch.float64, max_depth=kw["max_depth"])).numpy()
    assert np.abs(got - deterministic).max() > 1e-3  # the sampling is live


# --- the stochastic smooth loss: the one whole-loss gradient oracle ----------------

SMOOTH_DEPTH, SMOOTH_SEED = 2, 5


def _smooth_cfg(**kw):
    return T.RenderConfig(max_depth=SMOOTH_DEPTH, dtype=torch.float64, visibility="smooth",
                          stochastic_roughness=True, rng_seed=SMOOTH_SEED, **kw)


@functools.cache
def _target() -> np.ndarray:
    """The clipped deterministic hard render, fed to both sides."""
    img = T.render(_port_scene(), T.RenderConfig(max_depth=SMOOTH_DEPTH, dtype=torch.float64))
    return torch.clamp(img, 0.0, 1.0).numpy()


@functools.cache
def _jax_stochastic_oracle():
    """(loss, {leaf: grad}, frame) of the JAX XLA stochastic smooth L2 loss."""
    js = _jax_scene()
    cfg = J.RenderConfig(max_depth=SMOOTH_DEPTH, dtype=jnp.float64, visibility="smooth",
                         stochastic_roughness=True, rng_seed=SMOOTH_SEED)
    target = jnp.asarray(_target())

    def loss_and_image(params):
        image = J.render(jax_combine(params, js), cfg)
        return jax_l2_image_loss(image, target), image

    params = jax_scene_to_params(js)
    (loss, image), grads = _compile(jax.value_and_grad(loss_and_image, has_aux=True), params)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(image)


def test_stochastic_smooth_render_matches_xla():
    with torch.no_grad():
        got = T.render(_port_scene(), _smooth_cfg()).numpy()
    np.testing.assert_allclose(got, _jax_stochastic_oracle()[2], rtol=0, atol=RENDER_ATOL)


@pytest.mark.parametrize("route", GRAD_RTOL)
def test_stochastic_loss_gradients_match_jax_grad(route):
    """The loss and every scene_to_params leaf, three ways: torch autograd of
    the pure-torch route, the stochastic ``train_deep`` plain version (the
    L2 route of make_loss_fn, its xi keyed as l2_loss_fused keys it), and
    the ``smooth_fwd_deep``/``smooth_bwd_deep`` plain pair behind render()."""
    want_loss, want, _ = _jax_stochastic_oracle()
    scene, target = _port_scene(), torch.tensor(_target())
    params = scene_to_params(scene)
    if route == "torch_autograd":
        loss = make_loss_fn(scene, target, _smooth_cfg())(params)
    elif route == "train_deep_plain":
        assert fused_train_l2_ok(scene, _smooth_cfg(use_pallas=True))
        loss = make_loss_fn(scene, target, _smooth_cfg(use_pallas=True))(params)
    else:
        loss = l2_image_loss(T.render(combine(params, scene), _smooth_cfg(use_pallas=True)), target)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-9)
    assert want.keys() == params.keys()
    for key, p in params.items():
        got = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
        _assert_close_rel(got, want[key], GRAD_RTOL[route], f"{route}: d/d{key}")
    assert np.abs(params["spheres.specular_roughness"].grad.numpy()).max() > 0


# --- the CLI ------------------------------------------------------------------------


def test_cli_render_samples(tmp_path):
    """render --spp 2 --stochastic-roughness --seed 3 writes the PNG of the
    same render() call, and another seed another image."""
    out = [tmp_path / f"s{seed}.png" for seed in (3, 4)]
    for seed, path in zip((3, 4), out):
        rc = cli.main(["render", "--device", "cpu", "--width", "16", "--height", "8", "--spp", "2",
                       "--stochastic-roughness", "--seed", str(seed), "-o", str(path)])
        assert rc == 0
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    cfg = T.RenderConfig(samples_per_pixel=2, stochastic_roughness=True, rng_seed=3)
    want = to_uint8(T.render(tscenes.reference_scene(16, 8), cfg))
    np.testing.assert_array_equal(load_png(out[0]), want)
    assert not np.array_equal(load_png(out[0]), load_png(out[1]))
