"""The kernel routes of the sampled and one-bounce paths, on the CPU.

On CPU tensors the kernel wrappers run their plain versions, so these tests
hold the kernels' arithmetic (the glossy xi continuation in ``trace_deep``,
``bounce_step``, ``smooth_fwd_deep``/``smooth_bwd_deep`` and ``train_deep``,
and the one-bounce pair ``smooth_fwd_step``/``smooth_bwd_step``) against the
pure-torch route and its torch autograd.  The pure-torch route is held
against JAX in ``tests/test_torch_sampling.py``; the CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.  No JAX here:
frames are 24x12 in float64, inputs from a fixed seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions, ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_sub  # noqa: E402
from python_ray_tracer_tpu_torch.ops.rng import bounce_xi, fold_seed, seed_root  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, l2_image_loss, make_loss_fn, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.render import bounce, fused_train_l2_ok, l2_loss_fused  # noqa: E402

W, H = 24, 12
SEED = 11
# As in tests/test_torch_smooth.py: the kernels' plain versions take the
# compensated exact tier for the r = 99999 ground sphere where the f64 pure
# route takes the plain form (frames measured within 7.6e-10 there).
IMAGE_ATOL = 1e-8
GRAD_RTOL = 1e-7


def _scene(name="reference"):
    return getattr(tscenes, f"{name}_scene")(W, H, dtype=torch.float64)


def _cfg(depth, visibility="smooth", **kw):
    return T.RenderConfig(max_depth=depth, dtype=torch.float64, visibility=visibility,
                          stochastic_roughness=True, rng_seed=SEED, **kw)


def _render(cfg, name="reference"):
    with torch.no_grad():
        return T.render(_scene(name), cfg).numpy()


@pytest.mark.parametrize(
    "visibility,depth,name",
    [("smooth", 3, "reference"), ("smooth", 1, "reference"), ("smooth", 2, "all_effects"),
     ("hard", 3, "reference"), ("hard", 1, "reference")],
)
def test_stochastic_kernel_route_matches_pure(visibility, depth, name):
    """render() through the kernels' plain versions (smooth: the deep pair at
    depth >= 2, the one-bounce pair at depth 1; hard: trace_deep, and
    bounce_step at depth 1) against the pure-torch route, stochastic."""
    got = _render(_cfg(depth, visibility, use_pallas=True), name)
    want = _render(_cfg(depth, visibility), name)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    if depth > 1:  # the glossy continuation is live (at depth 1 no ray continues)
        mirror = _render(T.RenderConfig(max_depth=depth, dtype=torch.float64, visibility=visibility), name)
        assert np.abs(got - mirror).max() > 1e-3


@pytest.mark.parametrize("module,routes", [("smooth", ("deep", "step")), ("hard", ("trace_deep", "bounce_step"))])
def test_step_route_equals_deep_route(module, routes):
    """Forced to the per-bounce kernels at depth 3, the trace equals the
    depth-fused one bit for bit (stochastic, the same xi per bounce)."""
    scene = _scene()
    cfg = _cfg(3, "smooth" if module == "smooth" else "hard", use_pallas=True)
    fn = bss.trace_fused_smooth_sub if module == "smooth" else bounce_sub.trace_fused_sub
    key = 1234
    with torch.no_grad():
        deep, step = (fn(scene.camera.position, ray_directions_t(scene.camera, torch.float64), scene, cfg,
                         route=r, key=key) for r in routes)
    np.testing.assert_array_equal(step.numpy(), deep.numpy())


def _pure_state(scene, cfg, xi):
    """The state after one pure-torch bounce from the camera: thr and alive
    other than 1, as the second bounce of a chain takes them."""
    d = ray_directions(scene.camera, torch.float64)
    n = d.shape[0]
    state = (scene.camera.position.expand(d.shape), d, torch.ones(n, dtype=torch.float64),
             torch.ones(n, dtype=torch.float64), torch.zeros((n, 3), dtype=torch.float64))
    with torch.no_grad():
        return bounce(*state, scene, cfg, xi)


@pytest.mark.parametrize("stochastic", [False, True], ids=["mirror", "glossy"])
def test_bwd_step_matches_torch_autograd(stochastic):
    """The ``smooth_bwd_step`` plain version, through ``_BounceSub``, against
    torch autograd of one pure-torch bounce: cotangents of the bounce's
    inputs and of every scene_to_params leaf, from seeded nonzero
    cotangents on all five outputs."""
    scene = _scene()
    cfg = T.RenderConfig(max_depth=1, dtype=torch.float64, visibility="smooth")
    n = W * H
    xis = bounce_xi(SEED, n, 2, torch.float64) if stochastic else [None, None]
    state = _pure_state(scene, cfg, None if xis[0] is None else xis[0].T)
    assert float(state[2].min()) < 1.0 and float(state[3].min()) < 1.0
    rng = np.random.default_rng(SEED)
    cots = [torch.tensor(rng.uniform(-1.0, 1.0, tuple(s.shape))) for s in state]
    grads = {}
    for route in ("pure", "kernels"):
        params = scene_to_params(scene)
        leaves = [s.clone().requires_grad_(True) for s in state]
        sc = combine(params, scene)
        if route == "pure":
            out = bounce(*leaves, sc, cfg, None if xis[1] is None else xis[1].T)
        else:
            _, _, tables, kw = bss._kernel_inputs(sc.camera.position, ray_directions_t(sc.camera, torch.float64), sc, cfg)
            del kw["depth"]
            o, d, thr, alive, acc = leaves
            out_t = bss._BounceSub.apply(o.T.contiguous(), d.T.contiguous(), thr, alive, acc.T.contiguous(),
                                         *tables, xis[1], kw)
            out = (out_t[0].T, out_t[1].T, out_t[2], out_t[3], out_t[4].T)
        torch.autograd.backward(out, cots)
        grads[route] = {**{f"state.{i}": v.grad for i, v in enumerate(leaves)},
                        **{k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}}
    assert bss.LAUNCHES == dict.fromkeys(bss.LAUNCHES, 0)
    for key, want in grads["pure"].items():
        got, want = grads["kernels"][key].numpy(), want.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale, err_msg=key)
    assert np.abs(grads["kernels"]["spheres.specular_roughness"].numpy()).max() > 0


@pytest.mark.parametrize("depth,route", [(1, "auto"), (2, "step")])
def test_step_pair_loss_gradients_match_torch_autograd(depth, route):
    """A weighted-sum loss, stochastic: render() at smooth depth 1 takes the
    one-bounce pair, and at depth 2 the trace is forced onto it, so the
    glossy continuation's cotangent flows back through d.  Every
    scene_to_params leaf against torch autograd of the pure-torch route."""
    scene = _scene()
    weight = torch.tensor(np.random.default_rng(2).uniform(0.0, 1.0, (H, W, 3)))
    grads = {}
    for kernels in (False, True):
        params = scene_to_params(scene)
        sc = combine(params, scene)
        cfg = _cfg(depth, use_pallas=kernels)
        if kernels and route == "step":
            key = fold_seed(fold_seed(seed_root(SEED), 0), 4)  # render()'s key of sample 0
            dirs_t = ray_directions_t(sc.camera, torch.float64)
            img = bss.trace_fused_smooth_sub(sc.camera.position, dirs_t, sc, cfg, route="step", key=key).reshape(H, W, 3)
        else:
            img = T.render(sc, cfg)
        torch.sum(img * weight).backward()
        grads[kernels] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    for key, want in grads[False].items():
        scale = max(float(want.abs().max()), 1e-12)
        np.testing.assert_allclose(grads[True][key].numpy(), want.numpy(), rtol=0, atol=GRAD_RTOL * scale, err_msg=key)
    assert float(grads[True]["spheres.specular_roughness"].abs().max()) > 0


def test_supersampled_loss_gradients_match_torch_autograd():
    """An spp-2 stochastic L2 loss takes render()'s sample loop (make_loss_fn
    leaves train_deep for spp > 1): the deep pair's adjoint per sample,
    summed, against torch autograd of the pure-torch route."""
    scene = _scene()
    target = torch.tensor(np.random.default_rng(3).uniform(0.0, 1.0, (H, W, 3)))
    grads, losses = {}, {}
    for kernels in (False, True):
        cfg = _cfg(2, use_pallas=kernels, samples_per_pixel=2)
        assert not fused_train_l2_ok(scene, cfg)
        params = scene_to_params(scene)
        loss = make_loss_fn(scene, target, cfg)(params)
        loss.backward()
        losses[kernels] = float(loss.detach())
        grads[kernels] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    assert losses[True] == pytest.approx(losses[False], rel=1e-9)
    for key, want in grads[False].items():
        scale = max(float(want.abs().max()), 1e-12)
        np.testing.assert_allclose(grads[True][key].numpy(), want.numpy(), rtol=0, atol=GRAD_RTOL * scale, err_msg=key)


def test_stochastic_l2_loss_takes_train_deep_key():
    """l2_loss_fused keys its xi as render()'s sample 0 at spp 1, so the
    one-launch loss equals the L2 loss of the stochastic render."""
    scene = _scene()
    cfg = _cfg(2, use_pallas=True)
    target = torch.full((H, W, 3), 0.25, dtype=torch.float64)
    with torch.no_grad():
        fused = l2_loss_fused(scene, target, cfg)
        two_launch = l2_image_loss(T.render(scene, cfg), target)
    assert float(fused) == pytest.approx(float(two_launch), rel=1e-14)


def _step_args():
    scene = _scene()
    cfg = T.RenderConfig(max_depth=1, dtype=torch.float64, visibility="smooth", use_pallas=True)
    o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, torch.float64), scene, cfg)
    del kw["depth"]
    ones = torch.ones_like(d[0])
    return (o, d, ones, ones, torch.zeros_like(d)), tables, kw


@pytest.mark.parametrize(
    "fault,match",
    [("xi_shape", "xi: expected shape"), ("xi_dtype", "xi: expected torch.float64"), ("lane_shape", "thr: expected shape"),
     ("idx_dtype", "idx: expected torch.int32"), ("route", "unknown route"), ("deep_xi_rows", "xi: expected shape")],
)
def test_step_wrappers_refuse_what_the_kernels_do_not_take(fault, match):
    state, tables, kw = _step_args()
    xi = bounce_xi(SEED, state[1].shape[1], 1, torch.float64)[0]
    with pytest.raises(ValueError, match=match):
        if fault == "xi_shape":
            bss.smooth_fwd_step(*state, *tables, xi[:1].contiguous(), **kw)
        elif fault == "xi_dtype":
            bss.smooth_fwd_step(*state, *tables, xi.float(), **kw)
        elif fault == "lane_shape":
            bss.smooth_fwd_step(state[0], state[1], state[2][:-1].contiguous(), *state[3:], *tables, **kw)
        elif fault == "idx_dtype":
            fwd = bss.smooth_fwd_step(*state, *tables, **kw)
            cots = [torch.ones_like(t) for t in fwd[:5]]
            bss.smooth_bwd_step(*state[:4], fwd[5].long(), *fwd[6:], *tables, *cots, **kw)
        elif fault == "route":
            scene = _scene()
            bss.trace_fused_smooth_sub(scene.camera.position, state[1], scene, _cfg(1), route="scan")
        else:
            bss.smooth_fwd_deep(state[0], state[1], *tables, xi, depth=2, **kw)
    assert bss.LAUNCHES == dict.fromkeys(bss.LAUNCHES, 0)
