"""Image textures on the port's culled routes against JAX.

The culled hard pair with ``shade_culled``'s atlas mode, and the culled
smooth kernels ``fwd_cs``/``bwd_cs`` in theirs, plain versions with the
texels composed after each bounce in the re-sorted ray order, against the
JAX package's culled routes in interpret mode: frames within 1e-12 (the
kernels and JAX take the same polynomial UV, so the texel ids agree
exactly), and the culled smooth route's loss and every gradient leaf, the
atlas included.  Beside ``test_torch_texture.py`` so that each file's JAX
oracles compile in well under a minute on one worker; the helpers are
shared from there.  The CUDA kernels' atlas mode is held against these
plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
import python_ray_tracer_tpu_torch as T  # noqa: E402
from python_ray_tracer_tpu.camera import ray_directions_t as jax_rays_t  # noqa: E402
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_culled as jcul  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_culled_smooth as jcs  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled as tcul  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled_smooth as tcs  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.render import hard_route  # noqa: E402

from .test_torch_texture import GRAD_RTOL, _assert_close, _grads, _oracle, _port, _trace_pair  # noqa: E402


def _culled_atlas_scene(w=96, h=54, dtype=jnp.float64):
    """``inverse_task_scene(128)`` with every 3rd sphere sampling a (2, 8, 16,
    3) atlas (``tests/test_culled_smooth.py``'s culled atlas scene)."""
    from python_ray_tracer_tpu.scene import TEXTURE_IMAGE

    rng = np.random.default_rng(9)
    scene = jscenes.inverse_task_scene(n_spheres=128, width=w, height=h, dtype=dtype)
    kind = np.array(scene.spheres.texture_kind)
    tid = np.array(scene.spheres.texture_id)
    kind[::3] = TEXTURE_IMAGE
    tid[::3] = np.arange(len(tid[::3])) % 2
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, texture_kind=jnp.asarray(kind), texture_id=jnp.asarray(tid)),
        texture_atlas=jnp.asarray(rng.uniform(0.1, 1.0, (2, 8, 16, 3)), dtype),
        texture_hw=jnp.asarray([[8, 16], [8, 16]], jnp.int32),
    )


def test_culled_hard_route_matches_jax_interpret():
    """The culled pair with ``shade_culled``'s atlas mode and the texels
    composed after each bounce, in the re-sorted ray order, on
    ``textured_spheres_scene(128)`` at 64x36, depth 2, float64, against
    JAX's culled kernels in interpret mode."""
    js = jscenes.textured_spheres_scene(128, 64, 36, dtype=jnp.float64)
    ts = _port(js)
    jcfg = J.RenderConfig(max_depth=2, dtype=jnp.float64, use_pallas=True, pallas_interpret=True)
    tcfg = T.RenderConfig(max_depth=2, dtype=torch.float64, use_pallas=True)
    assert hard_route(ts, tcfg, None) == "culled"
    got, want = _trace_pair(js, ts, lambda o, d, sc: jcul.trace_fused_culled(o, d, sc, jcfg, transposed=True),
                            lambda o, d, sc: tcul.trace_fused_culled(o, d, sc, tcfg), jnp.float64, torch.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tcul.ATLAS_LAUNCHES == {"shade_culled": 0}


def test_culled_smooth_route_matches_jax_interpret():
    """``fwd_cs``/``bwd_cs`` in their atlas mode (plain versions), texels
    composed after each bounce in the sorted order, against JAX's culled
    smooth route in interpret mode at 96x54, depth 2: frame, loss and every
    gradient leaf, the atlas included."""
    js = _culled_atlas_scene()
    target = np.random.default_rng(0).uniform(0.0, 1.0, (96 * 54, 3))
    sharp = 200.0
    jcfg = J.RenderConfig(max_depth=2, dtype=jnp.float64, visibility="smooth", edge_sharpness=sharp,
                          shadow_sharpness=sharp, use_pallas=True, pallas_interpret=True, block_rays=512)
    tcfg = T.RenderConfig(max_depth=2, dtype=torch.float64, visibility="smooth", edge_sharpness=sharp,
                          shadow_sharpness=sharp, use_pallas=True)
    params = jax_scene_to_params(js, atlas=True)

    def loss(p):
        sc = jax_combine(p, js)
        img = jcs.trace_culled_smooth(sc.camera.position, jax_rays_t(sc.camera, jnp.float64), sc, jcfg, transposed=True)
        return jnp.mean((jnp.clip(img, 0.0, 1.0) - jnp.asarray(target)) ** 2), img

    (value, img), grads = _oracle(jax.value_and_grad(loss, has_aux=True), params)
    want = (float(value), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(img))

    ts = _port(js)
    tparams = scene_to_params(ts, atlas=True)
    sc = combine(tparams, ts)
    img = tcs.trace_culled_smooth(sc.camera.position, ray_directions_t(sc.camera, torch.float64), sc, tcfg)
    tloss = torch.mean((torch.clamp(img, 0.0, 1.0) - torch.tensor(target)) ** 2)
    tloss.backward()
    got = (float(tloss.detach()), _grads(tparams), img.detach().numpy())
    _assert_close(got, want, GRAD_RTOL["kernels"], "culled smooth", 1e-12)
    assert tcs.ATLAS_LAUNCHES == {"fwd_cs": 0, "bwd_cs": 0}
