"""Image textures and trainable atlases of the PyTorch port against JAX.

The textured builders bit for bit; the polynomial UV (``ATAN_C``,
``atan2_poly``, ``asin_poly``, ``flat_texel``) bitwise against the JAX
kernels' in float32 and float64; the pure-torch ``texture_color`` against
JAX's (libm ``atan2`` on both sides, so a few seam lanes may pick another
texel); the pure-torch smooth route's frame and value-and-grad, the atlas
leaf included, against ``jax.grad`` of the JAX XLA path; every kernel
route's plain versions (the sub hard and smooth routes here, the culled
ones in ``test_torch_texture_culled.py``, so that each file's JAX oracles
compile in well under a minute on one worker) against the JAX package's
Pallas routes in interpret mode, where both sides use the same polynomial,
so the texel ids agree exactly; the atlas routing against the JAX
renderer's; and ``compose_texels``'s deterministic backward.  Every JAX oracle compiles once, with XLA's fusion
(FMA contraction) and algebraic simplifier off.  The CUDA kernels' atlas
mode is held against these plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses
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
from python_ray_tracer_tpu.models import scenes as jscenes  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_bounce as jpb  # noqa: E402
from python_ray_tracer_tpu.ops import pallas_culled as jcul  # noqa: E402
from python_ray_tracer_tpu.ops import shading as jshading  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_bounce_sub import _bounce_math, _consts_row, _geometry_table  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_bounce import _material_table  # noqa: E402
from python_ray_tracer_tpu.optim.params import combine as jax_combine  # noqa: E402
from python_ray_tracer_tpu.optim.params import scene_to_params as jax_scene_to_params  # noqa: E402
from python_ray_tracer_tpu.optim.train import l2_image_loss as jax_l2_image_loss  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.convert import scene_from_numpy, scene_to_numpy  # noqa: E402
from python_ray_tracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_sub as tbs  # noqa: E402
from python_ray_tracer_tpu_torch.ops import shading as tshading  # noqa: E402
from python_ray_tracer_tpu_torch.ops import texture as ttex  # noqa: E402
from python_ray_tracer_tpu_torch.ops.tables import consts_row, geometry_table, material_table  # noqa: E402
from python_ray_tracer_tpu_torch.optim import combine, l2_image_loss, scene_to_params  # noqa: E402
from python_ray_tracer_tpu_torch.render import hard_route, smooth_route  # noqa: E402

jrender = importlib.import_module("python_ray_tracer_tpu.render")  # the module: the package re-exports render()

ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion,algsimp", "xla_backend_optimization_level": 0}
# The smooth route's float64 limits (tests/test_torch_smooth.py): frames
# within 1e-10, every gradient leaf within 1e-9 of the leaf's largest value
# for torch autograd of the pure-torch route and 1e-7 for the kernels'
# plain versions (JAX's interpret-mode table-gradient sums are not f64-exact,
# tests/test_torch_culled_smooth.py).
IMAGE_ATOL = 1e-10
GRAD_RTOL = {"pure": 1e-9, "kernels": 1e-7}
# The kernel routes' plain versions against JAX's interpret mode on the
# one-sphere texture task, where both run the same operations in the same
# order: frames within 1e-12 and gradients within 1e-12 of each leaf's
# largest value (reading: 4e-16).
TASK_KERNEL_RTOL = 1e-12
# libm atan2/asin in torch and XLA's own: at most this share of lanes may
# pick another texel (a seam lane), on either side of a texel edge.
MAX_SEAM_SHARE = 1e-3


def _oracle(fn, *args):
    """``fn(*args)`` compiled once by XLA without fusion and algsimp."""
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)(*args)


def _jax_leaves(scene) -> dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(k.name for k in path): np.asarray(x) for path, x in leaves}


def _port(js, dtype=torch.float64):
    """The JAX scene ``js`` on the port's side, the same arrays."""
    return scene_from_numpy(_jax_leaves(js), width=js.camera.width, height=js.camera.height,
                            n_exact=js.spheres.n_exact, device="cpu", dtype=dtype)


def _task_texture():
    return np.random.default_rng(3).uniform(0.2, 0.8, (8, 8, 3))


def _atlas_many_scene(w=32, h=18, dtype=jnp.float64):
    """24 spheres, every 3rd image-textured from a (2, 16, 32, 3) atlas
    (``tests/test_fused_smooth.py``'s atlas scene, in float64)."""
    from python_ray_tracer_tpu.scene import TEXTURE_IMAGE, build_lights, build_spheres, make_scene, make_sphere_row

    rng = np.random.default_rng(11)
    atlas = rng.uniform(0.1, 1.0, (2, 16, 32, 3))
    rows = []
    for i in range(24):
        center = rng.uniform([-3.0, -0.2, 1.0], [3.0, 2.0, 8.0])
        kw = dict(
            specular_gain=float(rng.uniform(0.0, 0.5)),
            specular_roughness=float(rng.uniform(0.1, 0.6)),
            diffuse_gain=float(rng.uniform(0.5, 1.0)),
            diffuse_color=rng.uniform(0.1, 1.0, 3),
        )
        if i % 3 == 0:
            kw.update(texture_kind=TEXTURE_IMAGE, texture_id=i % 2)
        rows.append(make_sphere_row(center, float(rng.uniform(0.15, 0.45)), **kw))
    spheres = build_spheres(rows, dtype=dtype)
    lights = build_lights((-4.0, 6.0, -1.0), domes=[(0.1, (1.0, 1.0, 1.0))], dtype=dtype)
    return make_scene(spheres, lights, (0.0, 0.6, -3.0), w, h, texture_atlas=atlas, dtype=dtype)


# --- scenes and the polynomial UV, bitwise --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_textured_scenes_match_jax(dtype):
    """Same draws in the same order: every table and the atlas equal."""
    cases = (
        (jscenes.textured_spheres_scene(128, 16, 8, dtype=getattr(jnp, dtype)),
         tscenes.textured_spheres_scene(128, 16, 8, dtype=getattr(torch, dtype))),
        (jscenes.texture_task_scene(_task_texture(), 16, 8, dtype=getattr(jnp, dtype)),
         tscenes.texture_task_scene(_task_texture(), 16, 8, dtype=getattr(torch, dtype))),
    )
    for js, ts in cases:
        got, want = scene_to_numpy(ts), _jax_leaves(js)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ts.spheres.n_exact == js.spheres.n_exact and ts.has_atlas


def test_atan_coefficients_match_jax():
    assert ttex.ATAN_C == tuple(jpb._ATAN_C)
    assert all(isinstance(c, float) for c in ttex.ATAN_C)


def _jax_flat(normal, tid, th_l, tw_l, tex_hw):
    """The JAX kernels' flat texel id (pallas_bounce_sub.py:288-298)."""
    th_pad, tw_pad = tex_hw
    u = 0.5 + jpb._atan2_poly(normal[2], normal[0]) / (2.0 * jnp.pi)
    v = 0.5 - jpb._asin_poly(normal[1]) / jnp.pi
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    ti = jnp.clip((u * (tw_l - 1.0)).astype(jnp.int32), 0, (tw_l - 1.0).astype(jnp.int32))
    tj = jnp.clip((v * (th_l - 1.0)).astype(jnp.int32), 0, (th_l - 1.0).astype(jnp.int32))
    return tid.astype(jnp.int32) * (th_pad * tw_pad) + tj * tw_pad + ti


def _unit_normals(n, dtype, seed=0):
    """Random unit normals plus the axes, the poles and the u = 0/1 seam."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    special = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        [-1, 0, 1e-12], [-1, 0, -1e-12], [-1, 0, 0.0], [1, 1, 1], [-1, -1, -1], [0, 1, 1e-9],
    ], np.float64)
    v = np.concatenate([special, v])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_polynomial_uv_matches_jax_bitwise(dtype):
    """atan2_poly, asin_poly and flat_texel equal the JAX kernels' functions
    bit for bit, axes, poles and the seam included."""
    nrm = _unit_normals(4000, dtype)
    grid = np.linspace(-1.5, 1.5, 301).astype(dtype)
    y, x = np.meshgrid(grid, grid)
    y, x = np.concatenate([y.ravel(), nrm[:, 1]]), np.concatenate([x.ravel(), nrm[:, 0]])
    tid = np.arange(len(nrm)) % 2
    th_l = np.where(tid == 0, 16.0, 9.0).astype(dtype)
    tw_l = np.where(tid == 0, 32.0, 7.0).astype(dtype)
    want = _oracle(
        lambda y, x, n, t, h, w: (jpb._atan2_poly(y, x), jpb._asin_poly(y), _jax_flat((n[:, 0], n[:, 1], n[:, 2]), t, h, w, (16, 32))),
        y, x, nrm, tid.astype(dtype), th_l, tw_l,
    )
    t = torch.tensor
    np.testing.assert_array_equal(ttex.atan2_poly(t(y), t(x)).numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(ttex.asin_poly(t(y)).numpy(), np.asarray(want[1]))
    normal = tuple(t(nrm[:, i]) for i in range(3))
    got = ttex.flat_texel(normal, t(tid.astype(dtype)), t(th_l), t(tw_l), (16, 32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[2]))


def test_texture_color_matches_jax():
    """The pure-torch image kind against JAX's XLA one on random unit
    normals: the atlas codes each texel's id in its color, so every color
    agrees wherever the ids do; libm ``atan2``/``asin`` part them on at most
    MAX_SEAM_SHARE of the lanes.  Constant and checker lanes bitwise."""
    n = 20000
    nrm = _unit_normals(n, np.float64, seed=1)
    p = np.random.default_rng(2).uniform(-3, 3, (len(nrm), 3))
    t_n, t_h, t_w = 2, 16, 32
    atlas = np.zeros((t_n, t_h, t_w, 3))
    atlas[..., 0] = np.arange(t_n * t_h * t_w).reshape(t_n, t_h, t_w)
    atlas[..., 1] = 0.5
    hw = np.array([[16, 32], [9, 7]], np.int32)
    kind = np.arange(len(nrm)) % 3  # const, checker, image
    tid = (np.arange(len(nrm)) // 3) % 2
    js = jscenes.texture_task_scene(atlas[0], 4, 4, dtype=jnp.float64)
    js = dataclasses.replace(js, texture_atlas=jnp.asarray(atlas), texture_hw=jnp.asarray(hw))
    ts = _port(js)
    dc = np.random.default_rng(4).uniform(0, 1, (len(nrm), 3))

    def jax_color(p, nrm):
        mat = jshading.LaneMaterial(**{f: None for f in jshading.LaneMaterial._fields})._replace(
            diffuse_color=jnp.asarray(dc), texture_kind=jnp.asarray(kind, jnp.int32),
            texture_id=jnp.asarray(tid, jnp.int32))
        return jshading.texture_color(p, nrm, mat, js)

    want = np.asarray(_oracle(jax_color, jnp.asarray(p), jnp.asarray(nrm)))
    mat = tshading.LaneMaterial(**{f: None for f in tshading.LaneMaterial._fields})._replace(
        diffuse_color=torch.tensor(dc), texture_kind=torch.tensor(kind, dtype=torch.int32),
        texture_id=torch.tensor(tid, dtype=torch.int32))
    got = tshading.texture_color(torch.tensor(p), torch.tensor(nrm), mat, ts).numpy()
    np.testing.assert_array_equal(got[kind != 2], want[kind != 2])
    seam = (got != want).any(1)
    assert seam.mean() <= MAX_SEAM_SHARE, int(seam.sum())
    assert (got[kind == 2, 1] == 0.5).all()


# --- the pure-torch smooth route against jax.grad of the XLA path ---------------


def _loss_setup(js, depth, **cfg_kw):
    """(target (N, 3) numpy, jax cfg, port cfg) for a clipped-L2 loss
    against 0.9 x the clipped hard frame."""
    jcfg = J.RenderConfig(max_depth=depth, dtype=jnp.float64, visibility="smooth", **cfg_kw)
    tcfg = T.RenderConfig(max_depth=depth, dtype=torch.float64, visibility="smooth",
                          use_pallas=cfg_kw.get("use_pallas", False))
    hard = T.render(_port(js), T.RenderConfig(max_depth=depth, dtype=torch.float64))
    return (torch.clamp(hard, 0.0, 1.0) * 0.9).numpy(), jcfg, tcfg


def _jax_value_and_grad(js, cfg, target):
    """JAX's loss, every ``scene_to_params(atlas=True)`` gradient and the
    frame, one compile."""
    params = jax_scene_to_params(js, atlas=True)

    def loss(p):
        img = J.render(jax_combine(p, js), cfg)
        return jax_l2_image_loss(img, jnp.asarray(target)), img

    (value, img), grads = _oracle(jax.value_and_grad(loss, has_aux=True), params)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}, np.asarray(img)


def _grads(params) -> dict[str, np.ndarray]:
    """Every leaf's gradient; a leaf the loss does not reach gets zeros, as
    in JAX."""
    return {k: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape)) for k, p in params.items()}


def _port_value_and_grad(js, cfg, target):
    ts = _port(js)
    params = scene_to_params(ts, atlas=True)
    img = T.render(combine(params, ts), cfg)
    loss = l2_image_loss(img, torch.tensor(target))
    loss.backward()
    return float(loss.detach()), _grads(params), img.detach().numpy()


def _assert_close(got, want, rtol, what, image_atol=IMAGE_ATOL):
    (g_loss, g_grads, g_img), (w_loss, w_grads, w_img) = got, want
    np.testing.assert_allclose(g_img, w_img, rtol=0, atol=image_atol, err_msg=what)
    assert abs(g_loss - w_loss) <= 1e-12 * abs(w_loss), (g_loss, w_loss)
    assert g_grads.keys() == w_grads.keys()
    for key in w_grads:
        scale = max(float(np.abs(w_grads[key]).max()), 1e-12)
        np.testing.assert_allclose(g_grads[key], w_grads[key], rtol=0, atol=rtol * scale, err_msg=f"{what}: {key}")
    assert (np.abs(g_grads["textures.atlas"]) > 0).sum() > 10


SMOOTH_SCENES = {
    "texture_task_48x27": lambda: jscenes.texture_task_scene(_task_texture(), 48, 27, dtype=jnp.float64),
    "atlas24_32x18": _atlas_many_scene,
}


@pytest.mark.parametrize("name", SMOOTH_SCENES)
def test_pure_smooth_route_matches_jax_grad(name):
    """Torch autograd through the pure-torch route (libm UV, the atlas's
    gradient through the gather) against jax.grad of the XLA path, depth 2."""
    js = SMOOTH_SCENES[name]()
    target, jcfg, tcfg = _loss_setup(js, 2)
    _assert_close(_port_value_and_grad(js, tcfg, target), _jax_value_and_grad(js, jcfg, target), GRAD_RTOL["pure"],
                  name)


# --- the kernel routes' plain versions against JAX's Pallas routes --------------


def test_hard_bounce_body_texels_match_jax():
    """The atlas mode of the hard kernel body: ``bounce_math``'s flat ids
    equal ``_bounce_math``'s exactly, and dww within 1e-15, two bounces."""
    js = _atlas_many_scene()
    ts = _port(js)
    d_t = jax_rays_t(js.camera, jnp.float64)
    n = d_t.shape[1]
    s = js.spheres.count
    kw = dict(faraway=J.RenderConfig(dtype=jnp.float64).faraway, s_cheap=s - js.spheres.n_exact)
    jt = (_geometry_table(js, jnp.float64), _material_table(js, jnp.float64)[:s], _consts_row(js, jnp.float64))
    tt = (geometry_table(ts, torch.float64), material_table(ts, torch.float64), consts_row(ts, torch.float64))
    jo = tuple(jnp.broadcast_to(js.camera.position[i], (n,)) for i in range(3))
    jd = (d_t[0], d_t[1], d_t[2])
    to = tuple(torch.tensor(np.asarray(x)) for x in jo)
    td = tuple(torch.tensor(np.asarray(x)) for x in jd)
    jthr = jal = jnp.ones((n,), jnp.float64)
    tthr = tal = torch.ones(n, dtype=torch.float64)
    images = 0
    for _ in range(2):
        _, jo, jd, jthr, jal, jflat, jdww = _bounce_math(jo, jd, jthr, jal, *jt, s_total=s, parts="full",
                                                         tex_hw=(16, 32), xi=None, **kw)
        _, to, td, tthr, tal, tflat, tdww = tbs.bounce_math(to, td, tthr, tal, *tt, tex_hw=(16, 32), **kw)
        np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
        np.testing.assert_allclose(tdww.numpy(), np.asarray(jdww), rtol=0, atol=1e-15)
        images += int((tflat > 0).sum())
    assert images > 20


def _trace_pair(js, ts, jtrace, ttrace, jdtype, tdtype):
    want = np.asarray(_oracle(lambda sc: jtrace(sc.camera.position, jax_rays_t(sc.camera, jdtype), sc), js))
    got = ttrace(ts.camera.position, ray_directions_t(ts.camera, tdtype), ts).numpy()
    return got, want


@pytest.mark.parametrize("depth", [2, 1])
def test_sub_hard_route_matches_jax_interpret(depth):
    """``trace_deep`` (depth 2) and ``bounce_step`` (depth 1) in their atlas
    mode, plain versions with the texels composed, against JAX's sublane
    kernels in interpret mode: within 1e-12, no seam lane (the same UV)."""
    from python_ray_tracer_tpu.ops.pallas_bounce_sub import trace_fused_sub as jtrace

    js = jscenes.texture_task_scene(_task_texture(), 32, 18, dtype=jnp.float64)
    jcfg = J.RenderConfig(max_depth=depth, dtype=jnp.float64, use_pallas=True, pallas_interpret=True)
    tcfg = T.RenderConfig(max_depth=depth, dtype=torch.float64, use_pallas=True)
    ts = _port(js)
    assert hard_route(ts, tcfg, None) == "sub"
    got, want = _trace_pair(js, ts, lambda o, d, sc: jtrace(o, d, sc, jcfg, transposed=True),
                            lambda o, d, sc: tbs.trace_fused_sub(o, d, sc, tcfg), jnp.float64, torch.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert tbs.LAUNCHES == tbs.ATLAS_LAUNCHES == {"trace_deep": 0, "bounce_step": 0}


@pytest.fixture(scope="module")
def jax_sub_smooth():
    """JAX's sublane smooth route in interpret mode on the texture task at
    32x18: the value-and-grad (atlas leaf included) and the frame at depth 2
    (the depth-fused pair) and depth 1 (the one-bounce pair)."""
    js = jscenes.texture_task_scene(_task_texture(), 32, 18, dtype=jnp.float64)
    out = {}
    for depth in (2, 1):
        target, jcfg, tcfg = _loss_setup(js, depth, use_pallas=True, pallas_interpret=True)
        out[depth] = (target, tcfg, _jax_value_and_grad(js, jcfg, target))
    return js, out


@pytest.mark.parametrize("depth", [2, 1])
def test_sub_smooth_route_matches_jax_interpret(jax_sub_smooth, depth):
    """The smooth pair's atlas mode (``smooth_fwd_deep``/``smooth_bwd_deep``
    at depth 2, ``smooth_fwd_step``/``smooth_bwd_step`` at depth 1), plain
    versions, the texels composed outside: frame, loss and every gradient
    leaf against JAX's sublane kernels' custom VJP."""
    js, out = jax_sub_smooth
    target, tcfg, want = out[depth]
    assert smooth_route(_port(js), tcfg, 32 * 18, None) == "sub"
    _assert_close(_port_value_and_grad(js, tcfg, target), want, TASK_KERNEL_RTOL, f"depth {depth}", 1e-12)
    assert bss.ATLAS_LAUNCHES == dict.fromkeys(bss.ATLAS_LAUNCHES, 0)


# --- routing ----------------------------------------------------------------------


def _routing_scene(n_spheres, texels, n_exact=1):
    """A scene of ``n_spheres`` spheres (``n_exact`` huge ones) with every 4th
    image-textured, and an atlas of ``texels`` texels (0: no atlas)."""
    rows = [T.make_sphere_row((float(i % 12) - 6.0, 0.0, 5.0 + i // 12), 0.3,
                              texture_kind=T.TEXTURE_IMAGE if texels and i % 4 == 0 else 0)
            for i in range(n_spheres - n_exact)]
    rows += [T.make_sphere_row((0.0, -99999.5 - i, 0.0), 99999.0) for i in range(n_exact)]
    atlas = np.full((1, 8, texels // 8, 3), 0.5) if texels else None
    return T.make_scene(T.build_spheres(rows), T.build_lights((-2.0, 1.0, 2.0)), (0.0, 0.2, -2.0), 8, 4,
                        texture_atlas=atlas)


def _jax_route(js, cfg, key):
    """The kernels JAX's ``_render_sample`` and ``trace`` pick for an atlas
    scene: "culled", "sub", "lane" (its lane kernel), "sweeps" (``trace``
    with the sweep kernels) or, smooth, "kernels" / "pure"."""
    from python_ray_tracer_tpu.ops.pallas_bounce_smooth_sub import MAX_BLK_SPHERES_SMOOTH

    s = js.spheres.count
    smooth = cfg.visibility == "smooth"
    key_ok = key is None or (s <= 64 if not smooth else s <= MAX_BLK_SPHERES_SMOOTH)
    if not (jrender._can_fuse_bounce(js, cfg) and key_ok):
        return "pure" if smooth else "sweeps"
    if smooth:
        return "kernels"
    if key is None and s >= 96 and js.spheres.n_exact <= 8 and cfg.max_depth <= jcul.MAX_CULL_DEPTH:
        return "culled"
    return "sub" if s <= 64 else "lane"


ROUTING = [
    (24, 512, "hard", None), (64, 1 << 20, "hard", None), (80, 1 << 15, "hard", None), (80, (1 << 15) + 8, "hard", None),
    (128, 1 << 20, "hard", None), (128, 1 << 20, "hard", 7), (96, 4096, "hard", None), (96, 4096, "hard", 7),
    (96, 512, "hard", None, 9), (24, 512, "smooth", None), (4096, 512, "smooth", None), (4097, 512, "smooth", None),
    (4097, 512, "smooth", 7), (4097, 0, "smooth", None),
]


@pytest.mark.parametrize("case", ROUTING, ids=lambda c: "-".join(map(str, c)))
def test_atlas_routing_matches_jax(case):
    """``hard_route``/``smooth_route`` with an atlas take the JAX renderer's
    route, its lane kernel's scenes (atlases of at most MAX_FUSED_TEXELS
    texels) included."""
    n_spheres, texels, vis, key, *n_exact = case
    ts = _routing_scene(n_spheres, texels, *n_exact)
    js = jax.tree_util.tree_map(jnp.asarray, _jax_scene_like(ts))
    tcfg = T.RenderConfig(max_depth=3, visibility=vis, use_pallas=True, stochastic_roughness=key is not None)
    jcfg = J.RenderConfig(max_depth=3, visibility=vis, use_pallas=True, stochastic_roughness=key is not None)
    want = _jax_route(js, jcfg, key)
    if vis == "smooth":
        got = smooth_route(ts, tcfg, 32, key)
        assert ("pure" if got == "pure" else "kernels") == want
        return
    assert hard_route(ts, tcfg, key) == want


def _jax_scene_like(ts):
    """The port scene ``ts`` as a JAX scene, the same arrays."""
    from python_ray_tracer_tpu.scene import Camera, Lights, Scene, Spheres

    arrays = scene_to_numpy(ts)

    def build(cls, prefix, **static):
        names = [f.name for f in dataclasses.fields(cls) if f.name not in static]
        return cls(**{n: jnp.asarray(arrays[f"{prefix}.{n}"]) for n in names}, **static)

    return Scene(
        spheres=build(Spheres, "spheres", n_exact=ts.spheres.n_exact),
        lights=build(Lights, "lights"),
        camera=build(Camera, "camera", width=ts.camera.width, height=ts.camera.height),
        texture_atlas=jnp.asarray(arrays["texture_atlas"]),
        texture_hw=jnp.asarray(arrays["texture_hw"]),
    )


# --- compose_texels -------------------------------------------------------------


def test_compose_texels_backward_is_the_scatter_add():
    """The texel gradient equals a sequential scatter-add bit for bit (and
    itself across two calls), dww's is the dot with the gathered texel, and
    acc's passes through."""
    rng = np.random.default_rng(5)
    n, n_texels = 5000, 64
    texels = torch.tensor(rng.uniform(0, 1, (n_texels, 3)), requires_grad=True)
    flat = torch.tensor(rng.integers(0, n_texels, n), dtype=torch.int32)
    dww = torch.tensor(np.where(rng.uniform(size=n) < 0.3, 0.0, rng.uniform(0, 1, n)), requires_grad=True)
    acc = torch.tensor(rng.uniform(0, 1, (3, n)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(3, n)))
    out = ttex.compose_texels(acc, texels, flat, dww)
    np.testing.assert_array_equal(out.detach().numpy(), (acc + texels[flat.long()].T * dww).detach().numpy())
    grads = [torch.autograd.grad(ttex.compose_texels(acc, texels, flat, dww), (acc, texels, dww), g) for _ in range(2)]
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    g_acc, g_texels, g_dww = grads[0]
    np.testing.assert_array_equal(g_acc.numpy(), g.numpy())
    want = torch.zeros((n_texels, 3), dtype=torch.float64).index_add_(0, flat.long(), (g * dww.detach()).T)
    np.testing.assert_array_equal(g_texels.numpy(), want.numpy())
    tex = texels.detach()[flat.long()].T
    np.testing.assert_array_equal(g_dww.numpy(), (g[0] * tex[0] + g[1] * tex[1] + g[2] * tex[2]).numpy())
