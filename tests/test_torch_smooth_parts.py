"""The per-shard sweeps of the sphere-sharded path against JAX's kernels.

The plain versions of ``smooth_nearest_parts``, ``clear_fwd``/``clear_bwd``
and ``shadow_parts`` against ``smooth_nearest_parts_pallas``,
``smooth_clear_parts_pallas`` and ``shadow_parts_pallas`` in interpret mode
(256 rays, 24 spheres of one shard, the last 4 in the exact tier, f32 and
f64), with rows that tie exactly and self indices out of the shard's range;
then the port's two autograd Functions against ``jax.vjp`` of the same JAX
functions.  Each JAX oracle compiles once a dtype, with XLA's fusion (FMA
contraction) off.  The CUDA kernels are held against the plain versions on
the card by ``chip_smoke.py``.

The JAX kernels pad each tier to their sphere block with zero-radius rows
whose indices run on past the tier's end: the cheap tier's padding takes
the exact tier's first indices, the exact tier's the indices after the
table.  The port sweeps the real rows only.  Where that shows, this file
checks the difference as it is: a ray whose largest discriminant is a
padding row's, and self indices in the padding's range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import python_ray_tracer_tpu as J  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_intersect import shadow_parts_pallas  # noqa: E402
from python_ray_tracer_tpu.ops.pallas_smooth_parts import (  # noqa: E402
    smooth_clear_parts_pallas,
    smooth_nearest_parts_pallas,
)
from python_ray_tracer_tpu_torch.ops import intersect_fused as tif  # noqa: E402
from python_ray_tracer_tpu_torch.ops import smooth_parts as sp  # noqa: E402

ORACLE_XLA_OPTIONS = {"xla_disable_hlo_passes": "fusion,algsimp"}
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
N_RAYS, N_SPHERES, N_EXACT = 256, 24, 4
S_CHEAP = N_SPHERES - N_EXACT
SHARPNESS = 200.0
LIGHT = (2.0, 12.0, -3.0)  # the point the shadow rays aim at
# Rows 5 and 9 repeat rows 2 and 3: exact ties of t and disc.
TWINS = {5: 2, 9: 3}
# Lanes whose self index is out of the shard's range, and one inside the
# range of the JAX exact tier's padding rows (24..31).
OUT_OF_RANGE = {7: -1, 8: N_SPHERES + 40, 9: N_SPHERES + 1}
PAD_SELF_LANE = 9
# The lane aimed 30 units beside the JAX cheap tier's padding row
# (0, -1e4, 0) from far off, missing every real sphere by more.  (A ray
# through that point itself can round to a strict hit on the padding row,
# which JAX then reports as the exact-tier row of the same index.)
PAD_DMAX_LANE = 0
# Relative tolerances (of each output's largest magnitude) of the plain
# versions against the JAX kernels: both evaluate the same expressions in
# one order (XLA without FMA contraction), so the forward outputs agree bit
# for bit but the f64 shadow product (1.1e-16: the JAX kernels multiply a
# block of rows first, the port row by row); the VJPs (10 x RTOL) part only
# in the geometry sums over the rays (measured 1.5e-7 f32, 1.3e-16 f64).
RTOL = {"float32": 1e-6, "float64": 1e-13}


def _oracle(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ORACLE_XLA_OPTIONS)(*args)


def _inputs(seed=3):
    """A shard of 24 spheres (the last 4 in the exact tier: a ground of
    radius 999 and three spheres far off the origin) and 256 rays from the
    camera's side, most of them aimed at a sphere."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-4.0, -1.0, -2.0], [4.0, 3.0, 6.0], (N_SPHERES, 3))
    r = rng.uniform(0.3, 1.0, N_SPHERES)
    c[S_CHEAP:] = [[0.0, -1000.0, 0.0], [3000.0, 2.0, 1.0], [-2500.0, 1.0, 40.0], [1.0, 2.0, 3000.0]]
    r[S_CHEAP:] = [999.0, 400.0, 300.0, 600.0]
    for a, b in TWINS.items():
        c[a], r[a] = c[b], r[b]
    o = rng.uniform([-6.0, 0.0, -9.0], [6.0, 4.0, -6.0], (N_RAYS, 3))
    aim = c[rng.integers(0, S_CHEAP, N_RAYS)] + rng.normal(0.0, 0.8, (N_RAYS, 3))
    d = aim - o
    d[::5] = rng.normal(0.0, 1.0, (len(d[::5]), 3))  # every fifth ray anywhere
    o[PAD_DMAX_LANE] = [5000.0, 0.0, 0.0]
    d[PAD_DMAX_LANE] = np.array([0.0, -1.0e4, 30.0]) - o[PAD_DMAX_LANE]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, c, r


@pytest.fixture(scope="module")
def oracles():
    """For each dtype: the inputs, JAX's three kernels' outputs, and their
    VJPs at seeded cotangents."""
    out = {}
    o, d, c, r = _inputs()
    rng = np.random.default_rng(11)
    cots = rng.normal(0.0, 1.0, (6, N_RAYS))
    for name, (jdt, _) in DTYPES.items():
        far = J.faraway(jdt)
        args = tuple(jnp.asarray(a, jdt) for a in (o, d, c, r))

        def nearest(o_, d_, c_, r_, g):
            parts, vjp = jax.vjp(
                lambda *a: tuple(smooth_nearest_parts_pallas(*a, far, n_exact=N_EXACT, interpret=True)), o_, d_, c_, r_
            )
            # cotangents of (t, idx, sol_w, disc_w, dmax, fidx, sol_f); none for the indices
            zero_i = np.zeros((N_RAYS,), jax.dtypes.float0)
            return parts, vjp((g[0], zero_i, g[1], g[2], g[3], zero_i, g[4]))

        parts, grads = _oracle(nearest, *args, jnp.asarray(cots[:5], jdt))
        parts = [np.asarray(x) for x in parts]
        idx = parts[1].astype(np.int32)
        self_idx = idx.copy()
        for lane, v in OUT_OF_RANGE.items():
            self_idx[lane] = v
        t = parts[0]
        p = o + d * np.where(t != far, t, 1.0)[:, None]
        to_light = np.array(LIGHT) - p
        to_light /= np.linalg.norm(to_light, axis=1, keepdims=True)
        p = p - 1e-3 * d
        sargs = tuple(jnp.asarray(a, jdt) for a in (p, to_light, c, r))
        jself = jnp.asarray(self_idx)

        def clear(o_, d_, c_, r_, s_, g):
            val, vjp = jax.vjp(
                lambda oo, dd, cc, rr: smooth_clear_parts_pallas(oo, dd, cc, rr, s_, far, SHARPNESS, n_exact=N_EXACT,
                                                                 interpret=True), o_, d_, c_, r_)
            return val, vjp(g)

        clear_val, clear_grads = _oracle(clear, *sargs, jself, jnp.asarray(cots[5], jdt))
        shadow = _oracle(lambda *a: shadow_parts_pallas(*a, far, n_exact=N_EXACT, interpret=True), *sargs, jself)
        out[name] = dict(
            far=far, ray=(o, d), shadow_ray=(p, to_light), c=c, r=r, self_idx=self_idx, cots=cots,
            parts=parts, grads=[np.asarray(x) for x in grads], clear=np.asarray(clear_val),
            clear_grads=[np.asarray(x) for x in clear_grads], shadow=[np.asarray(x) for x in shadow],
        )
    return out


def _t(a, dtype, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype).requires_grad_(requires_grad)


def _geom(case, dtype, requires_grad=False):
    return _t(np.concatenate([case["c"], case["r"][:, None]], axis=1), dtype, requires_grad)


def _close(name, got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max abs error {err:.3e} against scale {scale:.3e} (limit {rtol:g})"


@pytest.mark.parametrize("dtype", DTYPES)
def test_nearest_parts_plain_matches_jax(oracles, dtype):
    """Winner ``(t, idx)``, its raw ``(sol_w, disc_w)`` and the fallback
    ``(dmax, fidx, sol_f)``: indices exactly (the lowest index wins a tie),
    values within RTOL, on every lane but the one a JAX padding row wins."""
    case, tdt = oracles[dtype], DTYPES[dtype][1]
    o, d = (_t(a, tdt) for a in case["ray"])
    got = sp.smooth_nearest_parts_plain(o, d, _geom(case, tdt), faraway=case["far"], s_cheap=S_CHEAP)
    want = case["parts"]
    keep = np.arange(N_RAYS) != PAD_DMAX_LANE
    for name, g, w in zip(sp.SmoothParts._fields, got, want):
        g = g.numpy()
        if name in ("idx", "fidx"):
            np.testing.assert_array_equal(g[keep], w[keep].astype(np.int32), err_msg=name)
        else:
            _close(name, g[keep], w[keep], RTOL[dtype])
    idx, fidx = got.idx.numpy(), got.fidx.numpy()
    hits = got.t.numpy() != case["far"]
    assert hits.sum() > N_RAYS // 2 and (~hits).sum() > 10, "the rays should both hit and miss"
    for twin, first in TWINS.items():
        assert not np.any(idx == twin) and not np.any(fidx == twin), "a tie goes to the lower index"
        assert np.any(idx == first), f"row {first} should win some lanes"
    # The padding lane: JAX's fallback is its cheap-tier padding row (index
    # 20..23, an exact-tier row's), with a larger disc than any real row's.
    lane = PAD_DMAX_LANE
    assert not hits[lane]
    assert S_CHEAP <= want[5][lane] < S_CHEAP + 8 and want[4][lane] > got.dmax[lane].item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_clear_and_shadow_parts_plain_match_jax(oracles, dtype):
    """The shadow product and the hard-shadow partials on the shadow rays
    of the nearest hits, self indices in and out of range."""
    case, tdt = oracles[dtype], DTYPES[dtype][1]
    o, d = (_t(a, tdt) for a in case["shadow_ray"])
    geom = _geom(case, tdt)
    self_idx = torch.tensor(case["self_idx"], dtype=torch.int32)
    clear = sp.clear_fwd_plain(o, d, geom, self_idx, faraway=case["far"], sharpness=SHARPNESS, s_cheap=S_CHEAP)
    _close("clear", clear.numpy(), case["clear"], RTOL[dtype])
    assert 0.05 < float((clear < 0.999).float().mean()) < 0.95, "some lanes should be shadowed"
    t_others, t_self = tif.shadow_parts_plain(o, d, geom, self_idx, faraway=case["far"], s_cheap=S_CHEAP)
    w_others, w_self = case["shadow"]
    keep = np.arange(N_RAYS) != PAD_SELF_LANE
    np.testing.assert_allclose(t_others.numpy(), w_others, rtol=RTOL[dtype])
    np.testing.assert_allclose(t_self.numpy()[keep], w_self[keep], rtol=RTOL[dtype])
    big = tif._BIG[tdt]
    assert np.all(t_self.numpy()[list(OUT_OF_RANGE)] == big), "an out-of-range self index matches no sphere"
    # JAX's exact-tier padding row answers to index 25 (faraway, never a
    # hit); either value loses to the owning shard's t_self in the minimum.
    assert w_self[PAD_SELF_LANE] == case["far"]
    lit = (t_self <= t_others).numpy()
    assert lit.any() and not lit.all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_clear_parts_given_the_light_match_jax(oracles, dtype):
    """``smooth_clear_parts`` given the light its shadow rays aim at (which
    only the card kernel's skip reads), and ``clear_fwd_plain`` over the
    pairs that skip keeps, against JAX's ``_clear_fwd_kernel``."""
    case, tdt = oracles[dtype], DTYPES[dtype][1]
    o, d = (_t(a, tdt) for a in case["shadow_ray"])
    geom = _geom(case, tdt)
    self_idx = torch.tensor(case["self_idx"], dtype=torch.int32)
    kw = dict(faraway=case["far"], sharpness=SHARPNESS, s_cheap=S_CHEAP)
    light = torch.tensor(LIGHT, dtype=tdt)
    _close("clear given the light", sp.smooth_clear_parts(o, d, geom, self_idx, **kw, light=light).numpy(),
           case["clear"], RTOL[dtype])
    _close("clear over the kept pairs", sp.clear_fwd_plain(o, d, geom, self_idx, **kw, skip=True, light=light).numpy(),
           case["clear"], RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_functions_match_jax_vjp(oracles, dtype):
    """The two autograd Functions' backward passes against ``jax.vjp`` of
    JAX's custom_vjps: the nearest parts' row adjoints summed into the
    shard's geometry, and ``clear_bwd``'s lane and per-sphere gradients."""
    case, tdt = oracles[dtype], DTYPES[dtype][1]
    rtol = RTOL[dtype] * (10 if dtype == "float32" else 1)
    keep = np.arange(N_RAYS) != PAD_DMAX_LANE
    o, d = (_t(a, tdt, True) for a in case["ray"])
    geom = _geom(case, tdt, True)
    parts = sp.smooth_nearest_parts(o, d, geom, faraway=case["far"], s_cheap=S_CHEAP)
    cots = torch.tensor(case["cots"], dtype=tdt) * torch.tensor(keep, dtype=tdt)
    loss = sum((x * g).sum() for x, g in zip((parts.t, parts.sol_w, parts.disc_w, parts.dmax, parts.sol_f), cots))
    loss.backward()
    g_o, g_d, g_c, g_r = case["grads"]
    # JAX's VJP ran with the padding lane's cotangents too: compare the
    # lanes, and the geometry after taking that lane's rows out.
    _close("g_o", o.grad.numpy()[keep], g_o[keep], rtol)
    _close("g_d", d.grad.numpy()[keep], g_d[keep], rtol)
    want_geom = np.concatenate([g_c, g_r[:, None]], axis=1)
    lane_rows = _lane_rows(case, tdt, PAD_DMAX_LANE)
    _close("g_geom", geom.grad.numpy(), want_geom - lane_rows, rtol)

    o, d = (_t(a, tdt, True) for a in case["shadow_ray"])
    geom = _geom(case, tdt, True)
    self_idx = torch.tensor(case["self_idx"], dtype=torch.int32)
    clear = sp.smooth_clear_parts(o, d, geom, self_idx, faraway=case["far"], sharpness=SHARPNESS, s_cheap=S_CHEAP)
    (clear * torch.tensor(case["cots"][5], dtype=tdt)).sum().backward()
    g_o, g_d, g_c, g_r = case["clear_grads"]
    _close("clear g_o", o.grad.numpy(), g_o, rtol)
    _close("clear g_d", d.grad.numpy(), g_d, rtol)
    _close("clear g_geom", geom.grad.numpy(), np.concatenate([g_c, g_r[:, None]], axis=1), rtol)


def _lane_rows(case, tdt, lane):
    """The (S, 4) geometry-gradient rows JAX's VJP took from ``lane``: its
    winner row's and its fallback row's adjoints (the fallback row being
    JAX's padding-row index)."""
    o, d = (_t(a[lane : lane + 1], tdt) for a in case["ray"])
    geom = _geom(case, tdt)
    parts = case["parts"]
    g = case["cots"][:, lane]
    rows = np.zeros((N_SPHERES, 4))
    t = parts[0][lane]
    hit = t != case["far"]
    for idx, g_sol, g_disc in ((int(parts[1][lane]), (g[1] + g[0]) * hit, g[2] * hit),
                               (int(parts[5][lane]), g[4], g[3])):
        _, _, r = sp._row_adjoint(o, d, geom, torch.tensor([idx]), torch.tensor([g_sol], dtype=tdt),
                                  torch.tensor([g_disc], dtype=tdt))
        rows[idx] += r[0].numpy()
    return rows
