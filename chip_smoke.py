#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of ``python_ray_tracer_tpu_torch`` from
``csrc/`` (one ``nvcc`` per source, all at once), holds each kernel
against its plain PyTorch version on the card (mirror and glossy xi
continuations), shows the card's per-ray RNG draw bitwise equal to the
CPU's and to JAX's, and drives the port's main paths through the kernels
at 960x540:

* the hard forward render: the ``render`` CLI, held against the JAX
  package's golden image (``trace_deep``, ``bounce_step``);
* the smooth-visibility training step: ``render --visibility smooth``
  (``smooth_fwd_deep``), a non-L2 loss backpropagated through ``render()``
  (``smooth_bwd_deep``), ``optimize`` and the first Adam step's loss and
  gradients against the JAX golden (``train_deep``), and a recovery task
  whose loss must halve;
* sampling: ``render --stochastic-roughness`` against a JAX golden,
  ``--spp 4``, the smooth stochastic and depth-1 renders, ``optimize
  --stochastic-roughness`` and its first step against a JAX golden;
* the one-bounce smooth pair: a loss through ``render()`` at smooth depth
  1 (``smooth_fwd_step``, ``smooth_bwd_step``) against torch autograd;
* the big-scene hard render, BASELINE config 4 (``random1024``, 1920x1080,
  depth 4): the mirror CLI frame through the culled pair (``near_culled``,
  ``shade_culled``) against a JAX golden, and the ``--stochastic-roughness``
  frame through the standalone sweeps (``nearest_sweep``, ``shadow_sweep``)
  against the pure-torch route; each of the four kernels first against its
  plain version on its main path's real inputs, f32 at 1920x1080 and f64 at
  480x270.

Then it times every kernel (and each one's glossy variant) beside its plain
version and its bound, the benchmark's Adam step and the stochastic one,
and the config-4 frames with a ``torch.profiler`` split of the mirror one.
Phases print on their own lines; any failure exits non-zero.  The line
before the last lists the kernels as JSON; the last line is one JSON
object: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 960, 540
N_RAYS = WIDTH * HEIGHT
GOLDEN = "python_ray_tracer_tpu_torch/testdata/reference_960x540_d3_f32.npz"
TRAIN_GOLDEN = "python_ray_tracer_tpu_torch/testdata/reference_960x540_d3_smooth_train_f32.npz"
# JAX goldens of the sampled paths at seed SEED: the hard stochastic frame
# with the first and last 4,096 lanes of its first bounce's xi draw, and the
# stochastic training loss's first step (f32 and f64).
STOCH_GOLDEN = "python_ray_tracer_tpu_torch/testdata/reference_960x540_d3_stochastic_f32.npz"
STOCH_TRAIN_GOLDEN = "python_ray_tracer_tpu_torch/testdata/reference_960x540_d3_smooth_train_stochastic_f32.npz"
SEED = 7
HARD = ("trace_deep", "bounce_step")
SMOOTH = ("smooth_fwd_deep", "smooth_bwd_deep", "train_deep", "smooth_fwd_step", "smooth_bwd_step")
CULLED = ("near_culled", "shade_culled")
SWEEPS = ("nearest_sweep", "shadow_sweep")
SOURCE = {
    **{k: "python_ray_tracer_tpu_torch/csrc/bounce_sub.cu" for k in HARD},
    **{k: "python_ray_tracer_tpu_torch/csrc/bounce_smooth_sub.cu" for k in SMOOTH},
    **{k: "python_ray_tracer_tpu_torch/csrc/culled.cu" for k in CULLED},
    **{k: "python_ray_tracer_tpu_torch/csrc/intersect_fused.cu" for k in SWEEPS},
}
# BASELINE config 4: random_spheres_scene, 1024 spheres, 1920x1080, depth 4;
# the f64 kernel checks at a quarter of the width and height.
BIG_SPHERES, BIG_WIDTH, BIG_HEIGHT, BIG_DEPTH = 1024, 1920, 1080, 4
BIG_F64_SIZE = (480, 270)
BIG_GOLDEN = "python_ray_tracer_tpu_torch/testdata/random1024_1920x1080_d4_f32.npz"
# Rays per chunk of the pure-torch reference of the glossy config-4 frame
# (its (N, S) tables would not fit whole).
PURE_CHUNK = 32768
DEVICE = "cuda"
REPLACES = {
    "near_culled": "python_ray_tracer_tpu/ops/pallas_culled.py:609",
    "shade_culled": "python_ray_tracer_tpu/ops/pallas_culled.py:691",
    "nearest_sweep": "python_ray_tracer_tpu/ops/pallas_intersect.py:181",
    "shadow_sweep": "python_ray_tracer_tpu/ops/pallas_intersect.py:384",
    "trace_deep": "python_ray_tracer_tpu/ops/pallas_bounce_sub.py:416",
    "bounce_step": "python_ray_tracer_tpu/ops/pallas_bounce_sub.py:382",
    "smooth_fwd_deep": "python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:1329",
    "smooth_bwd_deep": "python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:1370",
    "train_deep": "python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:1799",
    "smooth_fwd_step": "python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:544",
    "smooth_bwd_step": "python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:1040",
}
# Kernel vs plain version: at most this share of values may differ by more
# than the dtype's threshold.  The two evaluate the same IEEE operations in
# the same order (no FMA contraction on either side), so they part only
# where pow/sin round differently and a hit or shadow test flips on it.
MAX_BAD_SHARE = 1e-4
THRESHOLD = {torch.float32: 1e-5, torch.float64: 1e-12}
# The per-ray gradients (g_o, g_d), kernel vs plain version, take the same
# operations in the same order too: every value within RAY_GRAD_TOL of
# max(1, |plain value|), since silhouette rays carry gradients up to ~1e8
# where interior rays carry ~1.  Bitwise equal on the reference scene (f64:
# within 6e-20); on all_effects, whose forward is bitwise equal, a few
# hundred of 1.5M f32 values part by up to 1.2e-4 of it in the adjoint.
RAY_GRAD_TOL = {torch.float32: 1e-3, torch.float64: 1e-12}
# The table gradients sum 518,400 rays per warp and then over warps, where
# the plain version's torch.sum associates otherwise.  Each column (one
# parameter field; each scene constant) is held within COLUMN_RTOL of that
# column's own largest value; readings reach 3.1e-6 (f32) and 2.6e-15 (f64).
COLUMN_RTOL = {torch.float32: 3e-5, torch.float64: 1e-12}
# Main path vs the JAX golden: share of uint8 values allowed to differ.
MAX_GOLDEN_SHARE = 1e-3
# A float32 gradient of this loss is only as exact as float32 allows: the
# JAX golden's own f32 gradient is 14% off its f64 one on the smallest leaf
# (d/d specular_roughness, 7e-6) and 0.35% on the radii.  So a float32
# route is held against the float64 answer, and may be off it by at most
# NOISE_FACTOR times what a peer f32 route (torch autograd of the
# pure-torch route, or the XLA path of the golden) is, plus NOISE_FLOOR of
# the leaf's largest value: no less exact than the peer, within that factor.
NOISE_FACTOR = 3.0
NOISE_FLOOR = 1e-5
# float64: the kernels' adjoint vs an exact autograd (torch's of the
# pure-torch route, or JAX's of the XLA path in a golden), relative to each
# leaf's largest value.  They differ where the quadratic's form differs and
# where Phase C divides by max(1 - occlusion, 1e-6), as the JAX kernels'
# adjoint does, while autograd takes the exact product rule: on lanes deep
# in another sphere's shadow.  The smooth depth-1 loss weighs those lanes
# most and reads closest to this limit.
F64_RTOL = 1e-6
# The published peaks of one H100 SXM (NVIDIA's datasheet): HBM
# bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"[device] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible", flush=True)
    return card


def phase_build() -> None:
    from python_ray_tracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for source, (path, log, seconds) in _build.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")
        _build.load_library(source)
        print(f"[build] {path.name} built in {seconds:.1f} s")
    print(f"[build] all sources built in {time.perf_counter() - t0:.1f} s", flush=True)


def _inputs(name: str, dtype: torch.dtype, device: str, width: int, height: int):
    """Camera rays and kernel tables of a built-in scene, as trace_fused_sub makes them."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.config import faraway
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops.tables import consts_row, geometry_table, material_table

    scene = getattr(scenes, f"{name}_scene")(width, height, dtype=dtype, device=device)
    d = ray_directions_t(scene.camera, dtype)
    o = scene.camera.position.reshape(3, 1).expand(d.shape).contiguous()
    tables = (geometry_table(scene, dtype), material_table(scene, dtype), consts_row(scene, dtype))
    s_cheap = scene.spheres.count - scene.spheres.n_exact
    return o, d, tables, dict(faraway=faraway(dtype), s_cheap=s_cheap)


def _trace_key() -> int:
    """The trace key of render()'s sample 0 at seed SEED (spp 1)."""
    from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root

    return fold_seed(fold_seed(seed_root(SEED), 0), 4)


def _xis(stochastic: bool, n: int, depth: int, dtype: torch.dtype, device: str = "cuda") -> list:
    """Each bounce's (2, N) xi on the main path's schedule, or Nones."""
    from python_ray_tracer_tpu_torch.ops.rng import bounce_xi

    return bounce_xi(_trace_key(), n, depth, dtype, device) if stochastic else [None] * depth


def _run_case(route: str, name: str, depth: int, dtype: torch.dtype, device: str, width: int, height: int,
              stochastic: bool = False):
    """(kernel acc, plain acc) of one case; the wrapper on CUDA tensors launches the kernel."""
    from python_ray_tracer_tpu_torch.ops import bounce_sub as bs

    o, d, tables, kw = _inputs(name, dtype, device, width, height)
    xis = _xis(stochastic, d.shape[1], depth, dtype, device)
    if route == "trace_deep":
        xi = torch.cat(xis) if stochastic else None
        return bs.trace_deep(o, d, *tables, xi, depth=depth, **kw), bs.trace_deep_plain(o, d, *tables, xi, depth=depth, **kw)
    outs = []
    for step in (bs.bounce_step, bs.bounce_step_plain):
        state = (o, d, torch.ones_like(d[0]), torch.ones_like(d[0]), torch.zeros_like(d))
        for xi in xis:
            state = step(*state, *tables, xi, **kw)
        outs.append(state[4])
    return tuple(outs)


CASES = (
    ("trace_deep", "reference", 3, torch.float32, False),
    ("trace_deep", "reference", 6, torch.float32, False),
    ("trace_deep", "all_effects", 3, torch.float32, False),
    ("bounce_step", "reference", 1, torch.float32, False),
    ("bounce_step", "reference", 12, torch.float32, False),
    ("trace_deep", "reference", 3, torch.float64, False),
    ("trace_deep", "reference", 3, torch.float32, True),
    ("trace_deep", "all_effects", 3, torch.float32, True),
    ("bounce_step", "reference", 3, torch.float32, True),
    ("trace_deep", "reference", 3, torch.float64, True),
)


def _per_value_check(label: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype) -> float:
    """At most MAX_BAD_SHARE of the values may differ by more than the dtype's threshold."""
    if kernel.dtype.is_floating_point and not bool(torch.isfinite(kernel).all()):
        fail(f"{label}: non-finite output")
    diff = (kernel.double() - plain.double()).abs()
    max_abs = float(diff.max())
    n_bad = int((diff > THRESHOLD[dtype]).sum())
    print(f"[kernels] {label}: max_abs {max_abs:.3e}, {n_bad} of {diff.numel()} values > {THRESHOLD[dtype]:g}")
    if n_bad > MAX_BAD_SHARE * diff.numel():
        fail(f"{label}: {n_bad / diff.numel():.2e} of values differ by more than {THRESHOLD[dtype]:g} (limit {MAX_BAD_SHARE:g})")
    return max_abs


def _per_ray_check(label: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype) -> float:
    """Every value within RAY_GRAD_TOL x max(1, |plain value|)."""
    if not bool(torch.isfinite(kernel).all()):
        fail(f"{label}: non-finite output")
    diff = (kernel.double() - plain.double()).abs()
    scaled = diff / plain.double().abs().clamp_min(1.0)
    worst = float(scaled.max())
    n_off = int((scaled > THRESHOLD[dtype]).sum())
    print(f"[kernels] {label}: max_abs {float(diff.max()):.3e}, largest difference / max(1, |value|) {worst:.3e} "
          f"(limit {RAY_GRAD_TOL[dtype]:g}); {n_off} of {diff.numel()} values above {THRESHOLD[dtype]:g} of it")
    if worst > RAY_GRAD_TOL[dtype]:
        fail(f"{label}: a value differs by {worst:.3e} x max(1, |value|) (limit {RAY_GRAD_TOL[dtype]:g})")
    return float(diff.max())


def _column_check(label: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype) -> float:
    """Each column's largest difference within COLUMN_RTOL of the column's
    own largest |plain value| (a column that is 0 must be 0)."""
    if not bool(torch.isfinite(kernel).all()):
        fail(f"{label}: non-finite values")
    k, p = (t.double().reshape(-1, t.shape[-1] if t.dim() else 1) for t in (kernel, plain))
    err, scale = (k - p).abs().amax(dim=0), p.abs().amax(dim=0)
    ratio = torch.where(err == 0, 0.0, err / scale)  # inf where a zero column is not
    worst = int(ratio.argmax())
    print(f"[kernels] {label}: max_abs {float(err.max()):.3e}; worst column {worst} of {err.numel()}: "
          f"{float(err[worst]):.3e} of its largest value {float(scale[worst]):.3e} = {float(ratio[worst]):.3e} "
          f"(limit {COLUMN_RTOL[dtype]:g}); per column: {' '.join(f'{float(r):.1e}' for r in ratio)}")
    if float(ratio[worst]) > COLUMN_RTOL[dtype]:
        fail(f"{label}: column {worst} differs by {float(ratio[worst]):.3e} of its largest value (limit {COLUMN_RTOL[dtype]:g})")
    return float(err.max())


def _grad_check(label: str, name: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype) -> float:
    """Per-ray gradients value by value; sums (sse, table gradients) column by column."""
    if name in ("g_o", "g_d", "g_thr", "g_alive"):
        return _per_ray_check(f"{label} {name}", kernel, plain, dtype)
    return _column_check(f"{label} {name}", kernel, plain, dtype)


def _relative_check(label: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    """Largest difference relative to the largest |want|; fails above ``rtol``."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    got, want = got.detach().double(), want.detach().double()
    max_abs = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    print(f"[main] {label}: max_abs {max_abs:.3e}, relative to max |value| {scale:.3e}: {max_abs / scale:.3e} (limit {rtol:g})")
    if max_abs > rtol * scale:
        fail(f"{label}: differs by {max_abs / scale:.3e} of its largest value (limit {rtol:g})")


def _noise_check(label: str, got, peer, exact) -> None:
    """``got`` is within NOISE_FACTOR x ``peer``'s distance of ``exact`` (+ floor)."""
    got, peer, exact = (torch.as_tensor(x).detach().double().cpu() for x in (got, peer, exact))
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    err, peer_err = float((got - exact).abs().max()), float((peer - exact).abs().max())
    limit = NOISE_FACTOR * peer_err + NOISE_FLOOR * float(exact.abs().max())
    print(f"[main] {label}: off the f64 answer by {err:.3e}, the f32 peer by {peer_err:.3e} (limit {limit:.3e})")
    if err > limit:
        fail(f"{label}: {err:.3e} off the f64 answer, more than {NOISE_FACTOR:g} x the f32 peer's {peer_err:.3e}")


def phase_kernels(device: str = "cuda", width: int = WIDTH, height: int = HEIGHT) -> dict[str, float]:
    """Each hard kernel against its plain version, mirror and glossy; returns
    the max abs error per kernel."""
    errs: dict[str, float] = {}
    for route, name, depth, dtype, stochastic in CASES:
        kernel, plain = _run_case(route, name, depth, dtype, device, width, height, stochastic)
        if device == "cuda":
            torch.cuda.synchronize()
        label = f"{route} {name} depth {depth} {str(dtype).split('.')[-1]} {width}x{height}{' glossy' if stochastic else ''}"
        max_abs = _per_value_check(label, kernel, plain, dtype)
        if dtype == torch.float32:
            errs[route] = max(errs.get(route, 0.0), max_abs)
    return errs


def _smooth_inputs(name: str, dtype: torch.dtype, depth: int, width: int = WIDTH, height: int = HEIGHT):
    """Rays, tables and scalars of a built-in scene, as the smooth route makes them."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import _kernel_inputs

    scene = getattr(scenes, f"{name}_scene")(width, height, dtype=dtype, device="cuda")
    cfg = RenderConfig(max_depth=depth, dtype=dtype, visibility="smooth", use_pallas=True)
    return _kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)


def _cotangent(d: torch.Tensor) -> torch.Tensor:
    """A seeded acc cotangent (3, N) for the backward kernel."""
    return torch.rand(d.shape, generator=torch.Generator("cuda").manual_seed(0), device="cuda", dtype=d.dtype) - 0.5


SMOOTH_CASES = (
    ("reference", 3, torch.float32, False),
    ("reference", 6, torch.float32, False),
    ("all_effects", 3, torch.float32, False),
    ("reference", 3, torch.float64, False),
    ("reference", 3, torch.float32, True),
    ("all_effects", 3, torch.float32, True),
    ("reference", 3, torch.float64, True),
)
GRAD_NAMES = ("g_o", "g_d", "g_geom", "g_mat", "g_consts")


def _step_state(o, d, tables, kw, xi):
    """The state after one bounce of the chain from the camera (thr and
    alive other than 1), as the second bounce's smooth_fwd_step takes it."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    ones = torch.ones_like(d[0])
    return bss.smooth_fwd_step_plain(o, d, ones, ones, torch.zeros_like(d), *tables, xi, **kw)[:5]


def _step_cotangents(outs) -> list[torch.Tensor]:
    """Seeded nonzero cotangents of the five state outputs of a bounce."""
    gen = torch.Generator("cuda").manual_seed(2)
    return [torch.rand(t.shape, generator=gen, device="cuda", dtype=t.dtype) - 0.5 for t in outs[:5]]


def _check_step_pair(label: str, o, d, tables, kw, xis, dtype, err: dict) -> None:
    """smooth_fwd_step and smooth_bwd_step on the second bounce of the chain
    against their plain versions; smooth_bwd_step twice, bitwise."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    skw = {k: v for k, v in kw.items() if k != "depth"}
    state = _step_state(o, d, tables, skw, xis[0])
    fk = bss.smooth_fwd_step(*state, *tables, xis[1], **skw)
    torch.cuda.synchronize()
    fp = bss.smooth_fwd_step_plain(*state, *tables, xis[1], **skw)
    for out_name, k, p in zip(("o", "d", "thr", "alive", "acc", "idx", "hit", "clear"), fk, fp):
        err["smooth_fwd_step"] = max(err["smooth_fwd_step"], _per_value_check(f"smooth_fwd_step {label} {out_name}", k, p, dtype))
    args = (*state[:4], *fp[5:], *tables, *_step_cotangents(fp), xis[1])
    bk = bss.smooth_bwd_step(*args, **skw)
    bk2 = bss.smooth_bwd_step(*args, **skw)
    torch.cuda.synchronize()
    bp = bss.smooth_bwd_step_plain(*args, **skw)
    for out_name, k, p in zip(("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts"), bk, bp):
        err["smooth_bwd_step"] = max(err["smooth_bwd_step"], _grad_check(f"smooth_bwd_step {label}", out_name, k, p, dtype))
    same = all(torch.equal(a, b) for a, b in zip(bk, bk2))
    print(f"[kernels] smooth_bwd_step {label}: two launches bitwise equal: {same}", flush=True)
    if not same:
        fail(f"smooth_bwd_step {label}: two launches on the same inputs differ")


def phase_smooth_kernels() -> dict[str, float]:
    """The five smooth kernels against their plain versions at 960x540,
    mirror and glossy; returns the max abs error per kernel over the
    float32 cases."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    errs = dict.fromkeys(SMOOTH, 0.0)
    fwd_names = ("acc", "osave", "dsave", "thrsave", "alivesave", "idx", "hit", "clear")
    for name, depth, dtype, stochastic in SMOOTH_CASES:
        o, d, tables, kw = _smooth_inputs(name, dtype, depth)
        xis = _xis(stochastic, d.shape[1], depth, dtype)
        xi = torch.cat(xis) if stochastic else None
        label = f"{name} depth {depth} {str(dtype).split('.')[-1]} {WIDTH}x{HEIGHT}{' glossy' if stochastic else ''}"
        fk = bss.smooth_fwd_deep(o, d, *tables, xi, **kw)
        torch.cuda.synchronize()
        fp = bss.smooth_fwd_deep_plain(o, d, *tables, xi, **kw)
        err = dict.fromkeys(SMOOTH, 0.0)
        for out_name, k, p in zip(fwd_names, fk, fp):
            if k.numel():
                err["smooth_fwd_deep"] = max(err["smooth_fwd_deep"], _per_value_check(f"smooth_fwd_deep {label} {out_name}", k, p, dtype))
        g_acc = _cotangent(d)
        bk = bss.smooth_bwd_deep(o, d, *fp[1:], *tables, g_acc, xi, **kw)  # both replay the plain residuals
        torch.cuda.synchronize()
        bp = bss.smooth_bwd_deep_plain(o, d, *fp[1:], *tables, g_acc, xi, **kw)
        for out_name, k, p in zip(GRAD_NAMES, bk, bp):
            err["smooth_bwd_deep"] = max(err["smooth_bwd_deep"], _grad_check(f"smooth_bwd_deep {label}", out_name, k, p, dtype))
        tgt = (torch.clamp(fp[0], 0.0, 1.0) * 0.9).contiguous()
        tk = bss.train_deep(o, d, tgt, *tables, xi, **kw)
        tk2 = bss.train_deep(o, d, tgt, *tables, xi, **kw)
        torch.cuda.synchronize()
        tp = bss.train_deep_plain(o, d, tgt, *tables, xi, **kw)
        for out_name, k, p in zip(("sse",) + GRAD_NAMES, tk, tp):
            err["train_deep"] = max(err["train_deep"], _grad_check(f"train_deep {label}", out_name, k, p, dtype))
        same = all(torch.equal(a, b) for a, b in zip(tk, tk2))
        print(f"[kernels] train_deep {label}: two launches bitwise equal: {same}", flush=True)
        if not same:
            fail(f"train_deep {label}: two launches on the same inputs differ")
        _check_step_pair(label, o, d, tables, kw, xis, dtype, err)
        if dtype == torch.float32:
            errs = {k: max(errs[k], err[k]) for k in SMOOTH}
    return errs


def phase_xi() -> None:
    """The per-ray RNG on the card: bitwise the CPU's draw, and bitwise the
    JAX package's draw stored in the stochastic golden."""
    from python_ray_tracer_tpu_torch.ops.rng import bounce_xi

    golden = np.load(REPO / STOCH_GOLDEN)
    card = bounce_xi(_trace_key(), N_RAYS, 1, torch.float32, "cuda")[0].cpu()
    cpu = bounce_xi(_trace_key(), N_RAYS, 1, torch.float32, "cpu")[0]
    same_cpu = torch.equal(card, cpu)
    same_jax = np.array_equal(card[:, :4096].T.numpy(), golden["xi_head"]) and np.array_equal(card[:, -4096:].T.numpy(), golden["xi_tail"])
    print(f"[xi] first bounce's uniform2 draw ({N_RAYS} x 2, f32, seed {SEED}) on the card: bitwise equal to the CPU's "
          f"{same_cpu}, to the JAX golden's first and last 4096 lanes {same_jax}", flush=True)
    if not (same_cpu and same_jax):
        fail("the card's xi draw differs from the CPU's or from JAX's")


def _launch_counts() -> tuple[dict[str, int], ...]:
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub, bounce_sub, culled, intersect_fused

    return bounce_sub.LAUNCHES, bounce_smooth_sub.LAUNCHES, culled.LAUNCHES, intersect_fused.LAUNCHES


def _reset_launches() -> None:
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def _launches() -> dict[str, int]:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def _expect_launched(what: str, launches: dict[str, int], kernels: tuple[str, ...],
                     exactly: int | None = None, absent: tuple[str, ...] = ()) -> None:
    """Each of ``kernels`` launched (``exactly`` that many times, if given),
    none of ``absent``."""
    print(f"[main] launches during {what}: {launches}", flush=True)
    for k in kernels:
        if launches[k] == 0 or exactly is not None and launches[k] != exactly:
            fail(f"{what} launched kernel {k} {launches[k]} times (expected {exactly or 'some'})")
    for k in absent:
        if launches[k]:
            fail(f"{what} launched kernel {k}, which its path does not take")


def phase_main_path(tmp: Path) -> dict[str, int]:
    """The render CLI on CUDA through the kernels; returns each kernel's launches.

    Depth 3 takes ``trace_deep`` and is held against the JAX golden; depth 1
    takes ``bounce_step`` and ``--depth auto`` (12 here) ``trace_deep`` again,
    both held against the pure-torch route on the card.
    """
    from python_ray_tracer_tpu_torch import RenderConfig, cli, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.render import auto_max_depth
    from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8

    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    depths = ("3", "1", "auto")
    _reset_launches()
    for depth in depths:
        cli.main(["render", "--builtin", "reference", *size, "--depth", depth, "-o", str(tmp / f"d{depth}.png")])
    launches = _launches()
    _expect_launched("the CLI renders", launches, HARD)

    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    golden = np.load(REPO / GOLDEN)["image"]
    for depth in depths:
        img = load_png(tmp / f"d{depth}.png")
        if depth == "3":
            ref, against = golden, "the JAX golden"
        else:
            n = 1 if depth == "1" else auto_max_depth(scene)
            ref, against = to_uint8(render(scene, RenderConfig(max_depth=n, use_pallas=False))), "the pure-torch route"
        _compare_uint8(f"depth {depth}", img, ref, against)
    return launches


def _compare_uint8(label: str, img: np.ndarray, ref: np.ndarray, against: str) -> None:
    if img.shape != ref.shape:
        fail(f"{label}: CLI frame has shape {img.shape}, expected {ref.shape}")
    delta = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    n_diff = int((delta > 0).sum())
    print(f"[main] {label} vs {against}: {n_diff} of {delta.size} uint8 values differ, max diff {int(delta.max())}")
    if n_diff > MAX_GOLDEN_SHARE * delta.size:
        fail(f"{label}: {n_diff} uint8 values differ from {against} (limit {MAX_GOLDEN_SHARE:g} of them)")


def _smooth_cfg(dtype: torch.dtype = torch.float32, **kw):
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=3, dtype=dtype, visibility="smooth", **kw)


def _leaf_grads(params) -> dict[str, torch.Tensor]:
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}


def phase_smooth_main(tmp: Path) -> dict[str, int]:
    """The training slice's main path on CUDA; returns each smooth kernel's
    launches, each read from the run that is its main path."""
    from python_ray_tracer_tpu_torch import cli, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.optim import adam, combine, init_state, make_loss_fn, make_train_step, scene_to_params
    from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8

    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    launches: dict[str, int] = {}

    # 1. render --visibility smooth: smooth_fwd_deep, against the pure-torch route.
    _reset_launches()
    cli.main(["render", "--visibility", "smooth", *size, "--depth", "3", "-o", str(tmp / "smooth.png")])
    counts = _launches()
    _expect_launched("the smooth CLI render", counts, ("smooth_fwd_deep",))
    launches["smooth_fwd_deep"] = counts["smooth_fwd_deep"]
    with torch.no_grad():
        ref = to_uint8(render(scene, _smooth_cfg()))
    _compare_uint8("smooth depth 3", load_png(tmp / "smooth.png"), ref, "the pure-torch route")

    # 2. A non-L2 loss through render(): smooth_bwd_deep, against torch
    #    autograd of the pure-torch route, in f32 (the main path) and f64.
    weight = torch.rand((HEIGHT, WIDTH, 3), generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    grads = {}
    for dtype in (torch.float32, torch.float64):
        scene_d = reference_scene(WIDTH, HEIGHT, dtype=dtype, device="cuda")
        for route, use_pallas in (("kernels", True), ("pure-torch", False)):
            params = scene_to_params(scene_d)
            _reset_launches()
            cfg = _smooth_cfg(use_pallas=use_pallas, dtype=dtype)
            loss = torch.sum(render(combine(params, scene_d), cfg) * weight.to(dtype)) / N_RAYS
            loss.backward()
            torch.cuda.synchronize()
            if use_pallas and dtype == torch.float32:
                counts = _launches()
                _expect_launched("the weighted-sum loss through render()", counts, ("smooth_fwd_deep", "smooth_bwd_deep"))
                launches["smooth_bwd_deep"] = counts["smooth_bwd_deep"]
            grads[route, dtype] = _leaf_grads(params)
            print(f"[main] weighted-sum loss, {route} {str(dtype).split('.')[-1]}: {float(loss.detach()):.10e}")
    for key, exact in grads["pure-torch", torch.float64].items():
        _relative_check(f"weighted-sum loss d/d{key}, kernels vs torch autograd, f64",
                        grads["kernels", torch.float64][key], exact, F64_RTOL)
        _noise_check(f"weighted-sum loss d/d{key}, kernels f32 (peer: torch autograd f32)",
                     grads["kernels", torch.float32][key], grads["pure-torch", torch.float32][key], exact)

    # 3. cli optimize against the port's own clipped hard-render PNG: train_deep.
    metrics = tmp / "optimize.jsonl"
    _reset_launches()
    cli.main(["optimize", "--visibility", "smooth", *size, "--depth", "3", "--target", str(tmp / "d3.png"),
              "--steps", "20", "--sync-every", "10", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize", counts, ("train_deep",))
    launches["train_deep"] = counts["train_deep"]
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    print(f"[main] cli optimize: {len(losses)} steps, loss {losses[0]:.6e} -> {losses[-1]:.6e}")
    if len(losses) != 20 or not all(np.isfinite(losses)):
        fail(f"cli optimize logged {len(losses)} losses, finite: {all(np.isfinite(losses))}")

    # 4. The first Adam step's loss and gradients against the JAX f32
    #    golden, calibrated by the golden's own distance from JAX's f64 answer.
    golden = np.load(REPO / TRAIN_GOLDEN)
    target = torch.tensor(np.load(REPO / GOLDEN)["image"], dtype=torch.float32, device="cuda") / 255.0
    params = scene_to_params(scene)
    loss = make_loss_fn(scene, target, _smooth_cfg(use_pallas=True))(params)
    loss.backward()
    print(f"[main] first step: loss {float(loss.detach()):.8e}, the JAX golden f32 {float(golden['loss']):.8e}, "
          f"f64 {float(golden['loss64']):.8e}")
    _noise_check("first-step loss (peer: the JAX f32 golden)", loss, golden["loss"], golden["loss64"])
    for key, g in _leaf_grads(params).items():
        _noise_check(f"first step d/d{key} (peer: the JAX f32 golden)", g, golden[f"grad/{key}"], golden[f"grad64/{key}"])

    # 5. Recovery: perturb one specular gain; Adam lr 2e-2, 20 steps halves the loss.
    with torch.no_grad():
        target = torch.clamp(render(scene, _smooth_cfg(use_pallas=True)), 0.0, 1.0)
    params = scene_to_params(scene, sphere_fields=("specular_gain",), light_fields=(), camera=False)
    with torch.no_grad():
        params["spheres.specular_gain"][1] += 0.3
    step = make_train_step(make_loss_fn(scene, target, _smooth_cfg(use_pallas=True)))
    state = init_state(params, adam(2e-2))
    history = []
    for _ in range(20):
        state, loss = step(state)
        history.append(float(loss))
    print(f"[main] recovery: loss {history[0]:.6e} -> {history[-1]:.6e} in 20 Adam steps")
    if not history[-1] < 0.5 * history[0]:
        fail(f"recovery task: loss {history[0]:.6e} -> {history[-1]:.6e} did not halve")
    return launches


def _cli_render(tmp: Path, out: str, *args: str) -> np.ndarray:
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.utils.image import load_png

    cli.main(["render", "--width", str(WIDTH), "--height", str(HEIGHT), *args, "-o", str(tmp / out)])
    return load_png(tmp / out)


def phase_sampled_main(tmp: Path) -> None:
    """The sampled renders through the CLI on CUDA, each run read for its
    launches: hard stochastic at depth 3 (trace_deep glossy, against the JAX
    golden) and 1 (bounce_step glossy), --spp 4, smooth stochastic
    (smooth_fwd_deep glossy) and smooth depth 1 (smooth_fwd_step, mirror and
    glossy), each of the rest against the pure-torch route on the card."""
    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    seed = ["--seed", str(SEED)]
    runs = (
        ("hard stochastic depth 3", ("--stochastic-roughness", *seed), ("trace_deep",),
         dict(stochastic_roughness=True, rng_seed=SEED)),
        ("hard stochastic depth 1", ("--stochastic-roughness", *seed, "--depth", "1"), ("bounce_step",),
         dict(stochastic_roughness=True, rng_seed=SEED, max_depth=1)),
        ("hard spp 4", ("--spp", "4", *seed), ("trace_deep",), dict(samples_per_pixel=4, rng_seed=SEED)),
        ("smooth stochastic depth 3", ("--visibility", "smooth", "--stochastic-roughness", *seed), ("smooth_fwd_deep",),
         dict(visibility="smooth", stochastic_roughness=True, rng_seed=SEED)),
        ("smooth depth 1", ("--visibility", "smooth", "--depth", "1"), ("smooth_fwd_step",),
         dict(visibility="smooth", max_depth=1)),
        ("smooth stochastic depth 1", ("--visibility", "smooth", "--depth", "1", "--stochastic-roughness", *seed),
         ("smooth_fwd_step",), dict(visibility="smooth", max_depth=1, stochastic_roughness=True, rng_seed=SEED)),
    )
    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    for i, (label, args, kernels, cfg_kw) in enumerate(runs):
        _reset_launches()
        img = _cli_render(tmp, f"sampled{i}.png", *args)
        _expect_launched(f"the CLI render, {label}", _launches(), kernels)
        if i == 0:
            ref, against = np.load(REPO / STOCH_GOLDEN)["image"], "the JAX golden"
        else:
            with torch.no_grad():
                ref = to_uint8(render(scene, RenderConfig(**{"max_depth": 3, **cfg_kw})))
            against = "the pure-torch route"
        _compare_uint8(label, img, ref, against)


def phase_step_main() -> dict[str, int]:
    """The one-bounce smooth pair's main path: a weighted-sum loss through
    render() at smooth depth 1, stochastic, on CUDA; its gradients against
    torch autograd of the pure-torch route (f64, and f32 under the noise
    rule).  Returns the pair's launches from the f32 kernel run."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.optim import combine, scene_to_params

    weight = torch.rand((HEIGHT, WIDTH, 3), generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    grads, launches = {}, {}
    for dtype in (torch.float32, torch.float64):
        scene = reference_scene(WIDTH, HEIGHT, dtype=dtype, device="cuda")
        for route, use_pallas in (("kernels", True), ("pure-torch", False)):
            params = scene_to_params(scene)
            _reset_launches()
            cfg = _smooth_cfg(dtype, use_pallas=use_pallas, stochastic_roughness=True, rng_seed=SEED)
            cfg = dataclasses.replace(cfg, max_depth=1)
            loss = torch.sum(render(combine(params, scene), cfg) * weight.to(dtype)) / N_RAYS
            loss.backward()
            torch.cuda.synchronize()
            if use_pallas and dtype == torch.float32:
                counts = _launches()
                _expect_launched("the depth-1 loss through render()", counts, ("smooth_fwd_step", "smooth_bwd_step"))
                launches = {k: counts[k] for k in ("smooth_fwd_step", "smooth_bwd_step")}
            grads[route, dtype] = _leaf_grads(params)
            print(f"[main] depth-1 loss, {route} {str(dtype).split('.')[-1]}: {float(loss.detach()):.10e}")
    for key, exact in grads["pure-torch", torch.float64].items():
        _relative_check(f"depth-1 loss d/d{key}, kernels vs torch autograd, f64",
                        grads["kernels", torch.float64][key], exact, F64_RTOL)
        _noise_check(f"depth-1 loss d/d{key}, kernels f32 (peer: torch autograd f32)",
                     grads["kernels", torch.float32][key], grads["pure-torch", torch.float32][key], exact)
    return launches


def phase_stochastic_train(tmp: Path) -> None:
    """``optimize --stochastic-roughness`` through train_deep (glossy), and
    its first Adam step's loss and every gradient against the JAX golden:
    f32 under the noise rule, f64 within F64_RTOL."""
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params

    metrics = tmp / "optimize_stochastic.jsonl"
    _reset_launches()
    cli.main(["optimize", "--visibility", "smooth", "--width", str(WIDTH), "--height", str(HEIGHT), "--depth", "3",
              "--stochastic-roughness", "--seed", str(SEED), "--target", str(tmp / "d3.png"), "--steps", "5",
              "--sync-every", "5", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize --stochastic-roughness", counts, ("train_deep",))
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    print(f"[main] cli optimize --stochastic-roughness: {len(losses)} steps, loss {losses[0]:.6e} -> {losses[-1]:.6e}")
    if len(losses) != 5 or not all(np.isfinite(losses)):
        fail(f"cli optimize --stochastic-roughness logged {len(losses)} losses, finite: {all(np.isfinite(losses))}")

    golden = np.load(REPO / STOCH_TRAIN_GOLDEN)
    for dtype in (torch.float32, torch.float64):
        scene = reference_scene(WIDTH, HEIGHT, dtype=dtype, device="cuda")
        target = torch.tensor(np.load(REPO / GOLDEN)["image"], dtype=dtype, device="cuda") / 255.0
        params = scene_to_params(scene)
        cfg = _smooth_cfg(dtype, use_pallas=True, stochastic_roughness=True, rng_seed=SEED)
        loss = make_loss_fn(scene, target, cfg)(params)
        loss.backward()
        tag = str(dtype).split(".")[-1]
        print(f"[main] stochastic first step {tag}: loss {float(loss.detach()):.8e}, the JAX golden f32 "
              f"{float(golden['loss']):.8e}, f64 {float(golden['loss64']):.8e}")
        if dtype == torch.float32:
            _noise_check("stochastic first-step loss (peer: the JAX f32 golden)", loss, golden["loss"], golden["loss64"])
            for key, g in _leaf_grads(params).items():
                _noise_check(f"stochastic first step d/d{key} (peer: the JAX f32 golden)", g,
                             golden[f"grad/{key}"], golden[f"grad64/{key}"])
        else:
            _relative_check("stochastic first-step loss f64 vs the JAX f64 golden", loss.cpu(),
                            torch.as_tensor(golden["loss64"]), F64_RTOL)
            for key, g in _leaf_grads(params).items():
                _relative_check(f"stochastic first step d/d{key} f64 vs the JAX f64 golden", g.cpu(),
                                torch.as_tensor(golden[f"grad64/{key}"]), F64_RTOL)


def time_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def count_ops(fn) -> int:
    """Elementwise floating-point operations ``fn`` performs, counted on its torch calls.

    Every arithmetic, comparison, select, min/max and transcendental call
    counts one operation per element of its largest operand (a sigmoid
    three: negate-exp, add, divide); a reduction counts its input's
    elements.  Indexing, copies and casts count nothing.  The smooth plain
    versions do the kernels' work lane by lane: each lane's own tier of the
    winner's quadratic, and each sphere's material gradients summed over
    the lanes it won; a few selects (the checker texture) still evaluate
    both arms.
    """
    from torch.overrides import TorchFunctionMode

    weights = {"sigmoid": 3}
    counted = {
        "add", "radd", "iadd", "sub", "rsub", "isub", "mul", "rmul", "imul", "truediv", "rtruediv", "div", "rdiv",
        "neg", "sqrt", "exp", "sigmoid", "sin", "cos", "pow", "rpow", "minimum", "maximum", "clamp", "clamp_min",
        "abs", "sign", "trunc", "mod", "rmod", "remainder", "where", "lt", "le", "gt", "ge", "eq", "ne",
        "and", "or", "invert", "sum", "prod",
    }
    total = 0

    class Counter(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "").strip("_")
            if name in counted:
                sizes = [a.numel() for a in (*args, out) if isinstance(a, torch.Tensor)]
                total += weights.get(name, 1) * max(sizes, default=1)
            return out

    with Counter():
        fn()
    return total


def _bound(ops: int, n_bytes: int) -> tuple[float, str]:
    """Least time for ``ops`` float32 operations and ``n_bytes`` of traffic, ms."""
    t_ops, t_bytes = ops / PEAK_F32_OPS_PER_S * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_timing(card: str) -> dict[str, dict]:
    """Kernel and plain-version ms at reference 960x540 depth 3, f32, with each
    kernel's bound, and each kernel's glossy variant beside it; then the
    render frame, the benchmark's Adam step and the stochastic one."""
    from python_ray_tracer_tpu_torch import RenderConfig, bench, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops import bounce_sub as bs

    o, d, tables, kw = _inputs("reference", torch.float32, "cuda", WIDTH, HEIGHT)
    ones, zeros = torch.ones_like(d[0]), torch.zeros_like(d)
    so, sd, stables, skw = _smooth_inputs("reference", torch.float32, 3)
    fwd = bss.smooth_fwd_deep(so, sd, *stables, **skw)
    g_acc = _cotangent(sd)
    tgt = (torch.clamp(fwd[0], 0.0, 1.0) * 0.9).contiguous()
    bwd = bss.smooth_bwd_deep(so, sd, *fwd[1:], *stables, g_acc, **skw)
    # The one-bounce pair on the chain's second bounce, with seeded
    # cotangents on all five outputs.
    sskw = {k: v for k, v in skw.items() if k != "depth"}
    state = _step_state(so, sd, stables, sskw, None)
    sfwd = bss.smooth_fwd_step(*state, *stables, **sskw)
    sbwd_args = (*state[:4], *sfwd[5:], *stables, *_step_cotangents(sfwd))
    sbwd = bss.smooth_bwd_step(*sbwd_args, **sskw)
    calls = {
        "trace_deep": (
            lambda: bs.trace_deep(o, d, *tables, depth=3, **kw),
            lambda: bs.trace_deep_plain(o, d, *tables, depth=3, **kw),
            _nbytes(o, d, d),  # o, d in; acc out
        ),
        "bounce_step": (
            lambda: bs.bounce_step(o, d, ones, ones, zeros, *tables, **kw),
            lambda: bs.bounce_step_plain(o, d, ones, ones, zeros, *tables, **kw),
            2 * _nbytes(o, d, ones, ones, zeros),  # the five state arrays in and out
        ),
        "smooth_fwd_deep": (
            lambda: bss.smooth_fwd_deep(so, sd, *stables, **skw),
            lambda: bss.smooth_fwd_deep_plain(so, sd, *stables, **skw),
            _nbytes(so, sd, *fwd),
        ),
        "smooth_bwd_deep": (
            lambda: bss.smooth_bwd_deep(so, sd, *fwd[1:], *stables, g_acc, **skw),
            lambda: bss.smooth_bwd_deep_plain(so, sd, *fwd[1:], *stables, g_acc, **skw),
            _nbytes(so, sd, *fwd[1:], g_acc, *bwd),
        ),
        "train_deep": (
            lambda: bss.train_deep(so, sd, tgt, *stables, **skw),
            lambda: bss.train_deep_plain(so, sd, tgt, *stables, **skw),
            _nbytes(so, sd, tgt, *bss.train_deep(so, sd, tgt, *stables, **skw)),
        ),
        "smooth_fwd_step": (
            lambda: bss.smooth_fwd_step(*state, *stables, **sskw),
            lambda: bss.smooth_fwd_step_plain(*state, *stables, **sskw),
            _nbytes(*state, *sfwd),  # the state in; the next state and the residuals out
        ),
        "smooth_bwd_step": (
            lambda: bss.smooth_bwd_step(*sbwd_args, **sskw),
            lambda: bss.smooth_bwd_step_plain(*sbwd_args, **sskw),
            _nbytes(*sbwd_args, *sbwd),  # state, residuals, tables, cotangents in; gradients out
        ),
    }
    # Each kernel's glossy variant on the same inputs, xi drawn on the main
    # path's schedule (the xi stacks are inputs: their bytes count too).
    xis = _xis(True, N_RAYS, 3, torch.float32)
    xi_all, xi_1 = torch.cat(xis), xis[1]
    glossy = {
        "trace_deep": lambda: bs.trace_deep(o, d, *tables, xi_all, depth=3, **kw),
        "bounce_step": lambda: bs.bounce_step(o, d, ones, ones, zeros, *tables, xi_1, **kw),
        "smooth_fwd_deep": lambda: bss.smooth_fwd_deep(so, sd, *stables, xi_all, **skw),
        "smooth_bwd_deep": lambda: bss.smooth_bwd_deep(so, sd, *fwd[1:], *stables, g_acc, xi_all, **skw),
        "train_deep": lambda: bss.train_deep(so, sd, tgt, *stables, xi_all, **skw),
        "smooth_fwd_step": lambda: bss.smooth_fwd_step(*state, *stables, xi_1, **sskw),
        "smooth_bwd_step": lambda: bss.smooth_bwd_step(*sbwd_args, xi_1, **sskw),
    }
    res: dict[str, dict] = {}
    for name, (kernel, plain, n_bytes) in calls.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, warmup=1, iters=3)
        ops = count_ops(plain)
        bound_ms, bound_by = _bound(ops, n_bytes)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        print(f"[timing] {name}: kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({ops / N_RAYS:.0f} operations per ray, {n_bytes} bytes), "
              f"kernel at {bound_ms / ms:.1%} of its bound (reference {WIDTH}x{HEIGHT} f32, depth 3 "
              f"or one bounce; {card})", flush=True)
    for name, fn in glossy.items():
        g_ms, ms = time_ms(fn), time_ms(calls[name][0])
        print(f"[timing] {name} glossy: kernel {g_ms:.4f} ms beside the mirror kernel's {ms:.4f} ms in turn "
              f"({g_ms / ms:.3f}x; reference {WIDTH}x{HEIGHT} f32; {card})", flush=True)
    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for label, cfg in (
            ("hard, through the kernels", RenderConfig(max_depth=3, use_pallas=True)),
            ("hard, pure-torch route", RenderConfig(max_depth=3, use_pallas=False)),
            ("smooth, through the kernels", _smooth_cfg(use_pallas=True)),
            ("smooth, pure-torch route", _smooth_cfg()),
        ):
            ms = time_ms(lambda: render(scene, cfg))
            print(f"[timing] render() {label}, depth 3: {ms:.4f} ms/frame, {N_RAYS / (ms * 1e-3):.4e} rays/s "
                  f"(reference {WIDTH}x{HEIGHT} f32; {card})", flush=True)
    record = bench.main(width=WIDTH, height=HEIGHT, depth=3, steps=200, profile_steps=20)
    print(f"[timing] bench Adam step: {record['step_ms']:.4f} ms/step, {record['value']:.4e} rays/s, "
          f"{record['train_deep_launches_per_step']:g} train_deep launches per step; device time "
          f"{record['profile_device_ms_per_step']:.4f} ms/step in {record['profile_device_ops_per_step']:.0f} "
          f"kernels and copies, busy {record['device_busy_share']:.1%} of the step "
          f"({record['profile_wall_ms_per_step']:.4f} ms/step under torch.profiler; {card})", flush=True)
    for name, us in record["profile_device_us_per_step"].items():
        print(f"[timing]   device time per step: {us:9.2f} us  {name}")
    step_ms = _stochastic_step_ms(scene)
    print(f"[timing] stochastic Adam step (--stochastic-roughness, one glossy train_deep launch per step): "
          f"{step_ms:.4f} ms/step, {N_RAYS / (step_ms * 1e-3):.4e} rays/s (reference {WIDTH}x{HEIGHT} f32, depth 3, "
          f"best of 3 calls of 100 steps; {card})", flush=True)
    return res


def _stochastic_step_ms(scene) -> float:
    """ms/step of the stochastic smooth L2 Adam step, timed as bench.py times
    the deterministic one: warm-up, then the best of three calls of 100
    steps, each ending in a CUDA synchronise."""
    from python_ray_tracer_tpu_torch.optim import adam, init_state, make_loss_fn, make_train_step_k, scene_to_params

    target = torch.tensor(np.load(REPO / GOLDEN)["image"], dtype=torch.float32, device="cuda") / 255.0
    cfg = _smooth_cfg(use_pallas=True, stochastic_roughness=True, rng_seed=SEED)
    step_k = make_train_step_k(make_loss_fn(scene, target, cfg))
    state = init_state(scene_to_params(scene), adam(1e-3))
    state, _ = step_k(state, 20)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state, losses = step_k(state, 100)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 100)
    if not bool(torch.isfinite(losses).all()):
        fail("the stochastic Adam step gave a non-finite loss")
    return best * 1e3


# --- BASELINE config 4: the culled pair and the standalone sweeps ---------------


def _big_scene(dtype: torch.dtype, width: int = BIG_WIDTH, height: int = BIG_HEIGHT):
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    return random_spheres_scene(BIG_SPHERES, width, height, dtype=dtype, device=DEVICE)


def _big_cfg(dtype: torch.dtype = torch.float32, **kw):
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=BIG_DEPTH, dtype=dtype, **kw)


def _culled_record(dtype: torch.dtype, width: int, height: int) -> list[dict]:
    """Each bounce's inputs of the two culled kernels in the mirror config-4
    frame (traced through the kernels on the card)."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops import culled

    scene = _big_scene(dtype, width, height)
    near, shade = [], []
    with _capture(culled, "near_culled", near), _capture(culled, "shade_culled", shade), torch.no_grad():
        culled.trace_fused_culled(scene.camera.position, ray_directions_t(scene.camera, dtype), scene,
                                  _big_cfg(dtype, use_pallas=True))
    torch.cuda.synchronize()
    return [dict(near=n[0], shade=s[0], kw=n[1]) for n, s in zip(near, shade)]


@contextlib.contextmanager
def _capture(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name`` (still called)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def _sweep_record(dtype: torch.dtype, width: int, height: int, depth: int = BIG_DEPTH):
    """The inputs of each bounce's nearest_sweep and shadow_sweep call in the
    stochastic config-4 frame (render() at seed SEED through the kernels)."""
    from python_ray_tracer_tpu_torch import render

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    near, shadow = [], []
    scene = _big_scene(dtype, width, height)
    cfg = dataclasses.replace(_big_cfg(dtype, use_pallas=True, stochastic_roughness=True, rng_seed=SEED), max_depth=depth)
    with _capture(render_mod, "nearest_sweep", near), _capture(render_mod, "shadow_sweep", shadow), torch.no_grad():
        render(scene, cfg)
    torch.cuda.synchronize()
    return near, shadow


def _exact_check(label: str, kernel: torch.Tensor, plain: torch.Tensor) -> None:
    n_diff = int((kernel != plain).sum())
    print(f"[kernels] {label}: {n_diff} of {kernel.numel()} differ (must be 0)")
    if n_diff:
        fail(f"{label}: {n_diff} values differ from the plain version")


def phase_big_kernels() -> tuple[dict[str, float], dict]:
    """The culled pair on the mirror config-4 frame's primary, first
    re-sorted and first full-sweep bounce, the sweeps on the stochastic
    frame's first two bounces, each against its plain version (idx exactly),
    f32 at 1920x1080 and f64 at 480x270; the primary lists checked
    conservative against the full sweep.  Returns the max abs error per
    kernel over the f32 cases and the f32 inputs (for the timings)."""
    from python_ray_tracer_tpu_torch.ops import culled, intersect_fused

    errs = dict.fromkeys(CULLED + SWEEPS, 0.0)
    inputs = {}
    for dtype, (width, height) in ((torch.float32, (BIG_WIDTH, BIG_HEIGHT)), (torch.float64, BIG_F64_SIZE)):
        tag = f"config 4 {str(dtype).split('.')[-1]} {width}x{height}"
        err = dict.fromkeys(CULLED + SWEEPS, 0.0)
        record = _culled_record(dtype, width, height)
        for b, kind in enumerate(("primary culled", "re-sorted culled", "full-sweep")):
            r = record[b]
            counts = r["near"][3:5]
            print(f"[kernels] {tag} bounce {b} ({kind}): nearest lists {int(counts[0].sum())} candidates + "
                  f"{int(counts[1].sum())} full-sweep spheres over {counts[0].numel()} tiles; shadow lists "
                  f"{int(r['shade'][12].sum())} + {int(r['shade'][13].sum())}", flush=True)
            nk = culled.near_culled(*r["near"], **r["kw"])
            torch.cuda.synchronize()
            np_ = culled.near_culled_plain(*r["near"], **r["kw"])
            for name, k, p in zip(("t", "idx", "p", "normal"), nk, np_):
                if name == "idx":
                    _exact_check(f"near_culled {tag} bounce {b} idx", k, p)
                else:
                    err["near_culled"] = max(err["near_culled"], _per_value_check(f"near_culled {tag} bounce {b} {name}", k, p, dtype))
            sk = culled.shade_culled(*r["shade"], **r["kw"])
            torch.cuda.synchronize()
            sp = culled.shade_culled_plain(*r["shade"], **r["kw"])
            for name, k, p in zip(("o", "d", "thr", "alive", "acc"), sk, sp):
                err["shade_culled"] = max(err["shade_culled"], _per_value_check(f"shade_culled {tag} bounce {b} {name}", k, p, dtype))
        # Conservative lists: at the primary bounce (every tile live) the
        # candidate sweep finds what the full sweep finds.
        o, d, cand, _, _, geom = record[0]["near"]
        kw = record[0]["kw"]
        full = culled.full_sweep_lists(torch.ones(cand.shape[0], dtype=torch.bool, device=DEVICE), kw["s_cheap"])
        listed, swept = culled.near_culled(*record[0]["near"], **kw), culled.near_culled(o, d, *full, geom, **kw)
        n_diff = int(((listed[0] != swept[0]) | (listed[1] != swept[1])).sum())
        print(f"[kernels] {tag} primary bounce, candidate lists vs the full sweep: {n_diff} of {o.shape[1]} rays "
              f"differ in t or idx (limit {MAX_BAD_SHARE:g} of them)", flush=True)
        if n_diff > MAX_BAD_SHARE * o.shape[1]:
            fail(f"{tag}: the candidate lists lose hits ({n_diff} rays differ from the full sweep)")
        near, shadow = _sweep_record(dtype, width, height, depth=2)
        for b in range(2):
            (args, kw_n), (sargs, kw_s) = near[b], shadow[b]
            nk = intersect_fused.nearest_sweep(*args, **kw_n)
            torch.cuda.synchronize()
            np_ = intersect_fused.nearest_sweep_plain(*args, **kw_n)
            err["nearest_sweep"] = max(err["nearest_sweep"], _per_value_check(f"nearest_sweep {tag} glossy bounce {b} t", nk.t, np_[0], dtype))
            _exact_check(f"nearest_sweep {tag} glossy bounce {b} idx", nk.idx, np_[1])
            lit = intersect_fused.shadow_sweep(*sargs, **kw_s)
            torch.cuda.synchronize()
            lit_p = intersect_fused.shadow_sweep_plain(*sargs, **kw_s)
            err["shadow_sweep"] = max(err["shadow_sweep"], _per_value_check(f"shadow_sweep {tag} glossy bounce {b} in_light", lit, lit_p, dtype))
        if dtype == torch.float32:
            errs = err
            inputs = dict(record=record, near=near, shadow=shadow)
        del record
    return errs, inputs


def _pure_frame(scene, cfg, key) -> torch.Tensor:
    """The pure-torch route's frame, traced PURE_CHUNK rays at a time (each
    chunk draws its lanes' xi from its global ray offset, so chunking is exact)."""
    from python_ray_tracer_tpu_torch import trace
    from python_ray_tracer_tpu_torch.camera import ray_directions

    dirs = ray_directions(scene.camera, cfg.dtype)
    with torch.no_grad():
        out = [trace(scene.camera.position, dirs[a : a + PURE_CHUNK], scene, cfg, key=key, ray_offset=a)
               for a in range(0, dirs.shape[0], PURE_CHUNK)]
    return torch.cat(out).reshape(scene.camera.height, scene.camera.width, 3)


def phase_big_main(tmp: Path) -> dict[str, int]:
    """``render --builtin random1024 --width 1920 --height 1080 --depth 4``:
    mirror through the culled pair (4 launches of each per frame) against
    the JAX golden; ``--stochastic-roughness --seed 7`` through the sweeps
    (4 of each per frame) against the pure-torch route on the card.  The
    CLI renders each frame twice (a first call and a timed one)."""
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    size = ["--builtin", "random1024", "--width", str(BIG_WIDTH), "--height", str(BIG_HEIGHT), "--depth", str(BIG_DEPTH)]
    launches = {}
    _reset_launches()
    img = _cli_render(tmp, "big.png", *size)
    counts = _launches()
    _expect_launched("the config-4 CLI render", counts, CULLED, exactly=2 * BIG_DEPTH, absent=HARD + SWEEPS)
    launches.update({k: counts[k] for k in CULLED})
    _compare_uint8("config 4 mirror", img, np.load(REPO / BIG_GOLDEN)["image"], "the JAX golden")

    _reset_launches()
    img = _cli_render(tmp, "big_glossy.png", *size, "--stochastic-roughness", "--seed", str(SEED))
    counts = _launches()
    _expect_launched("the config-4 glossy CLI render", counts, SWEEPS, exactly=2 * BIG_DEPTH, absent=HARD + CULLED)
    launches.update({k: counts[k] for k in SWEEPS})
    ref = to_uint8(_pure_frame(_big_scene(torch.float32), _big_cfg(stochastic_roughness=True, rng_seed=SEED), _trace_key()))
    _compare_uint8("config 4 glossy", img, ref, "the pure-torch route")
    return launches


def _linear_ops(run, lanes: int) -> tuple[float, float]:
    """(operations per lane, per lane and swept sphere) of a culled plain
    version: ``run(k)`` runs it over ``lanes`` lanes with k spheres each."""
    zero, one = count_ops(lambda: run(0)), count_ops(lambda: run(1))
    return zero / lanes, (one - zero) / lanes


def _culled_bound(name: str, r: dict) -> tuple[float, str]:
    """The least time of one launch on these inputs: bytes in and out once,
    and the operations of this run's lists (each lane's fixed work plus its
    swept spheres: its tile's candidates and full-sweep spheres)."""
    from python_ray_tracer_tpu_torch.ops import culled

    kw = r["kw"]
    args = r["near"] if name == "near_culled" else r["shade"]
    ci = 2 if name == "near_culled" else 11  # where the lists sit in the arguments
    tile = kw["tile_rays"]
    n = args[0].shape[1]
    fn = culled.near_culled_plain if name == "near_culled" else culled.shade_culled_plain

    def one_tile(k: int):
        sliced = [a[..., :tile] if a.dim() and a.shape[-1] == n else a for a in args]
        sliced[ci] = args[ci][:1]
        sliced[ci + 1] = torch.full((1,), k, dtype=torch.int32, device=DEVICE)
        sliced[ci + 2] = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        return fn(*sliced, **kw)

    per_lane, per_sphere = _linear_ops(one_tile, tile)
    swept = float((args[ci + 1].double().clamp(0, args[ci].shape[1]) + args[ci + 2].double().clamp(0, kw["s_cheap"])).sum()) * tile
    out = culled.near_culled(*args, **kw) if name == "near_culled" else culled.shade_culled(*args, **kw)
    n_bytes = _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out)
    return _bound(int(per_lane * n + per_sphere * swept), n_bytes)


def _sweep_bound(name: str, call) -> tuple[float, str]:
    from python_ray_tracer_tpu_torch.ops import intersect_fused

    args, kw = call
    n, part = args[0].shape[0], 4096
    plain = intersect_fused.nearest_sweep_plain if name == "nearest_sweep" else intersect_fused.shadow_sweep_plain
    ops = count_ops(lambda: plain(*(a[:part] if a.shape[0] == n else a for a in args), **kw)) * n / part
    out = intersect_fused.nearest_sweep(*args, **kw)[:2] if name == "nearest_sweep" else (intersect_fused.shadow_sweep(*args, **kw),)
    return _bound(int(ops), _nbytes(*args, *out))


def phase_big_timing(card: str, inputs: dict) -> dict[str, dict]:
    """The four kernels on each of their main-path launches of a config-4
    frame (CUDA events), beside their plain versions and bounds; the mirror
    and glossy frames through render(); a torch.profiler split of one mirror
    frame into the kernels and the glue."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import culled, intersect_fused

    launches = {
        "near_culled": [(lambda r=r: culled.near_culled(*r["near"], **r["kw"]),
                         lambda r=r: culled.near_culled_plain(*r["near"], **r["kw"]),
                         lambda r=r: _culled_bound("near_culled", r)) for r in inputs["record"]],
        "shade_culled": [(lambda r=r: culled.shade_culled(*r["shade"], **r["kw"]),
                          lambda r=r: culled.shade_culled_plain(*r["shade"], **r["kw"]),
                          lambda r=r: _culled_bound("shade_culled", r)) for r in inputs["record"]],
        "nearest_sweep": [(lambda c=c: intersect_fused.nearest_sweep(*c[0], **c[1]),
                           lambda c=c: intersect_fused.nearest_sweep_plain(*c[0], **c[1]),
                           lambda c=c: _sweep_bound("nearest_sweep", c)) for c in inputs["near"]],
        "shadow_sweep": [(lambda c=c: intersect_fused.shadow_sweep(*c[0], **c[1]),
                          lambda c=c: intersect_fused.shadow_sweep_plain(*c[0], **c[1]),
                          lambda c=c: _sweep_bound("shadow_sweep", c)) for c in inputs["shadow"]],
    }
    res = {}
    for name, calls in launches.items():
        rows = []
        for b, (kernel, plain, bound) in enumerate(calls):
            ms = time_ms(kernel, warmup=2, iters=10)
            plain_ms = time_ms(plain, warmup=0, iters=1)
            bound_ms, bound_by = bound()
            rows.append((ms, plain_ms, bound_ms, bound_by))
            print(f"[timing] {name} bounce {b}: kernel {ms:.4f} ms, plain version {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
                  f"by {bound_by}, kernel at {bound_ms / ms:.1%} of its bound (config 4, 1920x1080 f32; {card})", flush=True)
        k = len(rows)
        by_ops = sum(r[2] for r in rows if r[3] == "operations") >= sum(r[2] for r in rows if r[3] == "bytes")
        res[name] = dict(ms=sum(r[0] for r in rows) / k, plain_ms=sum(r[1] for r in rows) / k,
                         bound_ms=sum(r[2] for r in rows) / k, bound_by="operations" if by_ops else "bytes", library_ms=None)
        what = f"the mirror frame's {k}" if name in CULLED else f"the glossy frame's first {k} (every bounce sweeps the table)"
        print(f"[timing] {name}: mean per launch over {what}: kernel {res[name]['ms']:.4f} ms, plain "
              f"{res[name]['plain_ms']:.2f} ms, bound {res[name]['bound_ms']:.4f} ms ({card})", flush=True)

    scene = _big_scene(torch.float32)
    mirror, glossy = _big_cfg(use_pallas=True), _big_cfg(use_pallas=True, stochastic_roughness=True, rng_seed=SEED)
    with torch.no_grad():
        for label, cfg in (("mirror, culled pair", mirror), ("glossy seed 7, sweeps", glossy)):
            ms = time_ms(lambda cfg=cfg: render(scene, cfg), warmup=2, iters=5)
            print(f"[timing] config-4 frame, {label}: {ms:.3f} ms/frame, {BIG_WIDTH * BIG_HEIGHT / (ms * 1e-3):.4e} "
                  f"primary rays/s (render(), 1920x1080 depth 4, 1024 spheres, f32; {card})", flush=True)
        _profile_frame(lambda: render(scene, mirror), card)
    return res


def _profile_frame(frame, card: str) -> None:
    """Device time of one mirror config-4 frame by kernel under torch.profiler:
    the two culled kernels against the glue (list building, sorts, gathers)."""
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = {e.key: getattr(e, "self_device_time_total", 0.0) for e in events}
    kernels = {k: v for k, v in device_us.items() if "near_culled" in k or "shade_culled" in k}
    total = sum(device_us.values())
    glue = total - sum(kernels.values())
    print(f"[timing] config-4 mirror frame under torch.profiler: wall {wall_ms:.3f} ms, device {total / 1e3:.3f} ms in "
          f"{sum(e.count for e in events)} kernels and copies (busy {total / 1e3 / wall_ms:.1%}); the culled kernels "
          f"{sum(kernels.values()) / 1e3:.3f} ms, the glue {glue / 1e3:.3f} ms ({card})", flush=True)
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:16]:
        print(f"[timing]   {us / 1e3:9.3f} ms  {name[:100]}")


def main() -> int:
    card = phase_device()
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    phase_build()
    errs, launches, timings = {}, {}, {}
    errs.update(phase_kernels())
    errs.update(phase_smooth_kernels())
    phase_xi()
    big_errs, big_inputs = phase_big_kernels()
    errs.update(big_errs)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_main_path(Path(tmp)))
        launches.update(phase_smooth_main(Path(tmp)))
        launches.update(phase_step_main())
        phase_sampled_main(Path(tmp))
        phase_stochastic_train(Path(tmp))
        launches.update(phase_big_main(Path(tmp)))
    timings.update(phase_timing(card))
    timings.update(phase_big_timing(card, big_inputs))
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            **timings[name],
        }
        for name in HARD + SMOOTH + CULLED + SWEEPS
    ]
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
