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
  480x270;
* the culled smooth route, config 4's training step (1920x1080, depth 3):
  ``near_cs``, ``fwd_cs`` and ``bwd_cs`` against their plain versions on
  every bounce of a loss's forward and backward (mirror and glossy, f32 at
  1920x1080, f64 at 480x270), the primary lists against the full sweep,
  ``optimize --visibility smooth`` 3 steps with exact launch counts, the
  smooth CLI frames against the chunked pure-torch route, and the first
  step at 960x540 against a JAX golden;
* the smooth kernels past 256 spheres: all five against their plain
  versions at 1024 spheres (BASELINE config 5's inverse task, f32 at
  256x144 mirror and glossy, f64 at 64x36; geometry staged in shared
  memory) and at 4096 (f64, geometry from global memory), the one-bounce
  pair at 8192 (from global memory; f32, and f64 on the same inputs
  upcast); ``optimize --builtin random1024 --width 480 --height 270
  --visibility smooth`` (one ``train_deep`` a step) and its smooth frame
  against the pure-torch route; config 5's first Adam step against a JAX
  golden; an Adam step at 8192 spheres (``depth`` launches each of
  ``smooth_fwd_step`` and ``smooth_bwd_step``, the counterparts there of the
  JAX lane pair).  On all_effects and config 4 it prints the worst f32
  lanes of the smooth gradient kernels beside their f64 gaps;
* image textures: the atlas mode of the nine kernels that take an atlas
  against their plain versions (texel ids exactly; the backward kernels
  with nonzero dww cotangents, twice, bitwise) on the texture-recovery
  task (320x180), the textured1024 frame's culled pair and a textured1024
  smooth loss (960x540); ``render --builtin textured1024`` (1920x1080,
  depth 4) against a JAX golden; the texture task's hard frames against the
  pure-torch route; its first step against a JAX golden (bitwise across two
  runs), 40 Adam steps of the atlas through ``fit``, a depth-1 step;
  ``optimize --builtin textured1024 --visibility smooth`` at 960x540, 3
  steps, each with exact launch counts;
* the lane-layout hard bounce (``bounce_lane``) and the JSON-scene render
  path: the kernel against its plain version on every bounce of two scenes,
  the 80-sphere atlas scene ``testdata/lane80.json`` (texels read in the
  kernel; f32 1920x1080 and f64 480x270) and config 4's spheres with 9 in
  the exact tier (f32 1920x1080, f64 240x135), twice bitwise, and with its
  geometry forced into shared and into global memory, bitwise the same
  (1032 and 4104 spheres, without and with an atlas, f32 480x270 and f64
  240x135, and both 1920x1080 records; each launch's instantiation read
  from the profiler); ``render
  --scene lane80.json --settings lane80_settings.json`` (1920x1080, depth
  4) against a JAX golden with exact launch counts, the 1032-sphere frame
  through ``render()`` against the pure-torch route, ``--denoise`` against
  the CPU's denoise of the card's frame, and ``--profile``.

Then it times every kernel (and each one's glossy variant) beside its plain
version and its bound, the benchmark's Adam step and the stochastic one,
the config-4 frames with a ``torch.profiler`` split of the mirror one, the
config-4 culled smooth Adam step with a split into its kernels, the five
smooth kernels at config 5 and the pair at 8192 spheres beside their bounds,
the config-5 and 8192-sphere Adam steps with profiler splits, and each atlas
variant beside its no-atlas kernel on the same inputs, the textured1024
frame (with the texel composition's share), the texture task's Adam step
and the textured1024 culled smooth step, and ``bounce_lane`` per launch on
both lane scenes with each frame's ms and profiler split, and with its
geometry in shared and in global memory.
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
CS = ("near_cs", "fwd_cs", "bwd_cs")
STEP = ("smooth_fwd_step", "smooth_bwd_step")
# The one-bounce pair's entries in the kernels line past 4096 spheres, where
# it replaces the JAX lane pair (TPU rows 6-7).
LANE = {k: f"{k} (> 4096 spheres)" for k in STEP}
SOURCE = {
    **{k: "python_ray_tracer_tpu_torch/csrc/bounce_sub.cu" for k in HARD},
    **{k: "python_ray_tracer_tpu_torch/csrc/bounce_smooth_sub.cu" for k in SMOOTH},
    **{k: "python_ray_tracer_tpu_torch/csrc/culled.cu" for k in CULLED},
    **{k: "python_ray_tracer_tpu_torch/csrc/intersect_fused.cu" for k in SWEEPS},
    **{k: "python_ray_tracer_tpu_torch/csrc/culled_smooth.cu" for k in CS},
    **{LANE[k]: "python_ray_tracer_tpu_torch/csrc/bounce_smooth_sub.cu" for k in STEP},
    "bounce_lane": "python_ray_tracer_tpu_torch/csrc/bounce_lane.cu",
}
# BASELINE config 4: random_spheres_scene, 1024 spheres, 1920x1080, depth 4;
# the f64 kernel checks at a quarter of the width and height.
BIG_SPHERES, BIG_WIDTH, BIG_HEIGHT, BIG_DEPTH = 1024, 1920, 1080, 4
BIG_F64_SIZE = (480, 270)
BIG_GOLDEN = "python_ray_tracer_tpu_torch/testdata/random1024_1920x1080_d4_f32.npz"
# Rays per chunk of the pure-torch reference of the glossy config-4 frame
# (its (N, S) tables would not fit whole).
PURE_CHUNK = 32768
# The culled smooth route: BASELINE config 4's training step (random1024,
# 1920x1080, depth 3); the f64 kernel checks at 480x270.  Its JAX golden:
# the first Adam step's loss and every gradient of the XLA smooth path at
# 960x540, the smallest frame the route takes (MIN_CULL_SMOOTH_RAYS), f32
# and f64; the target is the hard render's uint8 image (stored) / 255.
CS_DEPTH = 3
CS_F64_SIZE = (480, 270)
CS_GOLDEN = "python_ray_tracer_tpu_torch/testdata/random1024_960x540_d3_smooth_train_f32.npz"
# BASELINE config 5 (the JAX package's benchmarks/config5_bench.py at 1024
# spheres, its "production default for 17..4096 spheres"):
# inverse_task_scene(1024), 256x144, depth 3, f32, L2 against the clipped
# hard render, Adam lr 1e-3; 36,864 rays, off the culled route, so the
# smooth kernels take the whole table.  Its JAX golden: the first Adam
# step's loss and every gradient of the XLA smooth path, f32 and f64, target
# the hard render's uint8 image (stored) / 255.
C5_SPHERES, C5_WIDTH, C5_HEIGHT, C5_DEPTH = 1024, 256, 144, 3
C5_GOLDEN = "python_ray_tracer_tpu_torch/testdata/inverse1024_256x144_d3_smooth_train_f32.npz"
# Past 4096 spheres (the JAX lane pair's range): random_spheres_scene(8192)
# at config 5's frame and depth, through the one-bounce pair.
LANE_SPHERES = 8192
# The smooth kernels against their plain versions at big tables: (scene,
# spheres, width, height, depth, dtype, glossy, kernels, timed).  Geometry
# is staged in shared memory up to 64 KB (1024 spheres: 16 KB f32, 32 KB
# f64) and read from global memory past it (4096 spheres f64, 8192).  The
# 8192-sphere pair is checked in float32 and again in float64 on the same
# inputs upcast.  The plain versions loop spheres in Python, seconds a call
# at 1024-8192 spheres whatever the frame, so the f64 cases take reduced
# frames and a one-bounce pair's entering state comes from the kernel.
BLOCKED_CASES = (
    ("inverse_task", 1024, 256, 144, 3, torch.float32, False, SMOOTH, True),
    ("inverse_task", 1024, 256, 144, 2, torch.float32, True, SMOOTH, False),
    ("inverse_task", 1024, 64, 36, 2, torch.float64, False, SMOOTH, False),
    ("inverse_task", 1024, 64, 36, 1, torch.float64, True, SMOOTH, False),
    ("random_spheres", 4096, 32, 18, 1, torch.float64, False, SMOOTH, False),
    ("random_spheres", 8192, 256, 144, 2, torch.float32, False, STEP, True),
)
# Image textures.  The texture-recovery task (the JAX package's
# benchmarks/texture_recovery_demo.py settings): texture_task_scene with a
# 64x64 texture at 320x180, depth 2, smooth, f32, the atlas leaf alone from
# 0.5, Adam lr 0.03.  Its JAX golden: the first step's loss and atlas
# gradient of the XLA smooth path, f32 and f64, the target the XLA smooth
# frame's uint8 image (stored) / 255.  The textured config-4 frame
# (textured_spheres_scene: 1024 spheres, every 4th sampling one of two
# 512x512 textures) at 1920x1080, depth 4, against a JAX golden; its culled
# smooth step at 960x540 (the route's smallest frame).
TEX_SIDE, TEX_WIDTH, TEX_HEIGHT, TEX_DEPTH = 64, 320, 180, 2
TEX_STEPS, TEX_LR = 40, 0.03
TEX_GOLDEN = "python_ray_tracer_tpu_torch/testdata/texture64_320x180_d2_smooth_train_f32.npz"
TEXTURED_GOLDEN = "python_ray_tracer_tpu_torch/testdata/textured1024_1920x1080_d4_f32.npz"
TEX_CS_SIZE = (960, 540)
# The kernels that take an atlas, and their atlas mode's entries in the
# kernels line (TPU rows 1, 2, 8-11, 14, 16, 17).
# The lane-layout hard bounce (TPU row 5) and its two scenes: (a) the JSON
# scene testdata/lane80.json (80 spheres, every 4th image-textured from two
# PNGs, one atlas slot each: 20 slots of 32x32, 20,480 texels) rendered by
# the CLI with lane80_settings.json at 1920x1080, depth 4, against a JAX
# golden (its lane route in interpret mode); (b) config 4's 1024 spheres
# with 8 more r = 99999 spheres, 9 in the exact tier, which the culled route
# refuses.  The f32 checks take the main path's 1920x1080 records and the
# f64 checks a quarter of each frame's sides; the 1032-sphere frame is also
# held against the pure-torch route at 480x270.
BOUNCE_LANE = ("bounce_lane",)
LANE_SCENE = "python_ray_tracer_tpu_torch/testdata/lane80.json"
LANE_SETTINGS = "python_ray_tracer_tpu_torch/testdata/lane80_settings.json"
LANE_GOLDEN = "python_ray_tracer_tpu_torch/testdata/lane80_1920x1080_d4_f32.npz"
LANE_WIDTH, LANE_HEIGHT, LANE_DEPTH = 1920, 1080, 4
LANE_F64_SIZE = (480, 270)
LANE_BIG_CHECK_SIZE, LANE_BIG_F64_SIZE = (480, 270), (240, 135)
# Where bounce_lane reads its geometry (csrc/bounce_lane.cu: staged in
# shared memory while that keeps as many blocks resident as global reads):
# both sides forced on the same inputs of the 1032-sphere scene (16.5 KB of
# f32 geometry) and of the same scene from random_spheres_scene(4096), 4104
# spheres (65.7 KB), each without and with lane80's first two textures on
# every 4th random sphere, f32 480x270 and f64 240x135, and on both 1920x1080
# main-path records.
LANE_GEOMETRY_RANDOM = (BIG_SPHERES, 4096)
LANE_GEOMETRY_SIZE, LANE_GEOMETRY_F64_SIZE = (480, 270), (240, 135)
ATLAS = {k: f"{k} (atlas)" for k in HARD + ("smooth_fwd_deep", "smooth_bwd_deep") + STEP + ("shade_culled", "fwd_cs", "bwd_cs")
         + BOUNCE_LANE}
DEVICE = "cuda"
REPLACES = {
    "bounce_lane": "python_ray_tracer_tpu/ops/pallas_bounce.py:160",
    LANE["smooth_fwd_step"]: "python_ray_tracer_tpu/ops/pallas_bounce_smooth.py:346",
    LANE["smooth_bwd_step"]: "python_ray_tracer_tpu/ops/pallas_bounce_smooth.py:420",
    "near_cs": "python_ray_tracer_tpu/ops/pallas_culled_smooth.py:154",
    "fwd_cs": "python_ray_tracer_tpu/ops/pallas_culled_smooth.py:252",
    "bwd_cs": "python_ray_tracer_tpu/ops/pallas_culled_smooth.py:284",
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
REPLACES.update({v: REPLACES[k] for k, v in ATLAS.items()})
SOURCE.update({v: SOURCE[k] for k, v in ATLAS.items()})
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
# Float32 table-gradient columns, by check label, that are sums of many
# lanes' contributions of both signs: the float32 kernel and the float32
# plain version both part from the float64 value by far more than from each
# other (PERF.md, Findings).  Such a column alone may reach
# ILL_CONDITIONED_FACTOR x COLUMN_RTOL, and only if the same kernel in
# float64 on the same inputs is within COLUMN_RTOL of its plain version.
# smooth_bwd_step's camera-z gradient at 8192 spheres reads 3.76e-5.
ILL_CONDITIONED_COLUMNS = {"smooth_bwd_step random_spheres(8192) depth 2 float32 256x144 g_consts": (2,)}
ILL_CONDITIONED_FACTOR = 2.0
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
# The culled smooth route's f64 first step at 960x540 (1024 spheres) against
# its golden, JAX's exact autograd of the XLA path: Phase C's max(1 -
# occlusion, 1e-6) (the JAX kernels' form) weighs more with 1024 spheres,
# whose shadows put many lanes deep in another sphere's shadow.  On the CPU
# the port's culled route sits up to 7.7e-7 (light) off torch autograd of
# its pure-torch route on random1024 at 32x32 (tests/test_torch_culled_smooth.py,
# test_config4_scene_f64_gradients_match_torch_autograd), the leaves that
# do not reach Phase C within 5e-10.
CS_F64_RTOL = 1e-5
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


def _column_check(label: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype, f64=None) -> float:
    """Each column's largest difference within COLUMN_RTOL of the column's
    own largest |plain value| (a column that is 0 must be 0).

    The one exception is a column named in ILL_CONDITIONED_COLUMNS under
    ``label``: it may reach ILL_CONDITIONED_FACTOR x COLUMN_RTOL in float32
    if ``f64`` (a callable giving the kernel's and the plain version's
    outputs on the same inputs upcast to float64) shows the kernel's float64
    column within COLUMN_RTOL[float64] of the plain version's."""
    if not bool(torch.isfinite(kernel).all()):
        fail(f"{label}: non-finite values")
    k, p = (t.double().reshape(-1, t.shape[-1] if t.dim() else 1) for t in (kernel, plain))
    err, scale = (k - p).abs().amax(dim=0), p.abs().amax(dim=0)
    ratio = torch.where(err == 0, 0.0, err / scale)  # inf where a zero column is not
    worst = int(ratio.argmax())
    print(f"[kernels] {label}: max_abs {float(err.max()):.3e}; worst column {worst} of {err.numel()}: "
          f"{float(err[worst]):.3e} of its largest value {float(scale[worst]):.3e} = {float(ratio[worst]):.3e} "
          f"(limit {COLUMN_RTOL[dtype]:g}); per column: {' '.join(f'{float(r):.1e}' for r in ratio)}")
    named = ILL_CONDITIONED_COLUMNS.get(label, ()) if dtype == torch.float32 and f64 is not None else ()
    for c in range(err.numel()):
        r = float(ratio[c])
        if r <= COLUMN_RTOL[dtype]:
            continue
        if c not in named:
            fail(f"{label}: column {c} differs by {r:.3e} of its largest value (limit {COLUMN_RTOL[dtype]:g})")
        limit = ILL_CONDITIONED_FACTOR * COLUMN_RTOL[dtype]
        k64, p64 = (t.double().reshape(k.shape) for t in f64())
        err64 = float((k64[:, c] - p64[:, c]).abs().max()) / float(p64[:, c].abs().max())
        k_off, p_off = (float((t[:, c] - p64[:, c]).abs().max()) / float(p64[:, c].abs().max()) for t in (k, p))
        print(f"[kernels] {label}: column {c} (named ill-conditioned) at {r:.3e} (limit {limit:g}); on the same inputs "
              f"in float64 the kernel is {err64:.3e} of the column off the plain version (limit "
              f"{COLUMN_RTOL[torch.float64]:g}); the float32 kernel is {k_off:.3e} and the float32 plain version "
              f"{p_off:.3e} of it off the float64 value", flush=True)
        if r > limit:
            fail(f"{label}: column {c} differs by {r:.3e} of its largest value (limit {limit:g})")
        if err64 > COLUMN_RTOL[torch.float64]:
            fail(f"{label}: column {c} in float64 differs by {err64:.3e} of its largest value "
                 f"(limit {COLUMN_RTOL[torch.float64]:g})")
    return float(err.max())


def _grad_check(label: str, name: str, kernel: torch.Tensor, plain: torch.Tensor, dtype: torch.dtype,
                f64=None) -> float:
    """Per-ray gradients value by value; sums (sse, table gradients) column
    by column (``f64``: see _column_check)."""
    if name in ("g_o", "g_d", "g_thr", "g_alive"):
        return _per_ray_check(f"{label} {name}", kernel, plain, dtype)
    return _column_check(f"{label} {name}", kernel, plain, dtype, f64)


def _upcast(args) -> list:
    return [a.double() if isinstance(a, torch.Tensor) and a.dtype.is_floating_point else a for a in args]


def _f64_outputs(kernel_fn, plain_fn, args: tuple, kw: dict):
    """Lazily, once: a gradient kernel and its plain version on ``args``
    upcast to float64.  Returns ``both``, a callable giving (kernel outputs,
    plain outputs); ``_nth(both, j)`` gives the j-th pair (for
    _column_check)."""
    cache: list = []

    def both():
        if not cache:
            up = _upcast(args)
            cache.append((kernel_fn(*up, **kw), plain_fn(*up, **kw)))
        return cache[0]

    return both


def _nth(both, j: int):
    return lambda: (both()[0][j], both()[1][j])


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


def _step_state(o, d, tables, kw, xi, kernel: bool = False):
    """The state after one bounce of the chain from the camera (thr and
    alive other than 1), as the second bounce's smooth_fwd_step takes it:
    from the plain version, or (big tables, where the plain call costs
    seconds) from the kernel."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    ones = torch.ones_like(d[0])
    step = bss.smooth_fwd_step if kernel else bss.smooth_fwd_step_plain
    return tuple(t.contiguous() for t in step(o, d, ones, ones, torch.zeros_like(d), *tables, xi, **kw)[:5])


def _step_cotangents(outs) -> list[torch.Tensor]:
    """Seeded nonzero cotangents of the five state outputs of a bounce."""
    gen = torch.Generator("cuda").manual_seed(2)
    return [torch.rand(t.shape, generator=gen, device="cuda", dtype=t.dtype) - 0.5 for t in outs[:5]]


def _plain_call(name: str, fn, plain_ms: dict | None):
    """``fn()`` (a plain version).  With ``plain_ms`` (a dict) the call runs
    under count_ops, and its time in ms (CUDA events around the one call, the
    counter's Python overhead included) and its operations are recorded as
    ``plain_ms[name] = (ms, ops)``: the plain versions of big tables take
    seconds, so one call serves the check, the time and the bound."""
    if plain_ms is None:
        return fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    result: list = []
    start.record()
    ops = count_ops(fn, result)
    end.record()
    end.synchronize()
    plain_ms[name] = (start.elapsed_time(end), ops)
    return result[0]


def _twice_bitwise(name: str, label: str, fn):
    """Two launches of a gradient kernel on the same inputs, bitwise equal."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[kernels] {name} {label}: two launches bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{name} {label}: two launches on the same inputs differ")
    return first


def _check_step_pair(label: str, o, d, tables, kw, xis, dtype, err: dict, state_by_kernel: bool = False,
                     plain_ms: dict | None = None, also_f64: bool = False) -> dict:
    """smooth_fwd_step and smooth_bwd_step on the second bounce of the chain
    against their plain versions; smooth_bwd_step twice, bitwise.  With
    ``also_f64`` both again in float64 on the same inputs upcast, under the
    float64 limits.  Returns the two calls (``{name: (kernel callable,
    bytes it moves)}``)."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    skw = {k: v for k, v in kw.items() if k != "depth"}
    state = _step_state(o, d, tables, skw, xis[0], kernel=state_by_kernel)
    fk = bss.smooth_fwd_step(*state, *tables, xis[1], **skw)
    fp = _plain_call("smooth_fwd_step", lambda: bss.smooth_fwd_step_plain(*state, *tables, xis[1], **skw), plain_ms)
    for out_name, k, p in zip(("o", "d", "thr", "alive", "acc", "idx", "hit", "clear"), fk, fp):
        err["smooth_fwd_step"] = max(err["smooth_fwd_step"], _per_value_check(f"smooth_fwd_step {label} {out_name}", k, p, dtype))
    args = (*state[:4], *fp[5:], *tables, *_step_cotangents(fp), xis[1])
    bk = _twice_bitwise("smooth_bwd_step", label, lambda: bss.smooth_bwd_step(*args, **skw))
    bp = _plain_call("smooth_bwd_step", lambda: bss.smooth_bwd_step_plain(*args, **skw), plain_ms)
    f64 = _f64_outputs(bss.smooth_bwd_step, bss.smooth_bwd_step_plain, args, skw)
    bwd_names = ("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts")
    for j, (out_name, k, p) in enumerate(zip(bwd_names, bk, bp)):
        err["smooth_bwd_step"] = max(err["smooth_bwd_step"],
                                     _grad_check(f"smooth_bwd_step {label}", out_name, k, p, dtype, _nth(f64, j)))
    if also_f64:
        label64 = f"{label}, upcast to float64"
        up = _upcast((*state, *tables, xis[1]))
        fk64 = bss.smooth_fwd_step(*up, **skw)
        fp64 = bss.smooth_fwd_step_plain(*up, **skw)
        for out_name, k, p in zip(("o", "d", "thr", "alive", "acc", "idx", "hit", "clear"), fk64, fp64):
            _per_value_check(f"smooth_fwd_step {label64} {out_name}", k, p, torch.float64)
        for out_name, k, p in zip(bwd_names, *f64()):
            _grad_check(f"smooth_bwd_step {label64}", out_name, k, p, torch.float64)
    return {
        "smooth_fwd_step": (lambda: bss.smooth_fwd_step(*state, *tables, xis[1], **skw),
                            _nbytes(*state, *tables, *[x for x in xis[1:2] if x is not None], *fk)),
        "smooth_bwd_step": (lambda: bss.smooth_bwd_step(*args, **skw),
                            _nbytes(*[a for a in args if a is not None], *bk)),
    }


def _check_smooth_case(label: str, o, d, tables, kw, xis, dtype, plain_ms: dict | None = None,
                       state_by_kernel: bool = False) -> tuple[dict, dict]:
    """The deep pair, train_deep and the one-bounce pair against their plain
    versions on one case's inputs; the gradient kernels twice, bitwise.
    Returns the max abs error per kernel and the gradient kernels' outputs
    beside their plain versions' (``{name: (kernel, plain)}``), with the
    inputs under ``"inputs"`` and each kernel's call and bytes under
    ``"calls"``."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    xi = torch.cat(xis[: kw["depth"]]) if xis[0] is not None else None
    fwd_names = ("acc", "osave", "dsave", "thrsave", "alivesave", "idx", "hit", "clear")
    fk = bss.smooth_fwd_deep(o, d, *tables, xi, **kw)
    fp = _plain_call("smooth_fwd_deep", lambda: bss.smooth_fwd_deep_plain(o, d, *tables, xi, **kw), plain_ms)
    err = dict.fromkeys(SMOOTH, 0.0)
    for out_name, k, p in zip(fwd_names, fk, fp):
        if k.numel():
            err["smooth_fwd_deep"] = max(err["smooth_fwd_deep"], _per_value_check(f"smooth_fwd_deep {label} {out_name}", k, p, dtype))
    g_acc = _cotangent(d)
    # Both replay the plain residuals.
    bk = _twice_bitwise("smooth_bwd_deep", label, lambda: bss.smooth_bwd_deep(o, d, *fp[1:], *tables, g_acc, xi, **kw))
    bp = _plain_call("smooth_bwd_deep", lambda: bss.smooth_bwd_deep_plain(o, d, *fp[1:], *tables, g_acc, xi, **kw), plain_ms)
    f64 = _f64_outputs(bss.smooth_bwd_deep, bss.smooth_bwd_deep_plain, (o, d, *fp[1:], *tables, g_acc, xi), kw)
    for j, (out_name, k, p) in enumerate(zip(GRAD_NAMES, bk, bp)):
        err["smooth_bwd_deep"] = max(err["smooth_bwd_deep"],
                                     _grad_check(f"smooth_bwd_deep {label}", out_name, k, p, dtype, _nth(f64, j)))
    tgt = (torch.clamp(fp[0], 0.0, 1.0) * 0.9).contiguous()
    tk = _twice_bitwise("train_deep", label, lambda: bss.train_deep(o, d, tgt, *tables, xi, **kw))
    tp = _plain_call("train_deep", lambda: bss.train_deep_plain(o, d, tgt, *tables, xi, **kw), plain_ms)
    f64 = _f64_outputs(bss.train_deep, bss.train_deep_plain, (o, d, tgt, *tables, xi), kw)
    for j, (out_name, k, p) in enumerate(zip(("sse",) + GRAD_NAMES, tk, tp)):
        err["train_deep"] = max(err["train_deep"], _grad_check(f"train_deep {label}", out_name, k, p, dtype, _nth(f64, j)))
    calls = _check_step_pair(label, o, d, tables, kw, xis, dtype, err, state_by_kernel, plain_ms)
    xi_in = [] if xi is None else [xi]
    calls.update({
        "smooth_fwd_deep": (lambda: bss.smooth_fwd_deep(o, d, *tables, xi, **kw), _nbytes(o, d, *tables, *xi_in, *fk)),
        "smooth_bwd_deep": (lambda: bss.smooth_bwd_deep(o, d, *fp[1:], *tables, g_acc, xi, **kw),
                            _nbytes(o, d, *fp[1:], *tables, g_acc, *xi_in, *bk)),
        "train_deep": (lambda: bss.train_deep(o, d, tgt, *tables, xi, **kw), _nbytes(o, d, tgt, *tables, *xi_in, *tk)),
    })
    outs = {"smooth_bwd_deep": (bk, bp), "train_deep": (tk[1:], tp[1:]), "calls": calls,
            "inputs": dict(fwd=fp, g_acc=g_acc, tgt=tgt, xi=xi)}
    return err, outs


def _sharp_disc(o, d, geom, idx, sharpness: float) -> torch.Tensor:
    """sharpness x |disc| of each lane's winner (plain-tier quadratic): how
    close the lane runs to the winner's silhouette, where the coverage
    sigmoid's slope (and the gradient) peaks."""
    g = geom[idx.long()].T.double()
    oc = o.double() - g[:3]
    b = 2.0 * (d.double() * oc).sum(0)
    ct = (oc * oc).sum(0) - g[3] * g[3]
    return sharpness * (b * b - 4.0 * ct).abs()


def _worst_lanes(label: str, kernel, plain, kernel64, plain64, sdisc, count: int = 5) -> None:
    """The ``count`` lanes (rays) where an f32 per-ray gradient parts most
    from its plain version, relative to max(1, |value|): each lane's value
    scale, sharpness x |disc| of its winner at every bounce, and the f64
    kernel's gap from the f64 plain version on the same inputs."""
    n = kernel.shape[-1]

    def gap(k, p):
        return ((k.double() - p.double()).abs() / p.double().abs().clamp_min(1.0)).reshape(-1, n).amax(dim=0)

    gap32, gap64 = gap(kernel, plain), gap(kernel64, plain64)
    scale = plain.double().abs().reshape(-1, n).amax(dim=0)
    worst = torch.topk(gap32, count).indices
    print(f"[lanes] {label}: worst {count} of {n} lanes; f64 gap over all lanes {float(gap64.max()):.3e}", flush=True)
    for i in worst.tolist():
        discs = " ".join(f"{float(x):.3e}" for x in sdisc[:, i])
        print(f"[lanes]   lane {i}: f32 gap {float(gap32[i]):.3e}, |value| {float(scale[i]):.3e}, "
              f"sharpness x |disc| per bounce {discs}, f64 gap {float(gap64[i]):.3e}")


def _smooth_worst_lanes(label: str, o, d, tables, kw, outs: dict) -> None:
    """Satellite of the smooth gradient check: the worst f32 lanes of
    smooth_bwd_deep and train_deep, with the f64 kernels and plain versions
    rerun on the same inputs in float64."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    up = lambda t: None if t is None else (t.double() if t.dtype.is_floating_point else t)  # noqa: E731
    inp = outs["inputs"]
    o64, d64, tables64, xi64, g_acc64, tgt64 = up(o), up(d), tuple(up(t) for t in tables), up(inp["xi"]), up(inp["g_acc"]), up(inp["tgt"])
    fp64 = bss.smooth_fwd_deep_plain(o64, d64, *tables64, xi64, **kw)
    fp = inp["fwd"]
    depth = kw["depth"]
    rays = [(o, d)] + [(fp[1][3 * k : 3 * k + 3], fp[2][3 * k : 3 * k + 3]) for k in range(depth - 1)]
    sdisc = torch.stack([_sharp_disc(ro, rd, tables[0], fp[5][k], kw["sharp_e"]) for k, (ro, rd) in enumerate(rays)])
    runs = {
        "smooth_bwd_deep": (lambda: bss.smooth_bwd_deep(o64, d64, *fp64[1:], *tables64, g_acc64, xi64, **kw),
                            lambda: bss.smooth_bwd_deep_plain(o64, d64, *fp64[1:], *tables64, g_acc64, xi64, **kw)),
        "train_deep": (lambda: bss.train_deep(o64, d64, tgt64, *tables64, xi64, **kw)[1:],
                       lambda: bss.train_deep_plain(o64, d64, tgt64, *tables64, xi64, **kw)[1:]),
    }
    for name, (kernel64, plain64) in runs.items():
        k64, p64 = kernel64(), plain64()
        k32, p32 = outs[name]
        for j, grad in enumerate(("g_o", "g_d")):
            _worst_lanes(f"{name} {label} {grad}", k32[j], p32[j], k64[j], p64[j], sdisc)


def phase_smooth_kernels() -> dict[str, float]:
    """The five smooth kernels against their plain versions at 960x540,
    mirror and glossy; on all_effects, the worst f32 lanes of the gradient
    kernels beside their f64 gaps.  Returns the max abs error per kernel over
    the float32 cases."""
    errs = dict.fromkeys(SMOOTH, 0.0)
    for name, depth, dtype, stochastic in SMOOTH_CASES:
        o, d, tables, kw = _smooth_inputs(name, dtype, depth)
        xis = _xis(stochastic, d.shape[1], depth, dtype)
        label = f"{name} depth {depth} {str(dtype).split('.')[-1]} {WIDTH}x{HEIGHT}{' glossy' if stochastic else ''}"
        err, outs = _check_smooth_case(label, o, d, tables, kw, xis, dtype)
        if name == "all_effects":
            _smooth_worst_lanes(label, o, d, tables, kw, outs)
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


def _launch_counts() -> tuple[tuple[dict[str, int], ...], tuple[dict[str, int], ...]]:
    """The wrappers' launch counters: the kernels', and their atlas modes'."""
    from python_ray_tracer_tpu_torch.ops import (
        bounce_lane, bounce_smooth_sub, bounce_sub, culled, culled_smooth, intersect_fused,
    )

    atlas_modules = (bounce_sub, bounce_smooth_sub, culled, culled_smooth, bounce_lane)
    return (tuple(m.LAUNCHES for m in (*atlas_modules, intersect_fused)), tuple(m.ATLAS_LAUNCHES for m in atlas_modules))


def _reset_launches() -> None:
    for group in _launch_counts():
        for counts in group:
            for k in counts:
                counts[k] = 0


def _launches() -> dict[str, int]:
    """Every counter, an atlas mode's under its ATLAS name."""
    plain, atlas = _launch_counts()
    out = {k: v for counts in plain for k, v in counts.items()}
    out.update({ATLAS[k]: v for counts in atlas for k, v in counts.items()})
    return out


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


def count_ops(fn, result: list | None = None) -> int:
    """Elementwise floating-point operations ``fn`` performs, counted on its torch calls.

    Every arithmetic, comparison, select, min/max and transcendental call
    counts one operation per element of its largest operand (a sigmoid
    three: negate-exp, add, divide); a reduction counts its input's
    elements.  ``result``, if given, receives ``fn()``'s return value.  Indexing, copies and casts count nothing.  The smooth plain
    versions do the kernels' work lane by lane: each lane's own tier of the
    winner's quadratic, and each sphere's material gradients summed over
    the lanes it won; a few selects (the checker texture, and near_cs's
    winner quadratic, both tiers) still evaluate both arms.
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
        out = fn()
    if result is not None:
        result.append(out)
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
    the deterministic one (_best_step_ms: 20 warm-up steps, calls of 100)."""
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    target = torch.tensor(np.load(REPO / GOLDEN)["image"], dtype=torch.float32, device="cuda") / 255.0
    cfg = _smooth_cfg(use_pallas=True, stochastic_roughness=True, rng_seed=SEED)
    return _best_step_ms(make_loss_fn(scene, target, cfg), scene, warmup=20, steps=100)[0]


def _best_step_ms(loss_fn, scene, warmup: int, steps: int, params=None, lr: float = 1e-3):
    """(ms/step, the K-step trainer, its state) of Adam (lr ``lr``) on
    ``loss_fn`` over ``params`` (default every leaf of ``scene``): ``warmup``
    steps, then the best of three calls of ``steps`` steps, each ending in a
    CUDA synchronise; fails on a non-finite loss."""
    from python_ray_tracer_tpu_torch.optim import adam, init_state, make_train_step_k, scene_to_params

    step_k = make_train_step_k(loss_fn)
    state, _ = step_k(init_state(scene_to_params(scene) if params is None else params, adam(lr)), warmup)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state, losses = step_k(state, steps)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / steps)
    if not bool(torch.isfinite(losses).all()):
        fail("an Adam step gave a non-finite loss")
    return best * 1e3, step_k, state


# --- BASELINE config 4: the culled pair and the standalone sweeps ---------------


def _big_scene(dtype: torch.dtype, width: int = BIG_WIDTH, height: int = BIG_HEIGHT):
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    return random_spheres_scene(BIG_SPHERES, width, height, dtype=dtype, device=DEVICE)


def _big_cfg(dtype: torch.dtype = torch.float32, **kw):
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=BIG_DEPTH, dtype=dtype, **kw)


def _culled_record(dtype: torch.dtype, width: int, height: int, scene=None) -> list[dict]:
    """Each bounce's inputs of the two culled kernels in the mirror config-4
    frame, or ``scene``'s (traced through the kernels on the card):
    ``near`` and ``shade`` the arguments, ``kw`` near_culled's keywords and
    ``shade_kw`` shade_culled's (with the atlas's slot extents on an atlas
    scene)."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops import culled

    scene = _big_scene(dtype, width, height) if scene is None else scene
    near, shade = [], []
    with _capture(culled, "near_culled", near), _capture(culled, "shade_culled", shade), torch.no_grad():
        culled.trace_fused_culled(scene.camera.position, ray_directions_t(scene.camera, dtype), scene,
                                  _big_cfg(dtype, use_pallas=True))
    torch.cuda.synchronize()
    return [dict(near=n[0], shade=s[0], kw=n[1], shade_kw=s[1]) for n, s in zip(near, shade)]


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


def _list_bound(plain, kernel, args: tuple, kw: dict, ci: int) -> tuple[float, str]:
    """The least time of one launch of a list-sweeping kernel on these
    inputs: bytes in and out once, and the operations of this run's lists
    (each lane's fixed work plus its tile's listed and full-tier spheres),
    counted on the plain version over one tile.  ``args[ci:ci + 3]`` are the
    swept lists (cand, cnt_cand, cnt_full)."""
    tile, s_cheap = kw["tile_rays"], kw["s_cheap"]
    n = args[0].shape[1]

    def one_tile(k: int):
        sliced = []
        for a in args:
            if isinstance(a, torch.Tensor) and a.dim() and a.shape[-1] == n:
                a = a[..., :tile]  # the first tile's lanes
            elif isinstance(a, torch.Tensor) and a.dtype == torch.int32 and a.shape[0] == n // tile:
                a = a[:1]  # its lists
            sliced.append(a)
        sliced[ci + 1] = torch.full((1,), k, dtype=torch.int32, device=DEVICE)
        sliced[ci + 2] = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        return plain(*sliced, **kw)

    per_lane, per_sphere = _linear_ops(one_tile, tile)
    swept = float((args[ci + 1].double().clamp(0, args[ci].shape[1]) + args[ci + 2].double().clamp(0, s_cheap)).sum()) * tile
    with torch.no_grad():
        out = kernel(*args, **kw)
    n_bytes = _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out)
    return _bound(int(per_lane * n + per_sphere * swept), n_bytes)


def _culled_bound(name: str, r: dict) -> tuple[float, str]:
    from python_ray_tracer_tpu_torch.ops import culled

    args, ci = (r["near"], 2) if name == "near_culled" else (r["shade"], 11)
    return _list_bound(getattr(culled, f"{name}_plain"), getattr(culled, name), args, r["kw"], ci)


def _sweep_bound(name: str, call) -> tuple[float, str]:
    from python_ray_tracer_tpu_torch.ops import intersect_fused

    args, kw = call
    n, part = args[0].shape[0], 4096
    plain = intersect_fused.nearest_sweep_plain if name == "nearest_sweep" else intersect_fused.shadow_sweep_plain
    ops = count_ops(lambda: plain(*(a[:part] if a.shape[0] == n else a for a in args), **kw)) * n / part
    out = intersect_fused.nearest_sweep(*args, **kw)[:2] if name == "nearest_sweep" else (intersect_fused.shadow_sweep(*args, **kw),)
    return _bound(int(ops), _nbytes(*args, *out))


def _time_launches(name: str, calls: list, card: str, context: str, what: str) -> dict:
    """Time each of a kernel's main-path launches, ``(kernel, plain, bound)``
    callables, beside its plain version and bound; returns the means per
    launch as the kernels line takes them."""
    rows = []
    for b, (kernel, plain, bound) in enumerate(calls):
        ms = time_ms(kernel, warmup=2, iters=10)
        plain_ms = time_ms(plain, warmup=0, iters=1)
        bound_ms, bound_by = bound()
        rows.append((ms, plain_ms, bound_ms, bound_by))
        print(f"[timing] {name} bounce {b}: kernel {ms:.4f} ms, plain version {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by}, kernel at {bound_ms / ms:.1%} of its bound ({context}; {card})", flush=True)
    k = len(rows)
    by_ops = sum(r[2] for r in rows if r[3] == "operations") >= sum(r[2] for r in rows if r[3] == "bytes")
    res = dict(ms=sum(r[0] for r in rows) / k, plain_ms=sum(r[1] for r in rows) / k,
               bound_ms=sum(r[2] for r in rows) / k, bound_by="operations" if by_ops else "bytes", library_ms=None)
    print(f"[timing] {name}: mean per launch over {what}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms, "
          f"bound {res['bound_ms']:.4f} ms ({card})", flush=True)
    return res


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
    res = {name: _time_launches(name, calls, card, "config 4, 1920x1080 f32",
                                f"the mirror frame's {len(calls)}" if name in CULLED
                                else f"the glossy frame's first {len(calls)} (every bounce sweeps the table)")
           for name, calls in launches.items()}

    scene = _big_scene(torch.float32)
    mirror, glossy = _big_cfg(use_pallas=True), _big_cfg(use_pallas=True, stochastic_roughness=True, rng_seed=SEED)
    with torch.no_grad():
        for label, cfg in (("mirror, culled pair", mirror), ("glossy seed 7, sweeps", glossy)):
            ms = time_ms(lambda cfg=cfg: render(scene, cfg), warmup=2, iters=5)
            print(f"[timing] config-4 frame, {label}: {ms:.3f} ms/frame, {BIG_WIDTH * BIG_HEIGHT / (ms * 1e-3):.4e} "
                  f"primary rays/s (render(), 1920x1080 depth 4, 1024 spheres, f32; {card})", flush=True)
        _device_profile(lambda: render(scene, mirror), "config-4 mirror frame", card, CULLED)
    return res


def _device_profile(fn, label: str, card: str, kernels: tuple[str, ...]) -> None:
    """Device time of one call of ``fn`` (after a warm one) by kernel under
    torch.profiler: each of ``kernels`` against the rest, the glue."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = {e.key: getattr(e, "self_device_time_total", 0.0) for e in events}
    split = {k: sum(v for key, v in device_us.items() if k in key) for k in kernels}
    total = sum(device_us.values())
    parts = ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in split.items())
    print(f"[timing] {label} under torch.profiler: wall {wall_ms:.3f} ms, device {total / 1e3:.3f} ms in "
          f"{sum(e.count for e in events)} kernels and copies (busy {total / 1e3 / wall_ms:.1%}); {parts}, the glue "
          f"{(total - sum(split.values())) / 1e3:.3f} ms ({card})", flush=True)
    for name, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:16]:
        print(f"[timing]   {us / 1e3:9.3f} ms  {name[:100]}")


# --- The culled smooth route: BASELINE config 4's training step ---------------


def _cs_cfg(dtype: torch.dtype = torch.float32, **kw):
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=CS_DEPTH, dtype=dtype, visibility="smooth", use_pallas=True, **kw)


def _cs_record(dtype: torch.dtype, width: int, height: int, stochastic: bool, scene=None) -> list[dict]:
    """Each bounce's inputs of near_cs, fwd_cs and bwd_cs in a weighted-sum
    loss's forward and backward through trace_culled_smooth on the card
    (config-4 scene, or ``scene``; depth 3; glossy at seed SEED)."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops import culled_smooth
    from python_ray_tracer_tpu_torch.optim import combine, scene_to_params

    scene = _big_scene(dtype, width, height) if scene is None else scene
    params = scene_to_params(scene)
    sc = combine(params, scene)
    cfg = _cs_cfg(dtype, stochastic_roughness=stochastic, rng_seed=SEED)
    weight = torch.rand((width * height, 3), generator=torch.Generator(DEVICE).manual_seed(4), device=DEVICE, dtype=dtype)
    near, fwd, bwd = [], [], []
    with _capture(culled_smooth, "near_cs", near), _capture(culled_smooth, "fwd_cs", fwd), \
            _capture(culled_smooth, "bwd_cs", bwd):
        img = culled_smooth.trace_culled_smooth(sc.camera.position, ray_directions_t(sc.camera, dtype), sc, cfg,
                                                key=_trace_key() if stochastic else None)
        torch.sum(img * weight).backward()
    torch.cuda.synchronize()
    return [dict(near=n, fwd=f, bwd=b) for n, f, b in zip(near, fwd, bwd[::-1])]


def phase_cs_kernels() -> tuple[dict[str, float], list[dict]]:
    """near_cs, fwd_cs and bwd_cs against their plain versions on every
    bounce of the config-4 step's forward and backward (primary, then two
    re-sorted reflected bounces), mirror and glossy, f32 at 1920x1080 and f64
    at 480x270: idx exactly, the rest under the per-value, per-ray and
    per-column limits; bwd_cs twice, bitwise.  On the f32 primary bounce the
    lists lose nothing: near_cs's (idx, hit) equal the plain full sweep's on
    every lane.  Returns the max abs error per kernel over the f32 cases and
    the f32 mirror record (for the timings)."""
    from python_ray_tracer_tpu_torch.ops import culled, culled_smooth as cs

    errs = dict.fromkeys(CS, 0.0)
    record_f32 = []
    gaps = []  # (bounce, bwd_cs's (g_o, g_d), the plain version's) of the f32 mirror record
    for dtype, (width, height) in ((torch.float32, (BIG_WIDTH, BIG_HEIGHT)), (torch.float64, CS_F64_SIZE)):
        for stochastic in (False, True):
            tag = f"config 4 smooth {str(dtype).split('.')[-1]} {width}x{height}{' glossy' if stochastic else ''}"
            record = _cs_record(dtype, width, height, stochastic)
            err = dict.fromkeys(CS, 0.0)
            with torch.no_grad():
                for b, r in enumerate(record):
                    (na, nkw), (fa, fkw), (ba, bkw) = r["near"], r["fwd"], r["bwd"]
                    print(f"[kernels] {tag} bounce {b}: nearest lists {int(na[5].sum())} candidates + {int(na[6].sum())} "
                          f"full-tier spheres over {na[5].numel()} tiles; shadow lists {int(fa[8].sum())} + "
                          f"{int(fa[9].sum())}", flush=True)
                    nk = cs.near_cs(*na, **nkw)
                    torch.cuda.synchronize()
                    np_ = cs.near_cs_plain(*na, **nkw)
                    for name, k, p in zip(("idx", "hit", "p", "normal", "sval"), nk, np_):
                        if name in ("idx", "hit"):
                            _exact_check(f"near_cs {tag} bounce {b} {name}", k, p)
                        else:
                            err["near_cs"] = max(err["near_cs"], _per_value_check(f"near_cs {tag} bounce {b} {name}", k, p, dtype))
                    fk = cs.fwd_cs(*fa, **fkw)
                    torch.cuda.synchronize()
                    fp = cs.fwd_cs_plain(*fa, **fkw)
                    for name, k, p in zip(("o", "d", "thr", "alive", "acc", "clear"), fk, fp):
                        err["fwd_cs"] = max(err["fwd_cs"], _per_value_check(f"fwd_cs {tag} bounce {b} {name}", k, p, dtype))
                    bk = cs.bwd_cs(*ba, **bkw)
                    bk2 = cs.bwd_cs(*ba, **bkw)
                    torch.cuda.synchronize()
                    bp = cs.bwd_cs_plain(*ba, **bkw)
                    for name, k, p in zip(("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts"), bk, bp):
                        err["bwd_cs"] = max(err["bwd_cs"], _grad_check(f"bwd_cs {tag} bounce {b}", name, k, p, dtype))
                    same = all(torch.equal(x, y) for x, y in zip(bk, bk2))
                    print(f"[kernels] bwd_cs {tag} bounce {b}: two launches bitwise equal: {same}", flush=True)
                    if not same:
                        fail(f"bwd_cs {tag} bounce {b}: two launches on the same inputs differ")
                    if dtype == torch.float32 and not stochastic:
                        gaps.append((b, bk[:2], bp[:2]))
                if dtype == torch.float32 and not stochastic:
                    # The culling loses nothing: the listed primary winners
                    # against the plain sweep of the whole table.
                    na, nkw = record[0]["near"]
                    n = width * height
                    full = culled.full_sweep_lists(torch.ones(na[4].shape[0], dtype=torch.bool, device=DEVICE), nkw["s_cheap"])
                    listed = cs.near_cs(*na, **nkw)
                    swept = cs.near_cs_plain(*na[:4], *full, na[7], **nkw)
                    n_diff = int(((listed[0][:n] != swept[0][:n]) | (listed[1][:n] != swept[1][:n])).sum())
                    print(f"[kernels] {tag} primary bounce, near_cs on the lists vs the plain full sweep: {n_diff} of {n} "
                          f"rays differ in idx or hit (must be 0)", flush=True)
                    if n_diff:
                        fail(f"{tag}: the nearest lists change {n_diff} smooth winners")
                    _cs_worst_lanes(tag, record, gaps)
                    gaps.clear()
                    record_f32 = record
            if dtype == torch.float32:
                errs = {k: max(errs[k], err[k]) for k in CS}
            del record
    return errs, record_f32


def phase_cs_main(tmp: Path) -> dict[str, int]:
    """The slice's main path: ``render --builtin random1024`` (1920x1080,
    depth 3) as the target, ``optimize --visibility smooth`` 3 Adam steps
    (exactly 3 launches each of near_cs, fwd_cs and bwd_cs a step, none of
    the unculled smooth kernels), and the smooth CLI frames, mirror and
    glossy, against the chunked pure-torch smooth route on the card.
    Returns the kernels' launches from the optimize run."""
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    size = ["--builtin", "random1024", "--width", str(BIG_WIDTH), "--height", str(BIG_HEIGHT), "--depth", str(CS_DEPTH)]
    _cli_render(tmp, "cs_target.png", *size)
    metrics = tmp / "cs_optimize.jsonl"
    from python_ray_tracer_tpu_torch import cli

    _reset_launches()
    cli.main(["optimize", *size, "--visibility", "smooth", "--target", str(tmp / "cs_target.png"), "--steps", "3",
              "--sync-every", "3", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize, config 4 smooth, 3 steps", counts, CS, exactly=3 * CS_DEPTH, absent=SMOOTH)
    launches = {k: counts[k] for k in CS}
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    print(f"[main] cli optimize config 4 smooth: {len(losses)} steps, losses {losses}")
    if len(losses) != 3 or not all(np.isfinite(losses)):
        fail(f"cli optimize config 4 smooth logged {len(losses)} losses, finite: {all(np.isfinite(losses))}")

    for label, extra, stochastic in (("mirror", (), False), ("glossy", ("--stochastic-roughness", "--seed", str(SEED)), True)):
        _reset_launches()
        img = _cli_render(tmp, f"cs_{label}.png", *size, "--visibility", "smooth", *extra)
        counts = _launches()
        _expect_launched(f"the config-4 smooth CLI render, {label}", counts, ("near_cs", "fwd_cs"),
                         exactly=2 * CS_DEPTH, absent=SMOOTH + ("bwd_cs",))
        cfg = dataclasses.replace(_cs_cfg(stochastic_roughness=stochastic, rng_seed=SEED), use_pallas=False)
        ref = to_uint8(_pure_frame(_big_scene(torch.float32), cfg, _trace_key() if stochastic else None))
        _compare_uint8(f"config 4 smooth {label}", img, ref, "the chunked pure-torch smooth route")
    return launches


def phase_cs_golden() -> None:
    """The first Adam step's loss and every gradient leaf at 960x540 (the
    route's smallest frame) through make_loss_fn, which takes the culled
    route there (3 launches of each kernel), against the JAX golden: f32
    under the noise rule, the f64 loss within F64_RTOL and its gradients
    within CS_F64_RTOL."""
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params

    golden = np.load(REPO / CS_GOLDEN)
    for dtype in (torch.float32, torch.float64):
        scene = _big_scene(dtype, WIDTH, HEIGHT)
        target = torch.tensor(golden["image"], dtype=dtype, device=DEVICE) / 255.0
        params = scene_to_params(scene)
        _reset_launches()
        loss = make_loss_fn(scene, target, _cs_cfg(dtype))(params)
        loss.backward()
        torch.cuda.synchronize()
        tag = str(dtype).split(".")[-1]
        _expect_launched(f"the {tag} loss at 960x540", _launches(), CS, exactly=CS_DEPTH, absent=SMOOTH)
        print(f"[main] config-4 smooth first step {tag} at {WIDTH}x{HEIGHT}: loss {float(loss.detach()):.8e}, the JAX "
              f"golden f32 {float(golden['loss']):.8e}, f64 {float(golden['loss64']):.8e}")
        if dtype == torch.float32:
            _noise_check("config-4 smooth first-step loss (peer: the JAX f32 golden)", loss, golden["loss"], golden["loss64"])
            for key, g in _leaf_grads(params).items():
                _noise_check(f"config-4 smooth first step d/d{key} (peer: the JAX f32 golden)", g,
                             golden[f"grad/{key}"], golden[f"grad64/{key}"])
        else:
            _relative_check("config-4 smooth first-step loss f64 vs the JAX f64 golden", loss.cpu(),
                            torch.as_tensor(golden["loss64"]), F64_RTOL)
            for key, g in _leaf_grads(params).items():
                _relative_check(f"config-4 smooth first step d/d{key} f64 vs the JAX f64 golden", g.cpu(),
                                torch.as_tensor(golden[f"grad64/{key}"]), CS_F64_RTOL)


def _cs_bound(name: str, r: dict) -> tuple[float, str]:
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    args, kw = r[{"near_cs": "near", "fwd_cs": "fwd", "bwd_cs": "bwd"}[name]]
    ci = 4 if name == "near_cs" else 7  # the nearest lists, or the shadow lists
    return _list_bound(getattr(cs, f"{name}_plain"), getattr(cs, name), args, kw, ci)


def phase_cs_timing(card: str, record: list[dict]) -> dict[str, dict]:
    """The three kernels on each bounce of the config-4 step (CUDA events),
    beside their plain versions and bounds; the config-4 culled smooth Adam
    step in ms/step with a torch.profiler split into the kernels and the
    glue; the smooth frame in ms/frame."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    parts = {"near_cs": "near", "fwd_cs": "fwd", "bwd_cs": "bwd"}
    with torch.no_grad():
        res = {
            name: _time_launches(
                name,
                [(lambda r=r, f=getattr(cs, name): f(*r[parts[name]][0], **r[parts[name]][1]),
                  lambda r=r, f=getattr(cs, f"{name}_plain"): f(*r[parts[name]][0], **r[parts[name]][1]),
                  lambda r=r: _cs_bound(name, r)) for r in record],
                card, "config 4 smooth step, 1920x1080 f32", f"the step's {len(record)}",
            )
            for name in CS
        }
    n, s = BIG_WIDTH * BIG_HEIGHT, BIG_SPHERES
    n_pad = -(-n // 4096) * 4096
    print(f"[timing] bwd_cs table-gradient rows per launch: {cs.grad_rows_bytes(n_pad, s, 4096, torch.float32)} bytes f32, "
          f"{cs.grad_rows_bytes(n_pad, s, 4096, torch.float64)} f64 (config 4: {n_pad // 4096} tiles x 8 warps x "
          f"(19 x {s} + 16) values)", flush=True)

    scene = _big_scene(torch.float32)
    with torch.no_grad():
        target = torch.clamp(render(scene, dataclasses.replace(_big_cfg(use_pallas=True), max_depth=CS_DEPTH)), 0.0, 1.0)
        ms = time_ms(lambda: render(scene, _cs_cfg()), warmup=1, iters=5)
    print(f"[timing] config-4 smooth frame (render(), culled smooth route, 1920x1080 depth 3, f32): {ms:.3f} ms/frame, "
          f"{n / (ms * 1e-3):.4e} primary rays/s ({card})", flush=True)
    ms, step_k, state = _best_step_ms(make_loss_fn(scene, target, _cs_cfg()), scene, warmup=2, steps=3)
    print(f"[timing] config-4 culled smooth Adam step: {ms:.3f} ms/step, {n / (ms * 1e-3):.4e} primary rays/s "
          f"(1920x1080 depth 3, 1024 spheres, f32, best of 3 calls of 3 steps; {card})", flush=True)
    _device_profile(lambda: step_k(state, 1), "config-4 culled smooth Adam step", card, CS + ("reduce_cs",))
    return res


# --- The smooth kernels past 256 spheres: BASELINE config 5, and the lane range ---


def _table_inputs(scene_name: str, n_spheres: int, width: int, height: int, depth: int, dtype: torch.dtype):
    """Rays, tables and scalars of ``<scene_name>_scene(n_spheres)``, as the smooth route makes them."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import _kernel_inputs

    scene = getattr(scenes, f"{scene_name}_scene")(n_spheres, width, height, dtype=dtype, device=DEVICE)
    cfg = _smooth_cfg(dtype, use_pallas=True)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    return _kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)


def phase_blocked_kernels(card: str) -> tuple[dict[str, float], dict[str, dict]]:
    """The five smooth kernels against their plain versions at 1024 spheres
    (staged geometry) and 4096 (f64, geometry from global memory), and the
    one-bounce pair at 8192 (from global memory; f32, and f64 on the same
    inputs upcast), under the existing limits, the gradient kernels twice
    and bitwise; each kernel's resident blocks per SM and the partials'
    bytes.  The timed cases (config 5's f32 frame at depth 3, and the 8192
    pair at 256x144) count their plain version's operations in the same call
    and time each kernel there.  Returns the max abs error per kernel of the
    8192 f32 pair, and the timings ``{case: {kernel: dict}}``."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    lane_errs: dict[str, float] = {}
    timings: dict[str, dict] = {}
    for scene_name, s, width, height, depth, dtype, glossy, kernels, timed in BLOCKED_CASES:
        o, d, tables, kw = _table_inputs(scene_name, s, width, height, depth, dtype)
        n = d.shape[1]
        xis = _xis(glossy, n, max(depth, 2), dtype)
        tag = str(dtype).split(".")[-1]
        label = f"{scene_name}({s}) depth {depth} {tag} {width}x{height}{' glossy' if glossy else ''}"
        smem = bss.shared_bytes(dtype, s)
        occupancy = {k: bss.blocks_per_sm(k, dtype, glossy, s) for k in kernels}
        print(f"[blocked] {label}: geometry {'staged in shared memory' if smem > 16 * dtype.itemsize else 'read from global memory'} "
              f"({smem} B of shared memory a block); "
              f"resident 128-thread blocks per SM {occupancy}; partials {bss.partials_bytes(n, s, dtype)} B "
              f"= (23 x {s} + 17) x {min(-(-n // 32), bss.PARTIAL_COLS)} columns x {dtype.itemsize} B", flush=True)
        plain_ms: dict | None = {} if timed else None
        t0 = time.perf_counter()
        if kernels == SMOOTH:
            err, outs = _check_smooth_case(label, o, d, tables, kw, xis, dtype, plain_ms, state_by_kernel=True)
            calls = outs["calls"]
        else:
            err = dict.fromkeys(SMOOTH, 0.0)
            calls = _check_step_pair(label, o, d, tables, kw, xis, dtype, err, state_by_kernel=True, plain_ms=plain_ms,
                                     also_f64=True)
        print(f"[blocked] {label}: checked in {time.perf_counter() - t0:.1f} s", flush=True)
        if kernels == STEP and dtype == torch.float32:
            lane_errs = {k: err[k] for k in STEP}
        if timed:
            res = {}
            for name in kernels:
                call, n_bytes = calls[name]
                ms = time_ms(call, warmup=2, iters=10)
                p_ms, ops = plain_ms[name]
                bound_ms, bound_by = _bound(ops, n_bytes)
                res[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                print(f"[timing] {name} at {label}: kernel {ms:.4f} ms, plain version {p_ms:.1f} ms (one call, under "
                      f"the op counter), bound {bound_ms:.4f} ms by {bound_by} ({ops / n:.0f} operations per ray, "
                      f"{n_bytes} bytes), kernel at {bound_ms / ms:.1%} of its bound; {occupancy[name]} blocks per SM "
                      f"({card})", flush=True)
            timings[label] = res
        else:
            for name in kernels:
                ms = time_ms(calls[name][0], warmup=1, iters=5)
                print(f"[timing] {name} at {label}: kernel {ms:.4f} ms ({card})", flush=True)
    return lane_errs, timings


def _c5_scene(dtype: torch.dtype, n_spheres: int = C5_SPHERES):
    from python_ray_tracer_tpu_torch.models.scenes import inverse_task_scene

    return inverse_task_scene(n_spheres, C5_WIDTH, C5_HEIGHT, dtype=dtype, device=DEVICE)


def _lane_scene(dtype: torch.dtype = torch.float32):
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    return random_spheres_scene(LANE_SPHERES, C5_WIDTH, C5_HEIGHT, dtype=dtype, device=DEVICE)


def _c5_cfg(dtype: torch.dtype = torch.float32):
    return dataclasses.replace(_smooth_cfg(dtype, use_pallas=True), max_depth=C5_DEPTH)


def _c5_target(scene) -> torch.Tensor:
    """The L2 target of a training step: config 5's clipped hard render
    (the culled pair up to 4096 spheres), or past 4096 spheres 0.9 x the
    clipped smooth frame (the one-bounce pair; no other kernel family)."""
    from python_ray_tracer_tpu_torch import render

    with torch.no_grad():
        if scene.spheres.count <= 4096:
            return torch.clamp(render(scene, dataclasses.replace(_c5_cfg(), visibility="hard")), 0.0, 1.0)
        return torch.clamp(render(scene, _c5_cfg()), 0.0, 1.0) * 0.9


def phase_c5_main(tmp: Path) -> dict[str, int]:
    """The slice's main paths: ``optimize --builtin random1024 --width 480
    --height 270 --visibility smooth`` 3 steps (exactly one train_deep a
    step, nothing else smooth) and the smooth CLI frame at that size
    (smooth_fwd_deep) against the chunked pure-torch route; config 5's first
    Adam step (inverse_task_scene(1024), 256x144, depth 3) through
    make_loss_fn, one train_deep, against the JAX golden (f32 under the noise
    rule, f64 within F64_RTOL); and an Adam step past 4096 spheres
    (random_spheres_scene(8192), 256x144, depth 3): exactly depth launches
    each of smooth_fwd_step and smooth_bwd_step.  Returns the launches of
    train_deep (config 5's first step) and of the pair past 4096 spheres."""
    from python_ray_tracer_tpu_torch import cli
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    others = SMOOTH + CS
    size = ["--builtin", "random1024", "--width", "480", "--height", "270", "--depth", str(C5_DEPTH)]
    _cli_render(tmp, "c5_target.png", *size)
    metrics = tmp / "c5_optimize.jsonl"
    _reset_launches()
    cli.main(["optimize", *size, "--visibility", "smooth", "--target", str(tmp / "c5_target.png"), "--steps", "3",
              "--sync-every", "3", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize --builtin random1024 480x270 smooth, 3 steps", counts, ("train_deep",), exactly=3,
                     absent=tuple(k for k in others if k != "train_deep"))
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    print(f"[main] cli optimize random1024 480x270 smooth: {len(losses)} steps, losses {losses}")
    if len(losses) != 3 or not all(np.isfinite(losses)):
        fail(f"cli optimize random1024 480x270 logged {len(losses)} losses, finite: {all(np.isfinite(losses))}")
    _reset_launches()
    img = _cli_render(tmp, "c5_smooth.png", *size, "--visibility", "smooth")
    # The CLI renders twice: a first call, then the timed one.
    _expect_launched("the smooth CLI render, random1024 480x270", _launches(), ("smooth_fwd_deep",), exactly=2,
                     absent=tuple(k for k in others if k != "smooth_fwd_deep"))
    scene = _big_scene(torch.float32, 480, 270)
    ref = to_uint8(_pure_frame(scene, dataclasses.replace(_c5_cfg(), use_pallas=False), None))
    _compare_uint8("random1024 480x270 smooth", img, ref, "the chunked pure-torch smooth route")

    launches: dict[str, int] = {}
    golden = np.load(REPO / C5_GOLDEN)
    for dtype in (torch.float32, torch.float64):
        scene = _c5_scene(dtype)
        target = torch.tensor(golden["image"], dtype=dtype, device=DEVICE) / 255.0
        params = scene_to_params(scene)
        _reset_launches()
        loss = make_loss_fn(scene, target, _c5_cfg(dtype))(params)
        loss.backward()
        torch.cuda.synchronize()
        tag = str(dtype).split(".")[-1]
        counts = _launches()
        _expect_launched(f"config 5's first step, {tag}", counts, ("train_deep",), exactly=1,
                         absent=tuple(k for k in others if k != "train_deep"))
        if dtype == torch.float32:
            launches["train_deep"] = counts["train_deep"]
        print(f"[main] config-5 first step {tag}: loss {float(loss.detach()):.8e}, the JAX golden f32 "
              f"{float(golden['loss']):.8e}, f64 {float(golden['loss64']):.8e}")
        if dtype == torch.float32:
            _noise_check("config-5 first-step loss (peer: the JAX f32 golden)", loss, golden["loss"], golden["loss64"])
            for key, g in _leaf_grads(params).items():
                _noise_check(f"config-5 first step d/d{key} (peer: the JAX f32 golden)", g,
                             golden[f"grad/{key}"], golden[f"grad64/{key}"])
        else:
            _relative_check("config-5 first-step loss f64 vs the JAX f64 golden", loss.cpu(),
                            torch.as_tensor(golden["loss64"]), F64_RTOL)
            for key, g in _leaf_grads(params).items():
                _relative_check(f"config-5 first step d/d{key} f64 vs the JAX f64 golden", g.cpu(),
                                torch.as_tensor(golden[f"grad64/{key}"]), F64_RTOL)

    scene = _lane_scene()
    target = _c5_target(scene)
    params = scene_to_params(scene)
    _reset_launches()
    loss = make_loss_fn(scene, target, _c5_cfg())(params)
    loss.backward()
    torch.cuda.synchronize()
    counts = _launches()
    _expect_launched(f"an L2 step at {LANE_SPHERES} spheres", counts, STEP, exactly=C5_DEPTH,
                     absent=tuple(k for k in others if k not in STEP))
    grads = _leaf_grads(params)
    if not (np.isfinite(float(loss.detach())) and all(bool(torch.isfinite(g).all()) for g in grads.values())):
        fail(f"the L2 step at {LANE_SPHERES} spheres gave a non-finite loss or gradient")
    print(f"[main] L2 step at {LANE_SPHERES} spheres: loss {float(loss.detach()):.8e}", flush=True)
    launches.update({LANE[k]: counts[k] for k in STEP})
    return launches


def phase_c5_timing(card: str) -> None:
    """Config 5's Adam step (ms/step, rays/s) with a torch.profiler split and
    the busy share, and the Adam step at 8192 spheres (one-bounce pair)."""
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    n = C5_WIDTH * C5_HEIGHT
    for label, scene, kernels in (
        (f"config 5 ({C5_SPHERES} spheres, train_deep)", _c5_scene(torch.float32), ("train_deep", "reduce_partials")),
        (f"{LANE_SPHERES} spheres (one-bounce pair)", _lane_scene(), STEP + ("reduce_partials",)),
    ):
        ms, step_k, state = _best_step_ms(make_loss_fn(scene, _c5_target(scene), _c5_cfg()), scene, warmup=3, steps=10)
        print(f"[timing] Adam step, {label}: {ms:.3f} ms/step, {n / (ms * 1e-3):.4e} primary rays/s "
              f"({C5_WIDTH}x{C5_HEIGHT} depth {C5_DEPTH}, f32, best of 3 calls of 10 steps; {card})", flush=True)
        _device_profile(lambda: step_k(state, 1), f"Adam step, {label}", card, kernels)


def _cs_worst_lanes(tag: str, record: list[dict], gaps: list) -> None:
    """Satellite of the bwd_cs check: on the bounce whose f32 ray gradients
    part most from the plain version, the worst lanes with their value
    scale, sharpness x |disc| and the f64 gap on the same inputs in float64."""
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    def worst(k, p):
        return float(((k.double() - p.double()).abs() / p.double().abs().clamp_min(1.0)).max())

    b, k32, p32 = max(gaps, key=lambda g: max(worst(k, p) for k, p in zip(g[1], g[2])))
    args, kw = record[b]["bwd"]
    up = [a.double() if isinstance(a, torch.Tensor) and a.dtype.is_floating_point else a for a in args]
    k64 = cs.bwd_cs(*up, **kw)
    p64 = cs.bwd_cs_plain(*up, **kw)
    sdisc = _sharp_disc(args[0], args[1], args[13], args[4], kw["sharp_e"])[None]
    for j, grad in enumerate(("g_o", "g_d")):
        _worst_lanes(f"bwd_cs {tag} bounce {b} {grad}", k32[j], p32[j], k64[j], p64[j], sdisc)


# --- Image textures: the atlas mode of the nine kernels that take an atlas ------


def make_texture(side: int = TEX_SIDE) -> np.ndarray:
    """The texture-recovery task's test pattern (the JAX package's
    benchmarks/texture_recovery_demo.py make_texture): hue gradient, rings
    and a checker quadrant, in [0.15, 0.85]."""
    y, x = np.mgrid[0:side, 0:side] / side
    r = np.hypot(x - 0.5, y - 0.5)
    tex = np.stack(
        [
            0.5 + 0.5 * np.sin(2 * np.pi * (x * 3 + r * 4)),
            0.5 + 0.5 * np.cos(2 * np.pi * (y * 2 - r * 6)),
            ((x * 8).astype(int) % 2 == (y * 8).astype(int) % 2).astype(float),
        ],
        axis=-1,
    )
    return (0.15 + 0.7 * tex).astype(np.float32)


def _tex_scene(dtype: torch.dtype):
    from python_ray_tracer_tpu_torch.models.scenes import texture_task_scene

    return texture_task_scene(make_texture(), TEX_WIDTH, TEX_HEIGHT, dtype=dtype, device=DEVICE)


def _textured_scene(dtype: torch.dtype, width: int = BIG_WIDTH, height: int = BIG_HEIGHT):
    from python_ray_tracer_tpu_torch.models.scenes import textured_spheres_scene

    return textured_spheres_scene(BIG_SPHERES, width, height, dtype=dtype, device=DEVICE)


def _tex_cfg(dtype: torch.dtype = torch.float32, depth: int = TEX_DEPTH, **kw):
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=depth, dtype=dtype, visibility="smooth", use_pallas=True, **kw)


def _tex_kernel_inputs(dtype: torch.dtype, depth: int):
    """Rays, tables, scalars and the atlas's slot extents of the texture task,
    as the sub routes make them."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import _kernel_inputs

    scene = _tex_scene(dtype)
    o, d, tables, kw = _kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene,
                                      _tex_cfg(dtype, depth))
    return o, d, tables, kw, (TEX_SIDE, TEX_SIDE)


def _seeded(shape, like: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded cotangents in [-0.5, 0.5) on the card."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=DEVICE, dtype=like.dtype) - 0.5


def _check_texels(label: str, name: str, kernel: tuple, plain: tuple, dtype: torch.dtype, err: dict,
                  image_lanes: bool = True) -> int:
    """The atlas outputs of a forward kernel: the flat texel ids exactly and
    dww under the per-value limit.  Returns the lanes with a texel weight,
    of which there must be some unless ``image_lanes`` is false (a bounce of
    a multi-bounce path, whose caller checks the path's sum)."""
    (kflat, kdww), (pflat, pdww) = kernel, plain
    _exact_check(f"{name} (atlas) {label} flat", kflat, pflat)
    err[name] = max(err[name], _per_value_check(f"{name} (atlas) {label} dww", kdww, pdww, dtype))
    n_image = int((kdww != 0).sum())
    print(f"[kernels] {name} (atlas) {label}: {n_image} lanes carry a texel weight, {int(kflat.unique().numel())} "
          f"distinct texel ids", flush=True)
    if image_lanes and n_image == 0:
        fail(f"{name} (atlas) {label}: no image lane")
    return n_image


def _check_sub_atlas(dtype: torch.dtype, err: dict) -> dict:
    """The four unculled kernels of the texture task at 320x180 (two hard,
    four smooth) in their atlas mode against their plain versions: the deep
    kernels at depth 2, the one-bounce ones on the bounce from the camera;
    the smooth backward kernels with nonzero acc and dww cotangents, twice,
    bitwise.  Returns the calls for the timings (f32)."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops import bounce_sub as bs

    tag = f"texture task {str(dtype).split('.')[-1]} {TEX_WIDTH}x{TEX_HEIGHT}"
    o, d, tables, kw, tex_hw = _tex_kernel_inputs(dtype, TEX_DEPTH)
    hkw = dict(faraway=kw["faraway"], s_cheap=kw["s_cheap"], tex_hw=tex_hw)
    ones, zeros = torch.ones_like(d[0]), torch.zeros_like(d)
    calls = {}

    k = bs.trace_deep(o, d, *tables, depth=TEX_DEPTH, **hkw)
    p = bs.trace_deep_plain(o, d, *tables, depth=TEX_DEPTH, **hkw)
    torch.cuda.synchronize()
    err["trace_deep"] = max(err["trace_deep"], _per_value_check(f"trace_deep (atlas) {tag} depth 2 acc", k[0], p[0], dtype))
    _check_texels(f"{tag} depth 2", "trace_deep", k[1:], p[1:], dtype, err)
    calls["trace_deep"] = (lambda: bs.trace_deep(o, d, *tables, depth=TEX_DEPTH, **hkw),
                           lambda: bs.trace_deep(o, d, *tables, depth=TEX_DEPTH, **{**hkw, "tex_hw": None}),
                           lambda: bs.trace_deep_plain(o, d, *tables, depth=TEX_DEPTH, **hkw), _nbytes(o, d, *k))

    state = (o, d, ones, ones, zeros)
    k = bs.bounce_step(*state, *tables, **hkw)
    p = bs.bounce_step_plain(*state, *tables, **hkw)
    torch.cuda.synchronize()
    for out_name, a, b in zip(("o", "d", "thr", "alive", "acc"), k, p):
        err["bounce_step"] = max(err["bounce_step"], _per_value_check(f"bounce_step (atlas) {tag} {out_name}", a, b, dtype))
    _check_texels(tag, "bounce_step", k[5:], p[5:], dtype, err)
    calls["bounce_step"] = (lambda: bs.bounce_step(*state, *tables, **hkw),
                            lambda: bs.bounce_step(*state, *tables, **{**hkw, "tex_hw": None}),
                            lambda: bs.bounce_step_plain(*state, *tables, **hkw), _nbytes(*state, *k))

    akw = dict(kw, tex_hw=tex_hw)
    fk = bss.smooth_fwd_deep(o, d, *tables, **akw)
    fp = bss.smooth_fwd_deep_plain(o, d, *tables, **akw)
    torch.cuda.synchronize()
    for out_name, a, b in zip(("acc", "osave", "dsave", "thrsave", "alivesave", "idx", "hit", "clear"), fk, fp):
        err["smooth_fwd_deep"] = max(err["smooth_fwd_deep"],
                                     _per_value_check(f"smooth_fwd_deep (atlas) {tag} {out_name}", a, b, dtype))
    _check_texels(tag, "smooth_fwd_deep", fk[8:], fp[8:], dtype, err)
    g_acc, g_dww = _cotangent(d), _seeded((TEX_DEPTH, d.shape[1]), d, 5)
    res = fp[1:8]
    bkw = dict(akw, g_dww=g_dww)
    bk = _twice_bitwise("smooth_bwd_deep (atlas)", tag, lambda: bss.smooth_bwd_deep(o, d, *res, *tables, g_acc, **bkw))
    bp = bss.smooth_bwd_deep_plain(o, d, *res, *tables, g_acc, **bkw)
    f64 = _f64_outputs(
        lambda *a, **k_: bss.smooth_bwd_deep(*a[:-1], g_dww=a[-1], **k_),
        lambda *a, **k_: bss.smooth_bwd_deep_plain(*a[:-1], g_dww=a[-1], **k_),
        (o, d, *res, *tables, g_acc, None, g_dww), akw,
    )
    for j, (out_name, a, b) in enumerate(zip(GRAD_NAMES, bk, bp)):
        err["smooth_bwd_deep"] = max(err["smooth_bwd_deep"],
                                     _grad_check(f"smooth_bwd_deep (atlas) {tag}", out_name, a, b, dtype, _nth(f64, j)))
    calls["smooth_fwd_deep"] = (lambda: bss.smooth_fwd_deep(o, d, *tables, **akw),
                                lambda: bss.smooth_fwd_deep(o, d, *tables, **kw),
                                lambda: bss.smooth_fwd_deep_plain(o, d, *tables, **akw), _nbytes(o, d, *fk))
    calls["smooth_bwd_deep"] = (lambda: bss.smooth_bwd_deep(o, d, *res, *tables, g_acc, **bkw),
                                lambda: bss.smooth_bwd_deep(o, d, *res, *tables, g_acc, **kw),
                                lambda: bss.smooth_bwd_deep_plain(o, d, *res, *tables, g_acc, **bkw),
                                _nbytes(o, d, *res, g_acc, g_dww, *bk))

    skw = {k_: v for k_, v in akw.items() if k_ != "depth"}
    fk = bss.smooth_fwd_step(*state, *tables, **skw)
    fp = bss.smooth_fwd_step_plain(*state, *tables, **skw)
    torch.cuda.synchronize()
    for out_name, a, b in zip(("o", "d", "thr", "alive", "acc", "idx", "hit", "clear"), fk, fp):
        err["smooth_fwd_step"] = max(err["smooth_fwd_step"],
                                     _per_value_check(f"smooth_fwd_step (atlas) {tag} {out_name}", a, b, dtype))
    _check_texels(tag, "smooth_fwd_step", fk[8:], fp[8:], dtype, err)
    cots = _step_cotangents(fp)
    g_dww1 = _seeded((d.shape[1],), d, 6)
    sargs = (*state[:4], *fp[5:8], *tables, *cots)
    sbkw = dict(skw, g_dww=g_dww1)
    bk = _twice_bitwise("smooth_bwd_step (atlas)", tag, lambda: bss.smooth_bwd_step(*sargs, **sbkw))
    bp = bss.smooth_bwd_step_plain(*sargs, **sbkw)
    f64 = _f64_outputs(
        lambda *a, **k_: bss.smooth_bwd_step(*a[:-1], g_dww=a[-1], **k_),
        lambda *a, **k_: bss.smooth_bwd_step_plain(*a[:-1], g_dww=a[-1], **k_),
        (*sargs, None, g_dww1), skw,
    )
    bwd_names = ("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts")
    for j, (out_name, a, b) in enumerate(zip(bwd_names, bk, bp)):
        err["smooth_bwd_step"] = max(err["smooth_bwd_step"],
                                     _grad_check(f"smooth_bwd_step (atlas) {tag}", out_name, a, b, dtype, _nth(f64, j)))
    nkw = {k_: v for k_, v in kw.items() if k_ != "depth"}
    calls["smooth_fwd_step"] = (lambda: bss.smooth_fwd_step(*state, *tables, **skw),
                                lambda: bss.smooth_fwd_step(*state, *tables, **nkw),
                                lambda: bss.smooth_fwd_step_plain(*state, *tables, **skw), _nbytes(*state, *fk))
    calls["smooth_bwd_step"] = (lambda: bss.smooth_bwd_step(*sargs, **sbkw),
                                lambda: bss.smooth_bwd_step(*sargs, **nkw),
                                lambda: bss.smooth_bwd_step_plain(*sargs, **sbkw), _nbytes(*sargs, g_dww1, *bk))
    return calls


def _bwd_cs_g_dww(args, kw):
    """bwd_cs's recorded call with its dww cotangent moved to the end of the
    arguments (so that the bound's one-tile slice cuts it too)."""
    kw = dict(kw)
    return (*args, kw.pop("g_dww")), kw


def _bwd_cs_last(fn):
    return lambda *a, **kw: fn(*a[:-1], g_dww=a[-1], **kw)


def phase_atlas_kernels() -> tuple[dict[str, float], dict]:
    """The nine kernels' atlas mode against their plain versions on their
    paths' inputs: the texture task (320x180) for the four unculled kernels,
    f32 and f64; shade_culled on every bounce of the textured1024 mirror
    frame (f32 1920x1080, f64 480x270); fwd_cs and bwd_cs on every bounce of
    a textured1024 smooth loss (f32 960x540, f64 480x270).  Texel ids
    exactly, the rest under the per-value, per-ray and per-column limits;
    the gradient kernels twice, bitwise.  Returns the max abs error per
    kernel (f32) and the f32 calls and records for the timings."""
    from python_ray_tracer_tpu_torch.ops import culled, culled_smooth as cs

    errs = dict.fromkeys(ATLAS, 0.0)
    inputs = {}
    for dtype in (torch.float32, torch.float64):
        err = dict.fromkeys(ATLAS, 0.0)
        calls = _check_sub_atlas(dtype, err)
        size = (BIG_WIDTH, BIG_HEIGHT) if dtype == torch.float32 else BIG_F64_SIZE
        record = _culled_record(dtype, *size, scene=_textured_scene(dtype, *size))
        tag = f"textured1024 {str(dtype).split('.')[-1]} {size[0]}x{size[1]}"
        n_image = 0
        with torch.no_grad():
            for b, r in enumerate(record):
                sk = culled.shade_culled(*r["shade"], **r["shade_kw"])
                torch.cuda.synchronize()
                sp = culled.shade_culled_plain(*r["shade"], **r["shade_kw"])
                for name, k, p in zip(("o", "d", "thr", "alive", "acc"), sk, sp):
                    err["shade_culled"] = max(err["shade_culled"],
                                              _per_value_check(f"shade_culled (atlas) {tag} bounce {b} {name}", k, p, dtype))
                n_image += _check_texels(f"{tag} bounce {b}", "shade_culled", sk[5:], sp[5:], dtype, err, False)
        if n_image == 0:
            fail(f"shade_culled (atlas) {tag}: no image lane on any bounce")
        cs_size = TEX_CS_SIZE if dtype == torch.float32 else CS_F64_SIZE
        cs_record = _cs_record(dtype, *cs_size, False, scene=_textured_scene(dtype, *cs_size))
        tag = f"textured1024 smooth {str(dtype).split('.')[-1]} {cs_size[0]}x{cs_size[1]}"
        n_image = 0
        with torch.no_grad():
            for b, r in enumerate(cs_record):
                (fa, fkw), (ba, bkw) = r["fwd"], r["bwd"]
                fk = cs.fwd_cs(*fa, **fkw)
                torch.cuda.synchronize()
                fp = cs.fwd_cs_plain(*fa, **fkw)
                for name, k, p in zip(("o", "d", "thr", "alive", "acc", "clear"), fk, fp):
                    err["fwd_cs"] = max(err["fwd_cs"], _per_value_check(f"fwd_cs (atlas) {tag} bounce {b} {name}", k, p, dtype))
                n_image += _check_texels(f"{tag} bounce {b}", "fwd_cs", fk[6:], fp[6:], dtype, err, False)
                bk = _twice_bitwise("bwd_cs (atlas)", f"{tag} bounce {b}", lambda: cs.bwd_cs(*ba, **bkw))
                bp = cs.bwd_cs_plain(*ba, **bkw)
                for name, k, p in zip(("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts"), bk, bp):
                    err["bwd_cs"] = max(err["bwd_cs"], _grad_check(f"bwd_cs (atlas) {tag} bounce {b}", name, k, p, dtype))
        if n_image == 0 or not any(bool((r["bwd"][1]["g_dww"] != 0).any()) for r in cs_record):
            fail(f"fwd_cs/bwd_cs (atlas) {tag}: no image lane, or no dww cotangent, on any bounce")
        if dtype == torch.float32:
            errs = err
            inputs = dict(calls=calls, culled=record, cs=cs_record)
    return errs, inputs


def _atlas_launched(what: str, launches: dict[str, int], atlas: tuple[str, ...], exactly: int,
                    plain_kernels: tuple[str, ...] = (), plain_exactly: int | None = None) -> None:
    """The atlas mode of ``atlas`` launched exactly ``exactly`` times each,
    ``plain_kernels`` (no atlas) ``plain_exactly`` times, nothing else."""
    want = {ATLAS[k]: exactly for k in atlas}
    want.update({k: plain_exactly for k in plain_kernels})
    print(f"[main] launches during {what}: {launches}", flush=True)
    for k, v in launches.items():
        if v != want.get(k, 0):
            fail(f"{what} launched kernel {k} {v} times (expected {want.get(k, 0)})")


def _atlas_grad_check(label: str, got: torch.Tensor, want: np.ndarray) -> None:
    """The JAX package's rule for kernel-versus-XLA atlas gradients
    (tests/test_fused_smooth.py): at most 2% of the texels off by more than
    5e-3 of the largest |value|, and more than 10 texels nonzero."""
    got = got.detach().double().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    off = float((np.abs(got - want) > 5e-3 * scale).mean())
    nonzero = int((got != 0).sum())
    print(f"[main] {label}: {off:.4%} of texels off by more than 5e-3 of the largest |value| {scale:.3e} "
          f"(limit 2%), max_abs {float(np.abs(got - want).max()):.3e}, {nonzero} texels nonzero (limit > 10)", flush=True)
    if off >= 0.02 or nonzero <= 10:
        fail(f"{label}: {off:.4%} of texels off, {nonzero} nonzero")


def _tex_params(scene, every_leaf: bool = False):
    """The texture task's parameters, the atlas set to 0.5: the atlas alone
    (the recovery task), or beside every other leaf."""
    from python_ray_tracer_tpu_torch.optim import scene_to_params

    if every_leaf:
        params = scene_to_params(scene, atlas=True)
    else:
        params = scene_to_params(scene, sphere_fields=(), light_fields=(), camera=False, atlas=True)
    with torch.no_grad():
        params["textures.atlas"].fill_(0.5)
    return params


def phase_tex_main(tmp: Path) -> dict[str, int]:
    """The slice's main paths.  (a) ``render --builtin textured1024 --depth
    4`` at 1920x1080: the culled pair, shade_culled in its atlas mode,
    against the JAX golden.  (d) The texture task's hard frame at 320x180:
    one trace_deep (atlas) at depth 2, one bounce_step (atlas) at depth 1,
    against the pure-torch route.  (b) Training the atlas: the first step
    with every leaf trained beside the atlas, one smooth_fwd_deep and one
    smooth_bwd_deep (atlas), against the JAX golden (loss by the first-step
    rules, the atlas gradient by JAX's fraction rule; the atlas leaf's
    gradient does not depend on which other leaves are trained), bitwise
    across two runs, f64 too; 40 Adam steps (lr 0.03) of the atlas alone
    through optim.fit, the loss below 0.05x its start (with the atlas the
    only leaf nothing the kernel takes needs a gradient, so autograd, like
    JAX's, runs no backward kernel: one smooth_fwd_deep (atlas) a step); a
    depth-1 step with every leaf through the atlas step pair.  (c) ``optimize --builtin textured1024
    --visibility smooth`` at 960x540, 3 steps: exactly 3 near_cs and 3
    fwd_cs and bwd_cs (atlas) a step, the loss finite and falling.  Returns
    the launches of each path's kernels."""
    from python_ray_tracer_tpu_torch import cli, render
    from python_ray_tracer_tpu_torch.optim import fit, make_loss_fn
    from python_ray_tracer_tpu_torch.utils.image import save_png, to_uint8

    launches: dict[str, int] = {}
    size = ["--builtin", "textured1024", "--width", str(BIG_WIDTH), "--height", str(BIG_HEIGHT), "--depth", str(BIG_DEPTH)]
    _reset_launches()
    img = _cli_render(tmp, "textured.png", *size)
    counts = _launches()
    # The CLI renders each frame twice (a first call and a timed one).
    _atlas_launched("the textured1024 CLI render", counts, ("shade_culled",), 2 * BIG_DEPTH, ("near_culled",),
                    2 * BIG_DEPTH)
    launches.update({ATLAS["shade_culled"]: counts[ATLAS["shade_culled"]]})
    golden = np.load(REPO / TEXTURED_GOLDEN)["image"]
    seam = int((np.abs(img.astype(np.int32) - golden.astype(np.int32)) > 0).any(-1).sum())
    print(f"[main] textured1024: {seam} of {BIG_WIDTH * BIG_HEIGHT} pixels differ from the JAX golden (its libm UV "
          f"against the kernels' polynomial on seam lanes, and float order)", flush=True)
    _compare_uint8("textured1024 mirror", img, golden, "the JAX golden")

    scene = _tex_scene(torch.float32)
    for depth, name in ((TEX_DEPTH, "trace_deep"), (1, "bounce_step")):
        cfg = dataclasses.replace(_tex_cfg(depth=depth), visibility="hard")
        _reset_launches()
        with torch.no_grad():
            frame = render(scene, cfg)
        torch.cuda.synchronize()
        counts = _launches()
        _atlas_launched(f"the texture task's hard frame, depth {depth}", counts, (name,), 1)
        launches[ATLAS[name]] = counts[ATLAS[name]]
        with torch.no_grad():
            ref = render(scene, dataclasses.replace(cfg, use_pallas=False))
        _compare_uint8(f"texture task hard depth {depth}", to_uint8(frame), to_uint8(ref), "the pure-torch route")

    tex_golden = np.load(REPO / TEX_GOLDEN)
    grads = {}
    for dtype, run in ((torch.float32, 0), (torch.float32, 1), (torch.float64, 0)):
        scene = _tex_scene(dtype)
        target = torch.tensor(tex_golden["image"], dtype=dtype, device=DEVICE) / 255.0
        params = _tex_params(scene, every_leaf=True)
        _reset_launches()
        loss = make_loss_fn(scene, target, _tex_cfg(dtype))(params)
        loss.backward()
        torch.cuda.synchronize()
        tag = str(dtype).split(".")[-1]
        counts = _launches()
        _atlas_launched(f"the texture task's first step, every leaf, {tag}", counts,
                        ("smooth_fwd_deep", "smooth_bwd_deep"), 1)
        if not all(bool(torch.isfinite(g).all()) for g in _leaf_grads(params).values()):
            fail(f"the texture task's first step, {tag}: a non-finite gradient")
        if dtype == torch.float32 and run == 0:
            launches[ATLAS["smooth_bwd_deep"]] = counts[ATLAS["smooth_bwd_deep"]]
        grad = params["textures.atlas"].grad
        if run == 1:
            same = torch.equal(grad, grads[tag]) and torch.equal(loss.detach(), grads[f"{tag} loss"])
            print(f"[main] texture task first step f32, two runs: loss and atlas gradient bitwise equal: {same}", flush=True)
            if not same:
                fail("the texture task's atlas gradient differs between two runs")
            continue
        grads[tag], grads[f"{tag} loss"] = grad.clone(), loss.detach().clone()
        print(f"[main] texture task first step {tag}: loss {float(loss.detach()):.8e}, the JAX golden f32 "
              f"{float(tex_golden['loss']):.8e}, f64 {float(tex_golden['loss64']):.8e}")
        if dtype == torch.float32:
            _noise_check("texture task first-step loss (peer: the JAX f32 golden)", loss, tex_golden["loss"],
                         tex_golden["loss64"])
            _atlas_grad_check("texture task first step d/dtextures.atlas f32 vs the JAX f32 golden", grad,
                              tex_golden["grad/textures.atlas"])
        else:
            _relative_check("texture task first-step loss f64 vs the JAX f64 golden", loss.detach().cpu(),
                            torch.as_tensor(tex_golden["loss64"]), F64_RTOL)
            _atlas_grad_check("texture task first step d/dtextures.atlas f64 vs the JAX f64 golden", grad,
                              tex_golden["grad64/textures.atlas"])

    scene = _tex_scene(torch.float32)
    target = torch.tensor(tex_golden["image"], dtype=torch.float32, device=DEVICE) / 255.0
    _reset_launches()
    final, history = fit(scene, target, _tex_cfg(), _tex_params(scene), steps=TEX_STEPS + 1, learning_rate=TEX_LR)
    counts = _launches()
    _atlas_launched(f"fit, {TEX_STEPS + 1} Adam steps on the texture task's atlas", counts, ("smooth_fwd_deep",),
                    TEX_STEPS + 1)
    launches[ATLAS["smooth_fwd_deep"]] = counts[ATLAS["smooth_fwd_deep"]]
    print(f"[main] texture task, Adam lr {TEX_LR}: loss {history[0]:.6e} at step 0, {history[TEX_STEPS]:.6e} at step "
          f"{TEX_STEPS} ({history[TEX_STEPS] / history[0]:.4f}x; limit 0.05x)", flush=True)
    if not (np.isfinite(history).all() and history[TEX_STEPS] < 0.05 * history[0]):
        fail(f"the texture task's loss went {history[0]:.3e} -> {history[TEX_STEPS]:.3e} in {TEX_STEPS} steps")
    rec = np.clip(final["textures.atlas"].detach().cpu().numpy()[0], 0.0, 1.0)
    save_png(rec, tmp / "texture_recovered.png")

    params = _tex_params(scene, every_leaf=True)
    _reset_launches()
    loss = make_loss_fn(scene, target, _tex_cfg(depth=1))(params)
    loss.backward()
    torch.cuda.synchronize()
    counts = _launches()
    _atlas_launched("the texture task's step at depth 1, every leaf", counts, ("smooth_fwd_step", "smooth_bwd_step"), 1)
    launches.update({ATLAS[k]: counts[ATLAS[k]] for k in ("smooth_fwd_step", "smooth_bwd_step")})
    grads = _leaf_grads(params)
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()) or not np.isfinite(float(loss.detach())):
        fail("the texture task's depth-1 step gave a non-finite loss or gradient")
    if not bool((grads["textures.atlas"] != 0).any()):
        fail("the texture task's depth-1 step gave no atlas gradient")

    gray = np.full((TEX_CS_SIZE[1], TEX_CS_SIZE[0], 3), 0.5, np.float32)
    save_png(gray, tmp / "gray.png")
    metrics = tmp / "tex_optimize.jsonl"
    size = ["--builtin", "textured1024", "--width", str(TEX_CS_SIZE[0]), "--height", str(TEX_CS_SIZE[1]),
            "--depth", str(CS_DEPTH)]
    _reset_launches()
    cli.main(["optimize", *size, "--visibility", "smooth", "--target", str(tmp / "gray.png"), "--steps", "3",
              "--sync-every", "3", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _atlas_launched("cli optimize textured1024 960x540 smooth, 3 steps", counts, ("fwd_cs", "bwd_cs"), 3 * CS_DEPTH,
                    ("near_cs",), 3 * CS_DEPTH)
    launches.update({ATLAS[k]: counts[ATLAS[k]] for k in ("fwd_cs", "bwd_cs")})
    losses = [json.loads(line)["loss"] for line in metrics.read_text().splitlines()]
    print(f"[main] cli optimize textured1024 960x540 smooth (target: mid gray): losses {losses}", flush=True)
    if len(losses) != 3 or not all(np.isfinite(losses)) or not losses[2] < losses[0]:
        fail(f"cli optimize textured1024 960x540: losses {losses} (finite and falling expected)")
    return launches


def phase_atlas_timing(card: str, inputs: dict) -> dict[str, dict]:
    """Each atlas variant beside its no-atlas kernel on the same inputs, in
    turn (CUDA events), with its plain version and bound: the texture task's
    four unculled kernels at 320x180, shade_culled on the textured1024
    frame's 4 bounces, fwd_cs and bwd_cs on the 960x540 smooth loss's 3;
    then ms/frame of (a) with a torch.profiler split showing compose_texels,
    ms/step of (b) and of (c)."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import culled, culled_smooth as cs
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    res: dict[str, dict] = {}
    for name, (kernel, no_atlas, plain, n_bytes) in inputs["calls"].items():
        ms, base_ms = time_ms(kernel), time_ms(no_atlas)
        ms2 = time_ms(kernel)
        plain_ms = time_ms(plain, warmup=1, iters=3)
        bound_ms, bound_by = _bound(count_ops(plain), n_bytes)
        res[ATLAS[name]] = dict(ms=min(ms, ms2), plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
        print(f"[timing] {name} (atlas): kernel {ms:.4f} / {ms2:.4f} ms beside the no-atlas kernel's {base_ms:.4f} ms "
              f"on the same inputs in turn, plain version {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"(texture task {TEX_WIDTH}x{TEX_HEIGHT} f32; {card})", flush=True)

    def no_atlas(fn, args, kw):
        kw = {k: v for k, v in kw.items() if k not in ("tex_hw", "g_dww")}
        return lambda: fn(*args, **kw)

    with torch.no_grad():
        rows = [(lambda r=r: culled.shade_culled(*r["shade"], **r["shade_kw"]),
                 lambda r=r: culled.shade_culled_plain(*r["shade"], **r["shade_kw"]),
                 lambda r=r: _list_bound(culled.shade_culled_plain, culled.shade_culled, r["shade"], r["shade_kw"], 11))
                for r in inputs["culled"]]
        res[ATLAS["shade_culled"]] = _time_launches("shade_culled (atlas)", rows, card, "textured1024, 1920x1080 f32",
                                                    f"the mirror frame's {len(rows)}")
        for b, r in enumerate(inputs["culled"]):
            a_ms = time_ms(rows[b][0], warmup=2, iters=10)
            n_ms = time_ms(no_atlas(culled.shade_culled, r["shade"], r["shade_kw"]), warmup=2, iters=10)
            print(f"[timing] shade_culled bounce {b}: atlas {a_ms:.4f} ms, no atlas {n_ms:.4f} ms on the same inputs "
                  f"({a_ms / n_ms:.3f}x; {card})", flush=True)
        for name, part, ci in (("fwd_cs", "fwd", 7), ("bwd_cs", "bwd", 7)):
            rows = []
            for r in inputs["cs"]:
                args, kw = r[part]
                kernel, plain = getattr(cs, name), getattr(cs, f"{name}_plain")
                if name == "bwd_cs":
                    args, kw = _bwd_cs_g_dww(args, kw)
                    kernel, plain = _bwd_cs_last(kernel), _bwd_cs_last(plain)
                rows.append((lambda k=kernel, a=args, w=kw: k(*a, **w), lambda p=plain, a=args, w=kw: p(*a, **w),
                             lambda k=kernel, p=plain, a=args, w=kw: _list_bound(p, k, a, w, ci)))
            res[ATLAS[name]] = _time_launches(f"{name} (atlas)", rows, card, "textured1024 smooth, 960x540 f32",
                                              f"the loss's {len(rows)}")
            for b, r in enumerate(inputs["cs"]):
                args, kw = r[part]
                a_ms = time_ms(lambda: getattr(cs, name)(*args, **kw), warmup=2, iters=10)
                n_ms = time_ms(no_atlas(getattr(cs, name), args, kw), warmup=2, iters=10)
                print(f"[timing] {name} bounce {b}: atlas {a_ms:.4f} ms, no atlas {n_ms:.4f} ms on the same inputs "
                      f"({a_ms / n_ms:.3f}x; {card})", flush=True)

    scene = _textured_scene(torch.float32)
    cfg = _big_cfg(use_pallas=True)
    with torch.no_grad():
        ms = time_ms(lambda: render(scene, cfg), warmup=2, iters=5)
        print(f"[timing] textured1024 frame (render(), culled pair, atlas): {ms:.3f} ms/frame, "
              f"{BIG_WIDTH * BIG_HEIGHT / (ms * 1e-3):.4e} primary rays/s (1920x1080 depth 4, f32; {card})", flush=True)
        _device_profile(lambda: render(scene, cfg), "textured1024 frame", card, CULLED + ("index",))
        _range_profile(lambda: render(scene, cfg), "textured1024 frame", card, "compose_texels")

    scene = _tex_scene(torch.float32)
    target = torch.tensor(np.load(REPO / TEX_GOLDEN)["image"], dtype=torch.float32, device=DEVICE) / 255.0
    best, step_k, state = _best_step_ms(make_loss_fn(scene, target, _tex_cfg()), scene, warmup=5, steps=20,
                                        params=_tex_params(scene), lr=TEX_LR)
    print(f"[timing] texture task Adam step (the atlas leaf alone: one smooth_fwd_deep (atlas) and the texel "
          f"scatter a step): {best:.4f} ms/step "
          f"({TEX_WIDTH}x{TEX_HEIGHT} depth {TEX_DEPTH}, f32, best of 3 calls of 20 steps; {card})", flush=True)
    _device_profile(lambda: step_k(state, 1), "texture task Adam step", card,
                    ("smooth_fwd_deep", "smooth_bwd_deep", "reduce_partials"))
    _range_profile(lambda: step_k(state, 1), "texture task Adam step", card, "compose_texels")

    scene = _textured_scene(torch.float32, *TEX_CS_SIZE)
    target = torch.full((TEX_CS_SIZE[1], TEX_CS_SIZE[0], 3), 0.5, device=DEVICE)
    best, step_k, state = _best_step_ms(make_loss_fn(scene, target, _cs_cfg()), scene, warmup=2, steps=2)
    print(f"[timing] textured1024 culled smooth Adam step (960x540 depth {CS_DEPTH}, f32, fwd_cs + bwd_cs atlas): "
          f"{best:.3f} ms/step (best of 3 calls of 2 steps; {card})", flush=True)
    _device_profile(lambda: step_k(state, 1), "textured1024 960x540 culled smooth Adam step", card,
                    CS + ("reduce_cs",))
    return res


def _range_profile(fn, label: str, card: str, name: str) -> None:
    """The device time of the kernels launched inside the named ranges
    ``name`` (and its backward) in one call of ``fn``, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.key.startswith(name) and e.device_type == torch.autograd.DeviceType.CPU:
            device_us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            print(f"[timing] {label}: range {e.key!r}, {e.count} calls, its kernels {device_us / 1e3:.3f} ms of device "
                  f"time, host {e.cpu_time_total / 1e3:.3f} ms ({card})", flush=True)

# --- The lane-layout hard bounce and the JSON-scene render path ----------------


def _lane80_scene(dtype: torch.dtype, width: int = LANE_WIDTH, height: int = LANE_HEIGHT):
    from python_ray_tracer_tpu_torch.io import load_scene

    return load_scene(REPO / LANE_SCENE, width=width, height=height, dtype=dtype, device=DEVICE)


def _lane_big_scene(dtype: torch.dtype, width: int, height: int, n_random: int = BIG_SPHERES,
                    atlas: bool = False):
    """Config 4's random_spheres_scene(1024) (its ground in the exact tier;
    ``n_random`` spheres in all) with 8 more r = 99999 spheres, built from
    the port's make_sphere_row: 9 in the exact tier, past the culled route's
    8, so render() takes the lane kernel.  One is a far back wall the rays
    see, seven lie under the ground: none stands between a sphere and the
    light, whose hard shadow test counts every sphere along the light ray,
    beyond the light too (a wall at either side would shade the whole
    scene).  With ``atlas``, every 4th random sphere shows one of lane80's
    first two textures."""
    from python_ray_tracer_tpu_torch import build_lights, build_spheres, make_scene, make_sphere_row
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene
    from python_ray_tracer_tpu_torch.scene import TEXTURE_IMAGE

    base = random_spheres_scene(n_random, width, height, dtype=torch.float64)
    sp = base.spheres
    fields = ("reflection_gain", "specular_gain", "specular_roughness", "iridescence_gain", "diffuse_gain",
              "specular_ior", "thin_film_weight", "thin_film_thickness", "thin_film_ior")

    def texture(k: int) -> dict:
        if atlas and k % 4 == 1:
            return dict(texture_kind=TEXTURE_IMAGE, texture_id=(k // 4) % 2)
        return dict(texture_kind=int(sp.texture_kind[k]), texture_id=int(sp.texture_id[k]))

    rows = [
        make_sphere_row(sp.center[k].tolist(), float(sp.radius[k]), diffuse_color=sp.diffuse_color[k].tolist(),
                        **texture(k), **{f: float(getattr(sp, f)[k]) for f in fields})
        for k in range(sp.count)
    ]
    walls = [((0.0, 0.0, 100060.0), (0.7, 0.8, 0.9))]
    walls += [((0.0, -100000.5 - 10.0 * i, 0.0), (1.0, 1.0, 1.0)) for i in range(7)]
    rows += [make_sphere_row(c, 99999.0, diffuse_gain=0.8, diffuse_color=col, specular_gain=0.2) for c, col in walls]
    lights = base.lights
    lights = build_lights(lights.point_position.tolist(), domes=list(zip(lights.dome_intensity.tolist(),
                          lights.dome_color.tolist())), dtype=dtype, device=DEVICE)
    tex = {}
    if atlas:
        lane80 = _lane80_scene(torch.float64, 16, 8)
        tex = dict(texture_atlas=lane80.texture_atlas[:2], texture_hw=lane80.texture_hw[:2].cpu().numpy())
    return make_scene(build_spheres(rows, dtype=dtype, device=DEVICE), lights, base.camera.position.tolist(),
                      width, height, dtype=dtype, device=DEVICE, **tex)


def _lane_cfg(dtype: torch.dtype = torch.float32):
    from python_ray_tracer_tpu_torch.io import load_settings

    cfg, _ = load_settings(REPO / LANE_SETTINGS)
    return dataclasses.replace(cfg, dtype=dtype)


def _lane_record(scene, dtype: torch.dtype) -> list[tuple]:
    """Each bounce's (args, kwargs) of bounce_lane in the scene's frame,
    traced through the kernel on the card (render() takes the lane route)."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import bounce_lane
    from python_ray_tracer_tpu_torch.render import hard_route

    cfg = _lane_cfg(dtype)
    if hard_route(scene, cfg, None) != "lane":
        fail(f"{scene.spheres.count} spheres ({scene.spheres.n_exact} exact): render() does not take the lane route")
    calls: list = []
    with _capture(bounce_lane, "bounce_lane", calls), torch.no_grad():
        render(scene, cfg)
    torch.cuda.synchronize()
    return calls


def _check_lane(tag: str, record: list, dtype: torch.dtype) -> float:
    """bounce_lane against its plain version on every bounce's inputs: twice,
    bitwise; alive exactly, the rest under the per-value limit."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    err = 0.0
    with torch.no_grad():
        for b, (args, kw) in enumerate(record):
            k = _twice_bitwise("bounce_lane", f"{tag} bounce {b}", lambda: bounce_lane.bounce_lane(*args, **kw))
            p = bounce_lane.bounce_lane_plain(*args, **kw)
            for name, kv, pv in zip(("o", "d", "thr", "alive", "acc"), k, p):
                if name == "alive":
                    _exact_check(f"bounce_lane {tag} bounce {b} alive", kv, pv)
                else:
                    err = max(err, _per_value_check(f"bounce_lane {tag} bounce {b} {name}", kv, pv, dtype))
    return err


def _lane_tag(name: str, scene, dtype: torch.dtype) -> str:
    sp, cam = scene.spheres, scene.camera
    return f"{name} ({sp.count} spheres, {sp.n_exact} exact) {str(dtype).split('.')[-1]} {cam.width}x{cam.height}"


def phase_lane_kernels() -> tuple[dict[str, float], dict]:
    """bounce_lane against its plain version on every bounce of both lane
    scenes: (a) lane80 (atlas mode) f32 1920x1080 and f64 480x270; (b) the
    1032-sphere scene f32 1920x1080 and f64 240x135.  Returns the max abs
    error of each variant, from the f32 records at the main path's
    1920x1080, and those records for the timings."""
    scenes = {"a": ("lane80", ATLAS["bounce_lane"], _lane80_scene),
              "b": ("config4+9exact", "bounce_lane", _lane_big_scene)}
    errs, inputs = {}, {}
    for key, (name, entry, make) in scenes.items():
        scene = make(torch.float32, LANE_WIDTH, LANE_HEIGHT)
        inputs[key] = _lane_record(scene, torch.float32)
        errs[entry] = _check_lane(_lane_tag(name, scene, torch.float32), inputs[key], torch.float32)
    for name, make, size in (("lane80", _lane80_scene, LANE_F64_SIZE),
                             ("config4+9exact", _lane_big_scene, LANE_BIG_F64_SIZE)):
        scene = make(torch.float64, *size)
        _check_lane(_lane_tag(name, scene, torch.float64), _lane_record(scene, torch.float64), torch.float64)
    return errs, inputs


def _lane_instantiation(args: tuple, kw: dict) -> tuple[str, ...]:
    """The template arguments (T, kAtlas, kStaged) of the bounce_lane
    instantiation that one launch with these arguments runs, from its name
    under torch.profiler."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from python_ray_tracer_tpu_torch.ops import bounce_lane

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        bounce_lane.bounce_lane(*args, **kw)
        torch.cuda.synchronize()
    found = {m.groups() for e in prof.key_averages() if (m := re.search(r"bounce_lane<(\w+), (\w+), (\w+)>", e.key))}
    if len(found) != 1:
        fail(f"bounce_lane: expected one kernel instantiation in the profile, found {sorted(found)}")
    return found.pop()


def _lane_geometry(tag: str, record: list, card: str) -> None:
    """bounce_lane with its geometry forced into shared memory and forced
    to global memory, on every bounce of ``record``: each bitwise the auto
    choice's output, each running its own instantiation (the profiler's
    kernel name), both timed per launch (CUDA events, mean over the
    bounces) beside the side the auto choice took."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    auto = _lane_instantiation(*record[0])
    ms = {}
    with torch.no_grad():
        for side, staged in (("shared", "true"), ("global", "false")):
            args, kw = record[0]
            got = _lane_instantiation(args, {**kw, "geometry": side})
            if got != (*auto[:2], staged):
                fail(f"bounce_lane {tag}: geometry={side} ran bounce_lane<{', '.join(got)}>")
            for b, (args, kw) in enumerate(record):
                want = bounce_lane.bounce_lane(*args, **kw)
                forced = bounce_lane.bounce_lane(*args, **kw, geometry=side)
                if not all(torch.equal(x, y) for x, y in zip(want, forced)):
                    fail(f"bounce_lane {tag} bounce {b}: geometry={side} differs from the auto choice")
            ms[side] = statistics.mean(
                time_ms(lambda a=a, k=k: bounce_lane.bounce_lane(*a, **k, geometry=side)) for a, k in record)
    took = "shared" if auto[2] == "true" else "global"
    print(f"[timing] bounce_lane {tag}: geometry in shared memory {ms['shared']:.4f} ms, from global memory "
          f"{ms['global']:.4f} ms a launch (mean of {len(record)}; bitwise equal); the auto choice took {took}, "
          f"bounce_lane<{', '.join(auto)}> ({card})", flush=True)


def phase_lane_geometry(card: str, inputs: dict) -> None:
    """Both sides of bounce_lane's geometry choice (_lane_geometry) on the
    1032- and 4104-sphere scenes, without and with an atlas, f32 480x270
    and f64 240x135, each first held against the plain version (every
    bounce, twice bitwise), and on the main path's 1920x1080 records of both
    lane scenes."""
    for n_random in LANE_GEOMETRY_RANDOM:
        for atlas in (False, True):
            for dtype, size in ((torch.float32, LANE_GEOMETRY_SIZE), (torch.float64, LANE_GEOMETRY_F64_SIZE)):
                scene = _lane_big_scene(dtype, *size, n_random=n_random, atlas=atlas)
                tag = _lane_tag("geometry" + (" atlas" if atlas else ""), scene, dtype)
                record = _lane_record(scene, dtype)
                _check_lane(tag, record, dtype)
                _lane_geometry(tag, record, card)
    _lane_geometry("lane80 (80 spheres, atlas) float32 1920x1080", inputs["a"], card)
    _lane_geometry("config4+9exact (1032 spheres) float32 1920x1080", inputs["b"], card)


def phase_lane_main(tmp: Path) -> dict[str, int]:
    """The JSON-scene render path on the card.  ``render --scene lane80.json
    --settings lane80_settings.json`` (use_pallas true: 1920x1080, depth 4):
    exactly 4 bounce_lane (atlas) launches a frame and no other kernel,
    within 0.1% of uint8 values of the JAX golden; one render() of it,
    exactly 4.  The 1032-sphere scene through render(): 4 bounce_lane
    launches (no atlas), and at 480x270 its frame against the pure-torch
    route.  ``--denoise`` against the CPU's denoise of the card's frame, and
    ``--profile`` writing a trace that holds the kernel."""
    from python_ray_tracer_tpu_torch import cli, render
    from python_ray_tracer_tpu_torch.utils.denoise import nl_means_denoise
    from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8

    launches: dict[str, int] = {}
    cmd = ["render", "--scene", str(REPO / LANE_SCENE), "--settings", str(REPO / LANE_SETTINGS)]
    _reset_launches()
    cli.main([*cmd, "-o", str(tmp / "lane80.png")])
    counts = _launches()
    # The CLI renders each frame twice (a first call and a timed one).
    _atlas_launched("the lane80 CLI render (two frames)", counts, BOUNCE_LANE, 2 * LANE_DEPTH)
    launches[ATLAS["bounce_lane"]] = counts[ATLAS["bounce_lane"]]
    _compare_uint8("lane80 1920x1080 depth 4", load_png(tmp / "lane80.png"), np.load(REPO / LANE_GOLDEN)["image"],
                   "the JAX golden")

    scene, cfg = _lane80_scene(torch.float32), _lane_cfg()
    _reset_launches()
    with torch.no_grad():
        frame = render(scene, cfg)
    torch.cuda.synchronize()
    _atlas_launched("one render() of lane80", _launches(), BOUNCE_LANE, LANE_DEPTH)

    big = _lane_big_scene(torch.float32, LANE_WIDTH, LANE_HEIGHT)
    _reset_launches()
    with torch.no_grad():
        img = render(big, cfg)
    torch.cuda.synchronize()
    counts = _launches()
    _atlas_launched("one render() of the 1032-sphere scene", counts, (), 0, BOUNCE_LANE, LANE_DEPTH)
    launches["bounce_lane"] = counts["bounce_lane"]
    if not bool(torch.isfinite(img).all()) or tuple(img.shape) != (LANE_HEIGHT, LANE_WIDTH, 3):
        fail("the 1032-sphere frame is not a finite (1080, 1920, 3) image")
    small = _lane_big_scene(torch.float32, *LANE_BIG_CHECK_SIZE)
    with torch.no_grad():
        kernel_frame = render(small, cfg)
    pure = _pure_frame(small, dataclasses.replace(cfg, use_pallas=False), None)
    _compare_uint8(f"1032 spheres {LANE_BIG_CHECK_SIZE[0]}x{LANE_BIG_CHECK_SIZE[1]} depth {LANE_DEPTH}",
                   to_uint8(kernel_frame), to_uint8(pure), "the pure-torch route")

    cli.main([*cmd, "--denoise", "-o", str(tmp / "lane80_denoised.png")])
    cpu = nl_means_denoise(torch.clamp(frame.cpu(), 0.0, 1.0))
    _compare_uint8("lane80 --denoise", load_png(tmp / "lane80_denoised.png"), to_uint8(cpu),
                   "the CPU's denoise of the card's frame")

    cli.main([*cmd, "--profile", str(tmp / "profile"), "-o", str(tmp / "lane80_profiled.png")])
    trace = tmp / "profile" / "trace.json"
    if not trace.exists() or "bounce_lane" not in trace.read_text():
        fail("render --profile wrote no trace, or a trace without the bounce_lane kernel")
    print(f"[main] render --profile wrote {trace.stat().st_size} bytes of torch.profiler trace", flush=True)
    return launches


def _lane_bound(args: tuple, kw: dict) -> tuple[float, str]:
    """The least time of one bounce_lane launch on these inputs: each input
    and output once, and the plain version's operations counted over 4096
    of the lanes, scaled to all of them (every lane sweeps every sphere
    twice)."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    n = args[0].shape[1]
    part = min(n, 4096)
    sliced = [a[..., :part] if isinstance(a, torch.Tensor) and a.shape[-1] == n else a for a in args]
    with torch.no_grad():
        ops = count_ops(lambda: bounce_lane.bounce_lane_plain(*sliced, **kw)) * n / part
        out = bounce_lane.bounce_lane(*args, **kw)
    return _bound(int(ops), _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out))


def phase_lane_timing(card: str, inputs: dict) -> dict[str, dict]:
    """bounce_lane on each of its launches of both scenes' 1920x1080 frames
    (CUDA events) beside its plain version and bound; each frame through
    render() in ms/frame, with a torch.profiler split."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    def calls(record):
        return [(lambda a=a, k=k: bounce_lane.bounce_lane(*a, **k),
                 lambda a=a, k=k: bounce_lane.bounce_lane_plain(*a, **k),
                 lambda a=a, k=k: _lane_bound(a, k)) for a, k in record]

    with torch.no_grad():
        res = {
            ATLAS["bounce_lane"]: _time_launches("bounce_lane (atlas)", calls(inputs["a"]), card,
                                                 "lane80, 80 spheres, 20,480 texels, 1920x1080 f32",
                                                 f"the lane80 frame's {LANE_DEPTH}"),
            "bounce_lane": _time_launches("bounce_lane", calls(inputs["b"]), card,
                                          "config 4 + 8 exact, 1032 spheres, 1920x1080 f32",
                                          f"the 1032-sphere frame's {LANE_DEPTH}"),
        }
        cfg = _lane_cfg()
        for label, scene in (("lane80 (80 spheres, atlas)", _lane80_scene(torch.float32)),
                             ("1032 spheres, 9 exact", _lane_big_scene(torch.float32, LANE_WIDTH, LANE_HEIGHT))):
            ms = time_ms(lambda scene=scene: render(scene, cfg), warmup=2, iters=5)
            print(f"[timing] {label} frame through the lane kernel: {ms:.3f} ms/frame, "
                  f"{LANE_WIDTH * LANE_HEIGHT / (ms * 1e-3):.4e} primary rays/s (render(), {LANE_WIDTH}x{LANE_HEIGHT} "
                  f"depth {LANE_DEPTH}, f32; {card})", flush=True)
            _device_profile(lambda scene=scene: render(scene, cfg), f"{label} frame", card, BOUNCE_LANE)
    return res



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
    cs_errs, cs_record = phase_cs_kernels()
    errs.update(cs_errs)
    lane_errs, blocked_timings = phase_blocked_kernels(card)
    errs.update({LANE[k]: v for k, v in lane_errs.items()})
    atlas_errs, atlas_inputs = phase_atlas_kernels()
    errs.update({ATLAS[k]: v for k, v in atlas_errs.items()})
    lane_errs, lane_inputs = phase_lane_kernels()
    errs.update(lane_errs)
    phase_lane_geometry(card, lane_inputs)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_main_path(Path(tmp)))
        launches.update(phase_smooth_main(Path(tmp)))
        launches.update(phase_step_main())
        phase_sampled_main(Path(tmp))
        phase_stochastic_train(Path(tmp))
        launches.update(phase_big_main(Path(tmp)))
        launches.update(phase_cs_main(Path(tmp)))
        c5_launches = phase_c5_main(Path(tmp))
        launches.update(phase_tex_main(Path(tmp)))
        launches.update(phase_lane_main(Path(tmp)))
    launches.update({k: v for k, v in c5_launches.items() if k in LANE.values()})
    phase_cs_golden()
    timings.update(phase_timing(card))
    timings.update(phase_big_timing(card, big_inputs))
    timings.update(phase_cs_timing(card, cs_record))
    phase_c5_timing(card)
    timings.update(phase_atlas_timing(card, atlas_inputs))
    timings.update(phase_lane_timing(card, lane_inputs))
    lane_timing = next(t for label, t in blocked_timings.items() if label.startswith(f"random_spheres({LANE_SPHERES})"))
    timings.update({LANE[k]: lane_timing[k] for k in STEP})
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
        for name in HARD + SMOOTH + CULLED + SWEEPS + CS + tuple(LANE.values()) + BOUNCE_LANE + tuple(ATLAS.values())
    ]
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
