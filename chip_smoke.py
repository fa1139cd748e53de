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
  plain version on its main path's real inputs (the sweeps on every bounce),
  f32 at 1920x1080 and f64 at 480x270;
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
  memory), the depth-fused three at 4096 (f64, geometry from global
  memory), the one-bounce pair at 8192 (from global memory; f32, and f64 on the same inputs
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
  the CPU's denoise of the card's frame, and ``--profile``;
* the sphere-sharded path (``parallel/`` on ``torch.distributed``), ranks
  started by the CLI or by ``run_local``, two on the one card over gloo:
  ``[parts]``, the per-shard kernels against their plain versions on both
  sphere shards of config 4 (``shadow_parts`` on the 1920x1080 mirror
  frame, ``smooth_nearest_parts``, ``clear_fwd`` and ``clear_bwd`` on the
  960x540 smooth step; f32, and f64 at 480x270; ``clear_bwd`` twice,
  bitwise) and the sharded first step against the JAX golden (f32 by the
  noise rule, f64); ``[sharded]``, ``render --builtin random1024
  --sphere-shards 2`` against the JAX golden and the single-process frame
  and ``optimize --sphere-shards 2`` (960x540, 3 steps), each rank's launch
  counts exact, and ``optimize --builtin inverse64 --ray-shards 2`` with its
  first step against the single-process step; with two or more cards the
  render and the optimize again over NCCL, one rank a card (a 2x2 mesh on
  four); ``[drill]``, kill-a-worker-and-resume: two ranks of ``optimize
  --distributed`` (config 4's spheres, 960x540, depth 3, a checkpoint every
  step), rank 1 SIGKILLed once rank 0 has logged step 2 and rank 0 torn down
  after a deadline, then a new job resumes from the checkpoint at step k
  (2 <= k < 6) and ends at step 6 with a finite loss and exact launch counts;
* the probes (TPU rows 21-22, ``python_ray_tracer_tpu_torch/benchmarks/``),
  ``[probes]``: the three material gathers (``gather_global``,
  ``gather_shared``, ``gather_shuffle``) bitwise their plain take at the five
  stage-1 shapes, on indices over all of int32 (JAX's ``abs(idx) % S``) and,
  in the entry point, at 2,097,152 rays x 1024 spheres x 12 channels, and
  ``vpu_ceiling`` against its plain version at 1, 2, 3 and 16 iterations on
  262,144 lanes; then each probe's entry point at its defaults: the op-mix
  ceiling at 4096 iterations with the SASS counts of its loop, and the
  gathers timed beside torch's take and the bytes bound.  The ceiling is
  also read in the operations its output needs, as ``count_ops`` counts
  them; ``[ceiling]`` prints every operations-bound kernel's bound at that
  ceiling beside its bound at 67 TFLOP/s, and ``train_deep``'s op rate as a
  share of it.

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
geometry in shared and in global memory, and each per-shard kernel at its
shard's shape.  For ``bwd_cs`` and ``gather_shuffle`` it prints the launch
layout: CTAs per launch, resident CTAs per SM (the occupancy API) and
ptxas's registers and spill bytes of each instantiation; for
``smooth_bwd_step`` its rows' bytes beside the column partials', and for
``clear_bwd`` its resident CTAs per SM.  ``bwd_cs``, ``smooth_bwd_step``
(1024 and 8192 spheres) and ``clear_bwd`` skip the shadow spheres that
reach none of a warp's rays, so their bound counts the work this run's
data needs: every lane-sphere pair pays the skip's test, the pairs reached
the rest; each prints the pairs reached and the bound on every pair beside.
The warp-bundle sphere skip of ``bounce_lane`` (both modes), ``shadow_sweep``
and ``shadow_parts``: on every recorded main-path launch, f32 and f64, the
kernel is held bitwise to the same kernel with the skip compiled out
(``skip="off"``), and ``[skip]`` lines print the share of (warp, sphere)
pairs the skip reaches (the plain bundle test) and the operations on every
pair beside those on the reached pairs with the bundles and the tests; the
f32 launches' bound (the kernels line's) is the second, the skip-off kernel
timed beside in turns.  The same holds for ``nearest_sweep``, ``fwd_cs``,
``clear_fwd`` (both ranks' launches, f32 and f64) and ``smooth_fwd_step``
(every recorded launch, with the skip also forced on where the launch rule
leaves it off, and the 8192-sphere step's again upcast to f64), whose
``[skip]`` lines print the (warp, sphere) pairs their winner sweep and
shadow product visit; for ``smooth_nearest_parts`` (both ranks' launches,
f32 and f64) and ``train_deep`` (every recorded launch: the 3-sphere and
stochastic ``optimize``, the 480x270 ``random1024`` CLI, config 5's first
step f32 and native f64), held with their skips (forced on, and the
launch rule's, which takes them from 16 cheap spheres) bitwise to the same
kernel without them, each first launch's pairs printed a bounce; both
kernels are timed beside their skip-off builds in turns with kept-pair
bounds.
Phases print on their own lines; any failure exits non-zero.  The line
before the last lists the kernels as JSON; the last line is one JSON
object: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import re
import signal
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
# frames and a one-bounce pair's entering state comes from the kernel; at
# 4096 spheres only the depth-fused kernels are checked (DEEP: three plain
# calls, not five), the one-bounce pair reading its geometry from global
# memory being held in f64 at 8192.
DEEP = ("smooth_fwd_deep", "smooth_bwd_deep", "train_deep")
BLOCKED_CASES = (
    ("inverse_task", 1024, 256, 144, 3, torch.float32, False, SMOOTH, True),
    ("inverse_task", 1024, 256, 144, 2, torch.float32, True, SMOOTH, False),
    ("inverse_task", 1024, 64, 36, 2, torch.float64, False, SMOOTH, False),
    ("inverse_task", 1024, 64, 36, 1, torch.float64, True, SMOOTH, False),
    ("random_spheres", 4096, 32, 18, 1, torch.float64, False, DEEP, False),
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
# The sphere-sharded path (parallel/): rows 18-20 (ops/smooth_parts.py) and
# row 4's parts mode (shadow_parts), on config 4 over two sphere shards of
# 512 spheres; the f64 kernel checks at a quarter of each frame's sides.
PARTS = ("smooth_nearest_parts", "clear_fwd", "clear_bwd")
SHARD_F64_SIZE = (480, 270)
# The ray-sharded config-5-shape first step (f32) against the
# single-process step on the card, relative to each leaf's largest value:
# the same arithmetic, but each shard's depth-fused pair sums its own
# 259,200 rays' table gradients and the all-reduce adds the two, where
# train_deep sums all 518,400 in one kernel.
RAY_SHARD_RTOL = 1e-4
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
    "smooth_nearest_parts": "python_ray_tracer_tpu/ops/pallas_smooth_parts.py:107",
    "clear_fwd": "python_ray_tracer_tpu/ops/pallas_smooth_parts.py:313",
    "clear_bwd": "python_ray_tracer_tpu/ops/pallas_smooth_parts.py:345",
    "shadow_parts": "python_ray_tracer_tpu/ops/pallas_intersect.py:384",
}
SOURCE.update({k: "python_ray_tracer_tpu_torch/csrc/smooth_parts.cu" for k in PARTS})
SOURCE["shadow_parts"] = "python_ray_tracer_tpu_torch/csrc/intersect_fused.cu"
REPLACES.update({v: REPLACES[k] for k, v in ATLAS.items()})
SOURCE.update({v: SOURCE[k] for k, v in ATLAS.items()})
# The probes (TPU rows 21-22; python_ray_tracer_tpu_torch/benchmarks/): the
# op-mix ceiling and the three material gathers.  Their main path is each
# probe's entry point at its defaults (4096 iterations over 262,144 lanes;
# stage 1, then stage 2 at 2,097,152 rays x 1024 spheres x 12 channels).
GATHERS = ("gather_global", "gather_shared", "gather_shuffle")
PROBES = ("vpu_ceiling",) + GATHERS
SOURCE.update({"vpu_ceiling": "python_ray_tracer_tpu_torch/csrc/vpu_ceiling.cu",
               **{k: "python_ray_tracer_tpu_torch/csrc/gather_probe.cu" for k in GATHERS}})
# gather_global also answers stage 1's take_along_axis probes, launched
# through _call; gather_shared is the direct kern_d's counterpart and
# gather_shuffle the piecewise kern's.
REPLACES.update({
    "vpu_ceiling": "benchmarks/vpu_ceiling.py:46",
    "gather_global": "benchmarks/gather_probe.py:40",
    "gather_shared": "benchmarks/gather_probe.py:228",
    "gather_shuffle": "benchmarks/gather_probe.py:187",
})
# vpu_ceiling against its plain version on the card, f32, at these
# iterations on all 262,144 lanes (the plain version issues ~450 torch calls
# an iteration; never at 4096): the strands' sum is at most ~16 in size and
# the same IEEE operations run in the same order on both sides (bitwise on an
# H100); an ulp of exp carried down the chain would stay far below this (the
# CPU test holds the plain version to JAX's kernel within the same 4e-6).
VPU_CHECK_ITERS = (1, 2, 3, 16)
VPU_TOL = 4e-6
# The plain version's time, at this many iterations (the kernel's is at 4096).
VPU_PLAIN_ITERS = 16
# The kill-a-worker drill ([drill]): two ranks of `cli optimize --distributed`
# on the one card over gloo, config 4's spheres at 960x540, depth 3, smooth
# (each rank half the rays through the depth-fused pair, ~0.1 s a step),
# a checkpoint every step; rank 1 is killed once rank 0 has logged step 2,
# rank 0 given DRILL_RANK0_S to die of it, then a new job resumes.
DRILL_STEPS, DRILL_KILL_AT = 6, 2
DRILL_WAIT_S, DRILL_RANK0_S = 600, 30
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
# None is named: smooth_bwd_step's camera-z gradient at 8192 spheres, named
# while its column partials read 3.76e-5, reads 2.82e-5 in its row layout.
ILL_CONDITIONED_COLUMNS: dict[str, tuple[int, ...]] = {}
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
# The sphere-sharded f64 first step at 960x540 against the JAX f64 golden:
# the limit of the culled route's f64 step (Phase C's max(1 - occlusion,
# 1e-6)), which the parts kernels' adjoint shares.
SHARDED_F64_RTOL = CS_F64_RTOL
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


def phase_build() -> dict[str, str]:
    """Build every source; returns each one's nvcc log (ptxas's registers and
    spills)."""
    from python_ray_tracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = {}
    for source, (path, log, seconds) in _build.build_all().items():
        logs[source] = log
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")
        _build.load_library(source)
        print(f"[build] {path.name} built in {seconds:.1f} s")
    print(f"[build] all sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    return logs


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
    against their plain versions; smooth_bwd_step twice, bitwise;
    smooth_fwd_step's skip bitwise the kernel without it.  With ``also_f64``
    both again in float64 on the same inputs upcast, under the float64
    limits.  Returns the two calls (``{name: (kernel callable, bytes it
    moves)}``)."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    skw = {k: v for k, v in kw.items() if k != "depth"}
    state = _step_state(o, d, tables, skw, xis[0], kernel=state_by_kernel)
    fk = bss.smooth_fwd_step(*state, *tables, xis[1], **skw)
    _step_skip_lines(label, [((*state, *tables, xis[1]), skw)], upcast=also_f64)
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
        "bwd_step_args": (args, skw),
        "fwd_step_args": ((*state, *tables, xis[1]), skw),
    }


def _check_smooth_case(label: str, o, d, tables, kw, xis, dtype, plain_ms: dict | None = None,
                       state_by_kernel: bool = False, pair: bool = True) -> tuple[dict, dict]:
    """The deep pair, train_deep and (``pair``) the one-bounce pair against
    their plain versions on one case's inputs; the gradient kernels twice,
    bitwise.
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
    calls = _check_step_pair(label, o, d, tables, kw, xis, dtype, err, state_by_kernel, plain_ms) if pair else {}
    xi_in = [] if xi is None else [xi]
    calls.update({
        "smooth_fwd_deep": (lambda: bss.smooth_fwd_deep(o, d, *tables, xi, **kw), _nbytes(o, d, *tables, *xi_in, *fk)),
        "smooth_bwd_deep": (lambda: bss.smooth_bwd_deep(o, d, *fp[1:], *tables, g_acc, xi, **kw),
                            _nbytes(o, d, *fp[1:], *tables, g_acc, *xi_in, *bk)),
        "train_deep": (lambda: bss.train_deep(o, d, tgt, *tables, xi, **kw), _nbytes(o, d, tgt, *tables, *xi_in, *tk)),
    })
    calls["train_args"] = ((o, d, tgt, *tables, xi), kw)
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


def _probe_counters() -> tuple[dict[str, int], ...]:
    """The probes' launch counters (rows 21-22), which the package's own
    counters leave out: the probes run on no path of the package."""
    from python_ray_tracer_tpu_torch.benchmarks import gather_probe, vpu_ceiling

    return vpu_ceiling.LAUNCHES, gather_probe.LAUNCHES


def _reset_launches() -> None:
    from python_ray_tracer_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()
    for counts in _probe_counters():
        counts.update(dict.fromkeys(counts, 0))


def _launches() -> dict[str, int]:
    """Every wrapper's counter, an atlas mode's under its ATLAS name, and the probes'."""
    from python_ray_tracer_tpu_torch.ops import launch_counts

    counts = launch_counts()
    for probe in _probe_counters():
        counts.update(probe)
    return counts


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
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
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
    train_calls: list = []
    with _capture(bss, "train_deep", train_calls):
        cli.main(["optimize", "--visibility", "smooth", *size, "--depth", "3", "--target", str(tmp / "d3.png"),
                  "--steps", "20", "--sync-every", "10", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize", counts, ("train_deep",))
    launches["train_deep"] = counts["train_deep"]
    _train_skip_lines("the 3-sphere optimize", train_calls)  # after the count: its launches are not the path's
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
    rule); smooth_fwd_step's skip (forced on: the rule leaves it off at 3
    spheres) bitwise the kernel without it.  Returns the pair's launches
    from the f32 kernel run."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
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
            fwd_calls: list = []
            with _capture(bss, "smooth_fwd_step", fwd_calls):
                loss = torch.sum(render(combine(params, scene), cfg) * weight.to(dtype)) / N_RAYS
                loss.backward()
            torch.cuda.synchronize()
            if use_pallas and dtype == torch.float32:
                counts = _launches()
                _expect_launched("the depth-1 loss through render()", counts, ("smooth_fwd_step", "smooth_bwd_step"))
                launches = {k: counts[k] for k in ("smooth_fwd_step", "smooth_bwd_step")}
            if use_pallas:  # after the count: the check's launches are not the path's
                _step_skip_lines(f"the 3-sphere depth-1 loss {str(dtype).split('.')[-1]}", fwd_calls)
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
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params

    metrics = tmp / "optimize_stochastic.jsonl"
    _reset_launches()
    train_calls: list = []
    with _capture(bss, "train_deep", train_calls):
        cli.main(["optimize", "--visibility", "smooth", "--width", str(WIDTH), "--height", str(HEIGHT), "--depth", "3",
                  "--stochastic-roughness", "--seed", str(SEED), "--target", str(tmp / "d3.png"), "--steps", "5",
                  "--sync-every", "5", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize --stochastic-roughness", counts, ("train_deep",))
    _train_skip_lines("the stochastic glossy optimize", train_calls)
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
    counted: dict[str, int] = {}
    for name, (kernel, plain, n_bytes) in calls.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, warmup=1, iters=3)
        ops = counted[name] = count_ops(plain)
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
    # train_deep on the 3-sphere launch: the launch rule's build (skip off
    # below 16 cheap spheres) beside the skips forced on, in turns.
    for tag, xi_t in (("mirror", None), ("glossy", xi_all)):
        targs = (so, sd, tgt, *stables, xi_t)
        fns = {"skip off (the launch rule's)": functools.partial(bss.train_deep, *targs, **skw),
               "skip on": functools.partial(bss.train_deep, *targs, **skw, skip="on")}
        turns: dict[str, list] = {k: [] for k in fns}
        for k in (*fns, *reversed(fns)):
            turns[k].append(time_ms(fns[k], warmup=2, iters=10))
        print(f"[timing] train_deep {tag} (reference {WIDTH}x{HEIGHT} f32, depth 3), in turns: "
              + ", ".join(f"{k} {statistics.mean(v):.4f} ms" for k, v in turns.items()) + f" ({card})", flush=True)
        if xi_t is None:
            _train_skip_bound(f"reference {WIDTH}x{HEIGHT} (the skips forced on)", targs, skw,
                              counted["train_deep"], calls["train_deep"][2])
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
    re-sorted and first full-sweep bounce, the sweeps on every bounce of the
    stochastic frame, each against its plain version (idx exactly), f32 at
    1920x1080 and f64 at 480x270; both sweeps with their skip bitwise the
    kernel without it, and (f64) the pairs the skip reaches; the primary
    lists checked conservative against the full sweep.  Returns the max abs
    error per kernel over the f32 cases and the f32 inputs (for the
    timings)."""
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
        near, shadow = _sweep_record(dtype, width, height)
        for b in range(BIG_DEPTH):
            (args, kw_n), (sargs, kw_s) = near[b], shadow[b]
            nk = intersect_fused.nearest_sweep(*args, **kw_n)
            torch.cuda.synchronize()
            np_ = intersect_fused.nearest_sweep_plain(*args, **kw_n)
            err["nearest_sweep"] = max(err["nearest_sweep"], _per_value_check(f"nearest_sweep {tag} glossy bounce {b} t", nk.t, np_[0], dtype))
            _exact_check(f"nearest_sweep {tag} glossy bounce {b} idx", nk.idx, np_[1])
            _skip_bitwise("nearest_sweep", f"{tag} glossy bounce {b}", intersect_fused.nearest_sweep, args, kw_n)
            lit = intersect_fused.shadow_sweep(*sargs, **kw_s)
            torch.cuda.synchronize()
            lit_p = intersect_fused.shadow_sweep_plain(*sargs, **kw_s)
            err["shadow_sweep"] = max(err["shadow_sweep"], _per_value_check(f"shadow_sweep {tag} glossy bounce {b} in_light", lit, lit_p, dtype))
            _skip_bitwise("shadow_sweep", f"{tag} glossy bounce {b}", intersect_fused.shadow_sweep, sargs, kw_s)
            if dtype == torch.float64:
                _sweep_skip_ops("nearest_sweep", f"{tag} glossy bounce {b}", args, kw_n)
                _sweep_skip_ops("shadow_sweep", f"{tag} glossy bounce {b}", sargs, kw_s)
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


def _list_ops(plain, args: tuple, kw: dict, ci: int) -> tuple[float, float, float]:
    """(operations per lane, per lane and listed sphere, listed lane-sphere
    pairs) of a list-sweeping kernel's launch: each lane's fixed work and
    its tile's listed and full-tier spheres, counted on the plain version
    over one tile.  ``args[ci:ci + 3]`` are the swept lists (cand, cnt_cand,
    cnt_full)."""
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
    return per_lane, per_sphere, swept


def _io_bytes(kernel, args: tuple, kw: dict) -> int:
    """Bytes a launch reads and writes once: its tensor inputs and outputs."""
    with torch.no_grad():
        out = kernel(*args, **kw)
    return _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out)


def _list_bound(plain, kernel, args: tuple, kw: dict, ci: int) -> tuple[float, str]:
    """The least time of one launch of a list-sweeping kernel on these
    inputs: bytes in and out once, and the operations of this run's lists
    (:func:`_list_ops`)."""
    per_lane, per_sphere, swept = _list_ops(plain, args, kw, ci)
    return _bound(int(per_lane * args[0].shape[1] + per_sphere * swept), _io_bytes(kernel, args, kw))


def _bwd_cs_reach(args: tuple, kw: dict) -> tuple[float, int, int]:
    """(operations of Phase C's test per lane and listed sphere, the listed
    lane-sphere pairs of the cheap tier, those Phase C reaches) of a bwd_cs
    call.  Phase C reaches a pair unless the sphere is the lane's winner or
    its shadow sigmoid is exactly 0: every one of its terms is then exactly
    +-0, and the kernel's warps skip the sphere where all their lanes agree.
    The test is the pair's quadratic and sigmoid, as the plain version
    computes them."""
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, sig
    from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import _xi_pair, fwd_sub_math

    o, d, thr, alive, idx, hit, clear, cand, cnt, cnt_full = args[:10]
    geom, mat, consts = args[13:16]
    xi = args[21] if len(args) > 21 else None
    tile, s_cheap, sharp_s = kw["tile_rays"], kw["s_cheap"], kw["sharp_s"]
    f = fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, _xi_pair(xi, 0), faraway=kw["faraway"],
                     s_cheap=s_cheap, sharp_e=kw["sharp_e"], sharp_s=sharp_s, saved=(idx, hit != 0, clear),
                     cand_sh=(cand, cnt, cnt_full, tile), tex_hw=kw.get("tex_hw"))

    def reaches(lanes, sid):
        g = geom[sid.long()]
        p_n, light = tuple(x[lanes] for x in f.p_n), tuple(x[lanes] for x in f.L)
        b, ct = b_cterm_plain(p_n, light, (g[:, 0], g[:, 1], g[:, 2]), g[:, 3])
        return (sig(sharp_s * (b * b - 4.0 * ct)) != 0) & (idx[lanes] != sid)

    n = o.shape[1]
    every = torch.arange(n, device=o.device)
    tile_of = every // tile
    cc = torch.clamp(cnt.long()[tile_of], 0, cand.shape[1])
    cf = torch.clamp(cnt_full.long()[tile_of], 0, s_cheap)
    with torch.no_grad():
        test_ops = count_ops(lambda: reaches(every[:tile], torch.zeros_like(every[:tile]))) / tile
        listed, reached = int((cc + cf).sum()), 0
        for j in range(int(cc.max())):
            lanes = every[j < cc]
            reached += int(reaches(lanes, cand[tile_of[lanes], j]).sum())
        for k in range(int(cf.max())):
            lanes = every[k < cf]
            reached += int(reaches(lanes, torch.full_like(lanes, k)).sum())
    return test_ops, listed, reached


def _bwd_cs_bound(args: tuple, kw: dict, label: str) -> tuple[float, str]:
    """bwd_cs's least time on one recorded call: as :func:`_list_bound`, but
    Phase C's operations counted on the pairs it reaches (each listed pair
    still paying its test): the work this run's data needs.  Prints the
    pairs reached beside the bound that counts every listed pair."""
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    kernel, plain = cs.bwd_cs, cs.bwd_cs_plain
    if kw.get("g_dww") is not None:  # the dww cotangent at the end, so one_tile cuts it
        args, kw = _bwd_cs_g_dww(args, kw)
        kernel, plain = _bwd_cs_last(kernel), _bwd_cs_last(plain)
    per_lane, per_sphere, swept = _list_ops(plain, args, kw, 7)
    test_ops, listed, reached = _bwd_cs_reach(args, kw)
    n_bytes = _io_bytes(kernel, args, kw)
    n = args[0].shape[1]
    every_pair = _bound(int(per_lane * n + per_sphere * swept), n_bytes)
    bound = _bound(int(per_lane * n + test_ops * swept + (per_sphere - test_ops) * reached), n_bytes)
    print(f"[timing] bwd_cs {label}: Phase C reaches {reached} of {listed} listed lane-sphere pairs "
          f"({reached / max(listed, 1):.2%}; test {test_ops:g}, whole pair {per_sphere:g} operations); bound "
          f"{bound[0]:.4f} ms by {bound[1]} on the reached pairs, {every_pair[0]:.4f} ms on every listed pair",
          flush=True)
    return bound


def _shadow_reach(p_n, light, idx, geom, s_cheap: int, sharpness: float, warp: bool = True) -> tuple[int, int]:
    """(lane-sphere pairs, warp-sphere pairs) that a shadow sweep's exact skip
    reaches: the sphere is not the lane's own (idx) and its tier's shadow
    sigmoid sig(sharpness * disc) is not exactly 0, disc from the (b, c_term)
    the kernels' test computes.  p_n, light: 3 rows of (N,); a warp is 32
    consecutive lanes (ray-warps); the spheres in chunks of 256."""
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, compensated_b_cterm, sig

    n, s = idx.shape[0], geom.shape[0]
    o = tuple(x[:, None] for x in p_n)
    dl = tuple(x[:, None] for x in light)
    lanes = warps = 0
    with torch.no_grad():
        for k0 in range(0, s, 256):
            ks = torch.arange(k0, min(k0 + 256, s), device=geom.device)
            c = tuple(geom[None, ks, i] for i in range(3))
            r = geom[None, ks, 3]
            b, ct = b_cterm_plain(o, dl, c, r)
            if k0 + len(ks) > s_cheap:  # the exact tier's columns
                be, cte = compensated_b_cterm(o, dl, c, r)
                exact = (ks >= s_cheap)[None, :]
                b, ct = torch.where(exact, be, b), torch.where(exact, cte, ct)
            reached = (sig(sharpness * (b * b - 4.0 * ct)) != 0) & (idx.long()[:, None] != ks[None, :])
            lanes += int(reached.sum())
            if warp:
                pad = torch.zeros(((-n) % 32, len(ks)), dtype=torch.bool, device=reached.device)
                warps += int(torch.cat([reached, pad]).reshape(-1, 32, len(ks)).any(1).sum())
    return lanes, warps


def _step_reach_bound(label: str, args: tuple, kw: dict, ops: int, n_bytes: int) -> tuple[float, str]:
    """smooth_bwd_step's least time on one call, counted as _bwd_cs_bound
    counts bwd_cs's: from the plain version's operations (``ops``, every
    lane-sphere pair paying the whole of Phase C's loop body, and Phase F's
    per-sphere winner compare), every pair pays the skip's test and only the
    pairs reached pay the rest of the body; Phase F adds each lane's row once.
    Prints the pairs reached (lanes and warps) beside the bound that counts
    every pair."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, sig

    o, d, thr, alive, idx, hit, clear, geom, mat, consts = args[:10]
    xi = args[15] if len(args) > 15 else None
    n, s = d.shape[1], geom.shape[0]
    with torch.no_grad():
        f = bss.fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, bss._xi_pair(xi, 0),
                             faraway=kw["faraway"], s_cheap=kw["s_cheap"], sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"],
                             saved=(idx, hit != 0, clear))
        c, r = (geom[0, 0], geom[0, 1], geom[0, 2]), geom[0, 3]
        g_pn_s, g_l = [torch.zeros_like(thr)] * 3, [torch.zeros_like(thr)] * 3

        def body():  # Phase C's loop body of the plain version, one sphere on every lane
            pn_b, pn_ct, l_b, row = bss.shadow_terms(f, 0, c, r, bss.sol_disc_plain, clear, kw["faraway"])
            for i in range(3):
                _ = g_pn_s[i] + pn_b[i] + pn_ct[i], g_l[i] + l_b[i]
            return [torch.sum(x) for x in row]

        def test():
            b, ct = b_cterm_plain(f.p_n, f.L, c, r)
            return (sig(kw["sharp_s"] * (b * b - 4.0 * ct)) != 0) & (idx != 0)

        pair_ops, test_ops = count_ops(body) / n, count_ops(test) / n
        lanes, warps = _shadow_reach(f.p_n, f.L, idx, geom, kw["s_cheap"], kw["sharp_s"])
    every_pair = _bound(ops, n_bytes)
    bound = _bound(int(ops - (pair_ops + 1) * n * s + test_ops * n * s + (pair_ops - test_ops) * lanes), n_bytes)
    print(f"[timing] smooth_bwd_step {label}: Phase C reaches {lanes} of {n * s} lane-sphere pairs "
          f"({lanes / (n * s):.3%}), {warps} of {-(-n // 32) * s} warp-sphere pairs ({warps / (-(-n // 32) * s):.3%}); "
          f"test {test_ops:g}, whole pair {pair_ops:g} operations; bound {bound[0]:.4f} ms by {bound[1]} on the "
          f"reached pairs, {every_pair[0]:.4f} ms on every pair", flush=True)
    return bound


def _clear_reach_bound(args: list, kw: dict, ops: float, n_bytes: int) -> tuple[float, str]:
    """clear_bwd's least time on one call, counted as _bwd_cs_bound counts
    bwd_cs's: from its plain version's operations (``ops``, every lane-sphere
    pair paying the whole), every pair pays the skip's test and only the
    pairs reached the rest.  Prints the pairs reached beside the bound that
    counts every pair."""
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, sig

    o, d, geom, self_idx = args[:4]
    n, s = o.shape[0], geom.shape[0]
    part = min(n, 4096)
    with torch.no_grad():
        oi = tuple(o[:part, i, None] for i in range(3))
        di = tuple(d[:part, i, None] for i in range(3))
        c = tuple(geom[None, :, i] for i in range(3))

        def test():
            b, ct = b_cterm_plain(oi, di, c, geom[None, :, 3])
            ids = torch.arange(s, device=geom.device)[None, :]
            return (sig(kw["sharpness"] * (b * b - 4.0 * ct)) != 0) & (ids != self_idx[:part, None])

        test_ops = count_ops(test) / (part * s)
        lanes, warps = _shadow_reach(tuple(o[:, i] for i in range(3)), tuple(d[:, i] for i in range(3)), self_idx,
                                     geom, kw["s_cheap"], kw["sharpness"])
    pair_ops = ops / (n * s)
    every_pair = _bound(int(ops), n_bytes)
    bound = _bound(int(ops - (pair_ops - test_ops) * (n * s - lanes)), n_bytes)
    print(f"[timing] clear_bwd: the skip reaches {lanes} of {n * s} lane-sphere pairs ({lanes / (n * s):.3%}), "
          f"{warps} of {-(-n // 32) * s} warp-sphere pairs ({warps / (-(-n // 32) * s):.3%}); test {test_ops:g}, whole "
          f"pair {pair_ops:g} operations; bound {bound[0]:.4f} ms by {bound[1]} on the reached pairs, "
          f"{every_pair[0]:.4f} ms on every pair", flush=True)
    return bound


def _culled_bound(name: str, r: dict) -> tuple[float, str]:
    from python_ray_tracer_tpu_torch.ops import culled

    args, ci = (r["near"], 2) if name == "near_culled" else (r["shade"], 11)
    return _list_bound(getattr(culled, f"{name}_plain"), getattr(culled, name), args, r["kw"], ci)


def _sweep_bound(name: str, call) -> tuple[float, str]:
    """The least time of one sweep launch: each input and output once, and
    the plain version's operations counted over 4096 of the lanes, scaled to
    all of them, on the pairs the skip reaches (:func:`_skip_bound`)."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused

    args, kw = call
    n, part = args[0].shape[0], 4096
    plain = intersect_fused.nearest_sweep_plain if name == "nearest_sweep" else intersect_fused.shadow_sweep_plain
    ops = count_ops(lambda: plain(*(a[:part] if a.shape[0] == n else a for a in args), **kw)) * n / min(n, part)
    out = intersect_fused.nearest_sweep(*args, **kw)[:2] if name == "nearest_sweep" else (intersect_fused.shadow_sweep(*args, **kw),)
    return _skip_bound(name, [_skip_sweep(plain, args, kw)], ops, _nbytes(*args, *out))


# --- The warp-bundle sphere skip of rows 4 (both modes) and 5 (both modes) ---


def _skip_bitwise(name: str, label: str, kernel, args, kw, forced: bool = False) -> None:
    """The kernel with its skip (the launcher's rule; with ``forced`` also
    the skip forced on, where the rule may leave it off) bitwise the same
    kernel with the skip compiled out (skip="off")."""
    with torch.no_grad():
        off = kernel(*args, **kw, skip="off")
        runs = {"": kernel(*args, **kw), **({" (forced on)": kernel(*args, **kw, skip="on")} if forced else {})}
    off = off if isinstance(off, tuple) else (off,)
    for how, got in runs.items():
        got = got if isinstance(got, tuple) else (got,)
        same = all(bool(torch.equal(x, y)) for x, y in zip(got, off))
        print(f"[skip] {name} {label}{how}: with the skip bitwise the kernel without it: {same}", flush=True)
        if not same:
            fail(f"{name} {label}{how}: the skip changes the output")


def _skip_sweep(plain, args: tuple, kw: dict) -> dict:
    """One sweep with the skip, on a sweep's (o, d, geom[, self_idx]) (N, 3)
    rows: the (warp, sphere) pairs the skip reaches (``bundle_reach``) and the
    operations it saves on the plain version ``plain``'s count: each skipped
    lane-sphere pair's operations (the plain version over two cheap spheres
    less over one), less the bundles (one a warp of 32 lanes in range) and
    the tests (one a cheap sphere and warp with a usable bundle), counted as
    count_ops counts their plain versions on 4096 lanes."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused as f

    o, d, geom = args[:3]
    rest = args[3:]
    n, s_cheap, light = o.shape[0], kw["s_cheap"], kw.get("light")
    part = min(n // 32 * 32, 4096) or n
    with torch.no_grad():
        def pair(k):
            sub = [a[:part] for a in rest]
            return count_ops(lambda: plain(o[:part], d[:part], geom[:k].contiguous(), *sub, faraway=kw["faraway"],
                                           s_cheap=k))
        pair_ops = (pair(2) - pair(1)) / part
        ok = f.warp_bundles(o, d, light).ok
        reach = f.bundle_reach(o, d, geom, s_cheap, light)
        lanes = torch.full((reach.shape[0],), 32, device=o.device)
        lanes[-1] = n - 32 * (reach.shape[0] - 1)
        skipped = int(((~reach).sum(1) * lanes).sum())
        warps = -(-part // 32)
        bundle_ops = count_ops(lambda: f.warp_bundles(o[:part], d[:part], light)) / warps
        sample = f.warp_bundles(o[:part], d[:part], light)
        test_ops = count_ops(lambda: f.bundle_test(sample, geom[:1])) / warps
    saved = pair_ops * skipped - bundle_ops * (n // 32) - test_ops * int(ok.sum()) * s_cheap
    return dict(reached=int(reach.sum()), pairs=reach.numel(), saved=saved, pair_ops=pair_ops, test_ops=test_ops)


def _lane_skips(args: tuple, kw: dict) -> list[dict]:
    """bounce_lane's two sweeps with the skip on one launch's inputs
    (:func:`_skip_sweep`): the nearest on the bounce's rays, the shadow on
    the plain version's shadow rays (its apex the light)."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane, intersect_fused as f

    calls: list = []
    with _capture(f, "bundle_reach", calls), torch.no_grad():
        plain_kw = {k: v for k, v in kw.items() if k not in ("geometry", "skip")}
        bounce_lane.bounce_lane_plain(*args, **plain_kw, skip=True)
    (near, _), (shadow, _) = calls
    o, d = near[0].contiguous(), near[1].contiguous()
    self_idx = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)  # the count does not read it
    sweep_kw = dict(faraway=kw["faraway"], s_cheap=kw["s_cheap"])
    return [_skip_sweep(f.nearest_sweep_plain, (o, d, near[2]), sweep_kw),
            _skip_sweep(f.shadow_sweep_plain, (*shadow[:3], self_idx), {**sweep_kw, "light": shadow[4]})]


def _skip_line(name: str, label: str, sweeps: list[dict], ops: float) -> float:
    """Print the pairs each sweep's skip reaches and the operations with the
    skip beside every pair's; returns the operations with the skip."""
    reached_ops = ops - sum(s["saved"] for s in sweeps)
    shares = ", ".join(f"{s['reached']} of {s['pairs']} ({s['reached'] / s['pairs']:.2%})" for s in sweeps)
    which = "nearest, shadow" if len(sweeps) == 2 else ("nearest" if name == "nearest_sweep" else "shadow")
    pair_ops = "/".join(f"{s['pair_ops']:g}" for s in sweeps)
    head = f"[skip] {name} {label}".rstrip()
    print(f"{head}: the skip reaches {shares} (warp, sphere) pairs ({which}); {ops:.4e} operations on every pair, "
          f"{reached_ops:.4e} on the reached pairs with the bundles and the tests (a pair {pair_ops}, a test "
          f"{sweeps[0]['test_ops']:g})", flush=True)
    return reached_ops


def _skip_bound(name: str, sweeps: list[dict], ops: float, n_bytes: int, label: str = "") -> tuple[float, str]:
    """The least time of a launch with the skip: the plain version's
    operations ``ops`` less what the skip saves (:func:`_skip_sweep`), beside
    the bound on every pair; returns the first."""
    return _skip_bound_line(name, label, ops, _skip_line(name, label, sweeps, ops), n_bytes)


def _sweep_skip_ops(name: str, label: str, args: tuple, kw: dict) -> None:
    """The reached pairs and operations of one sweep launch (an f64 record:
    no bound in time, the H100's float64 rate being no figure of this run)."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused as f

    plain = {"shadow_parts": f.shadow_parts_plain, "nearest_sweep": f.nearest_sweep_plain}.get(name, f.shadow_sweep_plain)
    n, part = args[0].shape[0], 4096
    with torch.no_grad():
        ops = count_ops(lambda: plain(*(a[:part] if a.shape[0] == n else a for a in args), **kw)) * n / min(n, part)
    _skip_line(name, label, [_skip_sweep(plain, args, kw)], ops)


def _cs_skip_line(name: str, label: str, args: tuple, kw: dict) -> dict:
    """fwd_cs's skip on one recorded launch: its listed cheap-tier (ray,
    sphere) pairs, those whose shadow sigmoid is exactly 0, those whose warp
    has that on every lane, and those the warp bound keeps
    (``benchmarks/sweep_skip_ab.cs_counts``); fails if the bound drops a
    pair that shades.  Returns the counts."""
    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import cs_counts, cs_counts_text

    c = cs_counts(args, kw)
    print(f"[skip] {name} {label}: {cs_counts_text(c)}", flush=True)
    if c["missed"]:
        fail(f"{name} {label}: the warp bound drops {c['missed']} (warp, sphere) pairs that shade")
    return c


def _fwd_cs_bound(args: tuple, kw: dict, label: str) -> tuple[float, str]:
    """fwd_cs's least time on one recorded call: as :func:`_list_bound`, with
    the shadow loop counted on the pairs the skip keeps: each listed (warp,
    cheap sphere) pair pays one test of the warp bound, each pair the bound
    keeps the quadratic and the zero test on every lane, and only the lanes
    whose shadow sigmoid is not exactly 0 the rest of the pair; the bundle
    once a lane.  Prints it beside the bound that counts every listed
    pair."""
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs, intersect_fused as f
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain

    per_lane, per_sphere, swept = _list_ops(cs.fwd_cs_plain, args, kw, 7)
    c = _cs_skip_line("fwd_cs", label, args, kw)
    n_bytes = _io_bytes(cs.fwd_cs, args, kw)
    n, part = args[0].shape[1], 4096
    geom = args[10]
    o, d = args[0][:, :part].T.contiguous(), args[1][:, :part].T.contiguous()
    sharp_s = kw["sharp_s"]
    with torch.no_grad():
        edge = torch.tensor(-cs.SIG_EDGE[o.dtype], dtype=o.dtype) / (4 * torch.tensor(sharp_s, dtype=o.dtype))
        sample = f.warp_bundles(o, d, args[12][0, 3:6])
        bundle_ops = count_ops(lambda: f.warp_bundles(o, d, args[12][0, 3:6])) / part
        line_ops = count_ops(lambda: f.line_test(sample, geom[:1], edge.to(o.device))) / (part // 32)
        g = geom[0]

        def test():
            b, ct = b_cterm_plain(tuple(o.T), tuple(d.T), (g[0], g[1], g[2]), g[3])
            return sharp_s * (b * b - 4.0 * ct) < cs.SIG_EDGE[o.dtype]

        test_ops = count_ops(test) / part
    every = _bound(int(per_lane * n + per_sphere * swept), n_bytes)
    ops = (per_lane + bundle_ops) * n + line_ops * c["w_listed"] + test_ops * c["kept"] + (per_sphere - test_ops) * (
        c["listed"] - c["zero"])
    bound = _bound(int(ops), n_bytes)
    print(f"[skip] fwd_cs {label}: bound {bound[0]:.4f} ms by {bound[1]} on the kept pairs (a warp test {line_ops:g}, "
          f"a pair's test {test_ops:g}, a whole pair {per_sphere:g} operations), {every[0]:.4f} ms by {every[1]} on "
          f"every listed pair", flush=True)
    return bound


# --- The skips of smooth_fwd_step (rows 6 and 8) and clear_fwd (row 19) ---


def _step_skip_lines(tag: str, calls: list, upcast: bool = False) -> None:
    """Each recorded smooth_fwd_step launch with its skip (the launch rule's
    and forced on) bitwise the kernel without it, with ``upcast`` again on
    the same inputs in float64, and the (warp, sphere) pairs its winner
    sweep and its shadow product visit (``benchmarks/sweep_skip_ab``'s
    step_counts)."""
    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import step_counts, step_counts_text
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    for b, (args, kw) in enumerate(calls):
        args = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
        for label, a in ((tag, args), *(((f"{tag}, upcast to float64", _upcast(args)),) if upcast else ())):
            _skip_bitwise("smooth_fwd_step", f"{label} bounce {b}", bss.smooth_fwd_step, a, kw, forced=True)
            print(f"[skip] smooth_fwd_step {label} bounce {b}: {step_counts_text(step_counts(a, kw))}", flush=True)


def _train_skip_lines(tag: str, calls: list) -> None:
    """Each recorded train_deep launch: the kernel with its skips (forced on,
    and by the launch rule, which takes them from STEP_SKIP_MIN_CHEAP
    cheap-tier spheres on) bitwise the kernel without them in all six
    outputs (the SSE, g_o, g_d, every table gradient); and, on the first
    launch, each bounce's pairs the skips keep
    (``benchmarks/sweep_skip_ab``'s train_counts)."""
    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import train_counts, train_counts_text
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    for b, (args, kw) in enumerate(calls):
        args = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
        label = f"{tag} launch {b}"
        rule = "on" if kw["s_cheap"] >= bss.STEP_SKIP_MIN_CHEAP else "off"
        with torch.no_grad():
            off = bss.train_deep(*args, **kw, skip="off")
            runs = {" (forced on)": bss.train_deep(*args, **kw, skip="on"),
                    f" (the launch rule's, {rule})": bss.train_deep(*args, **kw)}
        for how, got in runs.items():
            same = all(bool(torch.equal(x, y)) for x, y in zip(got, off))
            print(f"[skip] train_deep {label}{how}: bitwise the kernel without the skips: {same}", flush=True)
            if not same:
                fail(f"train_deep {label}{how}: the skips change the output")
        if b == 0:
            for dep, c in enumerate(train_counts(args, kw)):
                print(f"[skip] train_deep {label} bounce {dep}: {train_counts_text(c)}", flush=True)


def _nearest_skip_line(label: str, args, kw) -> None:
    """One smooth_nearest_parts launch with its skip (the rule's and forced
    on) bitwise the kernel without it, all seven outputs, and the share of
    the cheap-tier (warp, sphere) pairs its winner rules keep."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, smooth_parts as sp

    _skip_bitwise("smooth_nearest_parts", label, lambda *a, **k: tuple(sp.nearest_parts(*a, **k)), args, kw,
                  forced=True)
    with torch.no_grad():
        reach = bss.winner_reach(args[0], args[1], args[2], kw["s_cheap"], kw["faraway"])
    print(f"[skip] smooth_nearest_parts {label}: the winner rules keep "
          f"{float(reach[:, :kw['s_cheap']].float().mean()):.2%} of the cheap-tier (warp, sphere) pairs", flush=True)


def _clear_skip_line(label: str, args, kw) -> None:
    """One clear_fwd launch with its skip (the rule's and forced on) bitwise
    the kernel without it, and the share of the cheap-tier (warp, sphere)
    pairs its shadow bound keeps."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, smooth_parts as sp

    _skip_bitwise("clear_fwd", label, sp.clear_fwd, args, kw, forced=True)
    with torch.no_grad():
        reach = bss.shadow_reach(args[0], args[1], kw.get("light"), args[2], kw["s_cheap"], kw["sharpness"])
    print(f"[skip] clear_fwd {label}: the shadow bound keeps {float(reach[:, :kw['s_cheap']].float().mean()):.2%} of "
          f"the cheap-tier (warp, sphere) pairs", flush=True)


def _shadow_skip_costs(p_n, to_light, light, geom, s_cheap: int, sharp: float) -> dict:
    """What shadow_skip_product does on one launch's shadow rays p_n/to_light
    (N, 3): the cheap-tier (warp, sphere) pairs its bound keeps (each then
    takes the quadratic and the zero test on every lane), the lane-sphere
    pairs whose sigmoid is not exactly 0 (each computed whole), and the
    operations of its bundle (a lane), of its test (a warp and sphere) and
    of a pair's quadratic and zero test (a lane and sphere), as count_ops
    counts their plain versions on 4096 lanes."""
    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import _live_pairs
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, intersect_fused as f
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain

    part = min(p_n.shape[0] // 32 * 32, 4096)
    o, d, dtype = p_n[:part], to_light[:part], p_n.dtype
    with torch.no_grad():
        reach = bss.shadow_reach(p_n, to_light, light, geom, s_cheap, sharp)
        live = _live_pairs(p_n, to_light, geom[:s_cheap], sharp)
        edge = torch.tensor(-bss.SIG_EDGE[dtype], dtype=dtype) / (4 * torch.tensor(sharp, dtype=dtype))
        sample = f.warp_bundles(o, d, light)
        g = geom[0]

        def zero_test():
            b, ct = b_cterm_plain(tuple(o.T), tuple(d.T), (g[0], g[1], g[2]), g[3])
            return sharp * (b * b - 4.0 * ct) < bss.SIG_EDGE[dtype]

        return dict(kept=int(reach[:, :s_cheap].sum()), live=live, warps=reach.shape[0],
                    bundle_ops=count_ops(lambda: f.warp_bundles(o, d, light)) / part,
                    test_ops=count_ops(lambda: f.line_test(sample, geom[:1], edge.to(o.device))) / (part // 32),
                    zero_ops=count_ops(zero_test) / part)


def _skip_bound_line(name: str, label: str, ops: float, skip_ops: float, n_bytes: int, detail: str = "") -> tuple:
    """Print the bound on the work a skip leaves (``skip_ops``) beside the
    bound on every pair (``ops``); returns the first."""
    every, bound = _bound(int(ops), n_bytes), _bound(int(skip_ops), n_bytes)
    print(f"{f'[skip] {name} {label}'.rstrip()}: bound {bound[0]:.4f} ms by {bound[1]} on the reached pairs"
          f"{f' ({detail})' if detail else ''}, {every[0]:.4f} ms by {every[1]} on every pair", flush=True)
    return bound


def _step_skip_bound(label: str, args, kw, ops: float, n_bytes: int) -> tuple[float, str]:
    """smooth_fwd_step's least time with its skips on one call, from its
    plain version's operations ``ops`` on every pair: every cheap-tier
    (warp, sphere) pair pays a winner test and a shadow test (one lane
    each), the winner pairs the rules keep the winner sweep's body on every
    lane, the shadow pairs the bound keeps the quadratic and zero test, and
    only the lane pairs whose sigmoid is not 0 the whole shadow body; two
    bundles a lane.  The per-pair bodies are count_ops' counts of
    fwd_sub_math over one and two spheres on 4096 lanes, with and without
    the winner known."""
    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import step_counts
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, intersect_fused as f

    o, d, thr, alive, acc, geom, mat, consts = args[:8]
    xi = args[8] if len(args) > 8 else None
    n, s_cheap, part = d.shape[1], kw["s_cheap"], min(d.shape[1] // 32 * 32, 4096)
    c = step_counts(args, kw)
    with torch.no_grad():
        outs = bss.smooth_fwd_step(*args, **kw)
        f_all = bss.fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, bss._xi_pair(xi, 0),
                                 faraway=kw["faraway"], s_cheap=s_cheap, sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"],
                                 saved=(outs[5], outs[6] != 0, outs[7]), tex_hw=kw.get("tex_hw"))
        shadow = _shadow_skip_costs(torch.stack(f_all.p_n, 1), torch.stack(f_all.L, 1), consts[0, 3:6], geom, s_cheap,
                                    kw["sharp_s"])
        lanes = (tuple(o[:, :part]), tuple(d[:, :part]), thr[:part], alive[:part])
        xi_p = bss._xi_pair(None if xi is None else xi[:, :part], 0)
        known = (torch.zeros((part,), dtype=torch.int32, device=d.device), torch.zeros((part,), dtype=torch.bool,
                                                                                      device=d.device))

        def body(k: int, winner_known: bool) -> float:
            return count_ops(lambda: bss.fwd_sub_math(
                *lanes, geom[:k].contiguous(), mat[:k].contiguous(), consts, xi_p, faraway=kw["faraway"], s_cheap=k,
                sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"], known=known if winner_known else None,
                tex_hw=kw.get("tex_hw")))

        shadow_pair = (body(2, True) - body(1, True)) / part
        winner_pair = (body(2, False) - body(2, True) - body(1, False) + body(1, True)) / part
        wo, wd = o[:, :part].T.contiguous(), d[:, :part].T.contiguous()
        sample = f.warp_bundles(wo, wd)
        m = torch.zeros((sample.ok.shape[0], 1), dtype=d.dtype, device=d.device)
        winner_test = count_ops(lambda: f.winner_test(sample, geom[:1], m)) / (part // 32)
        winner_bundle = count_ops(lambda: f.warp_bundles(wo, wd)) / part
    pairs = n * s_cheap
    skip_ops = (ops - winner_pair * (pairs - 32 * c["winner_kept"]) - shadow_pair * (pairs - shadow["live"])
                + shadow["zero_ops"] * (32 * shadow["kept"] - shadow["live"])
                + (winner_bundle + shadow["bundle_ops"]) * n + (winner_test + shadow["test_ops"]) * c["warps"] * s_cheap)
    return _skip_bound_line("smooth_fwd_step", label, ops, skip_ops, n_bytes,
                            f"winner {c['winner']:.2%}, shadow {c['shadow']:.2%} of the warp-sphere pairs; a winner "
                            f"pair {winner_pair:g}, a shadow pair {shadow_pair:g}, its zero test {shadow['zero_ops']:g}, "
                            f"the tests {winner_test:g} and {shadow['test_ops']:g} operations")


def _clear_skip_bound(args, kw, ops: float, n_bytes: int) -> tuple[float, str]:
    """clear_fwd's least time with its skip on one call, from its plain
    version's operations ``ops`` on every pair: each cheap-tier (warp,
    sphere) pair pays a test, each pair the bound keeps the quadratic and
    zero test on every lane, and only the lane pairs whose sigmoid is not 0
    the whole pair; a bundle a lane."""
    o, d, geom = args[:3]
    n, s, s_cheap = o.shape[0], geom.shape[0], kw["s_cheap"]
    c = _shadow_skip_costs(o, d, kw.get("light"), geom, s_cheap, kw["sharpness"])
    pair_ops = ops / (n * s)
    skip_ops = (ops - pair_ops * (n * s_cheap - c["live"]) + c["zero_ops"] * (32 * c["kept"] - c["live"])
                + c["bundle_ops"] * n + c["test_ops"] * c["warps"] * s_cheap)
    return _skip_bound_line("clear_fwd", f"{s} spheres", ops, skip_ops, n_bytes,
                            f"{c['kept'] / (c['warps'] * s_cheap):.2%} of the warp-sphere pairs kept, "
                            f"{c['live'] / (n * s_cheap):.3%} of the lane pairs whole; a pair {pair_ops:g}, its zero "
                            f"test {c['zero_ops']:g}, a test {c['test_ops']:g} operations")


def _train_skip_bound(label: str, args, kw, ops: float, n_bytes: int) -> tuple[float, str]:
    """train_deep's least time with the row layout's skips on one launch,
    from its plain version's operations ``ops`` on every pair: on each
    bounce of the chain (``benchmarks/sweep_skip_ab``'s train_counts) the
    winner sweep and the shadow product as _step_skip_bound counts
    smooth_fwd_step's, and Phase C: every cheap-tier (lane, sphere) pair
    pays its test (the quadratic and the zero test), and only the (warp,
    sphere) pairs some lane reaches the whole term on every lane (the exact
    tier counted whole).  The per-pair bodies are count_ops' counts of
    fwd_sub_math over one and two spheres and of shadow_terms over one, on
    4096 lanes of the launch's rays."""
    from types import SimpleNamespace

    from python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab import train_counts
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, intersect_fused as f
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import sol_disc_plain

    o, d, _, geom, mat, consts, xi = args[:7]
    n, s_cheap, part, faraway = d.shape[1], kw["s_cheap"], min(d.shape[1] // 32 * 32, 4096), kw["faraway"]
    counts = train_counts(args, kw)
    with torch.no_grad():
        ones = torch.ones((part,), dtype=d.dtype, device=d.device)
        lanes = (tuple(o[:, :part]), tuple(d[:, :part]), ones, ones)
        xi_p = bss._xi_pair(None if xi is None else xi[:, :part], 0)
        known = (torch.zeros((part,), dtype=torch.int32, device=d.device),
                 torch.zeros((part,), dtype=torch.bool, device=d.device))

        def body(k: int, winner_known: bool) -> float:
            return count_ops(lambda: bss.fwd_sub_math(
                *lanes, geom[:k].contiguous(), mat[:k].contiguous(), consts, xi_p, faraway=faraway, s_cheap=k,
                sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"], known=known if winner_known else None))

        shadow_pair = (body(2, True) - body(1, True)) / part
        winner_pair = (body(2, False) - body(2, True) - body(1, False) + body(1, True)) / part
        wo, wd = o[:, :part].T.contiguous(), d[:, :part].T.contiguous()
        sample = f.warp_bundles(wo, wd)
        m = torch.zeros((sample.ok.shape[0], 1), dtype=d.dtype, device=d.device)
        winner_test = count_ops(lambda: f.winner_test(sample, geom[:1], m)) / (part // 32)
        winner_bundle = count_ops(lambda: f.warp_bundles(wo, wd)) / part
        fs = counts[0]["f"]
        sub = SimpleNamespace(p_n=tuple(x[:part] for x in fs.p_n), L=tuple(x[:part] for x in fs.L),
                              idx=fs.idx[:part], sharp_s=fs.sharp_s)
        g = geom[0]
        c_pair = count_ops(lambda: bss.shadow_terms(sub, 0, (g[0], g[1], g[2]), g[3], sol_disc_plain, ones,
                                                    faraway)) / part
        saved = 0.0
        for c in counts:
            shadow = _shadow_skip_costs(torch.stack(c["f"].p_n, 1), torch.stack(c["f"].L, 1), consts[0, 3:6], geom,
                                        s_cheap, kw["sharp_s"])
            pairs = n * s_cheap
            saved += (winner_pair * (pairs - 32 * c["winner_kept"]) + shadow_pair * (pairs - shadow["live"])
                      - shadow["zero_ops"] * (32 * shadow["kept"] - shadow["live"])
                      - (winner_bundle + shadow["bundle_ops"]) * n
                      - (winner_test + shadow["test_ops"]) * c["warps"] * s_cheap
                      + c_pair * (pairs - 32 * c["phase_c_cheap_kept"]) - shadow["zero_ops"] * pairs)
    shares = "; ".join(f"bounce {dep}: winner {c['winner']:.2%}, shadow {c['shadow']:.2%}, Phase C {c['phase_c']:.2%}"
                       for dep, c in enumerate(counts))
    return _skip_bound_line("train_deep", label, ops, ops - saved, n_bytes,
                            f"{shares} of the warp-sphere pairs; a winner pair {winner_pair:g}, a shadow pair "
                            f"{shadow_pair:g}, a Phase C pair {c_pair:g}, the tests {winner_test:g} and "
                            f"{shadow['test_ops']:g} operations")


def _nearest_skip_bound(args, kw, ops: float, n_bytes: int) -> tuple[float, str]:
    """smooth_nearest_parts' least time with its skip on one call, from its
    plain version's operations ``ops`` on every pair: each cheap-tier (warp,
    sphere) pair pays a test, each pair the winner rules keep the pair's
    operations on every lane; a bundle a lane."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss, intersect_fused as f

    o, d, geom = args[:3]
    n, s, s_cheap = o.shape[0], geom.shape[0], kw["s_cheap"]
    part = min(n // 32 * 32, 4096)
    with torch.no_grad():
        reach = bss.winner_reach(o, d, geom, s_cheap, kw["faraway"])
        sample = f.warp_bundles(o[:part], d[:part])
        m = torch.zeros((sample.ok.shape[0], 1), dtype=o.dtype, device=o.device)
        test_ops = count_ops(lambda: f.winner_test(sample, geom[:1], m)) / (part // 32)
        bundle_ops = count_ops(lambda: f.warp_bundles(o[:part], d[:part])) / part
    kept, warps = int(reach[:, :s_cheap].sum()), reach.shape[0]
    pair_ops = ops / (n * s)
    skip_ops = ops - pair_ops * (n * s_cheap - 32 * kept) + bundle_ops * n + test_ops * warps * s_cheap
    return _skip_bound_line("smooth_nearest_parts", f"{s} spheres", ops, skip_ops, n_bytes,
                            f"{kept / (warps * s_cheap):.2%} of the warp-sphere pairs kept; a pair {pair_ops:g}, a "
                            f"test {test_ops:g}, a bundle {bundle_ops:g} operations")


def _time_launches(name: str, calls: list, card: str, context: str, what: str) -> dict:
    """Time each of a kernel's main-path launches, ``(kernel, plain, bound)``
    callables (and a fourth, the kernel without its skip, timed beside in
    turns: skip, off, off, skip), beside its plain version and bound; returns
    the means per launch as the kernels line takes them."""
    rows, offs = [], []
    for b, (kernel, plain, bound, *off) in enumerate(calls):
        if off:
            turns = [time_ms(fn, warmup=2, iters=10) for fn in (kernel, off[0], off[0], kernel)]
            ms, off_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            offs.append(off_ms)
        else:
            ms = time_ms(kernel, warmup=2, iters=10)
        plain_ms = time_ms(plain, warmup=0, iters=1)
        bound_ms, bound_by = bound()
        rows.append((ms, plain_ms, bound_ms, bound_by))
        beside = f" (skip off {offs[-1]:.4f} ms, {offs[-1] / ms:.2f}x)" if off else ""
        print(f"[timing] {name} bounce {b}: kernel {ms:.4f} ms{beside}, plain version {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by}, kernel at {bound_ms / ms:.1%} of its bound ({context}; {card})",
              flush=True)
    k = len(rows)
    by_ops = sum(r[2] for r in rows if r[3] == "operations") >= sum(r[2] for r in rows if r[3] == "bytes")
    res = dict(ms=sum(r[0] for r in rows) / k, plain_ms=sum(r[1] for r in rows) / k,
               bound_ms=sum(r[2] for r in rows) / k, bound_by="operations" if by_ops else "bytes", library_ms=None)
    beside = f", skip off {sum(offs) / k:.4f} ms" if offs else ""
    print(f"[timing] {name}: mean per launch over {what}: kernel {res['ms']:.4f} ms{beside}, plain {res['plain_ms']:.2f} "
          f"ms, bound {res['bound_ms']:.4f} ms ({card})", flush=True)
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
                           lambda c=c: _sweep_bound("nearest_sweep", c),
                           lambda c=c: intersect_fused.nearest_sweep(*c[0], **c[1], skip="off")) for c in inputs["near"]],
        "shadow_sweep": [(lambda c=c: intersect_fused.shadow_sweep(*c[0], **c[1]),
                          lambda c=c: intersect_fused.shadow_sweep_plain(*c[0], **c[1]),
                          lambda c=c: _sweep_bound("shadow_sweep", c),
                          lambda c=c: intersect_fused.shadow_sweep(*c[0], **c[1], skip="off")) for c in inputs["shadow"]],
    }
    res = {name: _time_launches(name, calls, card, "config 4, 1920x1080 f32",
                                f"the mirror frame's {len(calls)}" if name in CULLED
                                else f"the glossy frame's {len(calls)}")
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
    per-column limits; bwd_cs twice, bitwise; fwd_cs with its skip bitwise
    the kernel without it (f64: the pairs the skip keeps; f32 in the
    timings).  On the f32 primary bounce the lists lose nothing: near_cs's (idx, hit) equal the plain full sweep's on
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
                    _skip_bitwise("fwd_cs", f"{tag} bounce {b}", cs.fwd_cs, fa, fkw)
                    if dtype == torch.float64:
                        _cs_skip_line("fwd_cs", f"{tag} bounce {b}", fa, fkw)
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

    if name == "bwd_cs":
        return _bwd_cs_bound(*r["bwd"], "config 4")
    if name == "fwd_cs":
        return _fwd_cs_bound(*r["fwd"], "config 4")
    args, kw = r[{"near_cs": "near", "fwd_cs": "fwd", "bwd_cs": "bwd"}[name]]
    ci = 4 if name == "near_cs" else 7  # the nearest lists, or the shadow lists
    return _list_bound(getattr(cs, f"{name}_plain"), getattr(cs, name), args, kw, ci)


def _bwd_cs_layout(card: str, log: str) -> None:
    """[timing] bwd_cs's launch: CTAs per launch at config 4 and at the atlas
    loss's 960x540, and per instantiation (1024 spheres) its resident CTAs
    per SM (the occupancy API at the launch's shared bytes) and ptxas's
    registers and spill bytes."""
    from python_ray_tracer_tpu_torch.benchmarks.bwd_cs_split import ptxas_report
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    ptxas = ptxas_report(log)
    ctas = {f"{w}x{h}": cs.bwd_rows(-(-w * h // 4096) * 4096, 4096) for w, h in ((BIG_WIDTH, BIG_HEIGHT), TEX_CS_SIZE)}
    parts = []
    for dtype in (torch.float32, torch.float64):
        for glossy in (False, True):
            for atlas in (False, True):
                key = f"{str(dtype).split('.')[-1].replace('float', 'f')}{' glossy' if glossy else ''}{' atlas' if atlas else ''}"
                rec = ptxas.get(key, {})
                parts.append(f"{key}: {cs.bwd_blocks_per_sm(dtype, glossy, atlas, BIG_SPHERES)} CTAs/SM, "
                             f"{rec.get('registers', 'n/a')} registers, {rec.get('spill_stores', 'n/a')}/"
                             f"{rec.get('spill_loads', 'n/a')} B spilled")
    print(f"[timing] bwd_cs layout: {cs.BWD_CTAS_PER_TILE} CTAs of {cs.BWD_THREADS} threads a 4096-ray tile, "
          f"{', '.join(f'{v} CTAs at {k}' for k, v in ctas.items())}; {cs.bwd_shared_bytes(BIG_SPHERES, torch.float32)} B "
          f"shared f32 at {BIG_SPHERES} spheres; {'; '.join(parts)} ({card})", flush=True)


def phase_cs_timing(card: str, record: list[dict], logs: dict[str, str]) -> dict[str, dict]:
    """The three kernels on each bounce of the config-4 step (CUDA events),
    beside their plain versions and bounds; bwd_cs's launch layout (from
    ``logs``, phase_build's); the config-4 culled smooth Adam step in
    ms/step with a torch.profiler split into the kernels and the glue; the
    smooth frame in ms/frame."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    parts = {"near_cs": "near", "fwd_cs": "fwd", "bwd_cs": "bwd"}

    def off(name, r):  # fwd_cs without its skip, timed beside in turns
        return (lambda: cs.fwd_cs(*r["fwd"][0], **r["fwd"][1], skip="off"),) if name == "fwd_cs" else ()

    with torch.no_grad():
        res = {
            name: _time_launches(
                name,
                [(lambda r=r, f=getattr(cs, name): f(*r[parts[name]][0], **r[parts[name]][1]),
                  lambda r=r, f=getattr(cs, f"{name}_plain"): f(*r[parts[name]][0], **r[parts[name]][1]),
                  lambda r=r: _cs_bound(name, r), *off(name, r)) for r in record],
                card, "config 4 smooth step, 1920x1080 f32", f"the step's {len(record)}",
            )
            for name in CS
        }
    n, s = BIG_WIDTH * BIG_HEIGHT, BIG_SPHERES
    n_pad = -(-n // 4096) * 4096
    print(f"[timing] bwd_cs table-gradient rows per launch: {cs.grad_rows_bytes(n_pad, s, 4096, torch.float32)} bytes f32, "
          f"{cs.grad_rows_bytes(n_pad, s, 4096, torch.float64)} f64 (config 4: {n_pad // 4096} tiles x "
          f"{cs.BWD_CTAS_PER_TILE} CTAs x (19 x {s} + 16) values)", flush=True)
    _bwd_cs_layout(card, logs["culled_smooth.cu"])

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
    (staged geometry), the depth-fused three at 4096 (f64, geometry from
    global memory), and the
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
        # The builds the launch rules take (smooth_fwd_step's and train_deep's skips from 16 cheap spheres on).
        occupancy = {k: bss.blocks_per_sm(k, dtype, glossy, s, skip=k in ("smooth_fwd_step", "train_deep")
                                          and kw["s_cheap"] >= bss.STEP_SKIP_MIN_CHEAP) for k in kernels}
        print(f"[blocked] {label}: geometry {'staged in shared memory' if smem > 16 * dtype.itemsize else 'read from global memory'} "
              f"({smem} B of shared memory a block); "
              f"resident blocks per SM {occupancy} (128 threads; smooth_bwd_step {bss.STEP_THREADS}); column partials "
              f"{bss.partials_bytes(n, s, dtype)} B = (23 x {s} + 17) x {min(-(-n // 32), bss.PARTIAL_COLS)} columns x "
              f"{dtype.itemsize} B (smooth_bwd_deep); smooth_bwd_step's and train_deep's rows "
              f"{bss.step_rows_bytes(n, s, dtype)} B = {bss.step_rows(n)} rows x (19 x {s} + 16) x {dtype.itemsize} B",
              flush=True)
        plain_ms: dict | None = {} if timed else None
        t0 = time.perf_counter()
        if kernels != STEP:
            err, outs = _check_smooth_case(label, o, d, tables, kw, xis, dtype, plain_ms, state_by_kernel=True,
                                           pair=kernels == SMOOTH)
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
                beside = ""
                p_ms, ops = plain_ms[name]
                bound_ms, bound_by = _bound(ops, n_bytes)
                if name == "smooth_bwd_step":
                    bound_ms, bound_by = _step_reach_bound(label, *calls["bwd_step_args"], ops, n_bytes)
                if name == "smooth_fwd_step":  # with the launch rule's skip and without it, in turns
                    args, skw = calls["fwd_step_args"]
                    turns = [time_ms(fn, warmup=2, iters=10) for fn in (
                        call, lambda: bss.smooth_fwd_step(*args, **skw, skip="off"),
                        lambda: bss.smooth_fwd_step(*args, **skw, skip="off"), call)]
                    ms, off_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                    skip_blocks = bss.blocks_per_sm(name, dtype, glossy, s, skip=True)
                    beside = f" (skip off {off_ms:.4f} ms, {off_ms / ms:.2f}x; {skip_blocks} blocks per SM with the skip)"
                    bound_ms, bound_by = _step_skip_bound(label, args, skw, ops, n_bytes)
                if name == "train_deep":  # with the launch rule's skips and without, in turns
                    targs, tkw = calls["train_args"]
                    off = functools.partial(bss.train_deep, *targs, **tkw, skip="off")
                    turns = [time_ms(fn, warmup=2, iters=10) for fn in (call, off, off, call)]
                    ms, off_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                    blocks = {k: bss.blocks_per_sm(name, dtype, glossy, s, skip=k) for k in (False, True)}
                    beside = f" (skip off {off_ms:.4f} ms, {off_ms / ms:.2f}x; blocks per SM without and with the " \
                             f"skips {blocks})"
                    if tkw["s_cheap"] >= bss.STEP_SKIP_MIN_CHEAP:
                        bound_ms, bound_by = _train_skip_bound(label, targs, tkw, ops, n_bytes)
                res[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                print(f"[timing] {name} at {label}: kernel {ms:.4f} ms{beside}, plain version {p_ms:.1f} ms (one call, "
                      f"under the op counter), bound {bound_ms:.4f} ms by {bound_by} ({ops / n:.0f} operations per ray, "
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
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.utils.image import to_uint8

    others = SMOOTH + CS
    size = ["--builtin", "random1024", "--width", "480", "--height", "270", "--depth", str(C5_DEPTH)]
    _cli_render(tmp, "c5_target.png", *size)
    metrics = tmp / "c5_optimize.jsonl"
    _reset_launches()
    train_calls: list = []
    with _capture(bss, "train_deep", train_calls):
        cli.main(["optimize", *size, "--visibility", "smooth", "--target", str(tmp / "c5_target.png"), "--steps", "3",
                  "--sync-every", "3", "--lr", "1e-3", "--metrics", str(metrics)])
    counts = _launches()
    _expect_launched("cli optimize --builtin random1024 480x270 smooth, 3 steps", counts, ("train_deep",), exactly=3,
                     absent=tuple(k for k in others if k != "train_deep"))
    _train_skip_lines("the random1024 480x270 optimize", train_calls)
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
        train_calls = []
        with _capture(bss, "train_deep", train_calls):
            loss = make_loss_fn(scene, target, _c5_cfg(dtype))(params)
            loss.backward()
        torch.cuda.synchronize()
        tag = str(dtype).split(".")[-1]
        counts = _launches()
        _expect_launched(f"config 5's first step, {tag}", counts, ("train_deep",), exactly=1,
                         absent=tuple(k for k in others if k != "train_deep"))
        _train_skip_lines(f"config 5's first step {tag}", train_calls)
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
    fwd_calls: list = []
    with _capture(bss, "smooth_fwd_step", fwd_calls):
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
    _step_skip_lines(f"the {LANE_SPHERES}-sphere L2 step", fwd_calls, upcast=True)
    return launches


@contextlib.contextmanager
def _train_skip(skip: str):
    """train_deep with ``skip`` forced, wherever the package calls it."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    real = bss.train_deep
    bss.train_deep = functools.partial(real, skip=skip)
    try:
        yield
    finally:
        bss.train_deep = real


def phase_c5_timing(card: str) -> None:
    """Config 5's Adam step (ms/step, rays/s) with a torch.profiler split and
    the busy share, and the Adam step at 8192 spheres (one-bounce pair)."""
    from python_ray_tracer_tpu_torch.optim import make_loss_fn

    n = C5_WIDTH * C5_HEIGHT
    for label, scene, kernels in (
        (f"config 5 ({C5_SPHERES} spheres, train_deep)", _c5_scene(torch.float32), ("train_deep", "reduce_rows")),
        (f"{LANE_SPHERES} spheres (one-bounce pair)", _lane_scene(), STEP + ("reduce_partials",)),
    ):
        ms, step_k, state = _best_step_ms(make_loss_fn(scene, _c5_target(scene), _c5_cfg()), scene, warmup=3, steps=10)
        print(f"[timing] Adam step, {label}: {ms:.3f} ms/step, {n / (ms * 1e-3):.4e} primary rays/s "
              f"({C5_WIDTH}x{C5_HEIGHT} depth {C5_DEPTH}, f32, best of 3 calls of 10 steps; {card})", flush=True)
        _device_profile(lambda: step_k(state, 1), f"Adam step, {label}", card, kernels)
        if "train_deep" in kernels:  # the step with train_deep's skips on (the rule's) and off, in turns
            loss_fn, turns = make_loss_fn(scene, _c5_target(scene), _c5_cfg()), {"on": [], "off": []}
            for skip in ("on", "off", "off", "on"):
                with _train_skip(skip):
                    turns[skip].append(_best_step_ms(loss_fn, scene, warmup=3, steps=10)[0])
            on, off = statistics.mean(turns["on"]), statistics.mean(turns["off"])
            print(f"[timing] Adam step, {label}, in turns: train_deep's skips on {on:.3f} ms/step, off {off:.3f} "
                  f"ms/step ({off / on:.2f}x; {card})", flush=True)


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
    the gradient kernels twice, bitwise; fwd_cs with its skip bitwise the
    kernel without it.  Returns the max abs error per kernel (f32) and the
    f32 calls and records for the timings."""
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
                _skip_bitwise("fwd_cs (atlas)", f"{tag} bounce {b}", cs.fwd_cs, fa, fkw)
                if dtype == torch.float64:
                    _cs_skip_line("fwd_cs (atlas)", f"{tag} bounce {b}", fa, fkw)
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
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
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
    fwd_calls: list = []
    with _capture(bss, "smooth_fwd_step", fwd_calls):
        loss = make_loss_fn(scene, target, _tex_cfg(depth=1))(params)
        loss.backward()
    torch.cuda.synchronize()
    counts = _launches()
    _step_skip_lines("the texture task's depth-1 step (atlas)", fwd_calls)
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
        for name, part in (("fwd_cs", "fwd"), ("bwd_cs", "bwd")):
            rows = []
            for r in inputs["cs"]:
                args, kw = r[part]
                kernel, plain = getattr(cs, name), getattr(cs, f"{name}_plain")
                bound = (lambda a=args, w=kw: _bwd_cs_bound(a, w, "textured1024 atlas")) if name == "bwd_cs" else (
                    lambda a=args, w=kw: _fwd_cs_bound(a, w, "textured1024 atlas"))
                off = () if name == "bwd_cs" else ((lambda a=args, w=kw: cs.fwd_cs(*a, **w, skip="off")),)
                rows.append((lambda k=kernel, a=args, w=kw: k(*a, **w), lambda p=plain, a=args, w=kw: p(*a, **w), bound,
                             *off))
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
    bitwise; alive exactly, the rest under the per-value limit; and bitwise
    the kernel with its skip compiled out."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    err = 0.0
    with torch.no_grad():
        for b, (args, kw) in enumerate(record):
            _skip_bitwise("bounce_lane", f"{tag} bounce {b}", bounce_lane.bounce_lane, args, kw)
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
        tag = _lane_tag(name, scene, torch.float64)
        record = _lane_record(scene, torch.float64)
        _check_lane(tag, record, torch.float64)
        for b, (args, kw) in enumerate(record):
            _skip_line("bounce_lane", f"{tag} bounce {b}", _lane_skips(args, kw), _lane_ops(args, kw))
    return errs, inputs


def _lane_instantiation(args: tuple, kw: dict) -> tuple[str, ...]:
    """The template arguments (T, kAtlas, kStaged, kSkip) of the bounce_lane
    instantiation that one launch with these arguments runs, from its name
    under torch.profiler."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from python_ray_tracer_tpu_torch.ops import bounce_lane

    for attempt in range(1, 6):
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            bounce_lane.bounce_lane(*args, **kw)
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()]
        found = {m.groups() for key in keys if (m := re.search(r"bounce_lane<(\w+), (\w+), (\w+), (\w+)>", key))}
        if found:
            break
        # A profile that holds no bounce_lane kernel is the profiler's miss
        # (the launch returned no error): the launch is profiled again, at
        # most five times.  A wrong or second instantiation fails at once.
        print(f"[geometry] the profiler recorded no bounce_lane kernel (attempt {attempt} of 5; its events: "
              f"{[k[:60] for k in keys]})", flush=True)
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
            if got != (*auto[:2], staged, auto[3]):
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


def _lane_ops(args: tuple, kw: dict) -> float:
    """The plain version's operations on one bounce_lane launch, counted over
    4096 of the lanes and scaled to all of them (every lane sweeping every
    sphere twice)."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    n = args[0].shape[1]
    part = min(n, 4096)
    sliced = [a[..., :part] if isinstance(a, torch.Tensor) and a.shape[-1] == n else a for a in args]
    with torch.no_grad():
        return count_ops(lambda: bounce_lane.bounce_lane_plain(*sliced, **kw)) * n / part


def _lane_bound(args: tuple, kw: dict, label: str = "") -> tuple[float, str]:
    """The least time of one bounce_lane launch on these inputs: each input
    and output once, and the operations of :func:`_lane_ops` less what the
    skip saves on this launch (:func:`_skip_bound`)."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    with torch.no_grad():
        out = bounce_lane.bounce_lane(*args, **kw)
    n_bytes = _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out)
    return _skip_bound("bounce_lane", _lane_skips(args, kw), _lane_ops(args, kw), n_bytes, label)


def phase_lane_timing(card: str, inputs: dict) -> dict[str, dict]:
    """bounce_lane on each of its launches of both scenes' 1920x1080 frames
    (CUDA events) beside its plain version and bound; each frame through
    render() in ms/frame, with a torch.profiler split."""
    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    def calls(record, tag):
        return [(lambda a=a, k=k: bounce_lane.bounce_lane(*a, **k),
                 lambda a=a, k=k: bounce_lane.bounce_lane_plain(*a, **k),
                 lambda a=a, k=k, b=b: _lane_bound(a, k, f"{tag} bounce {b}"),
                 lambda a=a, k=k: bounce_lane.bounce_lane(*a, **k, skip="off")) for b, (a, k) in enumerate(record)]

    with torch.no_grad():
        res = {
            ATLAS["bounce_lane"]: _time_launches("bounce_lane (atlas)", calls(inputs["a"], "lane80 1920x1080"), card,
                                                 "lane80, 80 spheres, 20,480 texels, 1920x1080 f32",
                                                 f"the lane80 frame's {LANE_DEPTH}"),
            "bounce_lane": _time_launches("bounce_lane", calls(inputs["b"], "1032 spheres 1920x1080"), card,
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


# --- The sphere-sharded path: parallel/ on torch.distributed, the per-shard kernels ---


def _shard_scene(dtype: torch.dtype, width: int, height: int, builtin: str = "random1024"):
    from python_ray_tracer_tpu_torch.models.scenes import inverse_task_scene

    if builtin == "inverse64":
        return inverse_task_scene(64, width, height, dtype=dtype, device=DEVICE)
    return _big_scene(dtype, width, height)


def _rank_tag(mesh) -> str:
    return f"rank ({mesh.rays.index}, {mesh.spheres.index})"


def _check_parts_calls(tag: str, calls: dict, dtype: torch.dtype, err: dict) -> None:
    """Each recorded per-shard call of the first two bounces, its kernel
    against its plain version: indices exactly, values as PERF.md section 2
    states (THRESHOLD, RAY_GRAD_TOL, COLUMN_RTOL); clear_bwd twice, bitwise;
    shadow_parts, clear_fwd and the shard's nearest_sweep on every bounce
    bitwise the kernel without its skip, with the pairs the skip reaches."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused, smooth_parts as sp

    def det(args):
        return [a.detach() if isinstance(a, torch.Tensor) else a for a in args]

    for b, (args, kw) in enumerate(calls.get("shadow_parts", [])):
        args = det(args)
        _skip_bitwise("shadow_parts", f"{tag} bounce {b}", intersect_fused.shadow_parts, args, kw)
        _sweep_skip_ops("shadow_parts", f"{tag} bounce {b}", tuple(args), kw)
        if b >= 2:
            continue
        got = intersect_fused.shadow_parts(*args, **kw)
        torch.cuda.synchronize()
        want = intersect_fused.shadow_parts_plain(*args, **kw)
        for name, k, p in zip(("t_others", "t_self"), got, want):
            err["shadow_parts"] = max(err["shadow_parts"], _per_value_check(f"shadow_parts {tag} bounce {b} {name}", k, p, dtype))
    for b, (args, kw) in enumerate(calls.get("nearest_sweep", [])):
        args = det(args)
        _skip_bitwise("nearest_sweep", f"{tag} bounce {b}", intersect_fused.nearest_sweep, args, kw)
        _sweep_skip_ops("nearest_sweep", f"{tag} bounce {b}", tuple(args), kw)
    for b, (args, kw) in enumerate(calls.get("nearest", [])):
        _nearest_skip_line(f"{tag} bounce {b}", det(args), kw)
    for b, (args, kw) in enumerate(calls.get("nearest", [])[:2]):
        args = det(args)
        got = sp.nearest_parts(*args, **kw)
        torch.cuda.synchronize()
        want = sp.smooth_nearest_parts_plain(*args, **kw)
        for name, k, p in zip(sp.SmoothParts._fields, got, want):
            if name in ("idx", "fidx"):
                _exact_check(f"smooth_nearest_parts {tag} bounce {b} {name}", k, p)
            else:
                err["smooth_nearest_parts"] = max(err["smooth_nearest_parts"], _per_value_check(
                    f"smooth_nearest_parts {tag} bounce {b} {name}", k, p, dtype))
    for b, (args, kw) in enumerate(calls.get("clear", [])):
        _clear_skip_line(f"{tag} bounce {b}", det(args), kw)
    for b, (args, kw) in enumerate(calls.get("clear", [])[:2]):
        args = det(args)
        got = sp.clear_fwd(*args, **kw)
        torch.cuda.synchronize()
        err["clear_fwd"] = max(err["clear_fwd"], _per_value_check(f"clear_fwd {tag} bounce {b} clear", got,
                                                                   sp.clear_fwd_plain(*args, **kw), dtype))
    # The backward runs the bounces in reverse: bounce 0 is the last call.
    for b, (args, kw) in enumerate(calls.get("clear_bwd", [])[::-1][:2]):
        args = det(args)
        got = sp.clear_bwd(*args, **kw)
        again = sp.clear_bwd(*args, **kw)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
        print(f"[parts] clear_bwd {tag} bounce {b}: two launches bitwise equal: {same}", flush=True)
        if not same:
            fail(f"clear_bwd {tag} bounce {b}: two launches differ")
        want = sp.clear_bwd_plain(*args, **kw)
        for name, k, p in zip(("g_o", "g_d", "g_geom"), got, want):
            e = _per_ray_check(f"clear_bwd {tag} bounce {b} {name}", k, p, dtype) if name != "g_geom" else \
                _column_check(f"clear_bwd {tag} bounce {b} {name}", k, p, dtype)
            err["clear_bwd"] = max(err["clear_bwd"], e)


@contextlib.contextmanager
def _parts_capture(calls: dict):
    """Record every per-shard kernel call of the sharded path (arguments, keywords)."""
    from python_ray_tracer_tpu_torch.ops import smooth_parts

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    with contextlib.ExitStack() as stack:
        for module, name, key in ((render_mod, "shadow_parts", "shadow_parts"), (render_mod, "nearest_sweep", "nearest_sweep"),
                                  (render_mod, "smooth_nearest_parts", "nearest"),
                                  (render_mod, "smooth_clear_parts", "clear"), (smooth_parts, "clear_bwd", "clear_bwd")):
            stack.enter_context(_capture(module, name, calls.setdefault(key, [])))
        yield


def _shard_rank(shape: tuple[int, int], jobs: list[dict], tmp: str) -> dict:
    """One rank of a mesh of ``shape`` on the card (spawned by run_local).

    ``"hard"`` jobs render config 4's mirror frame (depth 4) sharded and
    check the shard's shadow_parts calls; ``"smooth"`` jobs take the
    first-step loss and gradients of config 4's smooth L2 step (depth 3,
    the target ``job["target"]``), checking rows 18-20's calls where
    ``check`` is set; ``"step"`` jobs only the loss and gradients.  Rank 0
    saves its first f32 call of each kernel for the timings.  Returns the
    errors and, per job, the loss and gradients (numpy)."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(*shape)
    tag0 = _rank_tag(mesh)
    err = dict.fromkeys(PARTS + ("shadow_parts",), 0.0)
    out: dict = {"err": err}
    saved: dict = {}
    for job in jobs:
        dtype = job["dtype"]
        width, height = job["size"]
        tag = f"{tag0} {job['builtin']} {str(dtype).split('.')[-1]} {width}x{height}"
        scene = _shard_scene(dtype, width, height, job["builtin"])
        calls: dict = {}
        if job["kind"] == "hard":
            with _parts_capture(calls), torch.no_grad():
                render_sharded(scene, _big_cfg(dtype, use_pallas=True), mesh)
            torch.cuda.synchronize()
        else:
            cfg = RenderConfig(max_depth=job["depth"], dtype=dtype, visibility="smooth", use_pallas=True)
            target = torch.as_tensor(job["target"], dtype=dtype, device=DEVICE)
            params = scene_to_params(scene)
            with _parts_capture(calls) if job.get("check") else contextlib.nullcontext():
                loss = make_loss_fn(scene, target, cfg, mesh)(params)
                loss.backward()
            torch.cuda.synchronize()
            out[job["name"]] = {"loss": float(loss.detach()),
                                **{k: g.cpu().numpy() for k, g in _leaf_grads(params).items()}}
            print(f"[sharded] {tag}: first-step loss {float(loss.detach()):.8e}", flush=True)
        if job.get("check"):
            _check_parts_calls(tag, calls, dtype, err)
            if dtype == torch.float32 and mesh.spheres.index == 0 and mesh.rays.index == 0:
                for key in calls:
                    if calls[key] and key not in saved:
                        # shadow_parts: every bounce of the frame; the others their first.
                        picked = calls[key] if key == "shadow_parts" else [calls[key][-1 if key == "clear_bwd" else 0]]
                        saved[key] = [([a.detach() if isinstance(a, torch.Tensor) else a for a in args], kw)
                                      for args, kw in picked]
        del calls
    if saved:
        torch.save(saved, Path(tmp) / "parts_inputs.pt")
    return out


def _golden_target(width: int, height: int) -> np.ndarray:
    """config 4's smooth-step target: the CS golden's uint8 image / 255 at
    960x540, else the clipped single-process hard frame at that size."""
    if (width, height) == (WIDTH, HEIGHT):
        return np.load(REPO / CS_GOLDEN)["image"] / 255.0
    from python_ray_tracer_tpu_torch import render

    with torch.no_grad():
        img = render(_big_scene(torch.float32, width, height), dataclasses.replace(_big_cfg(use_pallas=True), max_depth=CS_DEPTH))
    return torch.clamp(img, 0.0, 1.0).cpu().numpy()


def phase_parts(tmp: Path) -> dict[str, float]:
    """[parts]: two ranks on the one card (gloo), sphere shards 0 and 1 of
    config 4.  Each rank checks its shard's calls on real inputs: row 4's
    parts mode on the first two bounces of the 1920x1080 mirror frame (f32;
    f64 at 480x270), rows 18-20 on the first two bounces of the 960x540
    smooth step's forward and backward (f32; f64 at 480x270).  The f32 and
    f64 first steps at 960x540 are then held to the JAX golden: f32 within
    NOISE_FACTOR x the single-process culled route's distance from the f64
    golden (+ NOISE_FLOOR of the leaf), f64 within SHARDED_F64_RTOL.
    Returns the f32 errors per kernel."""
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.parallel.distributed import run_local

    full, quarter = (BIG_WIDTH, BIG_HEIGHT), SHARD_F64_SIZE
    jobs = [
        dict(kind="hard", builtin="random1024", dtype=torch.float32, size=full, check=True),
        dict(kind="hard", builtin="random1024", dtype=torch.float64, size=quarter, check=True),
        dict(kind="smooth", name="step32", builtin="random1024", dtype=torch.float32, size=(WIDTH, HEIGHT),
             depth=CS_DEPTH, target=_golden_target(WIDTH, HEIGHT), check=True),
        dict(kind="smooth", name="check64", builtin="random1024", dtype=torch.float64, size=quarter, depth=CS_DEPTH,
             target=_golden_target(*quarter), check=True),
        dict(kind="smooth", name="step64", builtin="random1024", dtype=torch.float64, size=(WIDTH, HEIGHT),
             depth=CS_DEPTH, target=_golden_target(WIDTH, HEIGHT)),
    ]
    t0 = time.perf_counter()
    ranks = run_local(_shard_rank, 2, (1, 2), jobs, str(tmp))
    print(f"[parts] two ranks on one card: {time.perf_counter() - t0:.1f} s", flush=True)
    errs = {k: max(r["err"][k] for r in ranks) for k in ranks[0]["err"]}
    for name in ("step32", "step64"):
        for key in ranks[0][name]:
            if not np.array_equal(ranks[0][name][key], ranks[1][name][key]):
                fail(f"[parts] the ranks' {name} {key} differ")
    golden = np.load(REPO / CS_GOLDEN)
    scene = _big_scene(torch.float32, WIDTH, HEIGHT)
    params = scene_to_params(scene)
    loss = make_loss_fn(scene, torch.tensor(golden["image"], dtype=torch.float32, device=DEVICE) / 255.0,
                        _cs_cfg())(params)
    loss.backward()
    peer = {k: g.cpu().numpy() for k, g in _leaf_grads(params).items()}
    step = ranks[0]["step32"]
    _noise_check("sphere-sharded f32 first-step loss (peer: the single-process culled route)", step["loss"],
                 float(loss.detach()), golden["loss64"])
    for key in peer:
        _noise_check(f"sphere-sharded f32 first step d/d{key} (peer: the single-process culled route)", step[key],
                     peer[key], golden[f"grad64/{key}"])
    step = ranks[0]["step64"]
    _relative_check("sphere-sharded f64 first-step loss vs the JAX f64 golden", torch.tensor(step["loss"]),
                    torch.as_tensor(golden["loss64"]), F64_RTOL)
    for key in peer:
        _relative_check(f"sphere-sharded f64 first step d/d{key} vs the JAX f64 golden", torch.as_tensor(step[key]),
                        torch.as_tensor(golden[f"grad64/{key}"]), SHARDED_F64_RTOL)
    return errs


def _cli_sharded(what: str, argv: list[str], metrics: Path) -> dict:
    """Run ``cli.main(argv)`` with ``--metrics metrics`` (it starts the ranks)
    and return rank 0's last record there: the render's, or the optimize run's."""
    from python_ray_tracer_tpu_torch import cli

    t0 = time.perf_counter()
    code = cli.main([*argv, "--metrics", str(metrics)])
    if code != 0:
        fail(f"{what}: exit code {code}")
    rec = json.loads(metrics.read_text().splitlines()[-1])
    print(f"[sharded] {what}: {time.perf_counter() - t0:.1f} s for the command (ranks started, kernels loaded)",
          flush=True)
    return rec


def _rank_launches(what: str, rec: dict, kernels: tuple[str, ...], exactly: int, absent: tuple[str, ...]) -> dict:
    """Each rank's launches in ``rec`` hold ``exactly`` of each of
    ``kernels`` and none of ``absent``; returns their sums over the ranks."""
    total = dict.fromkeys(kernels, 0)
    for r, counts in enumerate(rec["launches"]):
        full = {k: counts.get(k, 0) for k in set(counts) | set(kernels) | set(absent)}
        _expect_launched(f"{what}, rank {r}", full, kernels, exactly=exactly, absent=absent)
        for k in kernels:
            total[k] += counts[k]
    return total


def phase_sharded_main(tmp: Path, shape: tuple[int, int] = (1, 2), label: str = "two ranks on one card, gloo") -> dict:
    """[sharded]: the CLI over a mesh of ranks (started by the CLI itself).

    (a) ``render --builtin random1024 --sphere-shards 2`` (1920x1080, depth
    4): within MAX_GOLDEN_SHARE of the JAX golden's uint8 values and of the
    single-process CLI frame; each rank exactly 4 nearest_sweep and 4
    shadow_parts, no culled kernel and no hard-mode shadow_sweep.  (b)
    ``optimize --builtin random1024 --width 960 --height 540 --visibility
    smooth --sphere-shards 2``, 3 steps: each rank exactly 9 of each of rows
    18-20 and none of the unsharded smooth kernels.  On one card also (c)
    ``optimize --builtin inverse64 --visibility smooth --ray-shards 2`` (960x540,
    depth 3), 3 steps, and its first step's loss and gradients against the
    single-process step (RAY_SHARD_RTOL).  Returns the new kernels' launches
    in (a) and (b), summed over the ranks."""
    from python_ray_tracer_tpu_torch.parallel.distributed import run_local
    from python_ray_tracer_tpu_torch.utils.image import load_png, save_png

    mesh_flags = ["--ray-shards", str(shape[0]), "--sphere-shards", str(shape[1])]
    tag = f"{shape[0]}x{shape[1]} mesh, {label}"
    big = ["--builtin", "random1024", "--width", str(BIG_WIDTH), "--height", str(BIG_HEIGHT), "--depth", str(BIG_DEPTH)]
    out = tmp / f"sharded_{shape[0]}x{shape[1]}.png"
    rec = _cli_sharded(f"render --sphere-shards ({tag})", ["render", *big, *mesh_flags, "-o", str(out)],
                       tmp / f"render_{shape[0]}x{shape[1]}.jsonl")
    print(f"[sharded] config-4 frame over the {tag}: {rec['render_s'] * 1e3:.3f} ms for the timed frame (a check "
          "of the path, not a speed of the port)", flush=True)
    counts = _rank_launches(f"the sharded config-4 render ({tag})", rec, ("nearest_sweep", "shadow_parts"),
                            BIG_DEPTH, CULLED + ("shadow_sweep",))
    launches = {"shadow_parts": counts["shadow_parts"]}
    img = load_png(out)
    _compare_uint8(f"config 4 sphere-sharded ({tag})", img, np.load(REPO / BIG_GOLDEN)["image"], "the JAX golden")
    _compare_uint8(f"config 4 sphere-sharded ({tag})", img, load_png(tmp / "big.png"), "the single-process CLI frame")

    target = tmp / "sharded_target.png"
    save_png(torch.as_tensor(np.load(REPO / CS_GOLDEN)["image"] / 255.0), target)
    small = ["--builtin", "random1024", "--width", str(WIDTH), "--height", str(HEIGHT), "--depth", str(CS_DEPTH),
             "--visibility", "smooth"]
    opt_metrics = tmp / f"optimize_{shape[0]}x{shape[1]}.jsonl"
    rec = _cli_sharded(f"optimize --sphere-shards ({tag})",
                       ["optimize", *small, *mesh_flags, "--target", str(target), "--steps", "3", "--sync-every", "3",
                        "--lr", "1e-3"], opt_metrics)
    steps = [r for r in map(json.loads, opt_metrics.read_text().splitlines()) if r["event"] == "step"]
    print(f"[sharded] config-4 smooth steps over the {tag}: losses {[s['loss'] for s in steps]}, "
          f"{steps[-1]['step_s'] * 1e3:.3f} ms/step, the mean of the three steps with the first one's set-up (a "
          "check of the path, not a speed of the port)", flush=True)
    if len(steps) != 3 or not all(np.isfinite([s["loss"] for s in steps])):
        fail(f"optimize --sphere-shards ({tag}) logged {len(steps)} steps")
    launches.update(_rank_launches(f"the sharded config-4 smooth optimize ({tag})", rec, PARTS, 3 * CS_DEPTH,
                                   SMOOTH + CS))
    if shape != (1, 2):
        return launches

    inv = ["--builtin", "inverse64", "--width", str(WIDTH), "--height", str(HEIGHT), "--depth", str(CS_DEPTH)]
    inv_target = tmp / "inverse64_target.png"
    _cli_render(tmp, inv_target.name, *inv)
    inv_metrics = tmp / "optimize_inverse64_2x1.jsonl"
    rec = _cli_sharded("optimize --builtin inverse64 --ray-shards 2",
                       ["optimize", *inv, "--visibility", "smooth", "--ray-shards", "2", "--target", str(inv_target),
                        "--steps", "3", "--sync-every", "3", "--lr", "1e-3"], inv_metrics)
    _rank_launches("the ray-sharded config-5-shape optimize", rec, ("smooth_fwd_deep", "smooth_bwd_deep"), 3,
                   PARTS + ("train_deep",))
    # Its first step against the single-process step on the card.
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params

    tgt = load_png(inv_target) / 255.0
    job = dict(kind="step", name="inv", builtin="inverse64", dtype=torch.float32, size=(WIDTH, HEIGHT), depth=CS_DEPTH,
               target=tgt)
    ranks = run_local(_shard_rank, 2, (2, 1), [job], str(tmp))
    scene = _shard_scene(torch.float32, WIDTH, HEIGHT, "inverse64")
    params = scene_to_params(scene)
    loss = make_loss_fn(scene, torch.tensor(tgt, dtype=torch.float32, device=DEVICE), _cs_cfg())(params)
    loss.backward()
    _relative_check("ray-sharded inverse64 first-step loss vs the single-process step", torch.tensor(ranks[0]["inv"]["loss"]),
                    loss.detach().cpu(), RAY_SHARD_RTOL)
    for key, g in _leaf_grads(params).items():
        if not np.array_equal(ranks[0]["inv"][key], ranks[1]["inv"][key]):
            fail(f"the ray-sharded ranks' d/d{key} differ")
        _relative_check(f"ray-sharded inverse64 first step d/d{key} vs the single-process step",
                        torch.as_tensor(ranks[0]["inv"][key]), g.cpu(), RAY_SHARD_RTOL)
    return launches


def phase_multi_card(tmp: Path) -> None:
    """(a) and (b) of [sharded] over NCCL, one rank a card: a 2x2 mesh with
    four cards, (1, 2) with two or three; one card prints that it needs more."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[multi-card] {n} card visible: the NCCL phase needs two or more (skipped on this machine)", flush=True)
        return
    shape = (2, 2) if n >= 4 else (1, 2)
    phase_sharded_main(tmp, shape, f"one rank a card, NCCL, {n} cards visible")


def _parts_bound(name: str, args: list, kw: dict) -> tuple[float, str]:
    """The least time of one launch: each input and output once, and the plain
    version's operations counted over 4096 of the lanes, scaled to all;
    clear_bwd's on the pairs its skip reaches (:func:`_clear_reach_bound`),
    clear_fwd's and shadow_parts' on the pairs their skips keep."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused, smooth_parts as sp

    plain, kernel = {
        "smooth_nearest_parts": (sp.smooth_nearest_parts_plain, sp.nearest_parts),
        "clear_fwd": (sp.clear_fwd_plain, sp.clear_fwd),
        "clear_bwd": (sp.clear_bwd_plain, sp.clear_bwd),
        "shadow_parts": (intersect_fused.shadow_parts_plain, intersect_fused.shadow_parts),
    }[name]
    n = args[0].shape[0]
    part = min(n, 4096)
    sliced = [a[:part] if isinstance(a, torch.Tensor) and a.shape[0] == n else a for a in args]
    with torch.no_grad():
        ops = count_ops(lambda: plain(*sliced, **kw)) * n / part
        out = kernel(*args, **kw)
    out = out if isinstance(out, tuple) else (out,)
    n_bytes = _nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *out)
    if name == "clear_bwd":
        return _clear_reach_bound(args, kw, ops, n_bytes)
    if name == "clear_fwd":
        return _clear_skip_bound(args, kw, ops, n_bytes)
    if name == "shadow_parts":
        return _skip_bound(name, [_skip_sweep(plain, tuple(args), kw)], ops, n_bytes)
    return _nearest_skip_bound(args, kw, ops, n_bytes)


def phase_parts_timing(card: str, tmp: Path) -> dict[str, dict]:
    """Each new kernel at its shard's shape (shard 0 of config 4, f32):
    shadow_parts on each bounce of the 1920x1080 frame, beside the kernel
    without its skip; rows 18-20 on the first bounce at 960x540
    (smooth_nearest_parts and clear_fwd beside the kernels without their
    skips, and their resident CTAs); each beside its plain version and its
    bound by counted operations (on the pairs a skip keeps)."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused, smooth_parts as sp

    saved = torch.load(tmp / "parts_inputs.pt", weights_only=False)
    kernels = {
        "smooth_nearest_parts": ("nearest", sp.nearest_parts, sp.smooth_nearest_parts_plain, "960x540"),
        "clear_fwd": ("clear", sp.clear_fwd, sp.clear_fwd_plain, "960x540"),
        "clear_bwd": ("clear_bwd", sp.clear_bwd, sp.clear_bwd_plain, "960x540"),
        "shadow_parts": ("shadow_parts", intersect_fused.shadow_parts, intersect_fused.shadow_parts_plain, "1920x1080"),
    }
    res = {}
    with torch.no_grad():
        for name, (key, kernel, plain, size) in kernels.items():
            calls = [(lambda a=a, k=k: kernel(*a, **k), lambda a=a, k=k: plain(*a, **k),
                      lambda a=a, k=k, n=name: _parts_bound(n, a, k),
                      *([lambda a=a, k=k: kernel(*a, **k, skip="off")] if name != "clear_bwd" else []))
                     for a, k in saved[key]]
            res[name] = _time_launches(name, calls, card, f"config 4 sphere shard 0 of 2, {saved[key][0][0][2].shape[0]} "
                                       f"spheres, {size} f32", f"the frame's {len(calls)}" if len(calls) > 1 else "one")
        args = saved["clear_bwd"][0][0]
        print(f"[timing] clear_bwd: {sp.clear_bwd_blocks_per_sm(torch.float32, args[2].shape[0])} resident CTAs of 256 "
              f"an SM, {-(-args[0].shape[0] // 256)} CTAs a launch ({card})", flush=True)
        blocks = {k: sp.clear_fwd_blocks_per_sm(torch.float32, args[2].shape[0], skip=k) for k in (False, True)}
        print(f"[timing] clear_fwd: resident CTAs of 256 an SM without and with the skip {blocks} ({card})", flush=True)
        blocks = {k: sp.nearest_parts_blocks_per_sm(torch.float32, args[2].shape[0], skip=k) for k in (False, True)}
        print(f"[timing] smooth_nearest_parts: resident CTAs of 256 an SM without and with the skip {blocks} ({card})",
              flush=True)
    return res



def _exact_gather(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A gather kernel's output bitwise its plain version's; returns the max |difference| (0)."""
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else got.numel()
        fail(f"{label}: {bad} of {want.numel()} values differ from the plain take")
    return float((got - want).abs().max())


# Indices that [probes] sends through each gather on the card besides the
# probes' own (all in range): JAX's abs(idx) % S wraps int32 at INT_MIN and
# takes a floor remainder; these and a seeded draw over all of int32 go
# through a power-of-two table, one that is not (a partial last piece for
# gather_shuffle; INT_MIN's remainder is not 0) and one narrower than a warp,
# 4106 lanes (a partial warp and block).
WRAP_INDICES = (0, 6, 7, -1, -8, 2**31 - 1, -(2**31))
WRAP_DRAW, WRAP_SPHERES = 4099, (1024, 1000, 7)


def phase_probes(card: str, logs: dict[str, str]) -> tuple[dict[str, float], dict[str, int], dict[str, dict],
                                                            dict[str, float]]:
    """[probes]: TPU rows 21-22 (python_ray_tracer_tpu_torch/benchmarks/).

    Checks first: each gather bitwise its plain version at the five stage-1
    shapes with seeded indices, and on WRAP_INDICES and a seeded draw over
    all of int32 (out of range, negative, INT_MIN); ``vpu_ceiling`` within
    VPU_TOL of its plain version at VPU_CHECK_ITERS on all 262,144 lanes.
    Then the main path, each probe's entry point at its defaults (the
    ceiling at 4096 iterations with its SASS counts; the gathers' stage 1 on
    JAX's indices and stage 2, 2,097,152 rays x 1024 spheres x 12 channels,
    each bitwise the take there), with exact launch counts; then the kernels
    line's figures and the ceiling in count_ops' units, for [ceiling].
    gather_shuffle's launch layout reads ptxas's report in ``logs``
    (phase_build's).  Returns (errors, launches, timings, ceiling)."""
    from python_ray_tracer_tpu_torch.benchmarks import gather_probe as gp
    from python_ray_tracer_tpu_torch.benchmarks import vpu_ceiling as vc

    errs = dict.fromkeys(GATHERS, 0.0)
    for name, *_ in gp.STAGE1:
        x, i, axis = gp.stage1_case(name, DEVICE, seed=0)
        want = gp.stage1_take(gp.gather_plain, x, i, axis)
        for k, gather in gp.GATHERS.items():
            errs[k] = max(errs[k], _exact_gather(f"{k} on stage 1's {name} (seeded indices)",
                                                 gp.stage1_take(gather, x, i, axis), want))
    table, idx = gp.stage2_inputs(gp.RAYS, device=DEVICE)
    draw = np.random.default_rng(2).integers(-(2**31), 2**31, WRAP_DRAW, dtype=np.int32)
    wrap_idx = torch.from_numpy(np.concatenate([np.array(WRAP_INDICES, np.int32), draw])).to(DEVICE)
    for s in WRAP_SPHERES:
        wrap_table = table[:, :s].contiguous()
        want = gp.gather_plain(wrap_table, wrap_idx)
        for k, gather in gp.GATHERS.items():
            errs[k] = max(errs[k], _exact_gather(f"{k} on wrapped indices, {s} spheres", gather(wrap_table, wrap_idx),
                                                 want))
    torch.cuda.synchronize()
    print(f"[probes] {', '.join(GATHERS)}: bitwise the plain take at the {len(gp.STAGE1)} stage-1 shapes (seeded "
          f"indices) and on {wrap_idx.numel()} indices over all of int32 ({WRAP_INDICES} and a seeded draw) at "
          f"{' and '.join(map(str, WRAP_SPHERES))} spheres", flush=True)
    x, y = vc.inputs(vc.TILES, DEVICE)
    errs["vpu_ceiling"] = 0.0
    for iters in VPU_CHECK_ITERS:
        got, plain = vc.vpu_ceiling(x, y, iters), vc.vpu_ceiling_plain(x, y, iters)
        err = float((got - plain).abs().max())
        print(f"[probes] vpu_ceiling vs plain at {iters} iterations, {x.numel()} lanes: max |diff| {err:.3e} "
              f"({float((got != plain).float().mean()):.2e} of lanes differ; limit {VPU_TOL})", flush=True)
        if not (torch.isfinite(got).all() and err <= VPU_TOL):
            fail(f"vpu_ceiling at {iters} iterations: max |diff| {err} past {VPU_TOL} (or not finite)")
        errs["vpu_ceiling"] = max(errs["vpu_ceiling"], err)

    _reset_launches()
    rec = vc.main([])
    stage2 = gp.main([])
    counts = _launches()
    launches = {k: counts[k] for k in PROBES}
    _expect_launched("the vpu_ceiling probe's entry point", launches, ("vpu_ceiling",), exactly=1 + vc.TIMED_REPS)
    _expect_launched("the gather probe's entry point", launches, GATHERS,
                     exactly=len(gp.STAGE1) + 2 + gp.TIMED_LAUNCHES * gp.TIMED_REPS)

    # The ceiling in count_ops' units: the operations the output needs per
    # lane-iteration (an even and an odd iteration, each computing only the
    # arm of its i % 2 select that it takes), over the kernel's time at
    # 4096 iterations.
    lanes, iters, ms = x.numel(), rec["iters"], rec["elapsed_ms"]
    with torch.no_grad():
        ops2, ops4 = (count_ops(lambda n=n: vc.vpu_ceiling_plain(x, y, n, both_arms=False)) for n in (2, 4))
    per_lane_iter = (ops4 - ops2) / 2 / lanes
    ceiling = {"tops": rec["ceiling_tops"], "counted_per_lane_iter": per_lane_iter,
               "counted_ops_per_s": lanes * iters * per_lane_iter / (ms * 1e-3)}
    bound_ms, bound_by = _bound(int(ops2 + (iters - 2) / 2 * (ops4 - ops2)), _nbytes(x, y, x))
    plain_ms = time_ms(lambda: vc.vpu_ceiling_plain(x, y, VPU_PLAIN_ITERS), warmup=1, iters=3)
    timings = {"vpu_ceiling": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)}
    print(f"[probes] vpu_ceiling: {ms:.4f} ms at {iters} iterations x {lanes} lanes, {rec['ceiling_tops']:.4f} T ops/s "
          f"in JAX's units ({vc.ops_per_lane_iter():g} a lane-iteration), {ceiling['counted_ops_per_s'] / 1e12:.4f} T "
          f"ops/s as count_ops counts the work the output needs ({per_lane_iter:g} a lane-iteration); bound "
          f"{bound_ms:.4f} ms by {bound_by} at {PEAK_F32_OPS_PER_S / 1e12:g} TFLOP/s, kernel at {bound_ms / ms:.1%} of "
          f"it; plain version {plain_ms:.2f} ms at {VPU_PLAIN_ITERS} iterations ({card})", flush=True)
    from python_ray_tracer_tpu_torch.benchmarks.splits import ptxas_kernels

    ctas, per_sm = gp.shuffle_launch(gp.RAYS)
    rec = next((r for k, r in ptxas_kernels(logs["gather_probe.cu"]).items() if "gather_shuffle" in k), {})
    print(f"[timing] gather_shuffle layout: {ctas} CTAs of 256 threads at {gp.RAYS} rays, {per_sm} CTAs/SM, "
          f"{rec.get('registers', 'n/a')} registers, {rec.get('spill_stores', 'n/a')}/{rec.get('spill_loads', 'n/a')} B "
          f"spilled ({card})", flush=True)
    # The gathers' bound is the probe's own, bytes (their abs and mod, two
    # operations an index, would take ~0.2% of it at 67 TFLOP/s).
    for k in GATHERS:
        plain_ms = time_ms(lambda: gp.gather_plain(table, idx))
        timings[k] = dict(ms=stage2[k]["ms"], plain_ms=plain_ms, bound_ms=stage2[k]["bound_ms"], bound_by="bytes",
                          library_ms=stage2["library_take"]["ms"])
        print(f"[probes] {k}: {timings[k]['ms']:.4f} ms, library take (index_select) {timings[k]['library_ms']:.4f} ms, "
              f"plain version {plain_ms:.4f} ms, bound {timings[k]['bound_ms']:.4f} ms by bytes (kernel at "
              f"{timings[k]['bound_ms'] / timings[k]['ms']:.1%} of it; {gp.RAYS} rays x {gp.SPHERES} spheres x "
              f"{gp.CHANS} channels, best of {gp.TIMED_REPS} x {gp.TIMED_LAUNCHES} launches; {card})", flush=True)
    return errs, launches, timings, ceiling


def phase_ceiling(card: str, timings: dict[str, dict], ceiling: dict[str, float]) -> None:
    """[ceiling]: each operations-bound kernel's bound at the measured ceiling
    (its counted operations over the ceiling in count_ops' units) beside its
    bound at the published 67 TFLOP/s, and train_deep's op rate (reference
    960x540 f32, depth 3: the kernel whose op mix the census took) as a
    share of the ceiling."""
    rate = ceiling["counted_ops_per_s"]
    print(f"[ceiling] the op-mix ceiling: {rate / 1e12:.4f} T counted ops/s ({ceiling['tops']:.4f} T in JAX's units), "
          f"{rate / PEAK_F32_OPS_PER_S:.1%} of the published {PEAK_F32_OPS_PER_S / 1e12:g} TFLOP/s ({card})", flush=True)
    for name, t in timings.items():
        if t["bound_by"] != "operations" or name in PROBES:
            continue
        ops = t["bound_ms"] * 1e-3 * PEAK_F32_OPS_PER_S
        at = ops / rate * 1e3
        print(f"[ceiling] {name}: bound {t['bound_ms']:.4f} ms at {PEAK_F32_OPS_PER_S / 1e12:g} TFLOP/s, {at:.4f} ms at "
              f"the ceiling; kernel {t['ms']:.4f} ms, at {at / t['ms']:.1%} of the ceiling's bound", flush=True)
    train = timings["train_deep"]
    op_rate = train["bound_ms"] * 1e-3 * PEAK_F32_OPS_PER_S / (train["ms"] * 1e-3)
    print(f"[ceiling] train_deep (reference {WIDTH}x{HEIGHT} f32, depth 3): {op_rate / 1e12:.4f} T counted ops/s, "
          f"{op_rate / rate:.1%} of the ceiling ({card})", flush=True)


def _drill_launch(tmp: Path, run: int, target: Path, ckpt: Path, metrics: Path) -> list[subprocess.Popen]:
    """The two ranks of one drill job, a fresh coordinator each job; their
    output goes to ``drill_<run>_rank<i>.log``."""
    from python_ray_tracer_tpu_torch.parallel.distributed import free_port

    coord = f"127.0.0.1:{free_port()}"
    argv = [sys.executable, "-m", "python_ray_tracer_tpu_torch.cli", "optimize", "--builtin", "random1024",
            "--width", str(WIDTH), "--height", str(HEIGHT), "--depth", str(CS_DEPTH), "--visibility", "smooth",
            "--device", DEVICE, "--target", str(target), "--steps", str(DRILL_STEPS), "--sync-every", "1",
            "--lr", "1e-3", "--checkpoint", str(ckpt), "--checkpoint-every", "1", "--metrics", str(metrics),
            "--distributed", "--coordinator", coord, "--num-processes", "2"]
    procs = []
    for i in range(2):
        with open(tmp / f"drill_{run}_rank{i}.log", "w") as log:
            procs.append(subprocess.Popen([*argv, "--process-id", str(i)], cwd=REPO, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def _drill_records(path: Path, event: str) -> list[dict]:
    """The whole lines of ``event`` records in rank 0's metrics so far."""
    if not path.exists():
        return []
    lines = path.read_text().split("\n")[:-1]  # the last may still be being written
    return [r for r in map(json.loads, lines) if r["event"] == event]


def _drill_fail(tmp: Path, run: int, msg: str) -> None:
    for i in range(2):
        log = tmp / f"drill_{run}_rank{i}.log"
        print(f"[drill] rank {i}, job {run}, last lines:\n" + "\n".join(log.read_text().splitlines()[-15:]), flush=True)
    fail(msg)


def phase_drill(tmp: Path) -> None:
    """[drill]: kill a worker mid-optimize, then resume the job.

    Two ranks of ``cli optimize --distributed`` on the one card over gloo
    (DRILL_STEPS steps, a checkpoint every step, rank 0 writing it between
    barriers).  Once rank 0's metrics show step DRILL_KILL_AT, rank 1's
    process is SIGKILLed; rank 0 is given DRILL_RANK0_S to end, then killed,
    as a scheduler would.  A new job (a new coordinator) must print
    ``resumed from ... at step k`` with DRILL_KILL_AT <= k < DRILL_STEPS, the
    checkpoint's step, end at step DRILL_STEPS with a finite loss, and launch
    exactly DRILL_STEPS - k of each of the depth-fused pair a rank (each rank
    half the rays: the pair, not train_deep)."""
    target = tmp / "drill_target.png"
    _cli_render(tmp, target.name, "--builtin", "random1024", "--depth", str(CS_DEPTH), "--device", DEVICE)
    ckpt = tmp / "drill.ckpt.npz"
    procs: list[subprocess.Popen] = []
    try:
        t0 = time.perf_counter()
        metrics = tmp / "drill_1.jsonl"
        procs = _drill_launch(tmp, 1, target, ckpt, metrics)
        deadline = time.monotonic() + DRILL_WAIT_S
        while not any(r["step"] >= DRILL_KILL_AT for r in _drill_records(metrics, "step")):
            if any(p.poll() is not None for p in procs):
                _drill_fail(tmp, 1, f"a rank ended before step {DRILL_KILL_AT} (codes {[p.poll() for p in procs]})")
            if time.monotonic() > deadline:
                _drill_fail(tmp, 1, f"rank 0 logged no step {DRILL_KILL_AT} within {DRILL_WAIT_S} s")
            time.sleep(0.01)
        procs[1].send_signal(signal.SIGKILL)
        if procs[1].wait(timeout=30) != -signal.SIGKILL:
            _drill_fail(tmp, 1, f"rank 1 ended with {procs[1].returncode} before the kill reached it")
        seen = max(r["step"] for r in _drill_records(metrics, "step"))
        try:
            procs[0].wait(timeout=DRILL_RANK0_S)
            fate = f"ended by itself with code {procs[0].returncode}"
        except subprocess.TimeoutExpired:
            procs[0].kill()
            procs[0].wait(timeout=30)
            fate = f"killed after {DRILL_RANK0_S} s"
        print(f"[drill] job 1: rank 1 SIGKILLed once rank 0 had logged step {seen}, {time.perf_counter() - t0:.1f} s in; "
              f"rank 0 {fate}", flush=True)
        if _drill_records(metrics, "optimize") or not ckpt.exists():
            _drill_fail(tmp, 1, "the killed job finished, or left no checkpoint")
        with np.load(ckpt) as saved:
            k = int(saved["step"])
        if not DRILL_KILL_AT <= k < DRILL_STEPS:
            _drill_fail(tmp, 1, f"the checkpoint holds step {k}, outside {DRILL_KILL_AT}..{DRILL_STEPS - 1}")

        t0 = time.perf_counter()
        metrics = tmp / "drill_2.jsonl"
        procs = _drill_launch(tmp, 2, target, ckpt, metrics)
        for p in procs:
            p.wait(timeout=DRILL_WAIT_S)
        if any(p.returncode != 0 for p in procs):
            _drill_fail(tmp, 2, f"the resumed job's ranks ended with codes {[p.returncode for p in procs]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    resumed = re.findall(r"resumed from \S+ at step (\d+)", (tmp / "drill_2_rank0.log").read_text())
    if [int(r) for r in resumed] != [k]:
        _drill_fail(tmp, 2, f"rank 0 printed {resumed!r}, not one 'resumed from ... at step {k}'")
    steps = [r["step"] for r in _drill_records(metrics, "step")]
    final = _drill_records(metrics, "optimize")
    if steps != list(range(k, DRILL_STEPS)) or len(final) != 1 or final[0]["steps"] != DRILL_STEPS \
            or not np.isfinite(final[0]["final_loss"]):
        _drill_fail(tmp, 2, f"the resumed job logged steps {steps} and {final}")
    _rank_launches("the resumed drill job", final[0], ("smooth_fwd_deep", "smooth_bwd_deep"), DRILL_STEPS - k,
                   CS + PARTS + ("train_deep",))
    print(f"[drill] job 2: resumed from step {k}, ran steps {steps[0]}-{steps[-1]}, final loss "
          f"{final[0]['final_loss']:.6e} at step {final[0]['steps']}, {time.perf_counter() - t0:.1f} s with its start-up",
          flush=True)


def _timed(phase, *args):
    """Run one phase and print the seconds it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[phase] {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    card = _timed(phase_device)
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    logs = _timed(phase_build)
    errs, launches, timings = {}, {}, {}
    errs.update(_timed(phase_kernels))
    errs.update(_timed(phase_smooth_kernels))
    _timed(phase_xi)
    big_errs, big_inputs = _timed(phase_big_kernels)
    errs.update(big_errs)
    cs_errs, cs_record = _timed(phase_cs_kernels)
    errs.update(cs_errs)
    lane_errs, blocked_timings = _timed(phase_blocked_kernels, card)
    errs.update({LANE[k]: v for k, v in lane_errs.items()})
    atlas_errs, atlas_inputs = _timed(phase_atlas_kernels)
    errs.update({ATLAS[k]: v for k, v in atlas_errs.items()})
    lane_errs, lane_inputs = _timed(phase_lane_kernels)
    errs.update(lane_errs)
    _timed(phase_lane_geometry, card, lane_inputs)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(_timed(phase_main_path, Path(tmp)))
        launches.update(_timed(phase_smooth_main, Path(tmp)))
        launches.update(_timed(phase_step_main))
        _timed(phase_sampled_main, Path(tmp))
        _timed(phase_stochastic_train, Path(tmp))
        launches.update(_timed(phase_big_main, Path(tmp)))
        launches.update(_timed(phase_cs_main, Path(tmp)))
        c5_launches = _timed(phase_c5_main, Path(tmp))
        launches.update(_timed(phase_tex_main, Path(tmp)))
        launches.update(_timed(phase_lane_main, Path(tmp)))
        errs.update(_timed(phase_parts, Path(tmp)))
        timings.update(_timed(phase_parts_timing, card, Path(tmp)))
        launches.update(_timed(phase_sharded_main, Path(tmp)))
        _timed(phase_multi_card, Path(tmp))
        _timed(phase_drill, Path(tmp))
    launches.update({k: v for k, v in c5_launches.items() if k in LANE.values()})
    _timed(phase_cs_golden)
    timings.update(_timed(phase_timing, card))
    timings.update(_timed(phase_big_timing, card, big_inputs))
    timings.update(_timed(phase_cs_timing, card, cs_record, logs))
    _timed(phase_c5_timing, card)
    timings.update(_timed(phase_atlas_timing, card, atlas_inputs))
    timings.update(_timed(phase_lane_timing, card, lane_inputs))
    lane_timing = next(t for label, t in blocked_timings.items() if label.startswith(f"random_spheres({LANE_SPHERES})"))
    timings.update({LANE[k]: lane_timing[k] for k in STEP})
    probe_errs, probe_launches, probe_timings, ceiling = _timed(phase_probes, card, logs)
    errs.update(probe_errs)
    launches.update(probe_launches)
    timings.update(probe_timings)
    phase_ceiling(card, {**timings, **{f"{k} at {label}": t for label, res in blocked_timings.items()
                                       if not label.startswith(f"random_spheres({LANE_SPHERES})") for k, t in res.items()}},
                  ceiling)
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
        + PARTS + ("shadow_parts",) + PROBES
    ]
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
