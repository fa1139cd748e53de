"""Time the sweeps' sphere skips off and on, in turns, on one CUDA card.

``bounce_lane`` (kernel-table row 5), ``shadow_sweep`` (row 4, both modes)
and ``nearest_sweep`` (row 3) skip the cheap-tier spheres that no ray of a
warp can hit (``csrc/sweep_math.cuh``); ``fwd_cs`` (row 16, both modes)
skips the shadow pairs whose factor is exactly 1: the spheres no shadow
line of a warp comes near enough to shade (``csrc/bundle_math.cuh``
``line_reaches``), and per lane the pairs whose ``sig(sharp_s disc)`` is
exactly 0; ``clear_fwd`` (row 19) skips those pairs of its shadow product
the same way, and ``smooth_fwd_step`` (rows 6 and 8) those of its shadow
product and, in its winner sweep, the cheap-tier spheres no half-line of
the warp can hit whose disc cannot exceed any lane's running dmax
(``csrc/smooth_math.cuh`` ``SkipAll``).  Their wrappers take ``skip="off"``
to launch the same source with the skip compiled out, so this A/B needs no
build variant: it records the main path's inputs once, checks every launch
with the skip bitwise equal to the launch without, and times the two in
turns (off, on, on, off; each turn the mean over the record's launches of
the median of 10 CUDA-event timings):

* ``bounce_lane`` on the 1032-sphere frame's 4 launches (config 4's
  spheres with 8 more in the exact tier, 1920x1080 f32) and on lane80's 4
  (80 spheres, atlas; ``testdata/lane80.json``);
* ``nearest_sweep`` and ``shadow_sweep`` on config 4's 4 glossy launches
  each (1920x1080 f32, ``--stochastic-roughness --seed 7``);
* ``nearest_sweep`` and ``shadow_parts`` on sphere shard 0's 4 launches of
  config 4's mirror frame: spheres 0-511, the last in the shard's exact
  tier as the sharded route takes it, on the rays of the single-process
  frame traced through the sweeps (each shadow lane's own sphere a local
  index, out of range where shard 1 holds it);
* ``fwd_cs`` on the config-4 smooth frame's 3 bounces (1920x1080, depth 3,
  mirror) and on the ``textured1024`` frame's 3 at 960x540 (atlas mode);
* in f64, at a quarter of the size (480x270): ``nearest_sweep`` on the
  glossy frame's 4 launches and ``fwd_cs`` on the config-4 frame's 3;
* the sweeps on the small tables the launch rule is for:
  ``random_spheres_scene(n)`` for each n of ``SMALL`` (its ground the one
  exact sphere), ``bounce_lane`` through ``trace_fused_lane`` (mirror) and
  ``nearest_sweep``/``shadow_sweep`` through ``render.trace`` (glossy,
  seed 7), 4 bounces;
* ``smooth_fwd_step`` on the one-bounce pair's launches (``route="step"``)
  at 256x144 (scaled with ``--width``/``--height``): the 8192-sphere L2
  step's 3 (f32, and the same inputs upcast to f64), ``inverse_task(1024)``
  (staged geometry) mirror at depth 3 and glossy at depth 2, the 3-sphere
  ``reference_scene`` at 960x540 depth 1, ``textured_spheres_scene(1024)``
  (32x32 textures, atlas mode) at depth 1, and ``random_spheres_scene(n)``
  at depth 1 for each n of ``SMALL``;
* ``clear_fwd`` on sphere shard 0's 3 launches of config 4's smooth step
  at 960x540 (half the width and height; two ranks on the card over gloo,
  the loss against a flat target; f32, and upcast to f64), and on the same
  rays against the shard's first n spheres for each n of ``SMALL``;
  ``smooth_nearest_parts`` on the same run's 3 shard launches the same way;
* ``train_deep`` on its one launch of an L2 loss through the fused route:
  config 5 (``inverse_task(1024)`` at 256x144, scaled with the frame,
  depth 3) mirror and glossy, native f64 at half that size, the 3-sphere
  ``reference_scene`` at half the frame mirror and glossy, and
  ``random_spheres_scene(n)`` for each n of ``SMALL``;
* ``near_cs`` on the config-4 smooth frame's 3 bounces (1920x1080, depth 3,
  mirror), on the ``textured1024`` frame's 3 at 960x540 and in f64 on the
  config-4 frame's 3 at 480x270; ``shade_culled`` on the config-4 mirror
  frame's 4 (1920x1080, depth 4, the culled hard route), on the
  ``textured1024`` frame's 4 (atlas mode) and in f64 on the config-4
  frame's 4 at 480x270.

Beside the times it prints each launch's share of (warp, sphere) pairs
the skip reaches (:func:`..ops.intersect_fused.bundle_reach`; for
``smooth_nearest_parts`` the winner rules', for ``train_deep`` each
bounce's winner sweep, shadow product and Phase C (:func:`train_counts`),
for ``smooth_fwd_step`` the winner sweep's and the shadow product's,
:func:`..ops.bounce_smooth_sub.winner_reach` and ``shadow_reach``); for
``nearest_sweep`` also the share of those a distance cut could drop (a
sphere whose nearest possible hit from the warp's ball of origins lies
past the largest ``t`` the warp's lanes end with), and for ``fwd_cs`` the
listed (ray, sphere) pairs whose shadow sigmoid is exactly 0, those whose
warp has that on every lane, and those the warp bound keeps
(:func:`..ops.culled_smooth.fwd_cs_reach`); for ``near_cs`` and
``shade_culled`` the listed (warp, list slot) pairs and those the skip
keeps (:func:`list_counts`).  Then ptxas's registers and
spill bytes of every instantiation of the four kernels (the build's
``-Xptxas -v`` log, read when this process builds the libraries), and
each instantiation's resident blocks per SM::

    python -m python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab [--device cpu --width 64 --height 36]
        [--rows K] [--split] [--frames] [--kernels a,b,...]

On ``--device cpu`` it runs the plain versions at the size given (a check
of the script, no times).  ``--rows K`` prints only the counts of the
nearest and shadow sweeps' cases, on K whole image rows (every
``height / K``-th) of the frame at the size given: each row traced alone
with its own ray offset (the xi the whole frame draws there), so that a
warp is 32 neighbouring pixels as in the frame.  ``--split`` runs
:mod:`.fwd_cs_split` after the A/B (``fwd_cs`` with its shadow loop
stubbed out, beside the source as it is).  ``--frames`` times only the
frames and steps ``nearest_sweep``, ``fwd_cs``, ``smooth_fwd_step``,
``near_cs`` and ``shade_culled`` sit in, with their skips off and on in
turns (:func:`frames`; the card only).  ``--kernels`` keeps the cases of
those kernels only (default: all ten).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import re
import statistics
from pathlib import Path

import torch

from . import card_label, resolve_device
from .splits import median_ms, ptxas_kernels

PACKAGE = Path(__file__).resolve().parent.parent
LANE80 = PACKAGE / "testdata" / "lane80.json"
LANE80_SETTINGS = PACKAGE / "testdata" / "lane80_settings.json"
SEED, DEPTH, SHARD, CS_DEPTH = 7, 4, 512, 3
TURNS = ("off", "on", "on", "off")
# Table sizes below the main path's, for the launch rule (kSkipMinCheap).
SMALL = (4, 8, 16, 17, 25, 32, 48)
KERNELS = ("bounce_lane", "nearest_sweep", "shadow_sweep", "fwd_cs", "smooth_fwd_step", "clear_fwd", "train_deep",
           "smooth_nearest_parts", "near_cs", "shade_culled")
# smooth_fwd_step's frame at 1920x1080 (scaled with the frame) and its big table.
STEP_SIZE, STEP_SPHERES = (256, 144), 8192


def _glossy():
    """Config 4's glossy frame: the sweeps' main path (seed SEED)."""
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=DEPTH, dtype=torch.float32, use_pallas=True, stochastic_roughness=True,
                        rng_seed=SEED)


def _mirror(width: int, height: int):
    """Config 4's mirror frame through the sweeps (a ray chunk keeps it off
    the culled pair), the rays each sphere shard sweeps."""
    from python_ray_tracer_tpu_torch import RenderConfig

    return RenderConfig(max_depth=DEPTH, dtype=torch.float32, use_pallas=True, ray_chunk=width * height)


def _key():
    """render()'s sample 0 at SEED."""
    from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root

    return fold_seed(fold_seed(seed_root(SEED), 0), 4)


def _shard(cases: dict) -> None:
    """Shard 0's tables in place of the whole one: spheres 0..SHARD-1, the
    last in the exact tier (the sharded route's s_cheap)."""
    for name, calls in cases.items():
        if "shard 0" in name:
            for j, (args, kw) in enumerate(calls):
                calls[j] = ((*args[:2], args[2][:SHARD].contiguous(), *args[3:]), {**kw, "s_cheap": SHARD - 1})


def _capture(module, name: str, calls: list):
    """Wrap ``module.name`` so each call's arguments land in ``calls``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    return real


def _lane_big_scene(device, width: int, height: int):
    """Config 4's spheres with 8 more r = 99999 spheres in the exact tier (a
    far back wall and seven under the ground), as chip_smoke.py builds it."""
    from python_ray_tracer_tpu_torch import build_lights, build_spheres, make_scene, make_sphere_row
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    base = random_spheres_scene(1024, width, height, dtype=torch.float64)
    sp = base.spheres
    fields = ("reflection_gain", "specular_gain", "specular_roughness", "iridescence_gain", "diffuse_gain",
              "specular_ior", "thin_film_weight", "thin_film_thickness", "thin_film_ior")
    rows = [make_sphere_row(sp.center[k].tolist(), float(sp.radius[k]), diffuse_color=sp.diffuse_color[k].tolist(),
                            texture_kind=int(sp.texture_kind[k]), texture_id=int(sp.texture_id[k]),
                            **{f: float(getattr(sp, f)[k]) for f in fields}) for k in range(sp.count)]
    walls = [((0.0, 0.0, 100060.0), (0.7, 0.8, 0.9))]
    walls += [((0.0, -100000.5 - 10.0 * i, 0.0), (1.0, 1.0, 1.0)) for i in range(7)]
    rows += [make_sphere_row(c, 99999.0, diffuse_gain=0.8, diffuse_color=col, specular_gain=0.2) for c, col in walls]
    lights = base.lights
    lights = build_lights(lights.point_position.tolist(), domes=list(zip(lights.dome_intensity.tolist(),
                          lights.dome_color.tolist())), dtype=torch.float32, device=device)
    return make_scene(build_spheres(rows, dtype=torch.float32, device=device), lights, base.camera.position.tolist(),
                      width, height, dtype=torch.float32, device=device)


def record(device, width: int, height: int, kernels=KERNELS) -> dict[str, list]:
    """Each case's launches: ``(args, kwargs)`` of its wrapper (the cases of
    ``kernels`` only)."""
    cases: dict[str, list] = {}
    if {"bounce_lane", "nearest_sweep", "shadow_sweep", "fwd_cs"} & set(kernels):
        cases.update(_record_sweeps(device, width, height))
    if "smooth_fwd_step" in kernels:
        cases.update(_record_step(device, width, height))
    if {"clear_fwd", "smooth_nearest_parts"} & set(kernels):
        shard = _shard_calls(device, width, height)
        cases.update(_record_clear(shard, width, height))
        cases.update(_record_nearest_parts(shard, width, height))
    if "train_deep" in kernels:
        cases.update(_record_train(device, width, height))
    if {"near_cs", "shade_culled"} & set(kernels):
        cases.update(_record_lists(device, width, height))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {name: calls for name, calls in cases.items() if name.split()[0] in kernels}


def _record_sweeps(device, width: int, height: int) -> dict[str, list]:
    """The cases of the four kernels of PRs 13-14."""
    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.io import load_scene, load_settings
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene
    from python_ray_tracer_tpu_torch.ops import bounce_lane

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    cases: dict[str, list] = {}
    lane_cfg = dataclasses.replace(load_settings(LANE80_SETTINGS)[0], dtype=torch.float32)
    for name, scene in (("bounce_lane 1032 spheres", _lane_big_scene(device, width, height)),
                        ("bounce_lane lane80 (atlas)", load_scene(LANE80, width=width, height=height,
                                                                   dtype=torch.float32, device=device))):
        calls = cases.setdefault(name, [])
        real = _capture(bounce_lane, "bounce_lane", calls)
        try:
            with torch.no_grad():
                render(scene, lane_cfg)
        finally:
            bounce_lane.bounce_lane = real
    config4 = random_spheres_scene(1024, width, height, dtype=torch.float32, device=device)
    for tag, cfg in (("config 4 glossy", _glossy()), ("config 4 shard 0", _mirror(width, height))):
        near = cases.setdefault(f"nearest_sweep {tag}", [])
        shadow = cases.setdefault(f"{'shadow_sweep' if 'glossy' in tag else 'shadow_parts'} {tag}", [])
        real = _capture(render_mod, "nearest_sweep", near), _capture(render_mod, "shadow_sweep", shadow)
        try:
            with torch.no_grad():
                render(config4, cfg)
        finally:
            render_mod.nearest_sweep, render_mod.shadow_sweep = real
    config4 = random_spheres_scene(1024, width // 4, height // 4, dtype=torch.float64, device=device)
    near = cases.setdefault("nearest_sweep config 4 glossy f64 (a quarter of the size)", [])
    real = _capture(render_mod, "nearest_sweep", near)
    try:
        with torch.no_grad():
            render(config4, dataclasses.replace(_glossy(), dtype=torch.float64))
    finally:
        render_mod.nearest_sweep = real
    _shard(cases)
    from python_ray_tracer_tpu_torch.camera import ray_directions, ray_directions_t
    from python_ray_tracer_tpu_torch.ops import culled_smooth

    for name, kind, size, dtype in (
            ("fwd_cs config 4 step", "random_spheres", (width, height), torch.float32),
            ("fwd_cs textured1024 step (atlas)", "textured_spheres", (width // 2, height // 2), torch.float32),
            ("fwd_cs config 4 step f64 (a quarter of the size)", "random_spheres", (width // 4, height // 4),
             torch.float64)):
        scene = getattr(scenes, f"{kind}_scene")(1024, *size, dtype=dtype, device=device)
        cfg = RenderConfig(max_depth=CS_DEPTH, dtype=dtype, visibility="smooth", use_pallas=True)
        calls = cases.setdefault(name, [])
        real = _capture(culled_smooth, "fwd_cs", calls)
        try:
            with torch.no_grad():
                culled_smooth.trace_culled_smooth(scene.camera.position, ray_directions_t(scene.camera, dtype), scene,
                                                  cfg)
        finally:
            culled_smooth.fwd_cs = real
    for n in SMALL:
        scene = random_spheres_scene(n, width, height, dtype=torch.float32, device=device)
        calls = cases.setdefault(f"bounce_lane {n} spheres", [])
        real = _capture(bounce_lane, "bounce_lane", calls)
        try:
            with torch.no_grad():
                bounce_lane.trace_fused_lane(scene.camera.position, ray_directions_t(scene.camera, torch.float32),
                                             scene, dataclasses.replace(_mirror(width, height), ray_chunk=0))
        finally:
            bounce_lane.bounce_lane = real
        near = cases.setdefault(f"nearest_sweep {n} spheres glossy", [])
        shadow = cases.setdefault(f"shadow_sweep {n} spheres glossy", [])
        real = _capture(render_mod, "nearest_sweep", near), _capture(render_mod, "shadow_sweep", shadow)
        try:
            with torch.no_grad():
                render_mod.trace(scene.camera.position, ray_directions(scene.camera, torch.float32), scene, _glossy(),
                                 key=_key())
        finally:
            render_mod.nearest_sweep, render_mod.shadow_sweep = real
    return cases


def _record_lists(device, width: int, height: int) -> dict[str, list]:
    """near_cs's and shade_culled's cases (see the module's docstring)."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops import culled, culled_smooth

    cases: dict[str, list] = {}
    f32, f64 = torch.float32, torch.float64
    for tag, kind, size, dtype in (("config 4", "random_spheres", (width, height), f32),
                                   ("textured1024", "textured_spheres", (width // 2, height // 2), f32),
                                   ("config 4 f64 (a quarter of the size)", "random_spheres",
                                    (width // 4, height // 4), f64)):
        scene = getattr(scenes, f"{kind}_scene")(1024, *size, dtype=dtype, device=device)
        dirs = ray_directions_t(scene.camera, dtype)
        smooth = RenderConfig(max_depth=CS_DEPTH, dtype=dtype, visibility="smooth", use_pallas=True)
        calls = cases.setdefault(f"near_cs {tag} step", [])
        real = _capture(culled_smooth, "near_cs", calls)
        try:
            with torch.no_grad():
                culled_smooth.trace_culled_smooth(scene.camera.position, dirs, scene, smooth)
        finally:
            culled_smooth.near_cs = real
        if kind == "textured_spheres":  # the atlas frame at the full size, as the CLI renders it
            scene = scenes.textured_spheres_scene(1024, width, height, dtype=dtype, device=device)
            dirs = ray_directions_t(scene.camera, dtype)
        calls = cases.setdefault(f"shade_culled {tag} mirror frame{' (atlas)' if kind == 'textured_spheres' else ''}",
                                 [])
        real = _capture(culled, "shade_culled", calls)
        try:
            with torch.no_grad():
                culled.trace_fused_culled(scene.camera.position, dirs, scene,
                                          RenderConfig(max_depth=DEPTH, dtype=dtype, use_pallas=True))
        finally:
            culled.shade_culled = real
    return cases


def _step_record(scene, cfg, key=None) -> list:
    """smooth_fwd_step's launches through the one-bounce pair's route."""
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    calls: list = []
    real = _capture(bss, "smooth_fwd_step", calls)
    try:
        with torch.no_grad():
            bss.trace_fused_smooth_sub(scene.camera.position, ray_directions_t(scene.camera, cfg.dtype), scene, cfg,
                                       route="step", key=key)
    finally:
        bss.smooth_fwd_step = real
    return calls


def _upcast(calls: list) -> list:
    """The launches on the same inputs in float64."""
    return [(tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args), kw)
            for args, kw in calls]


def _record_step(device, width: int, height: int) -> dict[str, list]:
    """smooth_fwd_step's cases (see the module's docstring)."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.models import scenes

    sw, sh = max(8, STEP_SIZE[0] * width // 1920), max(4, STEP_SIZE[1] * height // 1080)

    def cfg(depth: int, **kw):
        return RenderConfig(max_depth=depth, dtype=torch.float32, visibility="smooth", use_pallas=True, **kw)

    f32 = torch.float32
    cases = {f"smooth_fwd_step {STEP_SPHERES}-sphere step": _step_record(
        scenes.random_spheres_scene(STEP_SPHERES, sw, sh, dtype=f32, device=device), cfg(3))}
    cases[f"smooth_fwd_step {STEP_SPHERES}-sphere step f64 (upcast)"] = _upcast(cases[
        f"smooth_fwd_step {STEP_SPHERES}-sphere step"])
    inverse = scenes.inverse_task_scene(1024, sw, sh, dtype=f32, device=device)
    cases["smooth_fwd_step inverse_task(1024) mirror (staged)"] = _step_record(inverse, cfg(3))
    cases["smooth_fwd_step inverse_task(1024) glossy (staged)"] = _step_record(
        inverse, cfg(2, stochastic_roughness=True, rng_seed=SEED), _key())
    cases["smooth_fwd_step reference(3) depth 1"] = _step_record(
        scenes.reference_scene(width // 2, height // 2, dtype=f32, device=device), cfg(1))
    cases["smooth_fwd_step textured1024 depth 1 (atlas)"] = _step_record(
        scenes.textured_spheres_scene(1024, sw, sh, tex_side=32, dtype=f32, device=device), cfg(1))
    for n in SMALL:
        cases[f"smooth_fwd_step {n} spheres depth 1"] = _step_record(
            scenes.random_spheres_scene(n, sw, sh, dtype=f32, device=device), cfg(1))
    return cases


def clear_rank(path: str, size: tuple[int, int], device_type: str) -> None:
    """One of two ranks (spawned by run_local): the forward of config 4's
    smooth loss at ``size`` (depth 3, a flat target) on sphere shard (1, 2);
    rank 0 saves its clear_fwd and nearest_parts calls to ``path``, a list
    each under their names."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene
    from python_ray_tracer_tpu_torch.ops import smooth_parts
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.parallel import make_mesh
    from python_ray_tracer_tpu_torch.parallel.distributed import rank_device

    mesh = make_mesh(1, 2)
    device = rank_device(device_type)
    scene = random_spheres_scene(1024, *size, dtype=torch.float32, device=device)
    target = torch.full((size[1], size[0], 3), 0.5, device=device)
    cfg = RenderConfig(max_depth=CS_DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
    calls: dict[str, list] = {"clear_fwd": [], "nearest_parts": []}
    real = {name: _capture(smooth_parts, name, got) for name, got in calls.items()}
    try:
        with torch.no_grad():
            make_loss_fn(scene, target, cfg, mesh)(scene_to_params(scene))
    finally:
        for name, fn in real.items():
            setattr(smooth_parts, name, fn)
    if mesh.spheres.index == 0:
        torch.save({name: [([a.detach().cpu() if torch.is_tensor(a) else a for a in args],
                            {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}) for args, kw in got]
                    for name, got in calls.items()}, path)


def _shard_calls(device, width: int, height: int) -> dict[str, list]:
    """Sphere shard 0's clear_fwd and nearest_parts calls of config 4's
    smooth step at half the width and height, recorded from two ranks
    (:func:`clear_rank`), on ``device``."""
    import tempfile

    from python_ray_tracer_tpu_torch.parallel.distributed import run_local

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "shard_calls.pt")
        run_local(clear_rank, 2, path, (width // 2, height // 2), device.type, device_type=device.type)
        saved = torch.load(path, weights_only=False)
    return {name: [([a.to(device) if torch.is_tensor(a) else a for a in args],
                    {k: v.to(device) if torch.is_tensor(v) else v for k, v in kw.items() if k != "skip"})
                   for args, kw in calls] for name, calls in saved.items()}


def _record_nearest_parts(shard: dict, width: int, height: int) -> dict[str, list]:
    """smooth_nearest_parts' cases: shard 0's launches of config 4's smooth
    step (:func:`_shard_calls`), f32 and upcast to f64, and on the same rays
    against the shard's first n spheres for each n of ``SMALL``."""
    calls = shard["nearest_parts"]
    size = f"{width // 2}x{height // 2}"
    cases = {f"smooth_nearest_parts config 4 shard 0 {size}": calls,
             f"smooth_nearest_parts config 4 shard 0 {size} f64 (upcast)": _upcast(calls)}
    for n in SMALL:
        cases[f"smooth_nearest_parts shard 0's first {n} spheres {size}"] = [
            ((*args[:2], args[2][:n].contiguous(), *args[3:]), {**kw, "s_cheap": n - 1}) for args, kw in calls]
    return cases


def _record_train(device, width: int, height: int) -> dict[str, list]:
    """train_deep's cases: its one launch of an L2 loss through the fused
    route (:func:`.train_deep_split._calls`) on config 5 (inverse_task(1024),
    256x144 scaled with the frame, depth 3) mirror and glossy, in native f64
    at half that size, on the 3-sphere reference at half the frame, mirror
    and glossy, and on ``random_spheres_scene(n)`` for each n of SMALL."""
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.models import scenes

    from .train_deep_split import _calls

    sw, sh = max(8, STEP_SIZE[0] * width // 1920), max(4, STEP_SIZE[1] * height // 1080)

    def cfg(dtype=torch.float32, **kw):
        return RenderConfig(max_depth=3, dtype=dtype, visibility="smooth", use_pallas=True, **kw)

    f32, f64 = torch.float32, torch.float64
    glossy = dict(stochastic_roughness=True, rng_seed=SEED)
    c5 = scenes.inverse_task_scene(1024, sw, sh, dtype=f32, device=device)
    ref = scenes.reference_scene(width // 2, height // 2, dtype=f32, device=device)
    cases = {
        "train_deep config 5": _calls(c5, cfg()),
        "train_deep config 5 glossy": _calls(c5, cfg(**glossy), _key()),
        "train_deep config 5 f64 (native, half size)": _calls(
            scenes.inverse_task_scene(1024, max(8, sw // 2), max(4, sh // 2), dtype=f64, device=device), cfg(f64)),
        "train_deep reference(3)": _calls(ref, cfg()),
        "train_deep reference(3) glossy": _calls(ref, cfg(**glossy), _key()),
    }
    for n in SMALL:
        cases[f"train_deep {n} spheres"] = _calls(scenes.random_spheres_scene(n, sw, sh, dtype=f32, device=device),
                                                  cfg())
    return cases


def _record_clear(shard: dict, width: int, height: int) -> dict[str, list]:
    """clear_fwd's cases (see the module's docstring)."""
    calls = shard["clear_fwd"]
    size = f"{width // 2}x{height // 2}"
    cases = {f"clear_fwd config 4 shard 0 {size}": calls,
             f"clear_fwd config 4 shard 0 {size} f64 (upcast)": _upcast(calls)}
    for n in SMALL:
        cases[f"clear_fwd shard 0's first {n} spheres {size}"] = [
            ((*args[:2], args[2][:n].contiguous(), *args[3:]), {**kw, "s_cheap": n - 1}) for args, kw in calls]
    return cases


def record_rows(device, width: int, height: int, rows: int) -> dict[str, list]:
    """The nearest and shadow sweeps' cases of :func:`record` on ``rows``
    whole image rows of the config-4 frames: each row traced alone through
    ``render.trace`` with its ray offset, its launches joined row after row
    (a warp is 32 neighbouring pixels, as in the frame)."""
    from python_ray_tracer_tpu_torch.camera import ray_directions
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    scene = random_spheres_scene(1024, width, height, dtype=torch.float32, device=device)
    dirs = ray_directions(scene.camera, torch.float32)
    cases: dict[str, list] = {}
    for tag, cfg, key in (("config 4 glossy", _glossy(), _key()), ("config 4 shard 0", _mirror(width, height), None)):
        per_row = []
        for y in range(0, height, max(1, height // rows)):
            near, shadow = [], []
            real = _capture(render_mod, "nearest_sweep", near), _capture(render_mod, "shadow_sweep", shadow)
            try:
                with torch.no_grad():
                    render_mod.trace(scene.camera.position, dirs[y * width:(y + 1) * width], scene, cfg, key=key,
                                     ray_offset=y * width)
            finally:
                render_mod.nearest_sweep, render_mod.shadow_sweep = real
            per_row.append((near, shadow))
        shadow = f"{'shadow_sweep' if 'glossy' in tag else 'shadow_parts'} {tag}"
        for name, j in ((f"nearest_sweep {tag}", 0), (shadow, 1)):
            cases[name] = [_join([row[j][b] for row in per_row]) for b in range(DEPTH)]
    _shard(cases)
    return cases


def _join(calls: list) -> tuple:
    """One launch's ``(args, kwargs)`` from the same launch of each row: the
    per-ray arguments concatenated, the rest the first row's."""
    args0, kw0 = calls[0]
    n0 = args0[0].shape[0]
    args = tuple(torch.cat([c[0][j] for c in calls]) if torch.is_tensor(a) and a.shape[0] == n0 and j != 2 else a
                 for j, a in enumerate(args0))
    return args, kw0


def _kernel(name: str):
    from python_ray_tracer_tpu_torch.ops import bounce_lane, bounce_smooth_sub, culled_smooth, intersect_fused, smooth_parts

    if name.startswith("smooth_fwd_step"):
        return bounce_smooth_sub.smooth_fwd_step
    if name.startswith("train_deep"):
        return bounce_smooth_sub.train_deep
    if name.startswith("smooth_nearest_parts"):
        return lambda *a, **k: tuple(smooth_parts.nearest_parts(*a, **k))
    if name.startswith("clear_fwd"):
        return smooth_parts.clear_fwd
    if name.startswith("bounce_lane"):
        return bounce_lane.bounce_lane
    if name.startswith("fwd_cs"):
        return culled_smooth.fwd_cs
    if name.startswith("near_cs"):
        return culled_smooth.near_cs
    if name.startswith("shade_culled"):
        from python_ray_tracer_tpu_torch.ops import culled

        return culled.shade_culled
    if name.startswith("nearest_sweep"):
        return lambda *a, **k: tuple(intersect_fused.nearest_sweep(*a, **k))
    return intersect_fused.shadow_parts if name.startswith("shadow_parts") else intersect_fused.shadow_sweep


def nearest_counts(o, d, geom, s_cheap: int, faraway: float) -> dict:
    """Shares of a nearest sweep's cheap-tier (warp, sphere) pairs: those
    the skip reaches (``bundle_reach`` with no apex), and those of the
    reached a distance cut would also drop: a sphere whose nearest possible
    hit from any origin in the warp's ball (|g - c| - r_ball - r) lies past
    the largest t the warp's lanes end with (a bound of what the cut could
    save, the final t being no larger than the running one); and the warps
    with a lane that hits nothing (no cut there)."""
    from python_ray_tracer_tpu_torch.ops import intersect_fused as f

    b = f.warp_bundles(o, d)
    cheap = geom[:s_cheap]
    reach = f.bundle_test(b, cheap) | ~b.ok[:, None]
    t = f.nearest_sweep_plain(o, d, geom, faraway=faraway, s_cheap=s_cheap)[0]
    pad = (-t.shape[0]) % f.WARP
    t_max = torch.cat([t, t.new_full((pad,), faraway)]).reshape(-1, f.WARP).amax(1)
    dist = torch.linalg.vector_norm(cheap[None, :, :3] - b.c[:, None, :], dim=2)
    cut = reach & b.ok[:, None] & (dist - b.r[:, None] - cheap[None, :, 3] > t_max[:, None])
    n_reach = max(int(reach.sum()), 1)
    return dict(reached=float(reach.float().mean()), cut=int(cut.sum()) / n_reach, cut_all=float(cut.float().mean()),
                miss_warps=float((t_max == faraway).float().mean()))


def list_counts(name: str, args, kw) -> dict:
    """Counts of one near_cs or shade_culled launch's (warp, list slot)
    pairs over each tile's cheap-tier list (its candidates and full-tier
    fallback): those listed and those the skip keeps
    (:func:`..ops.culled_smooth.near_cs_reach`,
    :func:`..ops.culled.shade_culled_reach`), those the kernel tests against
    its warp bound, and the warps, and of those the warps that build the
    bound.  A warp tests and bounds only where its lanes all run, in one
    tile; near_cs's warp neither tests its list's first chunk of 32 (its
    candidates', or where it has none its fallback's) nor builds a bound
    where the list holds no more."""
    from python_ray_tracer_tpu_torch.ops import culled, culled_smooth as cs

    with torch.no_grad():
        if name.startswith("near_cs"):
            o, d, _, _, cand, cnt, cnt_full, geom = args[:8]
            reach = cs.near_cs_reach(o.T.contiguous(), d.T.contiguous(), cand, cnt, cnt_full, geom,
                                     s_cheap=kw["s_cheap"], faraway=kw["faraway"], tile_rays=kw["tile_rays"])
        else:
            p_n, to_light, cand, cnt, cnt_full, geom, consts = args[7], args[9], args[11], args[12], args[13], \
                args[14], args[15]
            reach = culled.shade_culled_reach(p_n.T.contiguous(), to_light.T.contiguous(), consts[0, 3:6], geom,
                                              kw["s_cheap"], kw["tile_rays"])
        c, s_cheap, tile = cand.shape[1], kw["s_cheap"], kw["tile_rays"]
        cc, cf = torch.clamp(cnt.long(), 0, c), torch.clamp(cnt_full.long(), 0, s_cheap)
        tile_of = torch.arange(reach.shape[0], device=reach.device) * 32 // tile
        listed = int((cc + cf)[tile_of].sum())
        n = args[7 if name.startswith("shade_culled") else 0].shape[1]
        w = torch.arange(reach.shape[0], device=reach.device)
        full = ((w + 1) * 32 <= n) & (tile % 32 == 0)
        first = torch.where(cc > 0, torch.clamp(cc, max=32), torch.clamp(cf, max=32))
        tests = (cc + cf - (first if name.startswith("near_cs") else 0))[tile_of] * full
        bundled = int((full & (tests > 0) if name.startswith("near_cs") else full).sum())
        if name.startswith("near_cs"):
            kept = int(reach.sum())
        else:
            ids, slots = cs._list_slots(cand, cc, cf, c)
            kept = 0
            for w0 in range(0, reach.shape[0], 4096):
                t = tile_of[w0:w0 + 4096]
                got = reach[w0:w0 + 4096].gather(1, ids[t].long().clamp(0, geom.shape[0] - 1))
                kept += int((got & slots[t]).sum())
    return dict(listed=listed, kept=kept, tested=int(tests.sum()), warps=reach.shape[0], bundled=bundled)


def list_counts_text(c: dict) -> str:
    """:func:`list_counts`' figures of one launch as the scripts print them."""
    return (f"the skip keeps {c['kept']} of {c['listed']} listed cheap-tier (warp, slot) pairs "
            f"({c['kept'] / max(c['listed'], 1):.2%}) over {c['warps']} warps")


def cs_counts(args, kw) -> dict:
    """Counts of one fwd_cs launch's listed cheap-tier (ray, sphere) pairs
    (each tile's candidates and full-tier fallback): those whose shadow
    sigmoid sig(sharp_s disc) is exactly 0, those whose warp has that on all
    32 lanes, and those the warp bound keeps
    (:func:`..ops.culled_smooth.fwd_cs_reach`); at warp level, the listed
    (warp, sphere) pairs, those the bound keeps and those with a lane whose
    sigmoid is not 0 (each of which the bound must keep: counted as
    ``missed`` if not)."""
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, sig
    from python_ray_tracer_tpu_torch.ops.bounce_smooth_sub import _xi_pair, fwd_sub_math

    o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat, consts = args[:13]
    xi = args[13] if len(args) > 13 else None
    tile, s_cheap, sharp_s = kw["tile_rays"], kw["s_cheap"], kw["sharp_s"]
    with torch.no_grad():
        f = fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, _xi_pair(xi, 0), faraway=kw["faraway"],
                         s_cheap=s_cheap, sharp_e=kw["sharp_e"], sharp_s=sharp_s,
                         saved=(idx, hit != 0, torch.ones_like(thr)), tex_hw=kw.get("tex_hw"))
        p_n, to_light = torch.stack(f.p_n, 1), torch.stack(f.L, 1)
        reach = cs.fwd_cs_reach(p_n, to_light, consts[0, 3:6], geom, s_cheap, sharp_s, tile)
        n = o.shape[1]
        warps = torch.arange(n // 32, device=o.device)
        tile_of = warps * 32 // tile
        cc = torch.clamp(cnt.long()[tile_of], 0, cand.shape[1])
        cf = torch.clamp(cnt_full.long()[tile_of], 0, s_cheap)
        out = dict.fromkeys(("listed", "zero", "warp_zero", "kept", "w_listed", "w_kept", "w_live", "missed"), 0)
        slots = [(j, cc, lambda w, j=j: cand[tile_of[w], j].long()) for j in range(int(cc.max()))]
        slots += [(k, cf, lambda w, k=k: torch.full_like(w, k)) for k in range(int(cf.max()))]
        for j, count, sid_of in slots:
            w = warps[j < count]
            sid = sid_of(w)
            lanes = (w[:, None] * 32 + torch.arange(32, device=o.device)).reshape(-1)
            g = geom[sid.repeat_interleave(32)]
            b, ct = b_cterm_plain(tuple(x[lanes] for x in f.p_n), tuple(x[lanes] for x in f.L),
                                  (g[:, 0], g[:, 1], g[:, 2]), g[:, 3])
            zero = (sig(sharp_s * (b * b - 4.0 * ct)) == 0).reshape(-1, 32)
            kept = reach[w, sid]
            live = ~zero.all(1)
            out["listed"] += zero.numel()
            out["zero"] += int(zero.sum())
            out["warp_zero"] += 32 * int((~live).sum())
            out["kept"] += 32 * int(kept.sum())
            out["w_listed"] += w.numel()
            out["w_kept"] += int(kept.sum())
            out["w_live"] += int(live.sum())
            out["missed"] += int((live & ~kept).sum())
    return out


def cs_counts_text(c: dict) -> str:
    """:func:`cs_counts`' figures of one launch as the scripts print them."""
    listed, w_listed = max(c["listed"], 1), max(c["w_listed"], 1)
    return (f"{c['listed']} listed cheap-tier pairs, sig(sharp_s disc) exactly 0 on {c['zero'] / listed:.2%}, on "
            f"all 32 lanes of the warp {c['warp_zero'] / listed:.2%}; the warp bound keeps {c['w_kept']} of "
            f"{c['w_listed']} (warp, sphere) pairs ({c['w_kept'] / w_listed:.2%}), {c['w_live']} with a lane that "
            f"shades ({c['w_live'] / w_listed:.2%}), {c['missed']} of those dropped")


def step_counts(args, kw) -> dict:
    """Counts of one smooth_fwd_step launch's cheap-tier pairs: the shares
    of (warp, sphere) pairs its winner sweep and its shadow product visit
    with the skip (:func:`..ops.bounce_smooth_sub.winner_reach`,
    ``shadow_reach``), the lane-sphere shadow pairs whose sigmoid is not
    exactly 0 and those the shadow bound keeps."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    o, d, thr, alive, acc, geom, mat, consts = args[:8]
    xi = args[8] if len(args) > 8 else None
    s_cheap, sharp_s = kw["s_cheap"], kw["sharp_s"]
    with torch.no_grad():
        outs = bss.smooth_fwd_step(*args, **kw, skip="off")
        winner = bss.winner_reach(o.T.contiguous(), d.T.contiguous(), geom, s_cheap, kw["faraway"])
        f = bss.fwd_sub_math(tuple(o), tuple(d), thr, alive, geom, mat, consts, bss._xi_pair(xi, 0),
                             faraway=kw["faraway"], s_cheap=s_cheap, sharp_e=kw["sharp_e"], sharp_s=sharp_s,
                             saved=(outs[5], outs[6] != 0, outs[7]), tex_hw=kw.get("tex_hw"))
        shadow = bss.shadow_reach(torch.stack(f.p_n, 1), torch.stack(f.L, 1), consts[0, 3:6], geom, s_cheap, sharp_s)
        live = _live_pairs(torch.stack(f.p_n, 1), torch.stack(f.L, 1), geom[:s_cheap], sharp_s)
    n = d.shape[1]
    return dict(winner=float(winner[:, :s_cheap].float().mean()), shadow=float(shadow[:, :s_cheap].float().mean()),
                live=live / max(n * s_cheap, 1), pairs=n * s_cheap, warps=winner.shape[0], s_cheap=s_cheap,
                winner_kept=int(winner[:, :s_cheap].sum()), shadow_kept=int(shadow[:, :s_cheap].sum()))


def _live_pairs(p_n, to_light, geom, sharp_s: float, chunk: int = 4096) -> int:
    """Lane-sphere pairs of shadow rays ``p_n``/``to_light`` (N, 3) over the
    cheap spheres ``geom`` whose shadow sigmoid is not exactly 0."""
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, sig

    live = 0
    c, r = tuple(geom[None, :, i] for i in range(3)), geom[None, :, 3]
    for a in range(0, p_n.shape[0], chunk):
        b, ct = b_cterm_plain(tuple(p_n[a:a + chunk, i, None] for i in range(3)),
                              tuple(to_light[a:a + chunk, i, None] for i in range(3)), c, r)
        live += int((sig(sharp_s * (b * b - 4.0 * ct)) != 0).sum())
    return live


def step_counts_text(c: dict) -> str:
    """:func:`step_counts`' figures of one launch as the scripts print them."""
    return (f"the winner sweep visits {c['winner']:.2%} and the shadow product {c['shadow']:.2%} of the "
            f"{c['warps'] * c['s_cheap']} cheap-tier (warp, sphere) pairs; sig(sharp_s disc) is not exactly 0 on "
            f"{c['live']:.4%} of the {c['pairs']} lane-sphere pairs")


def train_counts(args, kw) -> list[dict]:
    """Counts of one train_deep launch's pairs, bounce by bounce (the chain
    from ``smooth_fwd_deep``, whose residuals replay each bounce's shadow
    rays): the shares of cheap-tier (warp, sphere) pairs the kernel's
    winner sweep and shadow product visit with the skips
    (:func:`..ops.bounce_smooth_sub.winner_reach`, ``shadow_reach``), the
    lane-sphere shadow pairs whose sigmoid is not exactly 0, and the share
    of (warp, sphere) pairs, both tiers, Phase C takes (some lane reached:
    the sphere not its winner and its shadow sigmoid not exactly 0)."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops.bounce_smooth import b_cterm_plain, compensated_b_cterm, sig

    o, d, _, geom, mat, consts, xi = args[:7]
    s_cheap, sharp_s, faraway, depth = kw["s_cheap"], kw["sharp_s"], kw["faraway"], kw["depth"]
    n, s = d.shape[1], geom.shape[0]
    with torch.no_grad():
        _, osave, dsave, thrsave, alivesave, idx, hit, clear = bss.smooth_fwd_deep(o, d, geom, mat, consts, xi, **kw)
        ones = torch.ones_like(d[0])
        out = []
        for dep in range(depth):
            ro, rd = (o, d) if dep == 0 else (osave[3 * dep - 3:3 * dep], dsave[3 * dep - 3:3 * dep])
            thr, alive = (ones, ones) if dep == 0 else (thrsave[dep - 1], alivesave[dep - 1])
            f = bss.fwd_sub_math(tuple(ro), tuple(rd), thr, alive, geom, mat, consts, bss._xi_pair(xi, dep),
                                 faraway=faraway, s_cheap=s_cheap, sharp_e=kw["sharp_e"], sharp_s=sharp_s,
                                 saved=(idx[dep], hit[dep] != 0, clear[dep]))
            winner = bss.winner_reach(ro.T.contiguous(), rd.T.contiguous(), geom, s_cheap, faraway)
            p_n, to_light = torch.stack(f.p_n, 1), torch.stack(f.L, 1)
            shadow = bss.shadow_reach(p_n, to_light, consts[0, 3:6], geom, s_cheap, sharp_s)
            lanes = torch.zeros((-(-n // 32) * 32, s), dtype=torch.bool, device=d.device)
            c, r = tuple(geom[None, :, i] for i in range(3)), geom[None, :, 3]
            for a in range(0, n, 4096):
                rows = slice(a, min(n, a + 4096))
                po, pl = tuple(p_n[rows, i, None] for i in range(3)), tuple(to_light[rows, i, None] for i in range(3))
                b_p, ct_p = b_cterm_plain(po, pl, c, r)
                b_e, ct_e = compensated_b_cterm(po, pl, c, r)
                cheap = torch.arange(s, device=d.device)[None, :] < s_cheap
                disc = torch.where(cheap, b_p * b_p - 4.0 * ct_p, b_e * b_e - 4.0 * ct_e)
                own = idx[dep][rows, None].long() == torch.arange(s, device=d.device)[None, :]
                lanes[rows] = ~own & (sig(sharp_s * disc) != 0)
            phase_c = lanes.reshape(-1, 32, s).any(1)
            live = _live_pairs(p_n, to_light, geom[:s_cheap], sharp_s)
            out.append(dict(winner=float(winner[:, :s_cheap].float().mean()) if s_cheap else 0.0,
                            shadow=float(shadow[:, :s_cheap].float().mean()) if s_cheap else 0.0,
                            phase_c=float(phase_c.float().mean()), live=live, warps=winner.shape[0], n=n, s=s,
                            s_cheap=s_cheap, winner_kept=int(winner[:, :s_cheap].sum()),
                            shadow_kept=int(shadow[:, :s_cheap].sum()), phase_c_kept=int(phase_c.sum()),
                            phase_c_cheap_kept=int(phase_c[:, :s_cheap].sum()), f=f))
    return out


def train_counts_text(c: dict) -> str:
    """:func:`train_counts`' figures of one bounce as the scripts print them."""
    return (f"the winner sweep visits {c['winner']:.2%} and the shadow product {c['shadow']:.2%} of the "
            f"{c['warps'] * c['s_cheap']} cheap-tier (warp, sphere) pairs, Phase C takes {c['phase_c']:.2%} of the "
            f"{c['warps'] * c['s']}; sig(sharp_s disc) is not exactly 0 on "
            f"{c['live'] / max(c['n'] * c['s_cheap'], 1):.4%} of the cheap-tier lane-sphere pairs")


def _counts_line(name: str, calls: list) -> list:
    """The counts of each launch of a case, printed; returns the reached
    shares the A/B line shows."""
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub, intersect_fused

    shares = []
    for b, (args, kw) in enumerate(calls):
        if name.startswith("smooth_fwd_step"):
            c = step_counts(args, kw)
            shares.append([round(c["winner"], 4), round(c["shadow"], 4)])
            print(f"[sweep_skip_ab] {name} bounce {b}: {step_counts_text(c)}", flush=True)
        elif name.startswith("train_deep"):
            cs = train_counts(args, kw)
            shares.append([[round(c["winner"], 4), round(c["shadow"], 4), round(c["phase_c"], 4)] for c in cs])
            for dep, c in enumerate(cs):
                print(f"[sweep_skip_ab] {name} launch {b} bounce {dep}: {train_counts_text(c)}", flush=True)
        elif name.startswith("smooth_nearest_parts"):
            o, d, geom = args[:3]
            reach = bounce_smooth_sub.winner_reach(o, d, geom, kw["s_cheap"], kw["faraway"])
            shares.append([round(float(reach[:, :kw["s_cheap"]].float().mean()), 4)])
        elif name.startswith("clear_fwd"):
            o, d, geom = args[:3]
            reach = bounce_smooth_sub.shadow_reach(o, d, kw.get("light"), geom, kw["s_cheap"], kw["sharpness"])
            shares.append([round(float(reach[:, :kw["s_cheap"]].float().mean()), 4)])
        elif name.startswith(("near_cs", "shade_culled")):
            c = list_counts(name, args, kw)
            shares.append([round(c["kept"] / max(c["listed"], 1), 4)])
            print(f"[sweep_skip_ab] {name} bounce {b}: {list_counts_text(c)}", flush=True)
        elif name.startswith("fwd_cs"):
            c = cs_counts(args, kw)
            shares.append([round(c["w_kept"] / max(c["w_listed"], 1), 4)])
            print(f"[sweep_skip_ab] {name} bounce {b}: {cs_counts_text(c)}", flush=True)
            if c["missed"]:
                raise SystemExit(f"{name} bounce {b}: the warp bound drops {c['missed']} pairs that shade")
        elif name.startswith("nearest_sweep"):
            o, d, geom = args[:3]
            c = nearest_counts(o, d, geom, kw["s_cheap"], kw["faraway"])
            shares.append([round(c["reached"], 4)])
            print(f"[sweep_skip_ab] {name} bounce {b}: the skip reaches {c['reached']:.2%} of the cheap-tier (warp, "
                  f"sphere) pairs; a distance cut could drop {c['cut']:.2%} of those ({c['cut_all']:.2%} of all); "
                  f"{c['miss_warps']:.2%} of the warps have a lane that hits nothing", flush=True)
        elif name.startswith(("shadow_sweep", "shadow_parts")):
            o, d, geom = args[:3]
            reach = intersect_fused.bundle_reach(o, d, geom, kw["s_cheap"], kw.get("light"))
            shares.append([round(float(reach[:, :kw["s_cheap"]].float().mean()), 4)])
        else:
            shares.append([round(x, 4) for x in _lane_shares(args, kw)])
    return shares


def _lane_shares(args, kw) -> list[float]:
    """The share of (warp, sphere) pairs each of bounce_lane's sweeps reaches."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane, intersect_fused

    shares: list[float] = []
    real = intersect_fused.bundle_reach

    def counted(o, d, geom, s_cheap, apex=None):
        reach = real(o, d, geom, s_cheap, apex)
        shares.append(float(reach.float().mean()))
        return reach

    intersect_fused.bundle_reach = counted
    try:
        plain_kw = {k: v for k, v in kw.items() if k not in ("geometry", "skip")}
        bounce_lane.bounce_lane_plain(*args, **plain_kw, skip=True)
    finally:
        intersect_fused.bundle_reach = real
    return shares


def _same(a, b) -> bool:
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _instantiations(log: str) -> dict[str, dict]:
    """ptxas's figures of each instantiation of the four kernels, keyed by
    its template arguments."""
    out = {}
    for mangled, figures in ptxas_kernels(log).items():
        m = re.search(r"(bounce_lane|shadow_sweep|nearest_sweep|fwd_cs|smooth_fwd_step|clear_fwd|train_deep|"
                      r"smooth_nearest_parts|near_cs|shade_culled)I([fd])((?:Lb[01]E)+)", mangled)
        if m:
            flags = ", ".join("true" if b == "1" else "false" for b in re.findall(r"Lb([01])E", m.group(3)))
            out[f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, {flags}>"] = figures
    return out


def _layout(logs: dict[str, str], label: str) -> None:
    from python_ray_tracer_tpu_torch.ops import (bounce_lane, bounce_smooth_sub, culled, culled_smooth, intersect_fused,
                                                 smooth_parts)

    for source in SOURCES:
        found = _instantiations(logs.get(source, ""))
        if not found:
            print(f"[sweep_skip_ab] {source}: no ptxas log (the library was built before this process)", flush=True)
        for inst, figures in sorted(found.items()):
            print(f"[sweep_skip_ab] {inst}: {json.dumps(figures)} ({label})", flush=True)
    for dtype in (torch.float32, torch.float64):
        for s in (80, 1032):
            blocks = {f"atlas={a} skip={k}": bounce_lane.blocks_per_sm(dtype, s, atlas=a, skip=k)
                      for a in (False, True) for k in (False, True)}
            print(f"[sweep_skip_ab] bounce_lane {dtype} {s} spheres, resident blocks of 128 an SM: {blocks} ({label})",
                  flush=True)
        for s in (SHARD, 1024):
            blocks = {f"parts={p} skip={k}": intersect_fused.shadow_blocks_per_sm(dtype, s, parts=p, skip=k)
                      for p in (False, True) for k in (False, True)}
            blocks.update({f"nearest skip={k}": intersect_fused.nearest_blocks_per_sm(dtype, s, skip=k)
                           for k in (False, True)})
            print(f"[sweep_skip_ab] shadow_sweep/nearest_sweep {dtype} {s} spheres, resident blocks of 256 an SM: "
                  f"{blocks} ({label})", flush=True)
        blocks = {f"glossy={g} atlas={a} skip={k}": culled_smooth.fwd_blocks_per_sm(dtype, g, a, k, 1024)
                  for g in (False, True) for a in (False, True) for k in (False, True)}
        print(f"[sweep_skip_ab] fwd_cs {dtype} 1024 spheres, resident blocks of 256 an SM: {blocks} ({label})",
              flush=True)
        blocks = {f"skip={k}": culled_smooth.near_blocks_per_sm(dtype, k, 1024) for k in (False, True)}
        blocks.update({f"shade_culled atlas={a} skip={k}": culled.shade_blocks_per_sm(dtype, a, k, 1024)
                       for a in (False, True) for k in (False, True)})
        print(f"[sweep_skip_ab] near_cs {dtype} 1024 spheres, resident blocks of 256 an SM: {blocks} ({label})",
              flush=True)
        for s in (3, 1024, STEP_SPHERES):
            blocks = {f"glossy={g} skip={k}": bounce_smooth_sub.blocks_per_sm("smooth_fwd_step", dtype, g, s, skip=k)
                      for g in (False, True) for k in (False, True)}
            print(f"[sweep_skip_ab] smooth_fwd_step {dtype} {s} spheres, resident blocks of 128 an SM: {blocks} "
                  f"({label})", flush=True)
        blocks = {f"skip={k}": smooth_parts.clear_fwd_blocks_per_sm(dtype, SHARD, skip=k) for k in (False, True)}
        print(f"[sweep_skip_ab] clear_fwd {dtype} {SHARD} spheres, resident blocks of 256 an SM: {blocks} ({label})",
              flush=True)
        blocks = {f"skip={k}": smooth_parts.nearest_parts_blocks_per_sm(dtype, SHARD, skip=k) for k in (False, True)}
        print(f"[sweep_skip_ab] smooth_nearest_parts {dtype} {SHARD} spheres, resident blocks of 256 an SM: {blocks} "
              f"({label})", flush=True)
        for s in (3, 1024, 4096):
            blocks = {f"glossy={g} skip={k}": bounce_smooth_sub.blocks_per_sm("train_deep", dtype, g, s, skip=k)
                      for g in (False, True) for k in (False, True)}
            print(f"[sweep_skip_ab] train_deep {dtype} {s} spheres, resident blocks an SM (128 threads): {blocks} "
                  f"({label})", flush=True)


def _host_ms(fn, warmup: int = 1, iters: int = 5) -> float:
    """Median host-clock time of ``fn()`` to a synchronised card, ms."""
    import time

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def frames(device, label: str, width: int = 1920, height: int = 1080, kernels=KERNELS) -> None:
    """The frames and steps the skips' kernels sit in, with the skips of
    ``kernels`` off and on in turns (off, on, on, off; the wrappers'
    ``skip`` forced through the modules that call them): config 4's glossy
    frame (``nearest_sweep``; ``render()``), its smooth frame, its smooth
    loss and gradient (``fwd_cs``: the culled smooth route at 1920x1080,
    depth 3), the textured1024 loss and gradient at 960x540 (``fwd_cs``),
    and the 8192-sphere L2 step's loss and gradient (``smooth_fwd_step``: the
    one-bounce pair at 256x144, depth 3).  A case runs where one of its
    kernels is among ``kernels``."""
    import functools

    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene, textured_spheres_scene
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub, culled_smooth, intersect_fused
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params

    render_mod = importlib.import_module("python_ray_tracer_tpu_torch.render")
    smooth = RenderConfig(max_depth=CS_DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)

    def loss_grad(scene):
        target = torch.full((scene.camera.height, scene.camera.width, 3), 0.5, device=device)
        loss_fn = make_loss_fn(scene, target, smooth)

        def run():
            params = scene_to_params(scene)
            loss_fn(params).backward()
        return run

    size, half = f"{width}x{height}", f"{width // 2}x{height // 2}"
    sw, sh = STEP_SIZE[0] * width // 1920, STEP_SIZE[1] * height // 1080
    cases = []
    if "shade_culled" in kernels:
        mirror = RenderConfig(max_depth=DEPTH, dtype=torch.float32, use_pallas=True)
        config4 = random_spheres_scene(1024, width, height, dtype=torch.float32, device=device)
        textured = textured_spheres_scene(1024, width, height, dtype=torch.float32, device=device)
        cases += [(f"config-4 mirror frame (render(), {size} depth {DEPTH})", lambda: render(config4, mirror)),
                  (f"textured1024 mirror frame (render(), {size} depth {DEPTH})", lambda: render(textured, mirror))]
    if {"nearest_sweep", "fwd_cs", "near_cs"} & set(kernels):
        config4 = random_spheres_scene(1024, width, height, dtype=torch.float32, device=device)
        textured = textured_spheres_scene(1024, width // 2, height // 2, dtype=torch.float32, device=device)
        cases += [
            (f"config-4 glossy frame (render(), {size} depth {DEPTH})", lambda: render(config4, _glossy())),
            (f"config-4 smooth frame (render(), {size} depth {CS_DEPTH})", lambda: render(config4, smooth)),
            (f"config-4 smooth loss and gradient ({size} depth {CS_DEPTH})", loss_grad(config4)),
            (f"textured1024 smooth loss and gradient ({half} depth {CS_DEPTH})", loss_grad(textured)),
        ]
    if "smooth_fwd_step" in kernels:
        big = random_spheres_scene(STEP_SPHERES, sw, sh, dtype=torch.float32, device=device)
        cases.append((f"{STEP_SPHERES}-sphere L2 loss and gradient ({sw}x{sh} depth {CS_DEPTH})", loss_grad(big)))
    # The wrappers whose skip a turn forces: (module the caller reads it from, name, the wrapper).
    from python_ray_tracer_tpu_torch.ops import culled

    forced = [(m, name, getattr(m, name)) for m, name in ((render_mod, "nearest_sweep"), (culled_smooth, "fwd_cs"),
                                                          (bounce_smooth_sub, "smooth_fwd_step"),
                                                          (culled_smooth, "near_cs"), (culled, "shade_culled"))
              if name in kernels]
    for name, fn in cases:
        turns = {"off": [], "on": []}
        for skip in TURNS:
            for module, attr, wrapper in forced:
                setattr(module, attr, functools.partial(wrapper, skip=skip))
            try:
                turns[skip].append(_host_ms(fn))
            finally:
                for module, attr, wrapper in forced:
                    setattr(module, attr, wrapper)
        off, on = statistics.mean(turns["off"]), statistics.mean(turns["on"])
        print(f"[sweep_skip_ab] {name}: skips off {off:.3f} ms ({', '.join(f'{x:.3f}' for x in turns['off'])}), on "
              f"{on:.3f} ms ({', '.join(f'{x:.3f}' for x in turns['on'])}), {off / on:.3f}x; host clock, median of 5 "
              f"a turn ({label})", flush=True)


SOURCES = ("bounce_lane.cu", "intersect_fused.cu", "culled_smooth.cu", "bounce_smooth_sub.cu", "smooth_parts.cu",
           "culled.cu")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--rows", type=int, default=0, help="count the sweeps on this many whole rows only")
    ap.add_argument("--split", action="store_true", help="run fwd_cs_split after the A/B")
    ap.add_argument("--frames", action="store_true",
                    help="only the frames and steps with the skips off and on (card only)")
    ap.add_argument("--kernels", default=",".join(KERNELS), help="the kernels whose cases to run (default: all)")
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: {sorted(set(kernels) - set(KERNELS))} not among {KERNELS}")
    device = resolve_device(args.device)
    label = card_label(device)
    print(label, flush=True)
    if args.frames:
        if device.type != "cuda":
            raise SystemExit("--frames times the card; it has no CPU mode")
        frames(device, label, args.width, args.height, kernels)
        return 0
    if args.rows:
        for name, calls in record_rows(device, args.width, args.height, args.rows).items():
            n = calls[0][0][0].shape[0]
            print(f"[sweep_skip_ab] {name}: {args.rows} rows of {args.width}x{args.height} ({n} rays a launch)",
                  flush=True)
            shares = _counts_line(name, calls)
            print(f"[sweep_skip_ab] {name}: reached share a launch: {shares}", flush=True)
        return 0
    logs = {}
    if device.type == "cuda":
        from python_ray_tracer_tpu_torch.ops import _build

        logs = {source: log for source, (_, log, _) in _build.build_all(SOURCES).items()}
    cases = record(device, args.width, args.height, kernels)
    for name, calls in cases.items():
        kernel = _kernel(name)
        shares = _counts_line(name, calls)
        with torch.no_grad():
            for b, (a, k) in enumerate(calls):
                if not _same(kernel(*a, **k, skip="on"), kernel(*a, **k, skip="off")):
                    raise SystemExit(f"{name} launch {b}: the skip's output differs from the kernel without it")
        print(f"[sweep_skip_ab] {name}: {len(calls)} launches, skip on bitwise skip off; reached share of (warp, "
              f"sphere) pairs a launch: {shares}", flush=True)
        if device.type != "cuda":
            continue
        turns = []
        with torch.no_grad():
            for skip in TURNS:
                ms = [median_ms(lambda a=a, k=k: kernel(*a, **k, skip=skip)) for a, k in calls]
                turns.append((skip, ms))
                print(f"[sweep_skip_ab] {name}: skip {skip}: {statistics.mean(ms):.4f} ms a launch (mean of "
                      f"{len(ms)}: {', '.join(f'{x:.4f}' for x in ms)}; {label})", flush=True)
        off = statistics.mean(statistics.mean(ms) for skip, ms in turns if skip == "off")
        on = statistics.mean(statistics.mean(ms) for skip, ms in turns if skip == "on")
        print(f"[sweep_skip_ab] {name}: off {off:.4f} ms, on {on:.4f} ms, {off / on:.2f}x ({label})", flush=True)
    if device.type == "cuda":
        _layout(logs, label)
        if args.split:
            from . import fwd_cs_split

            return fwd_cs_split.main([])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
