"""Time the warp-bundle sphere skip off and on, in turns, on one CUDA card.

``bounce_lane`` (kernel-table row 5) and ``shadow_sweep`` (row 4, both
modes) skip the cheap-tier spheres that no ray of a warp can hit
(``csrc/sweep_math.cuh``).  Their wrappers take ``skip="off"`` to launch
the same source with the skip compiled out, so this A/B needs no build
variant: it records the main path's inputs once, checks every launch with
the skip bitwise equal to the launch without, and times the two in turns
(off, on, on, off; each turn the mean over the record's launches of the
median of 10 CUDA-event timings):

* ``bounce_lane`` on the 1032-sphere frame's 4 launches (config 4's
  spheres with 8 more in the exact tier, 1920x1080 f32) and on lane80's 4
  (80 spheres, atlas; ``testdata/lane80.json``);
* ``shadow_sweep`` on config 4's 4 glossy launches (1920x1080 f32,
  ``--stochastic-roughness --seed 7``);
* ``shadow_parts`` on sphere shard 0's 4 launches of config 4's mirror
  frame: spheres 0-511, the last in the shard's exact tier as the sharded
  route takes it, on the shadow rays of the single-process frame traced
  through the sweeps (each lane's own sphere a local index, out of range
  where shard 1 holds it);
* both kernels on the small tables the launch rule is for:
  ``random_spheres_scene(n)`` for each n of ``SMALL`` (its ground the one
  exact sphere), ``bounce_lane`` through ``trace_fused_lane`` (mirror) and
  ``shadow_sweep`` through ``render.trace`` (glossy, seed 7), 4 bounces.

Beside the times it prints each launch's share of (warp, sphere) pairs
the skip reaches (:func:`..ops.intersect_fused.bundle_reach`), ptxas's
registers and spill bytes of every instantiation of the two kernels (the
build's ``-Xptxas -v`` log, read when this process builds the libraries),
and each instantiation's resident blocks per SM::

    python -m python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab [--device cpu --width 64 --height 36]

On ``--device cpu`` it runs the plain versions at the size given (a check
of the script, no times).
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
SEED, DEPTH, SHARD = 7, 4, 512
TURNS = ("off", "on", "on", "off")
# Table sizes below the main path's, for the launch rule (kSkipMinCheap).
SMALL = (4, 8, 16, 17, 48)


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


def record(device, width: int, height: int) -> dict[str, list]:
    """Each case's launches: ``(args, kwargs)`` of its wrapper."""
    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.io import load_scene, load_settings
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
    glossy = RenderConfig(max_depth=DEPTH, dtype=torch.float32, use_pallas=True, stochastic_roughness=True,
                          rng_seed=SEED)
    mirror = RenderConfig(max_depth=DEPTH, dtype=torch.float32, use_pallas=True, ray_chunk=width * height)
    for name, cfg in (("shadow_sweep config 4 glossy", glossy), ("shadow_parts config 4 shard 0", mirror)):
        calls = cases.setdefault(name, [])
        real = _capture(render_mod, "shadow_sweep", calls)
        try:
            with torch.no_grad():
                render(config4, cfg)
        finally:
            render_mod.shadow_sweep = real
    parts = cases["shadow_parts config 4 shard 0"]
    for j, (args, kw) in enumerate(parts):
        o, d, geom, idx = args
        parts[j] = ((o, d, geom[:SHARD].contiguous(), idx), {**kw, "s_cheap": SHARD - 1})
    from python_ray_tracer_tpu_torch.camera import ray_directions, ray_directions_t
    from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root

    key = fold_seed(fold_seed(seed_root(SEED), 0), 4)  # render()'s sample 0 at SEED
    for n in SMALL:
        scene = random_spheres_scene(n, width, height, dtype=torch.float32, device=device)
        calls = cases.setdefault(f"bounce_lane {n} spheres", [])
        real = _capture(bounce_lane, "bounce_lane", calls)
        try:
            with torch.no_grad():
                bounce_lane.trace_fused_lane(scene.camera.position, ray_directions_t(scene.camera, torch.float32),
                                             scene, dataclasses.replace(mirror, ray_chunk=0))
        finally:
            bounce_lane.bounce_lane = real
        calls = cases.setdefault(f"shadow_sweep {n} spheres glossy", [])
        real = _capture(render_mod, "shadow_sweep", calls)
        try:
            with torch.no_grad():
                render_mod.trace(scene.camera.position, ray_directions(scene.camera, torch.float32), scene, glossy,
                                 key=key)
        finally:
            render_mod.shadow_sweep = real
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cases


def _kernel(name: str):
    from python_ray_tracer_tpu_torch.ops import bounce_lane, intersect_fused

    if name.startswith("bounce_lane"):
        return bounce_lane.bounce_lane
    return intersect_fused.shadow_parts if name.startswith("shadow_parts") else intersect_fused.shadow_sweep


def _reach_shares(name: str, args, kw) -> list[float]:
    """The share of (warp, sphere) pairs each sweep of the launch reaches."""
    from python_ray_tracer_tpu_torch.ops import bounce_lane, intersect_fused

    if not name.startswith("bounce_lane"):
        o, d, geom = args[:3]
        return [float(intersect_fused.bundle_reach(o, d, geom, kw["s_cheap"], kw.get("light")).float().mean())]
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
    """ptxas's figures of each bounce_lane and shadow_sweep instantiation,
    keyed by its template arguments."""
    out = {}
    for mangled, figures in ptxas_kernels(log).items():
        m = re.search(r"(bounce_lane|shadow_sweep)I([fd])((?:Lb[01]E)+)", mangled)
        if m:
            flags = ", ".join("true" if b == "1" else "false" for b in re.findall(r"Lb([01])E", m.group(3)))
            out[f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, {flags}>"] = figures
    return out


def _layout(logs: dict[str, str], label: str) -> None:
    from python_ray_tracer_tpu_torch.ops import bounce_lane, intersect_fused

    for source in ("bounce_lane.cu", "intersect_fused.cu"):
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
            print(f"[sweep_skip_ab] shadow_sweep {dtype} {s} spheres, resident blocks of 256 an SM: {blocks} ({label})",
                  flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m python_ray_tracer_tpu_torch.benchmarks.sweep_skip_ab")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    label = card_label(device)
    print(label, flush=True)
    logs = {}
    if device.type == "cuda":
        from python_ray_tracer_tpu_torch.ops import _build

        logs = {source: log for source, (_, log, _) in _build.build_all(("bounce_lane.cu", "intersect_fused.cu")).items()}
    cases = record(device, args.width, args.height)
    for name, calls in cases.items():
        kernel = _kernel(name)
        shares = [_reach_shares(name, a, k) for a, k in calls]
        with torch.no_grad():
            for b, (a, k) in enumerate(calls):
                if not _same(kernel(*a, **k, skip="on"), kernel(*a, **k, skip="off")):
                    raise SystemExit(f"{name} launch {b}: the skip's output differs from the kernel without it")
        print(f"[sweep_skip_ab] {name}: {len(calls)} launches, skip on bitwise skip off; reached share of (warp, "
              f"sphere) pairs a launch: {[[round(x, 4) for x in s] for s in shares]}", flush=True)
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
