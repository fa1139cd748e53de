"""Command-line interface: ``render``, ``optimize`` and ``bench``.

    python -m python_ray_tracer_tpu_torch.cli render --builtin reference -o out.png
    python -m python_ray_tracer_tpu_torch.cli render --scene scene.json --settings settings.json -o out.png
    python -m python_ray_tracer_tpu_torch.cli render --builtin random1024 --width 1920 --height 1080 --depth 4
    python -m python_ray_tracer_tpu_torch.cli optimize --builtin random1024 --width 1920 --height 1080 --depth 3 \
        --visibility smooth --target target.png --steps 3 --lr 1e-3
    python -m python_ray_tracer_tpu_torch.cli render --depth auto --device cpu -o out.png
    python -m python_ray_tracer_tpu_torch.cli render --spp 4 --stochastic-roughness --seed 7 -o out.png
    python -m python_ray_tracer_tpu_torch.cli optimize --visibility smooth --target ref.png --steps 200
    python -m python_ray_tracer_tpu_torch.cli bench

On a CUDA device the render and the training step go through the
hand-written kernels (as the JAX CLI does with ``--pallas``); on ``--device
cpu`` they take the pure-torch bounce loop, differentiated by torch
autograd.  The default device is ``cuda``, and without a card the command
fails rather than drop to the CPU on its own.

``--scene`` reads a JSON scene file and ``--settings`` a JSON render-settings
file (:mod:`.io.scene_json`, the JAX package's schema).  With a settings
file the frame size, depth, dtype, visibility, samples, seed and
``use_pallas`` come from the file, as in the JAX CLI: ``use_pallas`` is taken
as the file says (JAX's default is false, the pure-torch route on whatever
device was asked for), and the file's ``output_path`` and ``denoise`` apply
when ``-o`` and ``--denoise`` do not override them.  ``--profile DIR`` writes
a ``torch.profiler`` Chrome trace of the timed render into DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


# The built-in scenes (the JAX CLI's names).
BUILTINS = {
    "reference": "reference_scene",
    "all_effects": "all_effects_scene",
    "random1024": "random_spheres_scene",
    "textured1024": "textured_spheres_scene",
    "inverse64": "inverse_task_scene",
}


def _add_render_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", type=str, help="JSON scene file (instead of --builtin)")
    p.add_argument("--builtin", type=str, default="reference", choices=sorted(BUILTINS))
    p.add_argument("--settings", type=str, help="JSON render-settings file (replaces the render flags)")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument(
        "--depth",
        type=str,
        default="3",
        help="max reflection depth, or 'auto' to bound it by the scene's reflection energy decay",
    )
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "float64"])
    p.add_argument("--visibility", type=str, default="hard", choices=["hard", "smooth"])
    p.add_argument("--spp", type=int, default=1, help="samples per pixel (jittered supersampling)")
    p.add_argument("--stochastic-roughness", action="store_true", help="sample glossy GGX reflections")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for sampling")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--metrics", type=str, help="JSONL metrics output path")


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available (pass --device cpu to run on the CPU)")
    return device


def _build(args, device: torch.device):
    """``(scene, cfg, extras)`` from the flags, or from the ``--scene`` and
    ``--settings`` files; ``extras`` holds a settings file's output path and
    denoise flag (empty without one)."""
    from .config import RenderConfig
    from .models import scenes as builtin
    from .render import auto_max_depth

    depth_auto = str(args.depth) == "auto"
    extras = {}
    if args.settings:
        from .io import load_settings

        cfg, extras = load_settings(args.settings)
        width, height = extras["width"], extras["height"]
    else:
        cfg = RenderConfig(
            max_depth=1 if depth_auto else int(args.depth),
            dtype={"float32": torch.float32, "float64": torch.float64}[args.dtype],
            visibility=args.visibility,
            use_pallas=device.type == "cuda",
            samples_per_pixel=args.spp,
            stochastic_roughness=args.stochastic_roughness,
            rng_seed=args.seed,
        )
        width, height = args.width, args.height
    if args.scene:
        from .io import load_scene

        scene = load_scene(args.scene, width=width, height=height, dtype=cfg.dtype, device=device)
    else:
        make = getattr(builtin, BUILTINS[args.builtin])
        scene = make(width=width, height=height, dtype=cfg.dtype, device=device)
    if depth_auto:
        cfg = dataclasses.replace(cfg, max_depth=auto_max_depth(scene))
        print(f"auto depth: {cfg.max_depth}", file=sys.stderr)
    return scene, cfg, extras


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def cmd_render(args) -> int:
    from .render import render
    from .utils.image import save_png
    from .utils.metrics import MetricsLogger, profile_trace, rays_per_second

    device = _device(args)
    scene, cfg, extras = _build(args, device)
    metrics = MetricsLogger(args.metrics)

    # The first call builds the kernels (on CUDA); the second is timed.
    t0 = time.perf_counter()
    with torch.no_grad():
        img = render(scene, cfg)
    _sync(device)
    first_s = time.perf_counter() - t0
    with profile_trace(args.profile), torch.no_grad():
        t0 = time.perf_counter()
        img = render(scene, cfg)
        _sync(device)
        render_s = time.perf_counter() - t0

    # A settings file's keys apply where no flag overrides them.
    if args.denoise or extras.get("denoise", False):
        from .utils.denoise import nl_means_denoise

        img = nl_means_denoise(torch.clamp(img, 0.0, 1.0))
    out = args.output or extras.get("output_path") or "render_out.png"
    save_png(img, out)
    n = scene.camera.width * scene.camera.height
    rec = metrics.log(
        "render",
        device=_device_name(device),
        depth=cfg.max_depth,
        first_s=round(first_s, 4),
        render_s=round(render_s, 6),
        **{k: round(v, 1) for k, v in rays_per_second(n, cfg.max_depth, render_s).items()},
        output=str(out),
    )
    print(json.dumps(rec))
    return 0


def _train_params(scene, train_fields: str | None):
    """The ``scene_to_params`` leaves ``--train-fields`` names (all by default)."""
    from .optim import scene_to_params

    if not train_fields:
        return scene_to_params(scene)
    wanted = {f.strip() for f in train_fields.split(",") if f.strip()}
    return scene_to_params(
        scene,
        sphere_fields=tuple(k.split(".", 1)[1] for k in sorted(wanted) if k.startswith("spheres.")),
        light_fields=tuple(k.split(".", 1)[1] for k in sorted(wanted) if k.startswith("lights.")),
        camera="camera.position" in wanted,
    )


def cmd_optimize(args) -> int:
    from .optim import adam, init_state, make_loss_fn, make_train_step_k, run_steps
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.image import load_png
    from .utils.metrics import MetricsLogger

    device = _device(args)
    scene, cfg, _ = _build(args, device)
    target = torch.tensor(np.asarray(load_png(args.target), np.float32) / 255.0, dtype=cfg.dtype, device=device)
    if tuple(target.shape[:2]) != (scene.camera.height, scene.camera.width):
        print(
            f"error: target is {target.shape[1]}x{target.shape[0]}, "
            f"scene renders {scene.camera.width}x{scene.camera.height}",
            file=sys.stderr,
        )
        return 2
    params = _train_params(scene, args.train_fields)
    if not params:
        print(f"error: no valid keys in --train-fields {args.train_fields!r}", file=sys.stderr)
        return 2
    state = init_state(params, adam(args.lr))
    if args.checkpoint and Path(args.checkpoint).exists():
        state = load_checkpoint(args.checkpoint, state)
        print(f"resumed from {args.checkpoint} at step {state.step}", file=sys.stderr)

    step_k = make_train_step_k(make_loss_fn(scene, target, cfg))
    metrics = MetricsLogger(args.metrics)
    if state.step >= args.steps:
        print(json.dumps({"final_loss": None, "steps": state.step, "note": "checkpoint already past --steps"}))
        return 0
    def on_chunk(state, done, losses, seconds):
        for j, loss in enumerate(losses):
            metrics.log("step", step=done + j, loss=loss, step_s=round(seconds / len(losses), 6))
        if args.checkpoint and state.step % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, state)

    # --sync-every Adam steps per host sync; chunks end at checkpoint
    # boundaries so --checkpoint-every is exact.
    state, losses = run_steps(
        step_k, state, args.steps, sync_every=args.sync_every,
        boundary_every=args.checkpoint_every if args.checkpoint else None, on_chunk=on_chunk,
    )
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    print(json.dumps({"final_loss": losses[-1], "steps": args.steps, "device": _device_name(device)}))
    return 0


def cmd_bench(args) -> int:
    from . import bench

    bench.main(width=args.width, height=args.height, depth=args.depth, steps=args.steps)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python_ray_tracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a built-in or JSON scene to PNG")
    _add_render_opts(p)
    p.add_argument("-o", "--output", type=str, help="output PNG path")
    p.add_argument("--denoise", action="store_true", help="NL-means denoise the output")
    p.add_argument("--profile", type=str, help="directory for a torch.profiler Chrome trace of the timed render")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("optimize", help="inverse rendering against a target image")
    _add_render_opts(p)
    p.add_argument("--target", type=str, required=True, help="target PNG")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument(
        "--train-fields",
        type=str,
        help="comma-separated param keys to optimize (e.g. "
        "'spheres.center,spheres.diffuse_color,lights.point_position'); default: everything",
    )
    p.add_argument("--checkpoint", type=str, help="checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument(
        "--sync-every",
        type=int,
        default=25,
        help="Adam steps per host sync; metrics and checkpoints are written at chunk boundaries",
    )
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("bench", help="time the smooth L2 Adam step on the card")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--steps", type=int, default=200, help="Adam steps per timed call")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
