"""Command-line interface: the ``render`` subcommand.

    python -m python_ray_tracer_tpu_torch.cli render --builtin reference -o out.png
    python -m python_ray_tracer_tpu_torch.cli render --depth auto --device cpu -o out.png

On a CUDA device the render goes through the hand-written bounce kernels
(as the JAX CLI does with ``--pallas``); on ``--device cpu`` it takes the
pure-torch bounce loop.  The default device is ``cuda``, and without a card
the command fails rather than drop to the CPU on its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch


def _build(args, device: torch.device):
    from .config import RenderConfig
    from .models import scenes as builtin
    from .render import auto_max_depth

    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    depth_auto = str(args.depth) == "auto"
    cfg = RenderConfig(
        max_depth=1 if depth_auto else int(args.depth),
        dtype=dtype,
        use_pallas=device.type == "cuda",
    )
    make = builtin.reference_scene if args.builtin == "reference" else builtin.all_effects_scene
    scene = make(args.width, args.height, dtype=dtype, device=device)
    if depth_auto:
        cfg = dataclasses.replace(cfg, max_depth=auto_max_depth(scene))
        print(f"auto depth: {cfg.max_depth}", file=sys.stderr)
    return scene, cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args) -> int:
    from .render import render
    from .utils.image import save_png
    from .utils.metrics import MetricsLogger, rays_per_second

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to render on the CPU)")
    scene, cfg = _build(args, device)
    metrics = MetricsLogger(args.metrics)

    # The first call builds the kernels (on CUDA); the second is timed.
    t0 = time.perf_counter()
    img = render(scene, cfg)
    _sync(device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render(scene, cfg)
    _sync(device)
    render_s = time.perf_counter() - t0

    out = args.output or "render_out.png"
    save_png(img, out)
    n = scene.camera.width * scene.camera.height
    rec = metrics.log(
        "render",
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        depth=cfg.max_depth,
        first_s=round(first_s, 4),
        render_s=round(render_s, 6),
        **{k: round(v, 1) for k, v in rays_per_second(n, cfg.max_depth, render_s).items()},
        output=str(out),
    )
    print(json.dumps(rec))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python_ray_tracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a built-in scene to PNG")
    p.add_argument("--builtin", type=str, default="reference", choices=["reference", "all_effects"])
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument(
        "--depth",
        type=str,
        default="3",
        help="max reflection depth, or 'auto' to bound it by the scene's reflection energy decay",
    )
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "float64"])
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--metrics", type=str, help="JSONL metrics output path")
    p.add_argument("-o", "--output", type=str, help="output PNG path")
    p.set_defaults(fn=cmd_render)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
