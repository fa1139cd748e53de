#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of ``python_ray_tracer_tpu_torch`` from
``csrc/``, holds each against its plain PyTorch version on the card,
drives the port's main path (the ``render`` CLI at 960x540) through the
kernels, compares the frame with the JAX package's golden image, and
times the kernels.  Phases print on their own lines; any failure exits
non-zero.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it fails.
"""

from __future__ import annotations

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
GOLDEN = "python_ray_tracer_tpu_torch/testdata/reference_960x540_d3_f32.npz"
KERNEL_SOURCE = "python_ray_tracer_tpu_torch/csrc/bounce_sub.cu"
REPLACES = {
    "trace_deep": "python_ray_tracer_tpu/ops/pallas_bounce_sub.py:416",
    "bounce_step": "python_ray_tracer_tpu/ops/pallas_bounce_sub.py:382",
}
# Kernel vs plain version: at most this share of values may differ by more
# than the dtype's threshold.  The two evaluate the same IEEE operations in
# the same order (no FMA contraction on either side), so they part only
# where pow/sin round differently and a hit or shadow test flips on it.
MAX_BAD_SHARE = 1e-4
THRESHOLD = {torch.float32: 1e-5, torch.float64: 1e-12}
# Main path vs the JAX golden: share of uint8 values allowed to differ.
MAX_GOLDEN_SHARE = 1e-3


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

    path, log, seconds = _build.build()
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    _build.load_library()
    print(f"[build] {path.name} built in {seconds:.1f} s", flush=True)


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


def _run_case(route: str, name: str, depth: int, dtype: torch.dtype, device: str, width: int, height: int):
    """(kernel acc, plain acc) of one case; the wrapper on CUDA tensors launches the kernel."""
    from python_ray_tracer_tpu_torch.ops import bounce_sub as bs

    o, d, tables, kw = _inputs(name, dtype, device, width, height)
    if route == "trace_deep":
        return bs.trace_deep(o, d, *tables, depth=depth, **kw), bs.trace_deep_plain(o, d, *tables, depth=depth, **kw)
    outs = []
    for step in (bs.bounce_step, bs.bounce_step_plain):
        state = (o, d, torch.ones_like(d[0]), torch.ones_like(d[0]), torch.zeros_like(d))
        for _ in range(depth):
            state = step(*state, *tables, **kw)
        outs.append(state[4])
    return tuple(outs)


CASES = (
    ("trace_deep", "reference", 3, torch.float32),
    ("trace_deep", "reference", 6, torch.float32),
    ("trace_deep", "all_effects", 3, torch.float32),
    ("bounce_step", "reference", 1, torch.float32),
    ("bounce_step", "reference", 12, torch.float32),
    ("trace_deep", "reference", 3, torch.float64),
)


def phase_kernels(device: str = "cuda", width: int = WIDTH, height: int = HEIGHT) -> dict[str, float]:
    """Each kernel against its plain version; returns the max abs error per kernel."""
    errs: dict[str, float] = {}
    for route, name, depth, dtype in CASES:
        kernel, plain = _run_case(route, name, depth, dtype, device, width, height)
        if device == "cuda":
            torch.cuda.synchronize()
        if not bool(torch.isfinite(kernel).all()):
            fail(f"{route} {name} depth {depth}: non-finite output")
        diff = (kernel - plain).abs()
        max_abs = float(diff.max())
        n_bad = int((diff > THRESHOLD[dtype]).sum())
        share = n_bad / diff.numel()
        label = f"{route} {name} depth {depth} {str(dtype).split('.')[-1]} {width}x{height}"
        print(f"[kernels] {label}: max_abs {max_abs:.3e}, {n_bad} of {diff.numel()} values > {THRESHOLD[dtype]:g}")
        if share > MAX_BAD_SHARE:
            fail(f"{label}: {share:.2e} of values differ by more than {THRESHOLD[dtype]:g} (limit {MAX_BAD_SHARE:g})")
        if dtype == torch.float32:
            errs[route] = max(errs.get(route, 0.0), max_abs)
    return errs


def phase_main_path(tmp: Path) -> dict[str, int]:
    """The render CLI on CUDA through the kernels; returns each kernel's launches.

    Depth 3 takes ``trace_deep`` and is held against the JAX golden; depth 1
    takes ``bounce_step`` and ``--depth auto`` (12 here) ``trace_deep`` again,
    both held against the pure-torch route on the card.
    """
    from python_ray_tracer_tpu_torch import RenderConfig, cli, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.ops import bounce_sub
    from python_ray_tracer_tpu_torch.render import auto_max_depth
    from python_ray_tracer_tpu_torch.utils.image import load_png, to_uint8

    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    depths = ("3", "1", "auto")
    for k in bounce_sub.LAUNCHES:
        bounce_sub.LAUNCHES[k] = 0
    for depth in depths:
        cli.main(["render", "--builtin", "reference", *size, "--depth", depth, "-o", str(tmp / f"d{depth}.png")])
    launches = dict(bounce_sub.LAUNCHES)
    print(f"[main] launches during the CLI renders: {launches}")
    for k, v in launches.items():
        if v == 0:
            fail(f"the main path never launched kernel {k}")

    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    golden = np.load(REPO / GOLDEN)["image"]
    for depth in depths:
        img = load_png(tmp / f"d{depth}.png")
        if depth == "3":
            ref, against = golden, "the JAX golden"
        else:
            n = 1 if depth == "1" else auto_max_depth(scene)
            ref, against = to_uint8(render(scene, RenderConfig(max_depth=n, use_pallas=False))), "the pure-torch route"
        if img.shape != ref.shape:
            fail(f"depth {depth}: CLI frame has shape {img.shape}, expected {ref.shape}")
        delta = np.abs(img.astype(np.int32) - ref.astype(np.int32))
        n_diff = int((delta > 0).sum())
        print(f"[main] depth {depth} vs {against}: {n_diff} of {delta.size} uint8 values differ, max diff {int(delta.max())}")
        if n_diff > MAX_GOLDEN_SHARE * delta.size:
            fail(f"depth {depth}: {n_diff} uint8 values differ from {against} (limit {MAX_GOLDEN_SHARE:g} of them)")
    return launches


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


def phase_timing(card: str) -> dict[str, tuple[float, float]]:
    """Kernel and plain-version ms at reference 960x540, f32; returns (ms, plain_ms) per kernel."""
    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.models.scenes import reference_scene
    from python_ray_tracer_tpu_torch.ops import bounce_sub as bs

    o, d, tables, kw = _inputs("reference", torch.float32, "cuda", WIDTH, HEIGHT)
    ones, zeros = torch.ones_like(d[0]), torch.zeros_like(d)
    n = WIDTH * HEIGHT
    res = {
        "trace_deep": (
            time_ms(lambda: bs.trace_deep(o, d, *tables, depth=3, **kw)),
            time_ms(lambda: bs.trace_deep_plain(o, d, *tables, depth=3, **kw)),
        ),
        "bounce_step": (
            time_ms(lambda: bs.bounce_step(o, d, ones, ones, zeros, *tables, **kw)),
            time_ms(lambda: bs.bounce_step_plain(o, d, ones, ones, zeros, *tables, **kw)),
        ),
    }
    scene = reference_scene(WIDTH, HEIGHT, dtype=torch.float32, device="cuda")
    frame_k = time_ms(lambda: render(scene, RenderConfig(max_depth=3, use_pallas=True)))
    frame_p = time_ms(lambda: render(scene, RenderConfig(max_depth=3, use_pallas=False)))
    for label, ms in (
        ("trace_deep kernel, depth 3", res["trace_deep"][0]),
        ("trace_deep plain version, depth 3", res["trace_deep"][1]),
        ("bounce_step kernel, one bounce", res["bounce_step"][0]),
        ("bounce_step plain version, one bounce", res["bounce_step"][1]),
        ("render() through the kernels, depth 3", frame_k),
        ("render() pure-torch route, depth 3", frame_p),
    ):
        print(f"[timing] {label}: {ms:.4f} ms/frame, {n / (ms * 1e-3):.4e} rays/s "
              f"(reference {WIDTH}x{HEIGHT} f32; {card})", flush=True)
    return res


def main() -> int:
    card = phase_device()
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    phase_build()
    errs = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(Path(tmp))
    timings = phase_timing(card)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": timings[name][0],
            "plain_ms": timings[name][1],
        }
        for name in ("trace_deep", "bounce_step")
    ]
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
