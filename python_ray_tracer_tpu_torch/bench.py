"""Headline benchmark on CUDA: the smooth L2 Adam step at 960x540, depth 3.

Prints ONE JSON line with the JAX bench's metric name
(``python_ray_tracer_tpu/bench.py``):

    {"metric": "fwd_bwd_primary_rays_per_s_960x540_depth3", "value": N,
     "unit": "rays/s/chip", "vs_baseline": N, "step_ms": N, "device": "cuda", ...}

The step is the JAX bench's: ``reference_scene`` in float32, smooth
visibility through the kernels, an L2 pixel loss against the clipped hard
render, value-and-grad (one ``train_deep`` launch) and an Adam update at lr
1e-3.  One warm-up call of ``steps`` steps builds the kernels; then three
timed calls of ``steps`` steps each, every one ending in a CUDA
synchronise, and the best of the three counts.  The timed calls continue
from the warm-up's parameters (the JAX bench restarts each from them); the
work per step does not depend on the parameter values.

``profile_steps > 0`` then traces that many more steps with
``torch.profiler`` and adds to the record where the step's time goes: the
wall time per step under the profiler, the device time per step of every
kernel and copy, and the device's busy share of the unprofiled step.
"""

from __future__ import annotations

import json
import time

import torch

BASELINE_PRIMARY_RAYS_PER_S = 518_400 / 1.40  # the reference NumPy renderer: 960x540 in 1.40 s
TIMED_CALLS = 3


def _profile(step_k, state, steps: int) -> dict:
    """Device time per step by kernel name, and the busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        _, losses = step_k(state, steps)
        float(losses[-1])
        wall = time.perf_counter() - start
    device_events = [  # kernels and copies; user-annotation ranges (Optimizer.step, ...) span them
        e
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))
    ]
    device_us = {e.key[:80]: getattr(e, "self_device_time_total", 0.0) / steps for e in device_events}
    top = sorted(device_us.items(), key=lambda kv: -kv[1])
    return {
        "profile_wall_ms_per_step": wall * 1e3 / steps,
        "profile_device_ms_per_step": sum(device_us.values()) / 1e3,
        "profile_device_us_per_step": dict(top[:12]),
        "profile_device_ops_per_step": sum(e.count for e in device_events) / steps,
    }


def main(width: int = 960, height: int = 540, depth: int = 3, steps: int = 200, profile_steps: int = 0) -> dict:
    """Run the benchmark on the current CUDA device; print and return its record."""
    from .config import RenderConfig
    from .models.scenes import reference_scene
    from .ops import bounce_smooth_sub
    from .optim import adam, init_state, make_loss_fn, make_train_step_k, scene_to_params
    from .render import render

    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark times the CUDA kernels and needs a CUDA device")
    device = torch.device("cuda")
    scene = reference_scene(width, height, dtype=torch.float32, device=device)
    cfg = RenderConfig(max_depth=depth, dtype=torch.float32, visibility="smooth", use_pallas=True)
    with torch.no_grad():
        target = torch.clamp(render(scene, RenderConfig(max_depth=depth, dtype=torch.float32, use_pallas=True)), 0.0, 1.0)
    state = init_state(scene_to_params(scene), adam(1e-3))
    step_k = make_train_step_k(make_loss_fn(scene, target, cfg))

    state, losses = step_k(state, steps)  # warm-up: builds and loads the kernels
    float(losses[-1])
    launches_before = bounce_smooth_sub.LAUNCHES["train_deep"]
    elapsed = float("inf")
    for _ in range(TIMED_CALLS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, losses = step_k(state, steps)
        float(losses[-1])  # host fetch: the device has finished
        elapsed = min(elapsed, (time.perf_counter() - start) / steps)
    launches = bounce_smooth_sub.LAUNCHES["train_deep"] - launches_before

    rays_per_s = (width * height) / elapsed
    record = {
        "metric": f"fwd_bwd_primary_rays_per_s_{width}x{height}_depth{depth}",
        "value": rays_per_s,
        "unit": "rays/s/chip",
        "vs_baseline": rays_per_s / BASELINE_PRIMARY_RAYS_PER_S,
        "step_ms": elapsed * 1e3,
        "device": "cuda",
        "kind": torch.cuda.get_device_name(device),
        "train_deep_launches_per_step": launches / (TIMED_CALLS * steps),
        "final_loss": float(losses[-1]),
    }
    if profile_steps:
        record.update(_profile(step_k, state, profile_steps))
        # Device time against the step's unprofiled wall time.
        record["device_busy_share"] = record["profile_device_ms_per_step"] / record["step_ms"]
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
