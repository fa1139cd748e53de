"""Time the five smooth kernels with the geometry staged in shared memory
against read from global memory, on one CUDA card.

``csrc/bounce_smooth_sub.cu`` stages the (S, 4) geometry table in shared
memory up to ``kStageMaxBytes`` and reads it through ``__ldg`` past that.
This script builds the source three ways, each in a copy of the package
under ``out/geometry_ab/`` of the checkout: as it is, with nothing staged
(0), and with up to 128 KB staged.  It then times every kernel on the cases
below, each variant in its own process, in turns (as it is, global,
128 KB, 128 KB, global, as it is), and prints one line a case and turn with
each kernel's median CUDA-event time and resident blocks per SM::

    python -m python_ray_tracer_tpu_torch.geometry_ab
"""

from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
OUT = PACKAGE.parent / "out" / "geometry_ab"
# name: kStageMaxBytes (None: as in the source).
VARIANTS = {"as_is": None, "global": 0, "staged_128KB": 131072}
ORDER = ("as_is", "global", "staged_128KB", "staged_128KB", "global", "as_is")
# (scene, spheres, width, height, depth, dtype name): the 3-sphere bench
# frame, config 5, 4096 spheres in f32 (64 KB of geometry) and f64 (128 KB),
# and 8192 in f32 (128 KB; the one-bounce pair only, as it routes).
CASES = (
    ("reference", 3, 960, 540, 3, "float32"),
    ("inverse_task", 1024, 256, 144, 3, "float32"),
    ("random_spheres", 4096, 256, 144, 3, "float32"),
    ("random_spheres", 4096, 256, 144, 1, "float64"),
    ("random_spheres", 8192, 256, 144, 2, "float32"),
)


def _variant(name: str, stage_max: int | None) -> Path:
    """A copy of the package with kStageMaxBytes set to ``stage_max``."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if stage_max is not None:
        src = root / PACKAGE.name / "csrc" / "bounce_smooth_sub.cu"
        text, n = re.subn(r"constexpr int kStageMaxBytes = \d+;", f"constexpr int kStageMaxBytes = {stage_max};",
                          src.read_text())
        if n != 1:
            raise RuntimeError(f"kStageMaxBytes not found in {src}")
        src.write_text(text)
    return root


def _time_ms(fn, warmup: int, iters: int) -> float:
    import torch

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


def _time_cases(label: str) -> None:
    """In a variant's process (its copy first on sys.path): time each case."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    gen = torch.Generator("cuda").manual_seed(0)
    for scene_name, s, width, height, depth, dtype_name in CASES:
        dtype = getattr(torch, dtype_name)
        build = getattr(scenes, f"{scene_name}_scene")
        scene = (build(width, height, dtype=dtype, device="cuda") if scene_name == "reference"
                 else build(s, width, height, dtype=dtype, device="cuda"))
        cfg = RenderConfig(max_depth=depth, dtype=dtype, visibility="smooth", use_pallas=True)
        o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)
        skw = {k: v for k, v in kw.items() if k != "depth"}
        ones = torch.ones_like(d[0])
        state = bss.smooth_fwd_step(o, d, ones, ones, torch.zeros_like(d), *tables, **skw)[:5]
        state = tuple(t.contiguous() for t in state)
        step = bss.smooth_fwd_step(*state, *tables, **skw)
        cots = [torch.rand(t.shape, generator=gen, device="cuda", dtype=dtype) - 0.5 for t in step[:5]]
        calls = {
            "smooth_fwd_step": lambda: bss.smooth_fwd_step(*state, *tables, **skw),
            "smooth_bwd_step": lambda: bss.smooth_bwd_step(*state[:4], *step[5:], *tables, *cots, **skw),
        }
        if s <= 4096:  # the deep kernels' range off the culled route
            fwd = bss.smooth_fwd_deep(o, d, *tables, **kw)
            g_acc = torch.rand(d.shape, generator=gen, device="cuda", dtype=dtype) - 0.5
            tgt = (torch.clamp(fwd[0], 0.0, 1.0) * 0.9).contiguous()
            calls.update({
                "smooth_fwd_deep": lambda: bss.smooth_fwd_deep(o, d, *tables, **kw),
                "smooth_bwd_deep": lambda: bss.smooth_bwd_deep(o, d, *fwd[1:], *tables, g_acc, **kw),
                "train_deep": lambda: bss.train_deep(o, d, tgt, *tables, **kw),
            })
        res = [
            f"{name} {_time_ms(fn, 2, 10 if s < 8192 else 3):.4f} ms ({bss.blocks_per_sm(name, dtype, False, s)}/SM)"
            for name, fn in calls.items()
        ]
        print(f"[geometry_ab] {label} {scene_name}({s}) {width}x{height} depth {depth} {dtype_name}, "
              f"{bss.shared_bytes(dtype, s)} B shared a block: " + ", ".join(res), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT LABEL [build]
        sys.path.insert(0, argv[1])
        from python_ray_tracer_tpu_torch.ops import _build

        _build.build_all(("bounce_smooth_sub.cu",))
        if argv[3:] != ["build"]:
            _time_cases(argv[2])
        return 0
    roots = {name: _variant(name, stage_max) for name, stage_max in VARIANTS.items()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    child = [sys.executable, "-m", "python_ray_tracer_tpu_torch.geometry_ab", "--child"]
    builds = [subprocess.Popen([*child, str(root), name, "build"], cwd=root) for name, root in roots.items()]
    if any(p.wait() != 0 for p in builds):
        return 1
    for name in ORDER:
        subprocess.run([*child, str(roots[name]), name], cwd=roots[name], check=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
