"""Split ``fwd_cs``'s time on one CUDA card: the shadow product's loop against the rest.

``fwd_cs`` (``csrc/culled_smooth.cu``, kernel-table row 16) runs one culled
smooth bounce a ray: the winner's quadratic and the shading, and the shadow
product over its tile's shadow list (``fwd_bounce``'s shadow loop,
``csrc/smooth_math.cuh``).  As :mod:`.bwd_cs_split` does for ``bwd_cs``,
this script builds variants of the source, each in a copy of the package
(:func:`.package_copy`) under ``out/fwd_cs_split/`` of the checkout, and
times each variant's ``fwd_cs`` on the same recorded inputs:

* every bounce of config 4's smooth loss (``random1024``, 1920x1080,
  depth 3, f32, mirror), the row 16 launches of the config-4 step;
* every bounce of the ``textured1024`` loss at 960x540 (the atlas mode).

``as_is`` is the source as it is; ``no_shadow`` sets ``clear`` to 1 in
place of the shadow loop (its outputs are wrong by design; only its time is
read).  ``--variants`` also takes the skip's parts apart: ``no_bound``
(no warp bound: every listed pair tested per lane), ``no_pair_test`` (every
pair the bound keeps computed whole) and ``min5`` (the skip's
instantiations asked for 5 resident CTAs an SM).  Each variant times
``fwd_cs`` with ``skip="off"`` and, where its wrapper takes the switch,
``skip="on"``.  Beside the times: ptxas's registers and spill bytes of
every ``fwd_cs`` instantiation.  The recorded
inputs are taken once, with the source as it is; each variant runs in its
own process, in turns (``as_is`` first and last)::

    python -m python_ray_tracer_tpu_torch.benchmarks.fwd_cs_split [--tree PACKAGE_DIR] [--variants a,b,...]

``--tree`` takes the package directory of another checkout (a parent
commit unpacked with ``git archive``).  The builds, the recording and the
turns are :func:`.run_split`'s.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

# This file also runs as a script in each variant's process (with the
# copy first on sys.path), so it imports nothing of the package at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "fwd_cs_split"
SOURCE = "csrc/culled_smooth.cu"
SHADOW_LOOP = "csrc/smooth_math.cuh"
SPHERES, DEPTH = 1024, 3
CASES = {"config4": (1920, 1080, "random_spheres"), "textured1024_atlas": (960, 540, "textured_spheres")}

LAYOUTS = {
    "fwd_cs": dict(
        markers=[(SOURCE, "fwd_cs(const T* __restrict__ o")],
        time_args=[],
        report=lambda log: ptxas_report(log),
        common=[],
        stubs={
            # clear = 1 and no shadow loop (fwd_bounce's, the only one that
            # runs in this source: bwd_cs replays the saved clear).
            "no_shadow": [(SHADOW_LOOP, r"  if \(kWin != Winner::kSaved\) \{",
                           "  if (kWin != Winner::kSaved) f.clear = T(1);\n  if (false) {")],
            # The skip's parts (--variants): without the warp bound (every
            # listed pair tested per lane), without the per-pair zero test
            # (every pair the bound keeps computed whole), and the skip's
            # instantiations asked for 5 resident CTAs an SM.
            "no_bound": [(SOURCE, r"finite && sc\.sharp_s > T\(0\) \? warp_bundle", "false ? warp_bundle")],
            "no_pair_test": [(SHADOW_LOOP, r"\n  if \(finite && sig_is_zero\(x\)\) return;", "")],
            "min5": [(SOURCE, r"__launch_bounds__\(kThreads\)\n    fwd_cs\(",
                      "__launch_bounds__(kThreads, kSkip ? 5 : 1)\n    fwd_cs(")],
        },
    ),
}
STUBS = ("no_shadow",)


def ptxas_report(log: str) -> dict[str, dict]:
    """:func:`.splits.ptxas_kernels` of each fwd_cs instantiation, keyed
    ``"f32"``/``"f64"`` + ``" glossy"`` + ``" atlas"`` + ``" skip"``."""
    from .splits import ptxas_kernels

    out = {}
    for name, rec in ptxas_kernels(log).items():
        t = re.search(r"fwd_csI([fd])Lb([01])ELb([01])E(?:Lb([01])E)?", name)
        if t:
            key = ("f32" if t.group(1) == "f" else "f64") + (" glossy" if t.group(2) == "1" else "") + (
                " atlas" if t.group(3) == "1" else "") + (" skip" if t.group(4) == "1" else "")
            out[key] = rec
    return out


def record_calls(device: str = "cuda") -> dict[str, list]:
    """Each case's fwd_cs calls ``(args, kwargs)`` in a smooth frame through
    trace_culled_smooth (the loss's forward), bounce order."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops import culled_smooth

    records = {}
    real = culled_smooth.fwd_cs
    for case, (width, height, kind) in CASES.items():
        scene = getattr(scenes, f"{kind}_scene")(SPHERES, width, height, dtype=torch.float32, device=device)
        cfg = RenderConfig(max_depth=DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
        calls = []
        culled_smooth.fwd_cs = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
        try:
            with torch.no_grad():
                culled_smooth.trace_culled_smooth(scene.camera.position, ray_directions_t(scene.camera, torch.float32),
                                                  scene, cfg)
        finally:
            culled_smooth.fwd_cs = real
        records[case] = calls
    return records


def _record(path: Path) -> None:
    """In the as-is copy's process: the recorded calls, saved to ``path``."""
    import torch

    records = record_calls()
    for case, calls in records.items():
        for b, (a, _) in enumerate(calls):
            print(json.dumps({"case": case, "bounce": b, "tiles": a[8].numel(), "rays": a[0].shape[1],
                              "shadow_list_mean": float((a[8] + a[9]).float().mean()),
                              "shadow_list_max": int((a[8] + a[9]).max())}), flush=True)
    torch.save(records, path)


def _time_variant(label: str, inputs: Path) -> None:
    """In a variant's process (its copy first on sys.path): time its fwd_cs
    on every recorded call, skip off and (where the wrapper takes it) on;
    one JSON line a call."""
    import inspect

    import torch

    from splits import median_ms  # this file's directory, not the copy's package (see .splits)

    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    skips = ("off", "on") if "skip" in inspect.signature(cs.fwd_cs).parameters else (None,)
    records = torch.load(inputs, map_location="cuda")
    with torch.no_grad():
        for case, calls in records.items():
            for b, (args, kw) in enumerate(calls):
                ms = {str(s): median_ms(lambda a=args, k=kw, s=s: cs.fwd_cs(*a, **k, **({} if s is None else
                                                                                     {"skip": s})))
                      for s in skips}
                print(json.dumps({"variant": label, "case": case, "bounce": b, "ms": ms, "rays": args[0].shape[1]}),
                      flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT LABEL (build | record PATH | time PATH)
        sys.path.insert(0, argv[1])
        from python_ray_tracer_tpu_torch.ops import _build

        _, log, _ = _build.build_all(("culled_smooth.cu",))["culled_smooth.cu"]
        if argv[3] == "build":
            print(json.dumps({"variant": argv[2], "log": log}), flush=True)
        elif argv[3] == "record":
            _record(Path(argv[4]))
        else:
            _time_variant(argv[2], Path(argv[4]))
        return 0
    from .splits import run_split

    return run_split(argv, script=Path(__file__).resolve(), out=OUT, layouts=LAYOUTS, default_variants=STUBS)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
