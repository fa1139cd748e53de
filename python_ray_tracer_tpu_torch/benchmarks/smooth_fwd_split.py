"""Split ``smooth_fwd_step``'s and ``clear_fwd``'s time on one CUDA card by
stubbing out one part at a time.

``smooth_fwd_step`` (``csrc/bounce_smooth_sub.cu``, kernel-table rows 6 and
8) runs one smooth bounce a ray: the winner sweep over every sphere
(``fwd_bounce``'s, ``csrc/smooth_math.cuh``), the shading, and the shadow
product over every sphere.  ``clear_fwd`` (``csrc/smooth_parts.cu``, row 19)
is that shadow product alone, over one sphere shard.  As
:mod:`.smooth_bwd_split` does for their adjoints, this script builds
variants of the sources, each in a copy of the package
(:func:`.package_copy`) under ``out/smooth_fwd_split/`` of the checkout, and
times each variant on the same recorded inputs:

* ``smooth_fwd_step`` on the three launches of the 8192-sphere L2 step's
  forward (``random_spheres_scene(8192)``, 256x144, depth 3, f32, mirror;
  row 6);
* ``clear_fwd`` on sphere shard 0's three launches of config 4's smooth
  step forward at 960x540 (``random_spheres_scene(1024)``, two ranks on the
  card over gloo, the loss against the culled smooth golden's image; row
  19).

Variants are text patches of a copy, never switches in the shipped source:

``no_shadow``         ``fwd_bounce``'s shadow product removed (``clear`` = 1);
``no_winner``         its winner sweep removed (every lane takes sphere 0 as
                      a miss); the shadow product then runs on other rays,
                      which changes its work where it skips pairs;
``clear_no_product``  ``clear_fwd``'s product removed (``clear`` = 1).

The stubbed variants' outputs are wrong by design; only their times are
read.  Where the wrappers take ``skip`` (the redesigned sources), each
variant is timed with ``skip="off"`` and ``skip="on"``.  Beside the times:
ptxas's registers and spill bytes of each instantiation of the two kernels
and the resident CTAs per SM.  A ``clear_`` variant times ``clear_fwd``
only, the others ``smooth_fwd_step`` only, ``as_is`` both::

    python -m python_ray_tracer_tpu_torch.benchmarks.smooth_fwd_split [--tree PACKAGE_DIR] [--variants a,b,...]

``--tree`` takes the package directory of another checkout (the parent
commit unpacked with ``git archive``); its layout (``full``: every pair
swept; ``skip``: the skips of this design) is read from its sources.  The
builds, the recording and the turns are :func:`.run_split`'s.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

# This file also runs as a script in each variant's process (with the
# copy first on sys.path), so it imports nothing of the package at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "smooth_fwd_split"
STEP_SRC, CLEAR_SRC, SMOOTH_MATH = "csrc/bounce_smooth_sub.cu", "csrc/smooth_parts.cu", "csrc/smooth_math.cuh"
SOURCES = ("bounce_smooth_sub.cu", "smooth_parts.cu")
STEP_SPHERES, STEP_SIZE, DEPTH = 8192, (256, 144), 3
CLEAR_SIZE, CLEAR_SPHERES = (960, 540), 1024
CLEAR_GOLDEN = "python_ray_tracer_tpu_torch/testdata/random1024_960x540_d3_smooth_train_f32.npz"

# The same text on both layouts: fwd_bounce's shadow product (the block the
# saved-winner replay passes over), its winner sweep (from the fallback's
# index to the hit test), clear_fwd's product (from its start to its store).
_STUBS = {
    "no_shadow": [(SMOOTH_MATH, r"  if \(kWin != Winner::kSaved\) \{",
                   "  if (kWin != Winner::kSaved) f.clear = T(1);\n  if (false) {")],
    "no_winner": [(SMOOTH_MATH, r"(    int idmax = 0;\n).*?(\n    f\.hit = tmin != sc\.faraway;)", r"\1\2")],
    "clear_no_product": [(CLEAR_SRC, r"(  T clear = T\(1\);\n).*?(\n  clear_out\[i\] = clear;)", r"\1\2")],
}


def ptxas_report(log: str) -> dict[str, dict]:
    """:func:`.splits.ptxas_kernels` of each instantiation of the two
    kernels, keyed by kernel, dtype and the template flags that are set."""
    from .splits import ptxas_kernels

    out = {}
    for name, rec in ptxas_kernels(log).items():
        m = re.search(r"(smooth_fwd_step|clear_fwd)I([fd])((?:Lb[01]E)+)", name)
        if not m:
            continue
        flags = re.findall(r"Lb([01])E", m.group(3))
        names = {"smooth_fwd_step": ("glossy", "staged", "atlas", "skip"), "clear_fwd": ("staged", "skip")}[m.group(1)]
        key = " ".join([m.group(1), "f32" if m.group(2) == "f" else "f64"]
                       + [n for n, f in zip(names, flags) if f == "1"])
        out[key] = rec
    return out


LAYOUTS = {
    # Every (ray, sphere) pair swept (the kernels before the skips).
    "full": dict(
        markers=[(CLEAR_SRC, "T* __restrict__ clear_out, int n, int s_cheap, int s_total,\n              T faraway, T sharpness)")],
        common=[], report=ptxas_report, stubs=_STUBS,
    ),
    # The skips: the shadow set over the whole table (SkipAll) and clear_fwd's.
    "skip": dict(markers=[(SMOOTH_MATH, "struct SkipAll")], common=[], report=ptxas_report, stubs=_STUBS),
}
STUBS = ("no_shadow", "no_winner", "clear_no_product")


def _step_calls(device: str = "cuda") -> list:
    """smooth_fwd_step's calls ``(args, kwargs)`` in the 8192-sphere L2
    step's forward (``render()`` takes the one-bounce pair past 4096
    spheres), bounce order."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig, render
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    scene = random_spheres_scene(STEP_SPHERES, *STEP_SIZE, dtype=torch.float32, device=device)
    cfg = RenderConfig(max_depth=DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
    calls, real = [], bss.smooth_fwd_step
    bss.smooth_fwd_step = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
    try:
        with torch.no_grad():
            render(scene, cfg)
    finally:
        bss.smooth_fwd_step = real
    return [([a.detach() if isinstance(a, torch.Tensor) else a for a in args], kw) for args, kw in calls]


def _clear_rank(path: str, size: tuple[int, int] = CLEAR_SIZE, device: str = "cuda") -> None:
    """One of two ranks (spawned by run_local): the forward of config 4's
    smooth loss at ``size`` on sphere shard (1, 2), the target the culled
    smooth golden's image; rank 0 saves its clear_fwd calls to ``path``."""
    import numpy as np
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene
    from python_ray_tracer_tpu_torch.ops import smooth_parts
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 2)
    scene = random_spheres_scene(CLEAR_SPHERES, *size, dtype=torch.float32, device=device)
    repo = Path(smooth_parts.__file__).resolve().parents[2]
    image = np.load(repo / CLEAR_GOLDEN)["image"][: size[1], : size[0]]
    target = torch.as_tensor(image / 255.0, dtype=torch.float32, device=device)
    cfg = RenderConfig(max_depth=DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
    calls, real = [], smooth_parts.clear_fwd
    smooth_parts.clear_fwd = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
    try:
        with torch.no_grad():
            make_loss_fn(scene, target, cfg, mesh)(scene_to_params(scene))
    finally:
        smooth_parts.clear_fwd = real
    if mesh.spheres.index == 0:
        torch.save([([a.detach() if isinstance(a, torch.Tensor) else a for a in args], kw) for args, kw in calls],
                   path)


def _record(path: Path) -> None:
    """In the as-is copy's process: both kernels' calls, saved to ``path``."""
    import torch

    from python_ray_tracer_tpu_torch.parallel.distributed import run_local

    clear_path = path.with_name("clear_fwd.pt")
    run_local(_clear_rank, 2, str(clear_path))
    records = {"smooth_fwd_step": _step_calls(), "clear_fwd": torch.load(clear_path, map_location="cuda")}
    for name, calls in records.items():
        for b, (args, kw) in enumerate(calls):
            rays = args[1].shape[1] if name == "smooth_fwd_step" else args[0].shape[0]
            spheres = (args[5] if name == "smooth_fwd_step" else args[2]).shape[0]
            print(json.dumps({"kernel": name, "bounce": b, "rays": rays, "spheres": spheres,
                              "s_cheap": kw["s_cheap"]}), flush=True)
    torch.save(records, path)


def _time_variant(label: str, inputs: Path) -> None:
    """In a variant's process (its copy first on sys.path): time the kernel
    it patches on every recorded call, skip off and on where the wrapper
    takes the switch; one JSON line a call."""
    import inspect

    import torch
    from splits import median_ms  # this file's directory, not the copy's package (see .splits)

    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops import smooth_parts as sp

    records = torch.load(inputs, map_location="cuda", weights_only=False)
    kernels = {"smooth_fwd_step": bss.smooth_fwd_step, "clear_fwd": sp.clear_fwd}
    with torch.no_grad():
        for name, calls in records.items():
            if label != "as_is" and label.startswith("clear_") != (name == "clear_fwd"):
                continue
            kernel = kernels[name]
            skips = ("off", "on") if "skip" in inspect.signature(kernel).parameters else (None,)
            for b, (args, kw) in enumerate(calls):
                ms = {str(s): median_ms(lambda a=args, k=kw, s=s: kernel(*a, **k, **({} if s is None else {"skip": s})))
                      for s in skips}
                rec = {"variant": label, "kernel": name, "bounce": b, "ms": ms}
                if name == "smooth_fwd_step":
                    blocks = {str(s): bss.blocks_per_sm(name, torch.float32, False, args[5].shape[0],
                                                        **({} if s is None else {"skip": s == "on"})) for s in skips}
                    rec["blocks_per_sm"] = blocks
                print(json.dumps(rec), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT LABEL (build | record PATH | time PATH)
        sys.path.insert(0, argv[1])
        from python_ray_tracer_tpu_torch.ops import _build

        built = _build.build_all(SOURCES)
        if argv[3] == "build":
            print(json.dumps({"variant": argv[2], "log": "\n".join(built[s][1] for s in SOURCES)}), flush=True)
        elif argv[3] == "record":
            _record(Path(argv[4]))
        else:
            _time_variant(argv[2], Path(argv[4]))
        return 0
    from .splits import run_split

    return run_split(argv, script=Path(__file__).resolve(), out=OUT, layouts=LAYOUTS, default_variants=STUBS)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
