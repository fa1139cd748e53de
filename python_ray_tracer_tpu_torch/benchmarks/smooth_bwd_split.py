"""Split ``smooth_bwd_step``'s and ``clear_bwd``'s time on one CUDA card by
stubbing out one part at a time.

``ncu`` does not run on the card's machine, so this script measures what
holds the two kernels as :mod:`.bwd_cs_split` measures ``bwd_cs``: it builds
variants of ``csrc/bounce_smooth_sub.cu`` and ``csrc/smooth_parts.cu``, each
in a copy of the package (:func:`.package_copy`) under
``out/smooth_bwd_split/`` of the checkout, and times each variant on the
same recorded inputs:

* ``smooth_bwd_step`` on the second bounce of ``random_spheres_scene(8192)``
  at 256x144, f32, mirror (kernel-table row 7, the 8192-sphere L2 step's
  launches), of ``inverse_task_scene(1024)`` at 256x144 and of the
  3-sphere ``reference_scene`` at 960x540 (row 9's two figures), with
  seeded cotangents on all five outputs;
* ``clear_bwd`` on sphere shard 0's first-bounce inputs of config 4's
  smooth step at 960x540 (``random_spheres_scene(1024)``, two ranks on the
  card over gloo, the loss against the culled smooth golden's image; row
  20).

Variants are text patches of a copy, never switches in the shipped source:

``no_c_sink``          ``smooth_bwd_step``'s Phase C sink removed (the four
                       geometry values a shadow sphere), its math kept;
``no_c``               its Phase C removed whole, math and sink;
``no_f_sink``          its Phase F sink removed (the winner's material row);
``store``              its sink's read-modify-writes turned into plain
                       stores (the parent's column partials; the rows'
                       later rounds and material slots);
``clear_no_warp_sum``  ``clear_bwd``'s four warp sums a sphere removed;
``clear_no_adjoint``   ``clear_bwd``'s per-sphere work removed (the sweep
                       and its adjoint), the chunks' flushes kept.

On the row layout ``--variants`` also takes ``split2`` and ``split4``: a
ray-warp's spheres split over 2 or 4 warps (``kStepSplit``; CTAs of 256 or
512 threads, each still 4 ray-warps a round), and ``rows1024``: up to 1024
rows (CTAs) in place of 4096.

Beside each variant's times the script prints ptxas's registers and spill
bytes of each instantiation of the two kernels (nvcc ``-Xptxas -v``, as
the package builds), the resident CTAs per SM (the occupancy API at the
launch's dynamic shared bytes) and the CTAs a launch runs.  The stubbed
variants' outputs are wrong by design; only their times are read.  A step
variant times ``smooth_bwd_step`` only, a ``clear_`` variant ``clear_bwd``
only, ``as_is`` both::

    python -m python_ray_tracer_tpu_torch.benchmarks.smooth_bwd_split [--tree PACKAGE_DIR] [--variants a,b,...]

``--tree`` takes the package directory of another checkout (for example the
parent commit unpacked with ``git archive``); the patches are chosen by the
layout its sources have: ``columns`` (one partials column a warp, every
sphere visited, ``clear_bwd`` unskipped) or ``rows`` (one row a CTA, the
exact skip in both kernels).  The builds, the recording and the turns are
:func:`.run_split`'s.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

# This file also runs as a script in each variant's process (with the
# copy first on sys.path), so it imports nothing of the package at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "smooth_bwd_split"
STEP_SRC, CLEAR_SRC = "csrc/bounce_smooth_sub.cu", "csrc/smooth_parts.cu"
SOURCES = ("bounce_smooth_sub.cu", "smooth_parts.cu")
# (scene builder, spheres (None: the builder's own), width, height)
STEP_CASES = {
    "random_spheres(8192) 256x144": ("random_spheres", 8192, 256, 144),
    "inverse_task(1024) 256x144": ("inverse_task", 1024, 256, 144),
    "reference(3) 960x540": ("reference", None, 960, 540),
}
CLEAR_SIZE, CLEAR_SPHERES, CLEAR_DEPTH = (960, 540), 1024, 3
CLEAR_GOLDEN = "python_ray_tracer_tpu_torch/testdata/random1024_960x540_d3_smooth_train_f32.npz"

# clear_bwd's stubs, the same text on both layouts: its warp sums, and its
# per-sphere work, in place of which each slot of the chunk reads 0.
_CLEAR_NO_WARP_SUM = [(CLEAR_SRC, r"const T s = warp_sum\(row\[c\]\);", "const T s = row[c];")]
_CLEAR_NO_ADJOINT = [(CLEAR_SRC, r"(for \(int k = k0; k < k1; \+\+k\) \{\n).*?(\n    \}\n    __syncthreads\(\);)",
                      r"\1      if (lane == 0) {\n        for (int v = 0; v < 4; ++v) "
                      r"red[(warp * kChunk + (k - k0)) * 4 + v] = T(0);\n      }\2")]

# The stub sinks of the column layout, beside its Partials sink.
_COLUMN_SINKS = r"""template <typename T> struct NoGeomSink : Partials<T> {
  __device__ __forceinline__ void geom(int, int, int, T) const {}
};
template <typename T> struct NoWinnerSink : Partials<T> {
  __device__ __forceinline__ void winner(const Scal<T>&, int, const T (&)[15]) const {}
};
struct NoSpheres {
  template <typename T, typename F> __device__ __forceinline__ void visit(const Scal<T>&, F&&) const {}
};

\1"""
_COLUMN_CALL = r"sc, AllSpheres\{\}, part, g_dww\);"  # smooth_bwd_step's adjoint_bounce call, on one line
# clear_bwd's occupancy query, as the row layout's source has it.
_CLEAR_OCCUPANCY = (
    CLEAR_SRC, r"(\n\}  // namespace\n)",
    r"""
template <typename T> int clear_bwd_blocks_per_sm(int s_total) {
  const long long red_bytes = static_cast<long long>(sizeof(T)) * kWarps * kChunk * 4;
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  return staged(clear_bwd<T, true>, clear_bwd<T, false>, s_total, sizeof(T), red_bytes)
             ? resident_blocks(clear_bwd<T, true>, geom_bytes + red_bytes)
             : resident_blocks(clear_bwd<T, false>, red_bytes);
}
\1extern "C" int prt_clear_bwd_blocks_per_sm_f32(int s_total) { return clear_bwd_blocks_per_sm<float>(s_total); }
""",
)


def ptxas_report(log: str) -> dict[str, dict]:
    """:func:`.splits.ptxas_kernels` of each instantiation of the two
    kernels, keyed by kernel, dtype and the template flags that are set."""
    from .splits import ptxas_kernels

    out = {}
    for name, rec in ptxas_kernels(log).items():
        m = re.search(r"(smooth_bwd_step|clear_bwd)I([fd])((?:Lb[01]E)+)", name)
        if not m:
            continue
        flags = re.findall(r"Lb([01])E", m.group(3))
        # smooth_bwd_step<T, kXi, kStaged, kAtlas> in the column layout, <T, kXi, kAtlas> in the row one
        names = {3: ("glossy", "staged", "atlas"), 2: ("glossy", "atlas"), 1: ("staged",)}[len(flags)]
        key = " ".join([m.group(1), "f32" if m.group(2) == "f" else "f64"]
                       + [n for n, f in zip(names, flags) if f == "1"])
        out[key] = rec
    return out


LAYOUTS = {
    # One partials column a warp (the layout before the rows): every shadow sphere's four
    # values summed over the warp and added into the column by lane 0.
    "columns": dict(
        markers=[(STEP_SRC, "T* __restrict__ parts, int n, int n_cols, Scal<T> sc) {")],
        common=[(STEP_SRC, r"(__device__ __forceinline__ int v_sse\(int s\))", _COLUMN_SINKS), _CLEAR_OCCUPANCY],
        report=ptxas_report,
        stubs={
            "no_c_sink": [(STEP_SRC, _COLUMN_CALL, "sc, AllSpheres{}, NoGeomSink<T>{part}, g_dww);")],
            "no_c": [(STEP_SRC, _COLUMN_CALL, "sc, NoSpheres{}, part, g_dww);")],
            "no_f_sink": [(STEP_SRC, _COLUMN_CALL, "sc, AllSpheres{}, NoWinnerSink<T>{part}, g_dww);")],
            "store": [(STEP_SRC, r"(parts\[static_cast<long long>\(v\) \* n_cols \+ col\]) \+= s;", r"\1 = s;")],
            "clear_no_warp_sum": _CLEAR_NO_WARP_SUM,
            "clear_no_adjoint": _CLEAR_NO_ADJOINT,
        },
    ),
    # One row a CTA, the exact skip (the shipped layout).
    "rows": dict(
        markers=[(STEP_SRC, "constexpr int kStepRayWarps"), (CLEAR_SRC, "sig_is_zero(sharpness")],
        common=[],
        report=ptxas_report,
        stubs={
            "no_c_sink": [
                (STEP_SRC, r"(auto put = \[&\]\(int k, const T \(&gk\)\[4\]\) \{)\n\s*for \(int c = 0; c < 4; "
                           r"\+\+c\) \{\n\s*const T s = warp_sum\(valid \? gk\[c\] : T\(0\)\);\n"
                           r"\s*if \(lane == 0\) red\[.*?\n\s*\}", r"\1"),
                (STEP_SRC, r"(\n      __syncthreads\(\);)\n      // Thread x finishes.*?(\n      buf \^= 1;)", r"\1\2"),
            ],
            "no_c": [(STEP_SRC, r"\n    int buf = 0;\n    for \(int g = 0; g < groups; \+\+g\) \{.*?\n      buf \^= 1;\n    \}",
                      "")],
            "no_f_sink": [(STEP_SRC, r"\n    // Phase F: each distinct winner[^\n]*\n.*?\n    winner_rows_add\([^\n]*\n",
                           "\n")],
            "store": [
                (STEP_SRC, r"out = r == 0 \? v : out \+ v;", "out = v;"),
                (STEP_SRC, r"rm\[c\] \+= sum\[c\];", "rm[c] = sum[c];"),
            ],
            "clear_no_warp_sum": _CLEAR_NO_WARP_SUM,
            "clear_no_adjoint": _CLEAR_NO_ADJOINT,
            **{f"split{k}": [(STEP_SRC, r"constexpr int kStepSplit = \d+;", f"constexpr int kStepSplit = {k};")]
               for k in (2, 4)},
            # Up to 1024 rows (CTAs) in place of 4096, the source's and the
            # wrapper's cap: four rounds a CTA on the 3-sphere 960x540 case.
            "rows1024": [(STEP_SRC, r"constexpr int kStepMaxRows = \d+;", "constexpr int kStepMaxRows = 1024;"),
                         ("ops/bounce_smooth_sub.py", r"STEP_MAX_ROWS = \d+", "STEP_MAX_ROWS = 1024")],
        },
    ),
}
STUBS = ("no_c_sink", "no_c", "no_f_sink", "store", "clear_no_warp_sum", "clear_no_adjoint")


def layout_of(tree: Path) -> str:
    """The layout whose markers ``tree``'s sources hold."""
    from .splits import layout_of as find

    return find(tree, LAYOUTS)


def _step_args(builder: str, spheres: int | None, width: int, height: int, device: str = "cuda"):
    """smooth_bwd_step's arguments on the second bounce of a scene's chain
    (the state from smooth_fwd_step, seeded cotangents), and its keywords."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    build = getattr(scenes, f"{builder}_scene")
    dims = (width, height) if spheres is None else (spheres, width, height)
    scene = build(*dims, dtype=torch.float32, device=device)
    cfg = RenderConfig(max_depth=2, dtype=torch.float32, visibility="smooth", use_pallas=True)
    o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, torch.float32), scene,
                                          cfg)
    kw.pop("depth")
    ones = torch.ones_like(d[0])
    state = tuple(t.contiguous() for t in bss.smooth_fwd_step(o, d, ones, ones, torch.zeros_like(d), *tables, **kw)[:5])
    fwd = bss.smooth_fwd_step(*state, *tables, **kw)
    gen = torch.Generator(device).manual_seed(2)
    cots = [torch.rand(t.shape, generator=gen, device=device, dtype=t.dtype) - 0.5 for t in fwd[:5]]
    return (*state[:4], *fwd[5:8], *tables, *cots), kw


def _clear_rank(path: str, size: tuple[int, int] = CLEAR_SIZE, device: str = "cuda") -> None:
    """One of two ranks (spawned by run_local): config 4's smooth loss at
    ``size`` (960x540; the golden's image is the target there, else its
    top-left corner) on sphere shard (1, 2); rank 0 saves its first
    bounce's clear_bwd call (the last one the backward makes) to ``path``."""
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
    image = np.load(repo / CLEAR_GOLDEN)["image"][: size[1], : size[0]]  # (H, W, 3) uint8
    target = torch.as_tensor(image / 255.0, dtype=torch.float32, device=device)
    cfg = RenderConfig(max_depth=CLEAR_DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
    calls, real = [], smooth_parts.clear_bwd
    smooth_parts.clear_bwd = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
    try:
        params = scene_to_params(scene)
        make_loss_fn(scene, target, cfg, mesh)(params).backward()
    finally:
        smooth_parts.clear_bwd = real
    if mesh.spheres.index == 0:
        args, kw = calls[-1]
        torch.save(([a.detach() for a in args], kw), path)


def _record(path: Path) -> None:
    """In the as-is copy's process: every case's inputs, saved to ``path``."""
    import torch

    from python_ray_tracer_tpu_torch.parallel.distributed import run_local

    records = {"smooth_bwd_step": {case: _step_args(*spec) for case, spec in STEP_CASES.items()}}
    clear_path = path.with_name("clear_bwd.pt")
    run_local(_clear_rank, 2, str(clear_path))
    records["clear_bwd"] = {"config 4 sphere shard 0 of 2, 960x540": torch.load(clear_path, map_location="cuda")}
    for case, (args, kw) in records["smooth_bwd_step"].items():
        print(json.dumps({"kernel": "smooth_bwd_step", "case": case, "rays": args[1].shape[1],
                          "spheres": args[7].shape[0]}), flush=True)
    for case, (args, kw) in records["clear_bwd"].items():
        print(json.dumps({"kernel": "clear_bwd", "case": case, "rays": args[0].shape[0], "spheres": args[2].shape[0]}),
              flush=True)
    torch.save(records, path)


def _time_variant(label: str, inputs: Path) -> None:
    """In a variant's process (its copy first on sys.path): time the kernel
    it patches on every recorded case; one JSON line a case."""
    import torch
    from splits import median_ms  # this file's directory, not the copy's package (see .splits)

    from python_ray_tracer_tpu_torch.ops import _build
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss
    from python_ray_tracer_tpu_torch.ops import smooth_parts as sp

    records = torch.load(inputs, map_location="cuda", weights_only=False)
    kernels = {"smooth_bwd_step": bss.smooth_bwd_step, "clear_bwd": sp.clear_bwd}
    lib = _build.load_library("bounce_smooth_sub.cu")
    with torch.no_grad():
        for name, cases in records.items():
            if label != "as_is" and label.startswith("clear_") != (name == "clear_bwd"):
                continue
            for case, (args, kw) in cases.items():
                ms = median_ms(lambda a=args, k=kw: kernels[name](*a, **k))
                rec = {"variant": label, "kernel": name, "case": case, "ms": ms}
                if name == "smooth_bwd_step":
                    n, s = args[1].shape[1], args[7].shape[0]
                    # Resident CTAs an SM: the package's query, whose block size
                    # and shared bytes are the copy's own.
                    rec["blocks_per_sm"] = lib.prt_smooth_blocks_per_sm_f32(4, 0, s)
                    rec["ctas"] = bss.step_rows(n) if hasattr(bss, "step_rows") else -(-bss._n_cols(n) // 4)
                else:
                    rec["blocks_per_sm"] = _build.load_library("smooth_parts.cu").prt_clear_bwd_blocks_per_sm_f32(
                        args[2].shape[0])
                    rec["ctas"] = -(-args[0].shape[0] // 256)
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
