"""Split ``train_deep``'s time on one CUDA card by stubbing out one part at a time.

``train_deep`` (``csrc/bounce_smooth_sub.cu``, kernel-table row 12) runs the
whole L2 training step of a ray in one launch: the forward chain (each
bounce a winner sweep and a shadow product over the sphere table,
``fwd_bounce`` of ``csrc/smooth_math.cuh``), the loss cotangent, and the
reverse adjoint (``adjoint_bounce``: Phase C, the shadow product's adjoint,
visits the table again), with the table gradients handed to a sink.  As
:mod:`.smooth_fwd_split` and :mod:`.smooth_bwd_split` do for the one-bounce
pair, this script builds variants of the sources, each in a copy of the
package (:func:`.package_copy`) under ``out/train_deep_split/`` of the
checkout, and times each variant on the same recorded launches:

* config 5's: ``inverse_task_scene(1024)``, 256x144, depth 3, f32, mirror;
* the 3-sphere reference launch (``reference_scene``) at 960x540, depth 3,
  f32, mirror and glossy (seed 7).

Variants are text patches of a copy, never switches in the shipped source:

``no_winner``  the forward winner sweep removed (every lane takes sphere 0 as
               a miss), as in :mod:`.smooth_fwd_split`;
``no_shadow``  the forward shadow product removed (``clear`` = 1);
``no_c``       Phase C removed from the adjoint (no shadow sphere's terms,
               and in the row layout no chunk's barrier);
``no_sink``    the sink discards its values (the column partials' warp sums
               and read-modify-writes, and the winner rows' loop over every
               sphere; in the row layout Phase C's warp sums and flushes and
               Phase F's rows), gone with the values only they read;
``regs``       the replay state held in registers rather than the per-thread
               ``saved[]`` array: four entries, loops unrolled, the depth a
               runtime bound inside them (every input here is depth 3; the
               column layout only, through ``--variants``).

The stubbed variants' outputs are wrong by design; only their times are
read.  Beside the times: ptxas's registers and spill bytes of each
instantiation of ``train_deep`` and its resident CTAs per SM::

    python -m python_ray_tracer_tpu_torch.benchmarks.train_deep_split [--tree PACKAGE_DIR] [--variants a,b,...]

(the parent's split: ``--tree`` its package, ``--variants
no_winner,no_shadow,no_c,no_sink,regs``)

``--tree`` takes the package directory of another checkout (the parent
commit unpacked with ``git archive``); its layout (``columns``: the column
partials of the parent; ``rows``: one row of table gradients a CTA and the
skips) is read from its sources, and where the wrapper takes ``skip`` each
variant is timed with it off and on.  The builds, the recording and the
turns are :func:`.run_split`'s.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

# This file also runs as a script in each variant's process (with the
# copy first on sys.path), so it imports nothing of the package at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "train_deep_split"
SRC, SMOOTH_MATH, WRAPPER = "csrc/bounce_smooth_sub.cu", "csrc/smooth_math.cuh", "ops/bounce_smooth_sub.py"
# The parent's wrapper, which takes no skip.
_COLUMN_SIGNATURE = ("def train_deep(o, d, tgt, geom, mat, consts, xi=None, *, depth, faraway, s_cheap, sharp_e, "
                     "sharp_s):")
SOURCES = ("bounce_smooth_sub.cu",)
C5_SPHERES, C5_SIZE, REF_SIZE, DEPTH, SEED = 1024, (256, 144), (960, 540), 3, 7

# fwd_bounce's winner sweep and shadow product (smooth_fwd_split's stubs),
# and adjoint_bounce's Phase C: the same text in both layouts.
_COMMON_STUBS = {
    "no_winner": [(SMOOTH_MATH, r"(    int idmax = 0;\n).*?(\n    f\.hit = tmin != sc\.faraway;)", r"\1\2")],
    "no_shadow": [(SMOOTH_MATH, r"  if \(kWin != Winner::kSaved\) \{",
                   "  if (kWin != Winner::kSaved) f.clear = T(1);\n  if (false) {")],
    "no_c": [(SMOOTH_MATH, r"  shadow\.visit\(sc, \[&\]\(int slot, int k\) \{\n.*?\n  \}\);\n", "")],
}

# The parent's column partials: the sink's add and winner bodies, and the
# replay array with its two depth loops.
_COLUMN_STUBS = {
    "no_sink": [(SRC, r"(  __device__ __forceinline__ void add\(int v, T x\) const \{\n).*?(\n  \}\n)", r"\1\2"),
                (SRC, r"(  __device__ __forceinline__ void winner\(const Scal<T>& sc, int idx, "
                      r"const T \(&rows\)\[15\]\) const \{\n).*?(\n  \}\n)", r"\1\2")],
    "regs": [(SRC, r"Replay<T> saved\[kMaxTrainDepth\];(.*?)for \(int dep = 0; dep < depth; \+\+dep\) \{\n"
                   r"(.*?)for \(int dep = depth - 1; dep >= 0; --dep\) \{\n",
              "Replay<T> saved[4];\\1#pragma unroll\n    for (int dep = 0; dep < 4; ++dep) {\n"
              "      if (dep >= depth) break;\n\\2#pragma unroll\n    for (int dep = 3; dep >= 0; --dep) {\n"
              "      if (dep >= depth) continue;\n")],
}


def ptxas_report(log: str) -> dict[str, dict]:
    """:func:`.splits.ptxas_kernels` of each instantiation of ``train_deep``,
    keyed by dtype and the template flags that are set (``<T, kXi,
    kStaged>`` in the column layout, ``<T, kXi, kStaged, kSkip>`` in the row
    one)."""
    from .splits import ptxas_kernels

    out = {}
    for name, rec in ptxas_kernels(log).items():
        m = re.search(r"train_deepI([fd])((?:Lb[01]E)+)", name)
        if not m:
            continue
        flags = re.findall(r"Lb([01])E", m.group(2))
        key = " ".join(["train_deep", "f32" if m.group(1) == "f" else "f64"]
                       + [n for n, f in zip(("glossy", "staged", "skip"), flags) if f == "1"])
        out[key] = rec
    return out


LAYOUTS = {
    # The parent: one warp a column of (23 S + 17)-value partials.
    "columns": dict(markers=[(SRC, "Replay<T> saved[kMaxTrainDepth];"), (WRAPPER, _COLUMN_SIGNATURE)], common=[],
                    report=ptxas_report, stubs={**_COMMON_STUBS, **_COLUMN_STUBS}),
    # One row of table gradients a CTA, the skips (the shipped layout).
    "rows": dict(markers=[(SRC, "__launch_bounds__(kStepThreads)\n    train_deep(")], common=[], report=ptxas_report,
                 stubs={
        **{k: _COMMON_STUBS[k] for k in ("no_winner", "no_shadow")},
        "no_c": [(SRC, r"\n      for \(int k0 = 0; k0 < S; k0 \+= kStepChunk\) \{  // uniform over the CTA\n.*?"
                       r"\n      \}\n(\n      // --- Phases D-E)", r"\1")],
        "no_sink": [(SRC, r"(auto put = \[&\]\(int k, const T \(&gk\)\[4\]\) \{\n)          for \(int c = 0; "
                          r"c < 4; \+\+c\) \{\n[^\n]*\n            if \(lane == 0\) slots\[[^\n]*\n"
                          r"          \}\n[^\n]*\n", r"\1"),
                    (SRC, r"\n      // Phase F: each distinct winner[^\n]*\n.*?\n      winner_rows_add\([^\n]*\n", "\n")],
    }),
}
# The default variants, both layouts'; the column layout also takes ``regs``.
STUBS = ("no_winner", "no_shadow", "no_c", "no_sink")


def _calls(scene, cfg, key=None) -> list:
    """train_deep's launch in one L2 loss of ``scene`` through the fused
    route (``fused_train_l2``), the target 0.9 times the smooth frame."""
    import torch

    from python_ray_tracer_tpu_torch import render
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    calls, real = [], bss.train_deep
    bss.train_deep = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
    try:
        with torch.no_grad():
            target = (torch.clamp(render(scene, cfg), 0.0, 1.0) * 0.9).reshape(-1, 3)
            bss.fused_train_l2(scene.camera.position, ray_directions_t(scene.camera, cfg.dtype), target, scene, cfg,
                               key=key)
    finally:
        bss.train_deep = real
    return [([a.detach() if isinstance(a, torch.Tensor) else a for a in args], kw) for args, kw in calls]


def _record(path: Path) -> None:
    """In the as-is copy's process: the three launches, saved to ``path``."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.models.scenes import inverse_task_scene, reference_scene
    from python_ray_tracer_tpu_torch.ops.rng import fold_seed, seed_root

    def cfg(**kw):
        return RenderConfig(max_depth=DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True, **kw)

    ref = reference_scene(*REF_SIZE, dtype=torch.float32, device="cuda")
    records = {
        "config 5": _calls(inverse_task_scene(C5_SPHERES, *C5_SIZE, dtype=torch.float32, device="cuda"), cfg()),
        "3 spheres mirror": _calls(ref, cfg()),
        "3 spheres glossy": _calls(ref, cfg(stochastic_roughness=True, rng_seed=SEED),
                                   fold_seed(fold_seed(seed_root(SEED), 0), 0)),
    }
    for case, calls in records.items():
        if len(calls) != 1:
            raise RuntimeError(f"{case}: expected one train_deep launch, recorded {len(calls)}")
        args, kw = calls[0]
        print(json.dumps({"case": case, "rays": args[1].shape[1], "spheres": args[3].shape[0],
                          "s_cheap": kw["s_cheap"], "glossy": args[6] is not None}), flush=True)
    torch.save(records, path)


def _time_variant(label: str, inputs: Path) -> None:
    """In a variant's process (its copy first on sys.path): time train_deep
    on every recorded launch, skip off and on where the wrapper takes the
    switch; one JSON line a launch."""
    import inspect

    import torch
    from splits import median_ms  # this file's directory, not the copy's package (see .splits)

    from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss

    records = torch.load(inputs, map_location="cuda", weights_only=False)
    skips = ("off", "on") if "skip" in inspect.signature(bss.train_deep).parameters else (None,)
    with torch.no_grad():
        for case, [(args, kw)] in records.items():
            ms = {str(s): median_ms(lambda s=s: bss.train_deep(*args, **kw, **({} if s is None else {"skip": s})))
                  for s in skips}
            glossy, s = args[6] is not None, args[3].shape[0]
            blocks = {str(k): bss.blocks_per_sm("train_deep", torch.float32, glossy, s,
                                                **({} if k is None else {"skip": k == "on"})) for k in skips}
            print(json.dumps({"variant": label, "case": case, "ms": ms, "blocks_per_sm": blocks}), flush=True)


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
