"""Split ``bwd_cs``'s time on one CUDA card by stubbing out one part at a time.

``ncu`` does not run on the card's machine, so this script measures what
holds the culled smooth backward kernel (``csrc/culled_smooth.cu``
``bwd_cs``) the way :mod:`.geometry_ab` measures the geometry layout: it
builds variants of the source, each in a copy of the package
(:func:`.package_copy`) under ``out/bwd_cs_split/`` of the checkout, and
times each variant's ``bwd_cs`` on the same recorded inputs:

* every bounce of config 4's smooth loss (``random1024``, 1920x1080,
  depth 3, f32, mirror), the row 17 launches of the config-4 step;
* every bounce of the ``textured1024`` loss at 960x540 (the atlas mode).

Variants are text patches of a copy, never switches in the shipped source:

``as_is``      the source as it is;
``no_c_sink``  Phase C's table-gradient sink removed (the shadow spheres'
               four values a sphere), its math kept;
``no_f_sink``  Phase F's sink removed (the winner's 15 material values);
``no_g_sink``  Phase G's sink removed (the 10 scene constants);
``no_c``       Phase C removed whole: its math and its sink.

On the CTA-split layout ``--variants`` also takes four layouts beside the
shipped one (``__launch_bounds__`` asking for 4 resident CTAs an SM, which
caps the registers at 128, and rounds of 4 rays a thread): ``nocap``,
``min3`` and ``min5`` (1, 3 or 5 CTAs an SM asked for) and ``batch2``
(rounds of 2 rays).

``bwd_cs`` recomputes its bounce from the saved shadow product (``clear``;
``Winner::kSaved``), so it runs no forward shadow product to stub out.

Beside each variant's times the script prints ptxas's registers and spill
bytes of every ``bwd_cs`` instantiation (nvcc ``-Xptxas -v``, as the package
builds), the resident blocks per SM the occupancy API gives at the launch's
dynamic shared bytes, and the CTAs a launch runs.  The stubbed variants'
outputs are wrong by design; only their times are read.  The recorded
inputs are taken once, with the source as it is, and saved under
``out/bwd_cs_split/``; each variant runs in its own process, in turns
(``as_is`` first and last)::

    python -m python_ray_tracer_tpu_torch.benchmarks.bwd_cs_split [--tree PACKAGE_DIR] [--variants a,b,...]

``--tree`` takes the package directory of another checkout (for example a
parent commit unpacked with ``git archive``) in place of this one; the
patches are chosen by the layout its ``bwd_cs`` source has.  The builds,
the recording and the turns are :func:`.run_split`'s.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

# This file also runs as a script in each variant's process (with the
# copy first on sys.path), so it imports nothing of the package at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "bwd_cs_split"
SOURCE = "csrc/culled_smooth.cu"
SPHERES, DEPTH = 1024, 3
CASES = {"config4": (1920, 1080, "random_spheres"), "textured1024_atlas": (960, 540, "textured_spheres")}

# The occupancy query of a layout whose source has none: bwd_cs's resident
# blocks per SM at its launch's dynamic shared bytes (or -error).
_OCCUPANCY_ENTRY = r"""\1
namespace {
template <typename T> int split_occupancy(int glossy, int atlas, int s_total) {
  const int smem = geom_consts_smem<T>(s_total);
  const auto kernel = glossy ? (atlas ? bwd_cs<T, true, true> : bwd_cs<T, true, false>)
                             : (atlas ? bwd_cs<T, false, true> : bwd_cs<T, false, false>);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
}  // namespace
extern "C" int prt_bwd_cs_blocks_per_sm_f32(int glossy, int atlas, int s_total) {
  return split_occupancy<float>(glossy, atlas, s_total);
}
extern "C" int prt_bwd_cs_blocks_per_sm_f64(int glossy, int atlas, int s_total) {
  return split_occupancy<double>(glossy, atlas, s_total);
}
"""

# Each layout of bwd_cs: a marker its source holds, the CTAs a tile runs
# (None: the wrapper's BWD_CTAS_PER_TILE), the patches every variant takes
# and each stub's.
LAYOUTS = {
    # One CTA of 256 threads per 4096-ray tile; each warp's lane 0 adds its
    # shuffle sums into the warp's rows (TileSink), per ray and listed sphere.
    "tile_cta": dict(
        markers=[(SOURCE, "template <typename T> struct TileSink")],
        time_args=["1"],
        report=lambda log: ptxas_report(log),
        common=[(SOURCE, r"(const char\* prt_error_string\(int err\) \{[^}]*\}\n\n\}  // extern \"C\"\n)",
                 _OCCUPANCY_ENTRY)],
        stubs={
            "no_c_sink": [(SOURCE, r"(void geom\(int slot, int, int c, T x\) const \{)[^}]*\}", r"\1}")],
            "no_f_sink": [(SOURCE, r"(void winner\(const Scal<T>& sc, int idx, const T \(&rows\)\[kMatGrads\]\) const \{)"
                                   r".*?(\n  \}\n  __device__ __forceinline__ void consts)", r"\1\2")],
            "no_g_sink": [(SOURCE, r"(void consts\(const Scal<T>&, int c, T x\) const \{)[^}]*\}", r"\1}")],
            "no_c": [
                (SOURCE, r"(// adjoint_bounce's sink in bwd_cs)",
                 "struct NoSpheres {\n  template <typename T, typename F> __device__ void visit(const Scal<T>&, F&&) "
                 "const {}\n};\n\n\\1"),
                (SOURCE, r"s_cst, sc, shadow, sink,", "s_cst, sc, NoSpheres{}, sink,"),
            ],
        },
    ),
    # BWD_CTAS_PER_TILE CTAs of 128 threads per tile, Phase C slot-outer
    # over a round of rays, one row per CTA (the shipped layout).
    "cta_split": dict(
        markers=[(SOURCE, "constexpr int kBwdCtasPerTile")],
        time_args=["None"],
        report=lambda log: ptxas_report(log),
        common=[],
        stubs={
            "no_c_sink": [(SOURCE, r"\n      T\* red = scratch \+ buf .*?\n        buf \^= 1;\n      \}", "")],
            "no_f_sink": [(SOURCE, r"\n      // Phase F: each distinct winner of the warp once\..*?(\n    \}\n  \}\n\n  // Phase G)",
                           r"\1")],
            "no_g_sink": [(SOURCE, r"\n  // Phase G: the CTA's sums of the scene constants.*?\n    row_c\[x\] = v;\n  \}", "")],
            "no_c": [(SOURCE, r"\n    shadow\.visit\(sc, \[&\]\(int slot, int k\) \{.*?\n    \}\);", "")],
            # Layouts beside the shipped one (--variants): the launch bounds
            # asking for 1 (no register cap), 3 or 5 resident CTAs an SM in
            # place of 4, and rounds of 2 rays a thread in place of 4.
            **{name: [(SOURCE, r"constexpr int kBwdMinBlocks = \d+;", f"constexpr int kBwdMinBlocks = {blocks};")]
               for name, blocks in (("nocap", 1), ("min3", 3), ("min5", 5))},
            "batch2": [(SOURCE, r"constexpr int kBwdBatch = 4;", "constexpr int kBwdBatch = 2;")],
        },
    ),
}
STUBS = ("no_c_sink", "no_f_sink", "no_g_sink", "no_c")


def layout_of(tree: Path) -> str:
    """The layout whose marker ``tree``'s bwd_cs source holds."""
    from .splits import layout_of as find

    return find(tree, LAYOUTS)


def ptxas_report(log: str) -> dict[str, dict]:
    """:func:`ptxas_kernels` of each bwd_cs instantiation, keyed
    ``"f32"``/``"f64"`` + ``" glossy"`` + ``" atlas"``."""
    from .splits import ptxas_kernels

    out = {}
    for name, rec in ptxas_kernels(log).items():
        t = re.search(r"bwd_csI([fd])Lb([01])ELb([01])E", name)
        if t:
            key = ("f32" if t.group(1) == "f" else "f64") + (" glossy" if t.group(2) == "1" else "") + (
                " atlas" if t.group(3) == "1" else "")
            out[key] = rec
    return out


def _record(path: Path) -> None:
    """In the as-is copy's process: each case's bwd_cs calls in a weighted-sum
    loss's backward, saved to ``path``."""
    import torch

    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.camera import ray_directions_t
    from python_ray_tracer_tpu_torch.models import scenes
    from python_ray_tracer_tpu_torch.ops import culled_smooth
    from python_ray_tracer_tpu_torch.optim import combine, scene_to_params

    records = {}
    real = culled_smooth.bwd_cs
    for case, (width, height, builder) in CASES.items():
        scene = getattr(scenes, f"{builder}_scene")(SPHERES, width, height, dtype=torch.float32, device="cuda")
        params = scene_to_params(scene)
        sc = combine(params, scene)
        cfg = RenderConfig(max_depth=DEPTH, dtype=torch.float32, visibility="smooth", use_pallas=True)
        weight = torch.rand((width * height, 3), generator=torch.Generator("cuda").manual_seed(4), device="cuda")
        calls = []
        culled_smooth.bwd_cs = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
        try:
            img = culled_smooth.trace_culled_smooth(sc.camera.position, ray_directions_t(sc.camera, torch.float32), sc,
                                                    cfg)
            torch.sum(img * weight).backward()
        finally:
            culled_smooth.bwd_cs = real
        records[case] = calls[::-1]  # bounce order
        for b, (a, kw) in enumerate(records[case]):
            tiles = a[8].numel()
            print(json.dumps({"case": case, "bounce": b, "tiles": tiles, "rays": a[0].shape[1],
                              "shadow_list_mean": float((a[8] + a[9]).float().mean()),
                              "shadow_list_max": int((a[8] + a[9]).max()),
                              "nearest_list_mean": float((a[11] + a[12]).float().mean())}), flush=True)
    torch.save(records, path)


def _time_variant(label: str, inputs: Path, ctas_per_tile: int | None) -> None:
    """In a variant's process (its copy first on sys.path): time its bwd_cs
    on every recorded call; one JSON line a call."""
    import torch

    from splits import median_ms  # this file's directory, not the copy's package (see .splits)

    from python_ray_tracer_tpu_torch.ops import _build
    from python_ray_tracer_tpu_torch.ops import culled_smooth as cs

    lib = _build.load_library("culled_smooth.cu")
    per_tile = cs.BWD_CTAS_PER_TILE if ctas_per_tile is None else ctas_per_tile
    records = torch.load(inputs, map_location="cuda")
    with torch.no_grad():
        for case, calls in records.items():
            for b, (args, kw) in enumerate(calls):
                n, s, atlas = args[0].shape[1], args[13].shape[0], kw.get("g_dww") is not None
                ms = median_ms(lambda a=args, k=kw: cs.bwd_cs(*a, **k))
                blocks = lib.prt_bwd_cs_blocks_per_sm_f32(0, int(atlas), s)
                print(json.dumps({"variant": label, "case": case, "bounce": b, "ms": ms, "blocks_per_sm": blocks,
                                  "ctas": n // kw["tile_rays"] * per_tile, "rays": n}), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT LABEL (build | record PATH | time PATH CTAS)
        sys.path.insert(0, argv[1])
        from python_ray_tracer_tpu_torch.ops import _build

        _, log, _ = _build.build_all(("culled_smooth.cu",))["culled_smooth.cu"]
        if argv[3] == "build":
            print(json.dumps({"variant": argv[2], "log": log}), flush=True)
        elif argv[3] == "record":
            _record(Path(argv[4]))
        else:
            _time_variant(argv[2], Path(argv[4]), None if argv[5] == "None" else int(argv[5]))
        return 0
    from .splits import run_split

    return run_split(argv, script=Path(__file__).resolve(), out=OUT, layouts=LAYOUTS, default_variants=STUBS)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
