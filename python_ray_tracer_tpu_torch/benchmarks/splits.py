"""What the split scripts share (:mod:`.bwd_cs_split`, :mod:`.smooth_bwd_split`).

A split builds variants of a kernel's source, each in a copy of the
package, and times each on the same recorded inputs in a process of its
own.  The script runs twice over: as a module it drives the turns
(:func:`run_split`); as a file (``python <script> --child ...``) it is one
variant's process, with the copy first on ``sys.path``.  A child must not
import this checkout's package, which would shadow the copy, so this
module imports nothing of the package at the top and a child takes it as
the top-level module ``splits`` (its own directory is on ``sys.path``).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path


def median_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median of ``iters`` CUDA-event timings of one call of ``fn``, ms
    (after ``warmup`` calls)."""
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


def ptxas_kernels(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each entry function in an nvcc
    ``-Xptxas -v`` log, keyed by its mangled name."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def layout_of(tree: Path, layouts: dict) -> str:
    """The layout whose markers ``tree``'s sources all hold: each layout's
    ``markers`` is a list of ``(file in the package, text)``."""
    found = [name for name, lay in layouts.items()
             if all(text in (tree / file).read_text() for file, text in lay["markers"])]
    if len(found) != 1:
        raise RuntimeError(f"{tree}: expected the markers of exactly one layout, found {found}")
    return found[0]


def run_split(argv: list[str], *, script: Path, out: Path, layouts: dict, default_variants: tuple[str, ...]) -> int:
    """The turns of a split script: ``--tree`` (the package directory to
    copy; default this one) picks the layout by its markers; each variant
    (``as_is`` and ``--variants``) is a copy of the package under ``out``
    with the layout's ``common`` patches and its own; the copies build in
    parallel; the as-is copy records the inputs once (``out/inputs.pt``);
    then each variant times them in its own process, in turns, ``as_is``
    first and last.  ``script --child ROOT LABEL build|record PATH|time PATH
    [ARGS]`` is the script's own child mode; ``build`` prints one JSON line
    with the build's ptxas log (``"log"``), which this process reads with the
    layout's ``report``; ``time`` gets the layout's ``time_args``."""
    import torch

    from . import PACKAGE, card_label, package_copy

    ap = argparse.ArgumentParser(prog=f"python -m python_ray_tracer_tpu_torch.benchmarks.{script.stem}")
    ap.add_argument("--tree", type=Path, default=PACKAGE, help="the package directory to copy (default: this one)")
    ap.add_argument("--variants", default=",".join(default_variants),
                    help="comma-separated variants beside as_is (default: the stubs)")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    name = layout_of(tree, layouts)
    layout = layouts[name]
    variants = ("as_is", *args.variants.split(","))
    unknown = [v for v in variants[1:] if v not in layout["stubs"]]
    if unknown:
        raise SystemExit(f"--variants: {unknown} not among {sorted(layout['stubs'])} for this layout")
    print(card_label(torch.device("cuda")), flush=True)
    print(f"[{script.stem}] {tree}: layout {name}", flush=True)
    roots = {v: package_copy(out / v, layout["common"] + layout["stubs"].get(v, []), source=tree) for v in variants}
    child = [sys.executable, str(script), "--child"]
    builds = {v: subprocess.Popen([*child, str(root), v, "build"], cwd=root, stdout=subprocess.PIPE, text=True)
              for v, root in roots.items()}
    for v, proc in builds.items():
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            return 1
        log = json.loads(stdout.strip().splitlines()[-1])["log"]
        print(json.dumps({"variant": v, "ptxas": layout["report"](log)}), flush=True)
    inputs = out / "inputs.pt"
    subprocess.run([*child, str(roots["as_is"]), "as_is", "record", str(inputs)], cwd=roots["as_is"], check=True)
    for v in (*variants, "as_is"):
        subprocess.run([*child, str(roots[v]), v, "time", str(inputs), *layout.get("time_args", [])], cwd=roots[v],
                       check=True)
    shutil.rmtree(out, ignore_errors=True)
    return 0
