"""Compare two checkouts' kernels instruction by instruction (``cuobjdump -sass``).

A redesign that adds a template flag to shared device code (``fwd_bounce``'s
``kSkip``) should leave the kernels that do not set it as they were.  This
script builds the given sources of this package and of another checkout's
package (``--tree``: the parent commit unpacked with ``git archive``), each
in a copy under ``out/sass_diff/`` of the checkout (:func:`.package_copy`),
disassembles each library with ``cuobjdump -sass`` (beside ``nvcc``), and
prints for every kernel of this tree whether its instructions are the other
tree's, the address and encoding columns left out.  A kernel is matched by
its mangled name, or else by that name less a last template flag that is
false (``Lb0E``: a new defaulted flag off), and is reported as new where
neither exists::

    python -m python_ray_tracer_tpu_torch.benchmarks.sass_diff --tree out/parent/python_ray_tracer_tpu_torch \\
        [--sources bounce_smooth_sub.cu,culled_smooth.cu,smooth_parts.cu]

It needs ``nvcc`` and ``cuobjdump``, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from . import OUT, PACKAGE, package_copy

SOURCES = ("bounce_smooth_sub.cu", "culled_smooth.cu", "smooth_parts.cu")


def cuobjdump() -> str:
    """``cuobjdump`` from PATH, else beside ``nvcc`` ($CUDA_HOME or /usr/local/cuda)."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not path.exists():
        raise RuntimeError("cuobjdump not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda)")
    return str(path)


def build(tree: Path, label: str, sources: tuple[str, ...]) -> dict[str, Path]:
    """The libraries of ``sources`` built from a copy of the package ``tree``,
    in a process of their own (the copy first on sys.path)."""
    root = package_copy(OUT / "sass_diff" / label, source=tree)
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from python_ray_tracer_tpu_torch.ops import _build; "
            "print(json.dumps({s: str(p) for s, (p, _, _) in _build.build_all(tuple(sys.argv[2:])).items()}))")
    out = subprocess.run([sys.executable, "-c", code, str(root), *sources], cwd=root, check=True, capture_output=True,
                         text=True).stdout
    return {s: Path(p) for s, p in json.loads(out.strip().splitlines()[-1]).items()}


def kernels(library: Path) -> dict[str, list[str]]:
    """Each function's instructions in a library, keyed by mangled name less
    the anonymous namespace's prefix (which nvcc derives from the file)."""
    text = subprocess.run([cuobjdump(), "-sass", str(library)], check=True, capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = out.setdefault(re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1)), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and current is not None:
            current.append(m.group(1))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m python_ray_tracer_tpu_torch.benchmarks.sass_diff")
    ap.add_argument("--tree", type=Path, required=True, help="the other checkout's package directory")
    ap.add_argument("--sources", default=",".join(SOURCES))
    args = ap.parse_args(argv)
    sources = tuple(args.sources.split(","))
    ours, theirs = build(PACKAGE, "this", sources), build(args.tree.resolve(), "other", sources)
    same = differ = new = 0
    for source in sources:
        mine, other = kernels(ours[source]), kernels(theirs[source])
        for name, code in sorted(mine.items()):
            match = name if name in other else re.sub(r"Lb0E(E+v)", r"\1", name, count=1)
            if match not in other:
                new += 1
                print(f"[sass_diff] {source} {name}: new ({len(code)} instructions)", flush=True)
                continue
            if code == other[match]:
                same += 1
                print(f"[sass_diff] {source} {name}: identical ({len(code)} instructions)", flush=True)
            else:
                differ += 1
                changed = sum(a != b for a, b in zip(code, other[match])) + abs(len(code) - len(other[match]))
                print(f"[sass_diff] {source} {name}: differs ({len(code)} instructions against {len(other[match])}, "
                      f"{changed} lines changed)", flush=True)
    print(f"[sass_diff] {same} kernels identical, {differ} differ, {new} new", flush=True)
    shutil.rmtree(OUT / "sass_diff", ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
