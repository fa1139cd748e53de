"""Time ``gather_shuffle`` at 1, 2 and 4 indices a thread, on one CUDA card.

``csrc/gather_probe.cu``'s register gather takes ``kShuffleLanes`` indices
a thread: each piece of the table it loads then serves that many shuffles,
but a warp's ``32 x kShuffleLanes`` indices want more of the table's pieces.
This script builds the source once for each count, in copies of the
package (:func:`.package_copy`) under ``out/gather_lanes/`` of the
checkout, and times each copy's ``gather_shuffle`` at the probe's stage-2
shape (2,097,152 rays x 1024 spheres x 12 channels, best of 3 x 50
launches, after a bitwise check against the plain take), each count in its
own process, in turns (1, 2, 4, 4, 2, 1)::

    python -m python_ray_tracer_tpu_torch.benchmarks.gather_lanes
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

# Run as a script in each copy's process too (the copy first on sys.path),
# so nothing of the package is imported at the top.
OUT = Path(__file__).resolve().parents[2] / "out" / "gather_lanes"
LANES = (1, 2, 4)
ORDER = LANES + LANES[::-1]


def _time(lanes: int) -> None:
    """In a copy's process: the bitwise check, then the timing, one JSON line."""
    import torch

    from python_ray_tracer_tpu_torch.benchmarks import gather_probe as gp
    from python_ray_tracer_tpu_torch.benchmarks import time_launches

    table, idx = gp.stage2_inputs(gp.RAYS, device="cuda")
    if not torch.equal(gp.gather_shuffle(table, idx), gp.gather_plain(table, idx)):
        raise AssertionError(f"gather_shuffle at {lanes} lanes a thread differs from the plain take")
    ms = time_launches(lambda: gp.gather_shuffle(table, idx), gp.TIMED_LAUNCHES, gp.TIMED_REPS)
    ctas, per_sm = gp.shuffle_launch(idx.numel())
    print(json.dumps({"lanes_a_thread": lanes, "ms": ms, "ctas": ctas, "blocks_per_sm": per_sm,
                      "rays": gp.RAYS, "spheres": gp.SPHERES, "chans": gp.CHANS}), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:  # --child ROOT LANES (build | time)
        sys.path.insert(0, argv[1])
        from python_ray_tracer_tpu_torch.ops import _build

        _build.build_all(("gather_probe.cu",))
        if argv[3] == "time":
            _time(int(argv[2]))
        return 0
    from . import package_copy

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = {n: package_copy(OUT / f"lanes{n}", [("csrc/gather_probe.cu", r"constexpr int kShuffleLanes = \d+;",
                                                  f"constexpr int kShuffleLanes = {n};")]) for n in LANES}
    child = [sys.executable, str(Path(__file__).resolve()), "--child"]
    builds = [subprocess.Popen([*child, str(root), str(n), "build"], cwd=root) for n, root in roots.items()]
    if any(p.wait() != 0 for p in builds):
        return 1
    for n in ORDER:
        subprocess.run([*child, str(roots[n]), str(n), "time"], cwd=roots[n], check=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
