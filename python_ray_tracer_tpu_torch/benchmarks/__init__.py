"""Probes of the card, the counterparts of the JAX repository's ``benchmarks/``.

Each module carries the name of the JAX script it ports and runs as a
module: ``python -m python_ray_tracer_tpu_torch.benchmarks.<name>``.

* :mod:`.vpu_ceiling`: the op-mix ceiling (``benchmarks/vpu_ceiling.py``),
  the sustained rate of the fused train kernel's per-lane op mix;
* :mod:`.gather_probe`: material-row gathers (``benchmarks/gather_probe.py``)
  from global memory, shared memory and registers, beside torch's take.

A/B scripts of the port's own build variants (no JAX counterpart):
:mod:`.geometry_ab` (the smooth kernels' geometry staged or read from
global memory), :mod:`.gather_lanes` (the register gather's indices a
thread), and the splits :mod:`.bwd_cs_split` (``bwd_cs``),
:mod:`.smooth_bwd_split` (``smooth_bwd_step`` and ``clear_bwd``) and
:mod:`.fwd_cs_split` (``fwd_cs``'s shadow loop and skip) and
:mod:`.smooth_fwd_split` (``smooth_fwd_step``'s shadow product and winner
sweep, ``clear_fwd``'s product) and :mod:`.train_deep_split` (``train_deep``'s
sweeps, Phase C, sink and replay), which stub out one part of a kernel at a
time.  Each builds its variants in copies of the package made by
:func:`package_copy`; the splits share :mod:`.splits` (the builds, one
recording of the inputs, the timing turns, ``--tree``, the ptxas parser).
:mod:`.sweep_skip_ab` times the skips of the sweeps, ``bounce_lane``,
``fwd_cs``, ``clear_fwd``, ``smooth_fwd_step``, ``train_deep`` and
``smooth_nearest_parts`` off and on through the
wrappers' own ``skip`` switch (a template argument of the shipped source),
in one process, with their counts.  :mod:`.sass_diff` compares two
checkouts' kernels instruction by instruction (``cuobjdump -sass``).

An entry point runs on ``cuda`` unless ``--device cpu`` is given, and then
runs the plain versions at the size the caller gives; without a card it
fails.  Every figure it prints carries the card's name and power limit.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
OUT = PACKAGE.parent / "out"


def package_copy(root: Path, patches=(), source: Path = PACKAGE) -> Path:
    """A copy of the package directory ``source`` at ``root / source.name``
    (its build outputs and caches left out), with each ``(file, pattern,
    replacement)`` of ``patches`` applied to that file (a path inside the
    package) as one regular-expression substitution.  A pattern that does not
    match exactly once raises.  Returns ``root``: put it first on
    ``sys.path`` to import the copy."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(source, root / source.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for file, pattern, replacement in patches:
        path = root / source.name / file
        text, n = re.subn(pattern, replacement, path.read_text(), flags=re.DOTALL)
        if n != 1:
            raise RuntimeError(f"{pattern!r} matched {n} times in {path}, expected once")
        path.write_text(text)
    return root


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; ``cuda`` without a card raises (no fallback)."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device: expected cuda or cpu, got {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to run the plain versions)")
    return device


def card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or ``cpu``."""
    if device.type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()
    return smi[device.index or 0].strip()


def time_launches(fn, launches: int, reps: int) -> float:
    """Best over ``reps`` of the CUDA-event time of ``launches`` calls of
    ``fn``, per call, ms (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best

