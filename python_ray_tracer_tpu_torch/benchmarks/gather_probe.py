"""The material-gather probe: three ways a kernel can read a winner's material row.

Port of the JAX repository's ``benchmarks/gather_probe.py``.  Its TPU
kernels, all launched through ``_call``, become three CUDA kernels in
``csrc/gather_probe.cu``, one per strategy, each computing

    out[c, r, l] = table[c, abs(idx[r, l]) % S]

for a (C, S) f32 table (JAX's ``mat_t``: the first 12 columns of an
(S, 16) material table, transposed) and int32 indices of any shape:

* :func:`gather_global`: each thread reads its C values from global memory,
  as ``shade_culled`` reads the winner's row today;
* :func:`gather_shared`: each block stages the table in shared memory (the
  counterpart of JAX's direct gather ``kern_d``);
* :func:`gather_shuffle`: the register gather, the 32-entry pieces of the
  table that a lane of the warp wants held one value a lane and taken with
  warp shuffles (the counterpart of JAX's piecewise ``kern``).

:func:`gather_plain` is torch's advanced indexing; torch's own take
(:func:`library_take`, ``index_select``) is the counterpart of JAX's
``xla_take`` and is timed beside the kernels, never used by the port.  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.

Stage 1 holds every kernel to the five ``take_along_axis`` shapes of JAX's
``stage1()`` (:func:`take_along_axis` over the kernels; the sublane case
transposes).  Stage 2 is the material take at config-4 scale (S = 1024
spheres, 2,097,152 rays, 12 channels): each kernel bitwise equal to the
library take (a gather does not round), then each timed as JAX's
``_timeit`` does, 50 launches, best of 3, here with CUDA events, beside the
bytes bound.  A kernel that fails to build, launch or match raises: the run
exits non-zero.

    python -m python_ray_tracer_tpu_torch.benchmarks.gather_probe [--stage 1|2|all] [--rays N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _build
from . import card_label, resolve_device, time_launches

KERNELS = ("gather_global", "gather_shared", "gather_shuffle")
LAUNCHES = dict.fromkeys(KERNELS, 0)
CHANS, SPHERES, RAYS = 12, 1024, 2 * 1024 * 1024
# JAX's _timeit: launches a timed call, best of this many calls.
TIMED_LAUNCHES, TIMED_REPS = 50, 3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's datasheet)

_SOURCE = "gather_probe.cu"
# C signature of prt_gather_<kernel>_f32 before the trailing stream: table,
# idx, out; chans, S, lanes.
_SIGNATURE = "ppp" "iii"


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[:, abs(idx) % S]``, (C, *idx.shape)."""
    return table[:, (torch.abs(idx) % table.shape[1]).long()]


def library_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Torch's own take of in-range indices, one ``index_select`` call: the
    yardstick beside the kernels (JAX's ``xla_take``), not used by the port."""
    return torch.index_select(table, 1, idx.reshape(-1)).reshape(table.shape[0], *idx.shape)


def _gather(name: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table: expected a contiguous (C, S) float32 tensor, got {tuple(table.shape)} {table.dtype}")
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != table.device:
        raise ValueError(f"idx: expected contiguous int32 on {table.device}, got {idx.dtype} on {idx.device}")
    chans, s = table.shape
    if chans < 1 or s < 1 or not 0 < idx.numel() < 2**31 or chans * idx.numel() >= 2**31:
        raise ValueError(f"expected a non-empty table and 1 to 2**31 - 1 indices, got {tuple(table.shape)}, "
                         f"{idx.numel()} indices")
    if name == "gather_shared" and 4 * chans * s > _build.MAX_SHARED_BYTES:
        raise ValueError(f"gather_shared: a ({chans}, {s}) f32 table does not fit in {_build.MAX_SHARED_BYTES} B of "
                         "shared memory")
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    with torch.cuda.device(table.device):
        out = torch.empty((chans, *idx.shape), dtype=torch.float32, device=table.device)
        _build.launch(_SOURCE, name, _SIGNATURE, torch.float32, table, idx, out, chans, s, idx.numel())
        LAUNCHES[name] += 1
    return out


def gather_global(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, abs(idx) % S]``, each value read from global memory."""
    return _gather("gather_global", table, idx)


def gather_shared(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, abs(idx) % S]`` from a table staged in shared memory."""
    return _gather("gather_shared", table, idx)


def gather_shuffle(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[:, abs(idx) % S]`` by warp shuffles of 32-entry pieces."""
    return _gather("gather_shuffle", table, idx)


GATHERS = {"gather_global": gather_global, "gather_shared": gather_shared, "gather_shuffle": gather_shuffle}


def shuffle_launch(n: int) -> tuple[int, int]:
    """``(CTAs, resident CTAs per SM)`` of a ``gather_shuffle`` launch over
    ``n`` indices on the current card."""
    lib = _build.load_library(_SOURCE)
    blocks = lib.prt_gather_shuffle_blocks_per_sm()
    if blocks < 0:
        raise RuntimeError(f"occupancy query of gather_shuffle failed: CUDA error {-blocks}")
    return lib.prt_gather_shuffle_grid(n), blocks


def take_along_axis(gather, x: torch.Tensor, i: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take_along_axis(x, i, axis)`` of a 2-D ``x`` through one of the
    gathers, for indices in range: along axis 1 each row ``r`` takes from
    its own row of ``x`` (the gather over every row, then row ``r`` of
    table row ``r``); axis 0 transposes in and out."""
    if axis == 0:
        return take_along_axis(gather, x.T.contiguous(), i.T.contiguous(), 1).T
    if axis != 1 or x.dim() != 2 or i.dim() != 2 or i.shape[0] != x.shape[0]:
        raise ValueError(f"expected 2-D x and i with equal rows, axis 0 or 1; got {tuple(x.shape)}, {tuple(i.shape)}, {axis}")
    rows = torch.arange(x.shape[0], device=x.device)
    return gather(x.contiguous(), i.contiguous())[rows, rows]


# JAX's stage1() probes: (name, table rows x width, index rows x width,
# axis, JAX's constant index); axis None is the broadcast-row composite,
# one (1, S) table row gathered by every index.
STAGE1 = (
    ("lane_gather_8x128", (8, 128), (8, 128), 1, 0),
    ("lane_gather_8x1024", (8, 1024), (8, 1024), 1, 777),
    ("sublane_gather_8x128", (8, 128), (8, 128), 0, 1),
    ("lane_gather_wide_table", (8, 1024), (8, 256), 1, 777),
    ("broadcast_row_gather", (8, 1024), (8, 256), None, 900),
)


def stage1_case(name: str, device, seed: int | None = None) -> tuple[torch.Tensor, torch.Tensor, int | None]:
    """``(x, i, axis)`` of one stage-1 probe: JAX's inputs (an arange table,
    a constant index), or with ``seed`` indices drawn in range."""
    _, x_shape, i_shape, axis, const = next(c for c in STAGE1 if c[0] == name)
    x = torch.arange(x_shape[0] * x_shape[1], dtype=torch.float32).reshape(x_shape)
    if axis is None:  # the (1024,) row replicated on the 8 rows
        x = torch.arange(x_shape[1], dtype=torch.float32).expand(x_shape).contiguous()
    extent = x_shape[0] if axis == 0 else x_shape[1]
    if seed is None:
        i = np.full(i_shape, const, np.int32)
    else:
        i = np.random.default_rng(seed).integers(0, extent, i_shape).astype(np.int32)
    return x.to(device), torch.from_numpy(i).to(device), axis


def stage1_take(gather, x: torch.Tensor, i: torch.Tensor, axis: int | None) -> torch.Tensor:
    """One stage-1 probe through ``gather``."""
    if axis is None:
        return gather(x[:1].contiguous(), i)[0]
    return take_along_axis(gather, x, i, axis)


def stage1(device) -> None:
    """Every kernel on every stage-1 probe (JAX's inputs), bitwise
    ``torch.take_along_dim``; prints ``{"probe", "kernel", "ok": true}`` a
    check and raises on a mismatch."""
    for name, *_ in STAGE1:
        x, i, axis = stage1_case(name, device)
        want = torch.take_along_dim(x, i.long(), dim=1 if axis is None else axis)
        for kernel, gather in GATHERS.items():
            got = stage1_take(gather, x, i, axis)
            if not torch.equal(got, want):
                raise AssertionError(f"{kernel} on {name}: {int((got != want).sum())} values differ from the take")
            print(json.dumps({"probe": name, "kernel": kernel, "ok": True}), flush=True)  # noqa: T201


def stage2_inputs(n_rays: int, s: int = SPHERES, chans: int = CHANS, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """``(table, idx)``: the first ``chans`` columns of an (S, 16) uniform
    table from ``default_rng(0)``, transposed, and (8, n_rays / 8) indices in
    [0, S) from ``default_rng(1)``."""
    if n_rays % 8 or n_rays < 8:
        raise ValueError(f"--rays: expected a positive multiple of 8, got {n_rays}")
    mat = np.random.default_rng(0).uniform(0.0, 1.0, (s, 16)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, s, (8, n_rays // 8)).astype(np.int32)
    table = np.ascontiguousarray(mat[:, :chans].T)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def bound_ms(table: torch.Tensor, idx: torch.Tensor) -> float:
    """Least time of one take: the indices and the table read once, the
    output written once, over the card's memory rate."""
    n_bytes = 4 * (idx.numel() + table.numel() + table.shape[0] * idx.numel())
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def stage2(n_rays: int = RAYS, s: int = SPHERES, chans: int = CHANS, device="cpu") -> dict[str, dict]:
    """Each kernel bitwise the library take at this size, then (on CUDA)
    each timed beside the library take and the bound; prints a line each."""
    device = torch.device(device)
    table, idx = stage2_inputs(n_rays, s, chans, device)
    want = library_take(table, idx)
    if not torch.equal(gather_plain(table, idx), want):
        raise AssertionError("gather_plain differs from the library take")
    card = card_label(device)
    shape = {"rays": n_rays, "spheres": s, "chans": chans}
    res: dict[str, dict] = {}
    for kernel, gather in GATHERS.items():
        got = gather(table, idx)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel}: {int((got != want).sum())} of {want.numel()} values differ from the take")
    timed = {"library_take": library_take, **GATHERS} if device.type == "cuda" else {}
    for name, fn in timed.items():
        ms = time_launches(lambda fn=fn: fn(table, idx), TIMED_LAUNCHES, TIMED_REPS)
        res[name] = {"ms": ms, "bound_ms": bound_ms(table, idx)}
    for name in ("library_take", *GATHERS):
        rec = {"probe": f"{name}_ms", "ms": res.get(name, {}).get("ms"), "bound_ms": bound_ms(table, idx),
               "bitwise_take": True, **shape, "device": card}
        print(json.dumps(rec), flush=True)  # noqa: T201
    return res


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the probe's stages; returns stage 2's timings (empty on the CPU)."""
    ap = argparse.ArgumentParser(prog="python -m python_ray_tracer_tpu_torch.benchmarks.gather_probe")
    ap.add_argument("--stage", default="all", choices=["1", "2", "all"])
    ap.add_argument("--rays", type=int, default=RAYS, help="stage 2's rays (a multiple of 8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build_all((_SOURCE,))
    if args.stage in ("1", "all"):
        stage1(device)
    return stage2(args.rays, device=device) if args.stage in ("2", "all") else {}


if __name__ == "__main__":
    main()
