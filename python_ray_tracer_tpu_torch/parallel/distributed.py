"""Bringing up the ranks of a mesh, and cross-rank utilities.

Port of :mod:`python_ray_tracer_tpu.parallel.distributed`.  JAX brings up
one runtime per host (``jax.distributed.initialize``) and its mesh spans
every chip; here every rank is a process holding one device, joined in
one ``torch.distributed`` process group:

    from python_ray_tracer_tpu_torch.parallel import distributed, render_sharded
    distributed.initialize()                 # torchrun's environment
    mesh = distributed.global_mesh()         # every rank on the ray axis
    image = distributed.gather_image(render_sharded(scene, cfg, mesh))

Each rank takes ``cuda:(local_rank % device_count)``.  The backend is NCCL
where every rank has a card of its own, and gloo on the CPU or where ranks
share a card (NCCL refuses two ranks on one device); the rank prints the
one it took, and nothing else is tried if it fails.

:func:`run_local` starts the ranks of a one-host job itself, as the CLI
does for ``--ray-shards``/``--sphere-shards`` without ``--distributed``.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import sys
import traceback
from collections.abc import Callable
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, make_mesh

# How long a collective may wait for the other ranks.
TIMEOUT = datetime.timedelta(seconds=600)


def local_rank(rank: int | None = None) -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else its
    global rank (``rank``, or the process group's)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str = "cuda", rank: int | None = None) -> torch.device:
    """The device this rank computes on: ``cuda:(local_rank % count)``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank")
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def pick_backend(device_type: str, ranks_on_host: int) -> str:
    """NCCL when each of the host's ranks has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str = "cuda",
    backend: str | None = None,
) -> None:
    """Join the process group (idempotent).

    With no arguments the rank reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); explicit arguments name the
    coordinator (``host:port`` or a ``tcp://`` or ``file://`` URL), the
    process count and this process's id.  The ranks on one host default to
    ``LOCAL_WORLD_SIZE``, else to all of them.  A group that cannot be
    formed raises: a job does not fall back to one process.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if k not in os.environ]
        if missing:
            raise RuntimeError(f"initialize(): no coordinator given and {', '.join(missing)} not set (run under torchrun)")
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or pick_backend(device_type, on_host)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, rank))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=TIMEOUT)
    print(f"[rank {rank}/{world}] torch.distributed backend {backend}", file=sys.stderr, flush=True)


def global_mesh(n_sphere_shards: int = 1) -> Mesh:
    """(rays, spheres) mesh over every rank of the job."""
    return make_mesh(None, n_sphere_shards)


def gather_image(image: torch.Tensor) -> np.ndarray:
    """The rendered image as numpy on this rank: :func:`.render_sharded`
    already returns the whole frame on every rank."""
    return image.detach().cpu().numpy()


def barrier() -> None:
    """Wait for every rank (checkpoint and output coordination)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == dist.Backend.NCCL:
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, address: str, device_type: str, backend: str, args, results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        initialize(address, world, rank, device_type=device_type, backend=backend)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # report it to the parent, which stops the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local(fn: Callable[..., Any], world: int, *args, device_type: str = "cuda", timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of this host, each a process of
    its own in one process group; returns the ranks' return values in rank
    order.  ``fn`` must be importable by name (a module-level function).
    The backend is :func:`pick_backend`'s.  If a rank fails, the others are
    stopped and the failure is raised here; every process started here has
    ended when this returns.
    """
    backend = pick_backend(device_type, world)
    address = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world, address, device_type, backend, args, results), daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"run_local: no rank reported within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world)]
