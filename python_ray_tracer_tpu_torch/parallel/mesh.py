"""The (rays, spheres) mesh of ranks, and padding helpers.

Port of :mod:`python_ray_tracer_tpu.parallel.mesh`.  JAX's mesh is a grid
of devices inside one program; here it is a grid of processes
(``torch.distributed`` ranks), each holding one device.  Rank ``r`` sits at
``(r // n_spheres, r % n_spheres)``, the layout of JAX's
``reshape(n_rays, n_spheres)``.  Each axis has a process group of its own
for the collectives that finish a reduction along it
(:mod:`.collectives`): the ranks of one ray row share a sphere group, the
ranks of one sphere column a ray group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch.distributed as dist

RAY_AXIS = "rays"
SPHERE_AXIS = "spheres"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it."""

    name: str
    index: int  # this rank's position along the axis
    size: int
    group: Any = None  # its torch.distributed process group (None when size is 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (rays, spheres) mesh."""

    rays: Axis
    spheres: Axis

    @property
    def shape(self) -> dict[str, int]:
        """``{RAY_AXIS: n, SPHERE_AXIS: m}``, as JAX's ``Mesh.shape``."""
        return {RAY_AXIS: self.rays.size, SPHERE_AXIS: self.spheres.size}

    @property
    def size(self) -> int:
        return self.rays.size * self.spheres.size


def make_mesh(n_rays_shards: int | None = None, n_sphere_shards: int = 1) -> Mesh:
    """Build the ``(rays, spheres)`` mesh over every rank of the default
    process group (one rank, without one).

    Defaults to every rank on the ray axis; ``n_sphere_shards > 1`` also
    shards the sphere sweep.  Every rank calls it, with the same arguments:
    each group is made by all ranks, in one order.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_sphere_shards < 1 or world % n_sphere_shards:
        raise ValueError(f"{world} ranks not divisible by {n_sphere_shards} sphere shards")
    if n_rays_shards is None:
        n_rays_shards = world // n_sphere_shards
    if n_rays_shards * n_sphere_shards != world:
        raise ValueError(f"a {n_rays_shards}x{n_sphere_shards} mesh needs {n_rays_shards * n_sphere_shards} ranks, "
                         f"have {world}")
    ray_i, sphere_j = divmod(rank, n_sphere_shards)

    def groups(lines: list[list[int]], mine: int):
        if len(lines[0]) == 1:
            return None
        made = [dist.new_group(ranks) for ranks in lines]
        return made[mine]

    sphere_group = groups(
        [[i * n_sphere_shards + j for j in range(n_sphere_shards)] for i in range(n_rays_shards)], ray_i
    )
    ray_group = groups(
        [[i * n_sphere_shards + j for i in range(n_rays_shards)] for j in range(n_sphere_shards)], sphere_j
    )
    return Mesh(
        rays=Axis(RAY_AXIS, ray_i, n_rays_shards, ray_group),
        spheres=Axis(SPHERE_AXIS, sphere_j, n_sphere_shards, sphere_group),
    )


def round_up(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)
