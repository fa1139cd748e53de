"""Sharded rendering and training over a ``(rays, spheres)`` mesh of ranks.

Port of :mod:`python_ray_tracer_tpu.parallel` on ``torch.distributed``: the
mesh (:mod:`.mesh`), bringing up the ranks (:mod:`.distributed`), the
collectives with JAX's gradient rule (:mod:`.collectives`) and the sharded
render (:mod:`.sharded`).  JAX's ``render_sharded_jit`` has no counterpart:
PyTorch has no ``jit`` to wrap it in.
"""

from .mesh import RAY_AXIS, SPHERE_AXIS, Mesh, make_mesh, round_up
from .sharded import pad_spheres, render_sharded, trace_sharded

__all__ = [
    "RAY_AXIS",
    "SPHERE_AXIS",
    "Mesh",
    "make_mesh",
    "round_up",
    "pad_spheres",
    "render_sharded",
    "trace_sharded",
]
