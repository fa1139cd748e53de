"""One rank of the sharded-render tests of the PyTorch port (gloo on the CPU).

:func:`run` is started on every rank of a mesh by
``python_ray_tracer_tpu_torch.parallel.distributed.run_local`` and returns
this rank's results as numpy arrays.  It imports torch and the port only:
each rank is a fresh process, and the JAX oracles stay in the test process.
"""

from __future__ import annotations

import torch


def _scene(spec: dict, dtype: torch.dtype):
    from python_ray_tracer_tpu_torch.convert import scene_from_numpy

    return scene_from_numpy(spec["arrays"], width=spec["width"], height=spec["height"], n_exact=spec["n_exact"],
                            device="cpu", dtype=dtype)


def run(mesh_shape: tuple[int, int], jobs: list[dict]) -> dict[str, object]:
    """Run each job on this rank of a ``mesh_shape`` (rays, spheres) mesh.

    A job is ``{"name", "scene", "cfg", "dtype"}`` and, for a gradient,
    ``"target"``: a render returns the (H, W, 3) image, a gradient job the
    loss and every ``scene_to_params`` gradient of
    ``make_loss_fn(scene, target, cfg, mesh)``.  ``"launches"`` holds the
    kernel wrappers' launch counts over all jobs.
    """
    torch.set_num_threads(1)
    from python_ray_tracer_tpu_torch import RenderConfig
    from python_ray_tracer_tpu_torch.ops import launch_counts
    from python_ray_tracer_tpu_torch.optim import make_loss_fn, scene_to_params
    from python_ray_tracer_tpu_torch.parallel import make_mesh, render_sharded

    mesh = make_mesh(*mesh_shape)
    out: dict[str, object] = {"coords": (mesh.rays.index, mesh.spheres.index)}
    for job in jobs:
        dtype = getattr(torch, job["dtype"])
        scene = _scene(job["scene"], dtype)
        cfg = RenderConfig(dtype=dtype, **job["cfg"])
        if "target" not in job:
            with torch.no_grad():
                out[job["name"]] = render_sharded(scene, cfg, mesh).numpy()
            continue
        params = scene_to_params(scene)
        loss = make_loss_fn(scene, torch.tensor(job["target"], dtype=dtype), cfg, mesh)(params)
        loss.backward()
        grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy() for k, v in params.items()}
        out[job["name"]] = {"loss": float(loss.detach()), **grads}
    out["launches"] = launch_counts()
    return out
