"""Inverse rendering: differentiable L2 loss and the Adam training step.

Port of :mod:`python_ray_tracer_tpu.optim.train`.  The loss is an L2
pixel loss against a target image; a step is ``loss.backward()`` and one
``torch.optim.Adam`` update, the counterpart of ``optax.adam``.

Where :func:`..render.fused_train_l2_ok` holds (smooth visibility through
the kernels), the loss is one ``train_deep`` launch that also computed
every gradient; its backward only scales them.  With a mesh
(:mod:`..parallel`) the loss renders through
:func:`..parallel.sharded.render_sharded` on every rank of the mesh, and
every rank's backward gives the gradients of the single-device loss, so
the ranks' Adam updates agree.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..ops.vecmath import clip
from ..parallel.mesh import Mesh
from ..parallel.sharded import render_sharded
from ..render import fused_train_l2_ok, l2_loss_fused, render
from ..scene import Scene
from .params import Params, combine

OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


def l2_image_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared pixel error of the image clipped to [0, 1] as the PNG
    writer clips it; the clip's gradient splits at the bounds as JAX's does."""
    return torch.mean((clip(image, 0.0, 1.0) - target) ** 2)


def make_loss_fn(
    template: Scene,
    target: torch.Tensor,  # (H, W, 3) float in [0, 1]
    cfg: RenderConfig,
    mesh: Mesh | None = None,
) -> Callable[[Params], torch.Tensor]:
    """Loss as a function of the parameter dict; with a ``mesh`` every rank
    of it calls the function, and the rendering (and the backward pass) runs
    sharded."""
    tgt = target.detach().to(cfg.dtype)

    def loss_fn(params: Params) -> torch.Tensor:
        scene = combine(params, template)
        if mesh is not None:
            return l2_image_loss(render_sharded(scene, cfg, mesh), tgt)
        if fused_train_l2_ok(scene, cfg):
            return l2_loss_fused(scene, tgt, cfg)
        return l2_image_loss(render(scene, cfg), tgt)

    return loss_fn


def adam(learning_rate: float) -> OptimizerFactory:
    """``optax.adam(learning_rate)``: ``torch.optim.Adam`` with the same
    defaults (betas 0.9/0.999, eps 1e-8), made once the params exist."""
    return lambda leaves: torch.optim.Adam(leaves, lr=learning_rate, foreach=False)


class TrainState(NamedTuple):
    params: Params
    optimizer: torch.optim.Optimizer  # holds the Adam moments
    step: int


def init_state(params: Params, optimizer: OptimizerFactory) -> TrainState:
    return TrainState(params=params, optimizer=optimizer(list(params.values())), step=0)


def _one_step(loss_fn, state: TrainState, update_mask: Params | None) -> torch.Tensor:
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params)
    loss.backward()
    if update_mask is not None:
        with torch.no_grad():
            for key, mask in update_mask.items():
                grad = state.params[key].grad
                if grad is not None:
                    grad.mul_(mask)
    opt.step()
    return loss.detach()


def make_train_step(loss_fn: Callable[[Params], torch.Tensor], update_mask: Params | None = None):
    """``step(state) -> (state, loss)``: one value-and-grad and Adam update.

    The params are updated in place; the returned state holds the same
    tensors and the next step count.  ``update_mask`` (the JAX package's
    ``masked_updates``) multiplies each gradient by its 0/1 mask before
    Adam, so a masked element gets a zero update, as with optax's post-Adam
    mask.  The stored moments differ: here a masked element's moments decay
    toward zero, there they track its unmasked gradient.
    """

    def train_step(state: TrainState) -> tuple[TrainState, torch.Tensor]:
        loss = _one_step(loss_fn, state, update_mask)
        return state._replace(step=state.step + 1), loss

    return train_step


def make_train_step_k(loss_fn: Callable[[Params], torch.Tensor], update_mask: Params | None = None):
    """``step_k(state, k) -> (state, (k,) losses)``: K Adam steps per call.

    The losses stay on the device and come back as one (k,) tensor, so a
    caller syncs with the host once per chunk instead of once per step.
    """

    def train_step_k(state: TrainState, k: int) -> tuple[TrainState, torch.Tensor]:
        losses = [_one_step(loss_fn, state, update_mask) for _ in range(k)]
        return state._replace(step=state.step + k), torch.stack(losses)

    return train_step_k


ChunkHook = Callable[[TrainState, int, list[float], float], None]


def run_steps(
    step_k,
    state: TrainState,
    steps: int,
    *,
    sync_every: int = 25,
    boundary_every: int | None = None,
    on_chunk: ChunkHook | None = None,
) -> tuple[TrainState, list[float]]:
    """Run ``step_k`` (from :func:`make_train_step_k`) from ``state.step`` to ``steps``.

    Chunks hold at most ``sync_every`` steps and end at every multiple of
    ``boundary_every`` (a checkpoint interval).  After each chunk the host
    syncs once, and ``on_chunk(state, first_step, losses, seconds)`` fires.
    Returns the final state and the losses of the steps run.
    """
    history: list[float] = []
    while state.step < steps:
        done = state.step
        end = steps if boundary_every is None else min(steps, (done // boundary_every + 1) * boundary_every)
        t0 = time.perf_counter()
        state, losses = step_k(state, max(1, min(sync_every, end - done)))
        chunk = losses.cpu().tolist()  # one host transfer (and sync) per chunk
        if on_chunk is not None:
            on_chunk(state, done, chunk, time.perf_counter() - t0)
        history.extend(chunk)
    return state, history


def fit(
    template: Scene,
    target: torch.Tensor,
    cfg: RenderConfig,
    params: Params,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    mesh: Mesh | None = None,
    update_mask: Params | None = None,
    callback: Callable[[int, float], None] | None = None,
    sync_every: int = 25,
) -> tuple[Params, list[float]]:
    """Adam-optimize scene params against a target image.

    ``update_mask`` (optional) freezes parameter elements where 0.  Returns
    the final params and the per-step loss history.  The host syncs, and
    ``callback(step, loss)`` fires for each step, once per chunk of
    ``sync_every`` steps.
    """

    def per_step(_state, done, chunk, _seconds):
        for j, loss_val in enumerate(chunk):
            callback(done + j, loss_val)

    step_k = make_train_step_k(make_loss_fn(template, target, cfg, mesh), update_mask)
    state, history = run_steps(
        step_k, init_state(params, adam(learning_rate)), steps,
        sync_every=sync_every, on_chunk=per_step if callback is not None else None,
    )
    return state.params, history
