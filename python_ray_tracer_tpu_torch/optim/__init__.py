"""Inverse rendering: parameter partitioning, losses, Adam training."""

from .params import LIGHT_PARAM_FIELDS, SPHERE_PARAM_FIELDS, Params, combine, scene_to_params
from .train import (
    TrainState,
    adam,
    fit,
    init_state,
    l2_image_loss,
    make_loss_fn,
    make_train_step,
    make_train_step_k,
    run_steps,
)

__all__ = [
    "LIGHT_PARAM_FIELDS",
    "SPHERE_PARAM_FIELDS",
    "Params",
    "TrainState",
    "adam",
    "combine",
    "fit",
    "init_state",
    "l2_image_loss",
    "make_loss_fn",
    "make_train_step",
    "make_train_step_k",
    "run_steps",
    "scene_to_params",
]
