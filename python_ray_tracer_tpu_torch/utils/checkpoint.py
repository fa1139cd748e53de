"""Checkpoint / resume for inverse-rendering runs.

Port of :mod:`python_ray_tracer_tpu.utils.checkpoint` for a
:class:`..optim.train.TrainState`: the params, the Adam moments and the step
counter go into one ``.npz`` beside a structure key (the param names,
shapes and dtypes, as JSON), and load back with ``allow_pickle=False``.  A
checkpoint made with other ``--train-fields`` fails to load instead of
filling the wrong parameters.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..optim.train import TrainState

_STRUCTURE = "__structure__"


def _structure(state: TrainState) -> str:
    return json.dumps(
        [[k, list(v.shape), str(v.dtype).removeprefix("torch.")] for k, v in state.params.items()]
    )


def save_checkpoint(path: str | Path, state: TrainState) -> None:
    """Write ``state`` atomically (tmp + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {_STRUCTURE: np.frombuffer(_structure(state).encode(), dtype=np.uint8)}
    arrays["step"] = np.asarray(state.step, np.int64)
    for i, (key, p) in enumerate(state.params.items()):
        arrays[f"param/{key}"] = p.detach().cpu().numpy()
        moments = state.optimizer.state.get(p, {})
        for name in ("exp_avg", "exp_avg_sq"):
            if name in moments:
                arrays[f"adam/{i}/{name}"] = moments[name].detach().cpu().numpy()
        if "step" in moments:
            arrays[f"adam/{i}/step"] = np.asarray(float(moments["step"]), np.float64)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)


def load_checkpoint(path: str | Path, like: TrainState) -> TrainState:
    """Load into ``like`` (a state with the same params, fresh or not):
    params are overwritten in place, the Adam moments replaced."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        saved = bytes(data[_STRUCTURE]).decode()
        if saved != _structure(like):
            raise ValueError(
                f"{path}: checkpoint structure mismatch.\n  saved:    {saved}\n  expected: {_structure(like)}"
            )
        arrays = {k: data[k] for k in data.files}
    opt = like.optimizer
    state_dict = opt.state_dict()
    state_dict["state"] = {}
    with torch.no_grad():
        for i, (key, p) in enumerate(like.params.items()):
            p.copy_(torch.from_numpy(arrays[f"param/{key}"]))
            if f"adam/{i}/step" in arrays:
                state_dict["state"][i] = {
                    "step": torch.tensor(float(arrays[f"adam/{i}/step"])),
                    "exp_avg": torch.from_numpy(arrays[f"adam/{i}/exp_avg"]),
                    "exp_avg_sq": torch.from_numpy(arrays[f"adam/{i}/exp_avg_sq"]),
                }
    opt.load_state_dict(state_dict)
    return like._replace(step=int(arrays["step"]))
