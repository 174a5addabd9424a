"""Checkpoint / resume of a training run (counterpart of
``mesh2splat_tpu.utils.checkpoint``): the parameters, the optimizer's
``state_dict`` and the step counter in one ``torch.save`` file. The PLY
files stay the interchange format of the splats themselves (io/ply.py).

``params`` is a ``train.fit.SplatParams``, a dict of tensors, or one tensor
(``fit_textures``' texture).
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch


def _tensors(params) -> dict:
    if isinstance(params, torch.Tensor):
        return {"tensor": params}
    if dataclasses.is_dataclass(params):
        return {f.name: getattr(params, f.name)
                for f in dataclasses.fields(params)}
    return dict(params)


def save_training_state(path, params, optimizer, step: int):
    """Write (params, optimizer state, step) to ``path``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "params": {k: v.detach().cpu() for k, v in _tensors(params).items()},
        "opt_state": optimizer.state_dict(),
        "step": int(step),
    }, path)


def load_training_state(path, params_like, optimizer_like):
    """Restore a checkpoint into ``params_like`` (its tensors are
    overwritten in place, on their own device) and ``optimizer_like``, an
    optimizer over those tensors. Returns (params, optimizer, step)."""
    ckpt = torch.load(pathlib.Path(path), map_location="cpu",
                      weights_only=True)
    with torch.no_grad():
        for name, t in _tensors(params_like).items():
            t.copy_(ckpt["params"][name])
    optimizer_like.load_state_dict(ckpt["opt_state"])
    return params_like, optimizer_like, ckpt["step"]
