"""The numbers that decide ``correct``: what the program produced against
what the reference computes from the same inputs, and the control that
stores the reference's splats in bfloat16."""

from __future__ import annotations

import dataclasses

import torch

SPLAT_FIELDS = ("pos", "color", "scale", "normal", "quat", "pbr")


def splat_readings(prog, ref) -> dict:
    """count_diff: slots whose ``valid`` differs, plus any difference of
    capacity; max_err: over the float fields, the largest |program -
    reference| on the slots valid in both, as a share of the field's
    largest |reference| value."""
    n = min(prog.valid.shape[0], ref.valid.shape[0])
    pv, rv = prog.valid[:n], ref.valid[:n]
    count_diff = (int((pv != rv).sum())
                  + abs(prog.valid.shape[0] - ref.valid.shape[0]))
    both = pv & rv
    err = 0.0
    for f in SPLAT_FIELDS:
        p = getattr(prog, f)[:n][both].float()
        r = getattr(ref, f)[:n][both].float()
        if r.numel():
            scale = max(float(r.abs().max()), 1e-30)
            err = max(err, float((p - r).abs().max()) / scale)
    return {"count_diff": count_diff, "max_err": err}


def image_max_err(prog, ref) -> float:
    """The largest |program - reference| over the frame's pixels and
    channels."""
    return float((prog.float() - ref.float()).abs().max())


def bf16_splats(splats):
    """The control: the splats' float fields stored in bfloat16."""
    return dataclasses.replace(splats, **{
        f: getattr(splats, f).to(torch.bfloat16).float()
        for f in SPLAT_FIELDS})
