"""The numbers that decide ``correct``: what the program produced against
what the reference computes from the same inputs, and the control that
stores the reference's splats in bfloat16."""

from __future__ import annotations

import dataclasses
import math
import statistics

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


def _gap(a: float, b: float, floor: float) -> float:
    """|a - b| over the larger of b and ``floor``."""
    d = max(b, floor)
    if d > 0.0:
        return abs(a - b) / d
    return 0.0 if a == b else math.inf


def fit_readings(prog: dict, ref: dict) -> dict:
    """A trainer's first steps against the reference's, from the readings
    of ``reference.train.first_steps``:
    loss_rel_err: the largest gap of a step's loss over the reference's;
    grad_norm_gap: over the leaves, the largest gap between the norms of
    the first gradient, over the larger of the reference's norm of that
    leaf and of the median leaf;
    change_norm_gap: the same of each leaf's change over the steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf with a gradient of nought to rounding moves under
    Adam by round-off alone)."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    else:
        loss = max(_gap(a, b, 0.0)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"])
    grad = max(_gap(a, b, g_med)
               for a, b in zip(prog["grad_norms"], ref["grad_norms"]))
    keep = [i for i, g in enumerate(ref["grad_norms"]) if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change_norms"][i] for i in keep)
    change = max(_gap(prog["change_norms"][i], ref["change_norms"][i], c_med)
                 for i in keep)
    return {"loss_rel_err": loss, "grad_norm_gap": grad,
            "change_norm_gap": change}
