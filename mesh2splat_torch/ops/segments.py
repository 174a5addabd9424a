"""Segment/slot allocation primitives (counterpart of
``mesh2splat_tpu.ops.segments``): a producer claiming ``count`` contiguous
slots is an exclusive cumsum; mapping each slot back to its producer is a
scatter-max of producer values at segment starts followed by a running max,
or, where only the producer's id is wanted, a binary search over the
segment ends (``owner_of_slots``).

Values stay int32; indices are cast to int64 only to index.
"""

from __future__ import annotations

import torch


def alloc_slots(counts: torch.Tensor, capacity: int):
    """counts: (T,) int32 >= 0. Returns (offsets, total) where producer t owns
    slots [offsets[t], offsets[t] + counts[t]) clipped to capacity."""
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total = torch.clamp(offsets[-1] + counts[-1], max=capacity)
    return offsets, total


def _start_index(offsets, counts, capacity):
    starts = torch.where(counts > 0, offsets, capacity)
    return torch.clamp(starts, 0, capacity).long()


def _scatter_max(idx, vals, capacity, init):
    marks = torch.full((capacity + 1,), init, dtype=torch.int32,
                       device=vals.device)
    marks.scatter_reduce_(0, idx, vals.to(torch.int32), "amax",
                          include_self=True)
    return marks[:capacity]


def expand_to_slots(offsets, counts, capacity, extra=None):
    """Returns (owner, local, in_budget[, extra_filled]): per-slot producer
    id, the slot's index within its producer's segment, a liveness mask, and
    (given ``extra``, (K, T) int32 >= 0) each extra channel forward-filled
    over the producer's slots ("last set value wins")."""
    t = offsets.shape[0]
    idx = _start_index(offsets, counts, capacity)
    ids = torch.arange(1, t + 1, dtype=torch.int32, device=offsets.device)
    channels = [ids, offsets + 1, offsets + counts]
    if extra is not None:
        channels += [extra[i] for i in range(extra.shape[0])]

    slot = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    filled = []
    for vals in channels:
        marks = _scatter_max(idx, vals, capacity, -1)
        last = torch.cummax(torch.where(marks >= 0, slot, -1), 0).values
        filled.append(torch.where(last >= 0, marks[last.clamp(min=0).long()],
                                  -1))
    owner = filled[0] - 1
    seg_start = filled[1] - 1
    seg_end = filled[2]
    local = slot - seg_start
    in_budget = (owner >= 0) & (slot < seg_end)
    if extra is None:
        return torch.clamp(owner, min=0), local, in_budget
    return (torch.clamp(owner, min=0), local, in_budget,
            torch.stack(filled[3:]))


def fill_value(offsets, counts, capacity, value):
    """Forward-fill ``value`` (non-decreasing across producers with
    counts > 0) over each producer's slots; -1 before the first segment."""
    idx = _start_index(offsets, counts, capacity)
    marks = _scatter_max(idx, value + 1, capacity, 0)
    return torch.cummax(marks, 0).values - 1


def owner_of_slots(offsets, counts, capacity):
    """(capacity,) int64 producer of each slot, equal on every slot to
    ``clamp(fill_value(offsets, counts, capacity, arange(T)), min=0)``.

    The segment ends ``offsets + counts`` of a cumsum allocation never
    decrease, so a live slot's producer is the first whose end lies past
    it; a dead slot takes the last live slot's producer, as the running max
    carries it, and every slot takes 0 when no slot is live. A search of
    sorted queries, with no scatter: the scatter-max sends every producer
    with a count of 0 to one overflow address."""
    ends = offsets + counts
    total = torch.clamp(ends[-1], max=capacity)
    slot = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    # q < ends[-1]: the search never runs past the last producer
    q = torch.minimum(slot, total - 1)
    return torch.searchsorted(ends, q, right=True)


def expand_monotone(offsets, counts, capacity, value=None):
    """Returns (local, started[, filled_value]) for contiguous cumsum
    allocations: ``local`` is each slot's index within its producer's
    segment, ``started`` marks slots at/after the first live segment
    (callers must also mask ``slot < total``)."""
    seg_start = fill_value(offsets, counts, capacity, offsets)
    slot = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    local = slot - seg_start
    started = seg_start >= 0
    if value is None:
        return local, started
    return local, started, fill_value(offsets, counts, capacity, value)


def segment_starts(sorted_keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) start offsets of each key's run in sorted keys;
    keys >= num_segments fall past the end."""
    seg = torch.arange(num_segments + 1, dtype=sorted_keys.dtype,
                       device=sorted_keys.device)
    return torch.searchsorted(sorted_keys, seg, right=False).to(torch.int32)
