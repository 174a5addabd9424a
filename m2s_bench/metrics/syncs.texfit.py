"""The host's blocking waits a step (runtime synchronisations and
synchronous copies) inside ``texture_step_fn``'s step (from its
optimizer's zero_grad to the end of its Adam step,
``spans.training_spans``)."""

from m2s_bench.spans import syncs


def read(run):
    return syncs(run)
