"""The program's spans in a traced run: the device's idle time by the layer
the host was in, and the host's blocking waits.

``mesh2splat_torch`` opens a span (``utils.profiling.annotate``) at each
layer of ``Scene.convert`` and ``Scene.render``: a host event of the
profiler named ``m2s.<entry>[.<layer>]``, on the device trace's clock.
Spans nest as the calls do, and the innermost span open at a moment owns
it. A run of a program without spans reads nothing here (the readers
return None).

The trainer's step (``train.fit.train_step_fn``) opens no span of its own
around its layers; torch's own host events in it give them
(``training_spans``): the step from its optimizer's ``zero_grad`` to the
end of its optimizer step, its backward from the first to the last
autograd node evaluated in between, and the optimizer step.
"""

from __future__ import annotations

import bisect

from .trace import Trace

PREFIX = "m2s."
STEP, BACKWARD, OPTIMIZER = "torch.step", "torch.backward", "torch.optimizer"
ENTRIES = ("m2s.convert", "m2s.render", STEP)   # a cell's units
OUTSIDE = "outside"    # moments under no span
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
ZERO_GRAD = "Optimizer.zero_grad#"
OPT_STEP = "Optimizer.step#"
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "


def training_spans(host) -> list:
    """(start, end, name) of each training step's STEP, BACKWARD and
    OPTIMIZER spans, from torch's host events in ``host``: a step runs
    from an optimizer's zero_grad to the end of the optimizer step that
    follows it."""
    zero = sorted((s, e) for s, e, name in host
                  if name.startswith(ZERO_GRAD))
    nodes = sorted((s, e) for s, e, name in host
                   if name.startswith(AUTOGRAD_NODE))
    node_starts = [s for s, _ in nodes]
    out = []
    for s, e, name in host:
        if not name.startswith(OPT_STEP):
            continue
        j = bisect.bisect_right(zero, (s, float("inf"))) - 1
        if j < 0:
            continue
        z0, z1 = zero[j]
        out += [(z0, e, STEP), (s, e, OPTIMIZER)]
        lo = bisect.bisect_left(node_starts, z1)
        hi = bisect.bisect_left(node_starts, s)
        inside = [n for n in nodes[lo:hi] if n[1] <= s]
        if inside:
            out.append((inside[0][0], max(n[1] for n in inside), BACKWARD))
    return out


def innermost(spans) -> list:
    """Disjoint (start, end, name) pieces of the time the spans cover, each
    named by the innermost span open there. ``spans``: (start, end, name)
    of spans that nest (one thread's)."""
    out, stack, t = [], [], 0.0
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = end
    return [p for p in out if p[1] > p[0]]


def split_idle(host, device) -> dict:
    """{span name or OUTSIDE: seconds}: each idle gap of the device (between
    the intervals in ``device``) shared among the innermost spans of
    ``host`` that overlap it, by the overlap; the rest of the gap goes to
    OUTSIDE. Every span present gets an entry, 0 where it overlaps no
    gap."""
    spans = ([h for h in host if h[2].startswith(PREFIX)]
             + training_spans(host))
    pieces = innermost(spans)
    tot = dict.fromkeys({name for _, _, name in spans}, 0.0)
    tot[OUTSIDE] = 0.0
    _, gaps = Trace._union(device)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            ov = min(b, e) - max(a, s)
            if ov > 0.0:
                tot[name] += ov
                covered += ov
            k += 1
        tot[OUTSIDE] += (b - a) - covered
    return tot


def _traced(run) -> bool:
    return run.trace is not None and bool(run.completed)


def idle_ms(run, span: str):
    """Device idle ms a unit while ``span`` was the host's innermost span
    (OUTSIDE: under none); None where the trace holds no such span. The
    split is made once a trace and kept on it: a cell reads several."""
    if not _traced(run):
        return None
    tot = getattr(run.trace, "idle_split", None)
    if tot is None:
        tot = run.trace.idle_split = split_idle(run.trace.host,
                                                run.trace.device)
    if span not in tot or (span == OUTSIDE and len(tot) == 1):
        return None
    return tot[span] * 1e3 / run.completed


def count_syncs(host) -> tuple:
    """(blocking waits inside an entry span, entry spans) in ``host``."""
    entries = sorted((s, e) for s, e, name in host + training_spans(host)
                     if name in ENTRIES)
    waits = sorted(s for s, _, name in host if name in SYNCS)
    n, j = 0, 0
    for s, e in entries:
        while j < len(waits) and waits[j] < s:
            j += 1
        while j < len(waits) and waits[j] <= e:
            n += 1
            j += 1
    return n, len(entries)


def syncs(run):
    """The host's blocking waits a unit (runtime synchronisations and
    synchronous copies) inside the entry spans; None without them."""
    if not _traced(run):
        return None
    n, units = count_syncs(run.trace.host)
    if not units:
        return None
    return n / run.completed
