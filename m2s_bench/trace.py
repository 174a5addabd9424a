"""Reduction of a torch.profiler trace of the measured window.

The profiler traces the host's ops and, through CUPTI, every kernel, copy
and fill on the card, the kernels the port launches through ctypes
included. From that the benchmark takes the device's busy time (the union
of the device intervals), the device time by kernel name, the duration of
each launch of a kernel in order, and the idle gaps between device work,
each named by the innermost host op that was running at its middle, and
the device time of the work launched inside given host events. User
annotations (``record_function``, such as torch.optim's
``Optimizer.step#Adam.step``) are host spans: their copies on the device's
timeline are left out of the device's intervals.
"""

from __future__ import annotations

import bisect
import re

TOP = 10            # entries of each breakdown list
NAME_CHARS = 160    # kernel names are cut to this many characters
SCAN_BACK = 20000   # host ops looked at to name one idle gap


def _op_id(e) -> int:
    """A host op's own id, which the device work it launched links to; 0
    for a CUDA runtime or driver call, whose id is CUPTI's, of another
    sequence (it links to its op instead)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return (e.correlation_id() if kind() in ("cpu_op", "user_annotation")
                else 0)
    if e.linked_correlation_id() or e.name().startswith("cu"):
        return 0
    return e.correlation_id()


class Trace:
    """The device and host intervals of one profiled window (seconds), read
    from the profiler's raw events (building its FunctionEvent tree takes
    minutes over a window of this length)."""

    def __init__(self, prof, window_s: float, detail: bool = True):
        """``detail=False`` reads the device's intervals alone, without
        their names or the host's ops: enough for the busy time."""
        from torch.autograd import DeviceType

        self.window_s = window_s
        cuda = DeviceType.CUDA
        dev, host, links = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if e.is_user_annotation():
                    continue
                dev.append((e.start_ns(), e.end_ns(),
                            e.name() if detail else ""))
                if detail:
                    links.append((e.duration_ns(),
                                  e.linked_correlation_id()))
            elif detail:
                host.append((e.start_ns(), e.end_ns(), e.name(),
                             e.start_thread_id(), _op_id(e)))
        # seconds from the first event: the raw stamps are ns since the
        # epoch, beyond a double's resolution of a short kernel
        base = min([i[0] for i in dev + host], default=0)
        dev.sort()
        host.sort()
        self.device = [((s - base) * 1e-9, (e - base) * 1e-9, name)
                       for s, e, name in dev]
        self.host = [((s - base) * 1e-9, (e - base) * 1e-9, name)
                     for s, e, name, _, _ in host]
        self._host_tid = [h[3] for h in host]
        # each device event's duration and the host op that launched it:
        # (seconds, the op's start in seconds, its thread)
        linked = {c for _, c in links if c > 0}
        ops = {c: ((s - base) * 1e-9, tid) for s, _, _, tid, c in host
               if c in linked}
        self._launched = [(d * 1e-9, *ops[c]) for d, c in links if c in ops]
        self.busy_s, gaps = self._union(self.device)
        self._gaps = gaps if detail else []
        if not detail:
            self.device = []

    @staticmethod
    def _union(intervals):
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, _ in intervals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy, gaps

    def durations(self, pattern: str) -> list:
        """The duration (s) of each device event whose name matches
        ``pattern`` (a regular expression), in the order they started."""
        rx = re.compile(pattern)
        return [e - s for s, e, name in self.device if rx.search(name)]

    def device_s(self, pattern: str) -> float:
        return sum(self.durations(pattern))

    def device_s_under(self, pattern: str) -> float:
        """Device seconds of the work launched by host ops that ran inside
        a host event whose name matches ``pattern``, on its thread."""
        rx = re.compile(pattern)
        spans: dict = {}
        for (s, e, name), tid in zip(self.host, self._host_tid):
            if rx.search(name):
                spans.setdefault(tid, []).append((s, e))
        starts = {tid: [s for s, _ in iv] for tid, iv in spans.items()}
        tot = 0.0
        for dur, t, tid in self._launched:
            iv = spans.get(tid)
            if not iv:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and iv[i][1] >= t:
                tot += dur
        return tot

    def top_device_ops(self, n: int = TOP) -> list:
        """[[kernel name, seconds]] of the n names with the most device
        time."""
        tot: dict = {}
        for s, e, name in self.device:
            key = name[:NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_op_at(self, t: float, starts) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - SCAN_BACK, -1), -1):
            s, e, name = self.host[j]
            if e >= t:
                return name
        return "host (no traced op)"

    def idle_gaps(self, n: int = TOP) -> list:
        """[[host op, seconds]]: the device's idle time between its first
        and last event, summed by the innermost host op running at the
        middle of each gap, the n largest."""
        starts = [s for s, _, _ in self.host]
        tot: dict = {}
        for a, b in self._gaps:
            name = self._host_op_at(0.5 * (a + b), starts)[:NAME_CHARS]
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


def idle_pct(run):
    """The device's idle share of the traced window, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def device_ms_per_unit(run, pattern: str):
    """Device ms a unit of the window of the kernels matching ``pattern``."""
    if run.trace is None or not run.completed:
        return None
    return run.trace.device_s(pattern) * 1e3 / run.completed


def roofline_share(run, kernel: str, pattern: str, launches: int = 1):
    """100 x the benchmark's bound over the measured time of ``kernel``'s
    launches (those whose name matches ``pattern``), over the window's
    units whose bound the reference counted. ``launches`` launches a unit,
    in order; None when the trace or the counts do not fit that (the
    reader then reports nothing)."""
    bounds = run.bounds.get(kernel)
    if run.trace is None or not bounds:
        return None
    durs = run.trace.durations(pattern)
    if len(durs) != launches * len(run.unit_keys):
        return None
    b = t = 0.0
    for j, key in enumerate(run.unit_keys):
        if key in bounds:
            b += bounds[key]
            t += sum(durs[j * launches:(j + 1) * launches])
    if t <= 0.0:
        return None
    return 100.0 * b / t
