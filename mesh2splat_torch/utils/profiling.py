"""Frame timing and observability (counterpart of
``mesh2splat_tpu.utils.profiling``).

The reference rotates a pool of 10 GL_TIME_ELAPSED queries read 5 frames late
to avoid pipeline stalls (reference: src/renderer/renderer.cpp:59-63,147-175).
FrameTimer keeps the same pool and latency: it holds (t_submit, result) pairs
and waits for a frame only ``latency`` frames later, so timing never
serializes the card. For a frame whose result lies on a CUDA device it
records a ``torch.cuda.Event`` on the current stream at submission and later
waits on that event; a result on the CPU is complete when it is returned.

``trace()`` wraps torch.profiler and writes a Chrome trace (chrome://tracing,
Perfetto). ``annotate()`` is the program's span (the glPushDebugGroup
analogue, reference: RenderContext.hpp:12-25 PassesDebugIDs): ``Scene``'s
entries and each layer under them open one (``m2s.convert.*``,
``m2s.render.*``). A span is recorded only while a torch.profiler records
CPU activity ("tracing on" is running under the profiler; there is no other
switch), as one host event in the profiler's own buffers, written out with
the device's events on the same clock; otherwise it costs about a
microsecond. It is a FUNCTION-scope record, not a user annotation
(``torch.profiler.record_function``): the profiler copies user annotations
onto the device's timeline as ``gpu_user_annotation`` events, which would
count as device time in a reading of the device's intervals, and
``record_function`` costs about ten times as much.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import time

import torch

DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trace"


def _on_cuda(result) -> bool:
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_cuda(v) for v in result.values())
    if isinstance(result, (list, tuple)):
        return any(_on_cuda(v) for v in result)
    return False


class FrameTimer:
    """Rolling frame timer with deferred synchronization."""

    def __init__(self, pool: int = 10, latency: int = 5):
        # NUM_FRAME_TIME_QUERIES=10 / 5-frame latency (renderer.cpp:59-63)
        self.pool = pool
        self.latency = latency
        self._pending = collections.deque()
        self.samples = collections.deque(maxlen=pool)

    def frame(self, result):
        """Record a frame whose device work ends at ``result`` (a tensor, or
        a dict, list or tuple of them). Returns the newest completed frame's
        time in ms, or None while the pipeline warms up."""
        done = None
        if _on_cuda(result):
            done = torch.cuda.Event()
            done.record()
        self._pending.append((time.perf_counter(), done))
        if len(self._pending) > self.latency:
            t_submit, ev = self._pending.popleft()
            if ev is not None:
                ev.synchronize()
            self.samples.append((time.perf_counter() - t_submit) * 1e3)
        return self.samples[-1] if self.samples else None

    @property
    def average_ms(self):
        return sum(self.samples) / len(self.samples) if self.samples else None


@contextlib.contextmanager
def trace(log_dir=DEFAULT_TRACE_DIR):
    """torch.profiler over the block (CPU, and CUDA where there is a card);
    on exit a Chrome trace ``trace.json`` is written into ``log_dir``
    (default: build/trace/ of the checkout). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A span named ``name`` over a ``with`` block: a host event of the
    profiler's trace while one records CPU activity, else nothing."""
    return torch._C._profiler._RecordFunctionFast(name)


def format_with_commas(value: int) -> str:
    """UI count formatting (reference: utils.cpp:404-430)."""
    return f"{value:,}"
