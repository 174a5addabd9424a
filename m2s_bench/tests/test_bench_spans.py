"""The span readers (``m2s_bench/spans.py``) on hand-made traces: the
device's idle gaps split among the innermost spans by overlap, the parts
and ``outside`` summing to the idle, and the host's blocking waits counted
inside the entry spans only."""

import random
from types import SimpleNamespace

import pytest
import torch

from m2s_bench import spans
from m2s_bench.trace import Trace

# device busy [0, 1], [3, 4], [10, 11]: gaps (1, 3) and (4, 10)
DEVICE = [(0.0, 1.0, "k"), (3.0, 4.0, "k"), (10.0, 11.0, "k")]
HOST = [
    (0.5, 9.0, "m2s.convert"),
    (0.5, 2.0, "m2s.convert.bbox"),
    (1.2, 1.8, "aten::add"),
    (1.5, 1.9, "cudaStreamSynchronize"),
    (2.0, 2.1, "cudaMemcpyAsync"),
    (2.5, 6.0, "m2s.convert.calibrate"),
    (5.0, 5.5, "m2s.convert.inner"),
    (5.2, 5.3, "cudaMemcpy"),
    (10.5, 11.0, "cudaDeviceSynchronize"),   # the harness's closing sync
]


def fake_run(host, device, completed=2):
    return SimpleNamespace(trace=SimpleNamespace(host=host, device=device),
                           completed=completed)


def test_idle_split_by_innermost_span():
    tot = spans.split_idle(HOST, DEVICE)
    assert tot == pytest.approx({
        "m2s.convert": 0.5 + 3.0,          # (2, 2.5) and (6, 9)
        "m2s.convert.bbox": 1.0,           # (1, 2)
        "m2s.convert.calibrate": 0.5 + 1.0 + 0.5,
        "m2s.convert.inner": 0.5,          # (5, 5.5)
        spans.OUTSIDE: 1.0,                # (9, 10)
    })
    run = fake_run(HOST, DEVICE)
    assert spans.idle_ms(run, "m2s.convert.bbox") == pytest.approx(500.0)
    assert spans.idle_ms(run, spans.OUTSIDE) == pytest.approx(500.0)
    assert spans.idle_ms(run, "m2s.render.bin") is None


def test_syncs_inside_entry_spans_only():
    """Two waits inside ``m2s.convert``; the closing synchronise and the
    asynchronous copy are not counted."""
    assert spans.count_syncs(HOST) == (2, 1)
    assert spans.syncs(fake_run(HOST, DEVICE, completed=1)) == 2.0


def test_a_program_without_spans_reads_nothing():
    host = [h for h in HOST if not h[2].startswith("m2s.")]
    run = fake_run(host, DEVICE)
    assert spans.idle_ms(run, "m2s.convert.bbox") is None
    assert spans.idle_ms(run, spans.OUTSIDE) is None
    assert spans.syncs(run) is None
    assert spans.syncs(SimpleNamespace(trace=None, completed=3)) is None


def _nested(rng, lo, hi, depth, out):
    """Random spans that nest inside (lo, hi)."""
    t = lo
    while depth and t < hi:
        a = rng.uniform(t, hi)
        b = rng.uniform(a, hi)
        out.append((a, b, f"m2s.d{depth}.{len(out) % 3}"))
        _nested(rng, a, b, depth - 1, out)
        t = b + rng.uniform(0, (hi - lo) / 4)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_parts_and_outside_sum_to_the_idle(seed):
    rng = random.Random(seed)
    host = _nested(rng, 0.0, 100.0, 4, [])
    dev = sorted((s, s + rng.uniform(0, 3), "k")
                 for s in (rng.uniform(0, 110) for _ in range(60)))
    _, gaps = Trace._union(dev)
    tot = spans.split_idle(host, dev)
    assert sum(tot.values()) == pytest.approx(sum(b - a for a, b in gaps))
    assert all(v >= -1e-12 for v in tot.values())
    # the innermost pieces tile the spans' cover without overlap
    pieces = spans.innermost(host)
    assert all(p[1] <= q[0] + 1e-12 for p, q in zip(pieces, pieces[1:]))


# a training step as torch's own host events show it: zero_grad, the
# forward's projection span, the autograd nodes (on the backward's
# thread), the optimizer step; device busy [0, 1], [4, 5], [8, 9]
STEP_HOST = [
    (0.2, 0.3, "Optimizer.zero_grad#Adam.zero_grad"),
    (0.4, 2.0, "m2s.render.project"),
    (1.5, 1.6, "cudaStreamSynchronize"),
    (2.5, 3.0, "autograd::engine::evaluate_function: MulBackward0"),
    (3.5, 6.0, "autograd::engine::evaluate_function: IndexSelectBackward0"),
    (4.5, 4.6, "cudaMemcpy"),
    (6.5, 7.5, "Optimizer.step#Adam.step"),
    (9.5, 9.6, "cudaDeviceSynchronize"),    # the harness's, after the step
]
STEP_DEVICE = [(0.0, 1.0, "k"), (4.0, 5.0, "k"), (8.0, 9.0, "k")]


def test_training_spans_from_torch_events():
    """The step from zero_grad to the optimizer step's end, its backward
    from the first to the last autograd node, the optimizer step; the
    device's idle split among them, the waits counted inside the step."""
    got = sorted(spans.training_spans(STEP_HOST))
    assert got == [(0.2, 7.5, spans.STEP), (2.5, 6.0, spans.BACKWARD),
                   (6.5, 7.5, spans.OPTIMIZER)]
    tot = spans.split_idle(STEP_HOST, STEP_DEVICE)
    assert tot == pytest.approx({
        spans.STEP: 0.5 + 0.5,             # (2, 2.5) and (6, 6.5)
        "m2s.render.project": 1.0,         # (1, 2)
        spans.BACKWARD: 1.5 + 1.0,         # (2.5, 4) and (5, 6)
        spans.OPTIMIZER: 1.0,              # (6.5, 7.5)
        spans.OUTSIDE: 0.5,                # (7.5, 8)
    })
    run = fake_run(STEP_HOST, STEP_DEVICE, completed=1)
    assert spans.idle_ms(run, spans.BACKWARD) == pytest.approx(2500.0)
    assert spans.count_syncs(STEP_HOST) == (2, 1)
    assert spans.syncs(run) == 2.0


def test_training_spans_of_a_real_step():
    """A CPU profile of the port's ``train_step_fn``: each step gives one
    STEP, BACKWARD and OPTIMIZER span, nested as stated, with the
    forward's ``m2s.render.*`` spans inside the step and before its
    backward."""
    from torch.profiler import ProfilerActivity, profile

    from mesh2splat_torch.train import fit
    from mesh2splat_torch.types import Splats, make_camera

    from test_bench_reference import _random_splats

    w, h = 32, 32
    start = _random_splats(120, 2, Splats)
    params = fit.SplatParams.from_splats(start)
    opt = torch.optim.Adam(params.parameters(), lr=1e-2)
    cams = [make_camera([0.0, 0.0, 3.2], [0, 0, 0], [0, 1, 0], 1.0, w, h,
                        device="cpu")]
    targets = torch.rand((1, h, w, 3))
    step = fit.train_step_fn(opt, w, h)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(params, start.valid, cams, targets)
    host = Trace(prof, 1.0).host
    got = spans.training_spans(host)
    steps = sorted(s for s in got if s[2] == spans.STEP)
    assert [n for *_, n in got].count(spans.BACKWARD) == 2
    assert [n for *_, n in got].count(spans.OPTIMIZER) == 2 == len(steps)
    for a, b, _ in steps:
        inner = {n: (s, e) for s, e, n in got if a <= s and e <= b
                 and n != spans.STEP}
        fwd = [(s, e) for s, e, n in host
               if n.startswith("m2s.render.") and a <= s and e <= b]
        assert {"m2s.render.project", "m2s.render.bin",
                "m2s.render.composite"} <= {n for s, e, n in host
                                            if a <= s and e <= b}
        bwd, opt_span = inner[spans.BACKWARD], inner[spans.OPTIMIZER]
        assert max(e for _, e in fwd) <= bwd[0] < bwd[1] <= opt_span[0]


class _Event:
    """A profiler event as ``Trace`` reads it."""

    def __init__(self, name, start, end, device, corr=0, link=0, tid=1,
                 annotation=False):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       duration_ns=end - start, correlation_id=corr,
                       linked_correlation_id=link, start_thread_id=tid,
                       is_user_annotation=annotation)
        self._device = device

    def __getattr__(self, key):
        """The event's readings as methods; like torch 2.11's, it has no
        ``activity_type``."""
        if key == "device_type":
            from torch.autograd import DeviceType
            return lambda: DeviceType.CUDA if self._device else DeviceType.CPU
        if key not in self._v:
            raise AttributeError(key)
        return lambda: self._v[key]


def _prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def test_trace_leaves_out_annotations_and_links_launches():
    """A user annotation's copy on the device's timeline is no device
    work; a kernel belongs to the host event its launching op ran in, on
    that op's thread."""
    node = "autograd::engine::evaluate_function: IndexSelectBackward0"
    events = [
        _Event("Optimizer.step#Adam.step", 0, 900, False, corr=7,
               annotation=True),
        _Event("Optimizer.step#Adam.step", 100, 900, True, corr=7,
               annotation=True),
        _Event(node, 1000, 2000, False, corr=40, tid=2),
        _Event("aten::index_add_", 1100, 1200, False, corr=41, tid=2),
        _Event("cudaLaunchKernel", 1150, 1160, False, corr=41, link=41,
               tid=2),      # CUPTI's id, equal by chance to an op's
        _Event("indexFuncLargeIndex", 1300, 1700, True, corr=41, link=41),
        _Event("aten::mul", 1500, 1600, False, corr=42, tid=1),
        _Event("mul_kernel", 2100, 2200, True, corr=50, link=42),
        _Event("aten::mul", 2500, 2600, False, corr=43, tid=2),
        _Event("mul_kernel", 2700, 2900, True, corr=51, link=43),
    ]
    t = Trace(_prof(events), 1e-6)
    assert t.busy_s == pytest.approx(700e-9)
    assert [n for *_, n in t.device] == ["indexFuncLargeIndex", "mul_kernel",
                                         "mul_kernel"]
    assert t.device_s_under("IndexSelectBackward0$") == pytest.approx(400e-9)
    assert t.device_s_under("aten::mul") == pytest.approx(300e-9)
    assert t.device_s_under("nothing") == 0.0
