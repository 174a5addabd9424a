"""The span readers (``m2s_bench/spans.py``) on hand-made traces: the
device's idle gaps split among the innermost spans by overlap, the parts
and ``outside`` summing to the idle, and the host's blocking waits counted
inside the entry spans only."""

import random
from types import SimpleNamespace

import pytest

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
