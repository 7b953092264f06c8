"""The window's arithmetic and the trace's reduction, on made-up clocks
and intervals."""
from __future__ import annotations

import itertools

import pytest

from portbench import devtrace
from portbench.window import median, run_window


class Clock:
    """A clock that each request advances by its own duration."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def test_rate_counts_every_request_over_the_whole_span():
    clock = Clock()
    walls = itertools.cycle([0.4, 0.6])

    def request():
        clock.t += next(walls)
        return 2.0, None

    w = run_window(request, 1.5, clock)
    # 0.4 + 0.6 + 0.4 = 1.4 < 1.5, so a fourth request runs to its end
    assert w.attempted == 4 and w.failed == 0
    assert w.span_s == pytest.approx(2.0)
    assert w.rate() == pytest.approx(8.0 / 2.0)
    assert [r.start_s for r in w.requests] == pytest.approx([0, .4, 1., 1.4])


def test_a_failed_request_counts_as_never_answered():
    clock = Clock()
    n = itertools.count()

    def request():
        clock.t += 1.0
        if next(n) == 1:
            raise RuntimeError("refused")
        return 1.0, "answer"

    w = run_window(request, 2.5, clock)
    assert w.attempted == 3 and w.failed == 1
    assert w.rate() == pytest.approx(2.0 / 3.0)
    assert w.requests[1].kept is None
    assert median([r.wall_s for r in w.requests]) == pytest.approx(1.0)


def test_busy_is_the_union_of_device_intervals_in_the_window():
    t = devtrace.Trace(
        device=[(0.0, 2.0, "k"), (1.0, 3.0, "k"), (5.0, 6.0, "Memcpy"),
                (9.0, 12.0, "k")],
        host=[(0.0, 10.0, devtrace.WINDOW_SPAN), (3.0, 4.5, "aten::cat"),
              (3.5, 4.0, "cudaMemcpyAsync")],
        window=(0.5, 10.0))
    assert t.busy() == [(0.5, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert t.busy_s() == pytest.approx(4.5)
    assert t.device_s("k") == pytest.approx(1.5 + 2.0 + 1.0)
    assert t.top_device_ops() == [["k", pytest.approx(4.5)],
                                  ["Memcpy", pytest.approx(1.0)]]
    # gaps (3, 5) and (6, 9): the first's middle 4.0 lies in both host
    # spans, the innermost names it; nothing covers 7.5
    assert t.idle_gaps() == [["after aten::cat", pytest.approx(3.0)],
                             ["cudaMemcpyAsync", pytest.approx(2.0)]]


def test_annotations_on_the_device_timeline_are_not_device_work():
    class Ev:
        def __init__(self, name, a, b, dev):
            from torch.autograd import DeviceType

            self.name = name
            self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
            self.time_range = type("R", (), {"start": a, "end": b})()

    class Prof:
        def events(self):
            return [Ev(devtrace.WINDOW_SPAN, 0, 1e6, False),
                    Ev(devtrace.WINDOW_SPAN, 0, 1e6, True),
                    Ev("void track_fused_kernel<0>(...)", 1e5, 3e5, True)]

    t = devtrace.from_profiler(Prof())
    assert t.window == (0.0, 1.0)
    assert t.busy_s() == pytest.approx(0.2)
