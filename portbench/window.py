"""The timed window: requests in a closed loop, and the arithmetic of its
rates.

One client sends the next request when the last has answered, until
`seconds` have passed; the request in flight at that moment is finished
and counted.  A rate is the work of every request that answered over the
whole span, from the first send to the last answer.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
import traceback
from typing import Any, Callable


@dataclasses.dataclass
class Request:
    start_s: float          # on the window's clock, from its start
    wall_s: float
    ok: bool
    work: float = 0.0       # what the request did, in its kind's unit
    kept: Any = None        # the answer, kept for the check


@dataclasses.dataclass
class Window:
    requests: list
    span_s: float

    @property
    def attempted(self) -> int:
        return len(self.requests)

    @property
    def failed(self) -> int:
        return sum(not r.ok for r in self.requests)

    def rate(self) -> float:
        """The work of the requests that answered over the whole span."""
        return sum(r.work for r in self.requests if r.ok) / self.span_s


def run_window(request: Callable[[], tuple], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call request() -> (work, kept) in a closed loop for `seconds`.  A
    request that raises is recorded as failed, its traceback on stderr."""
    reqs = []
    t0 = clock()
    while True:
        t = clock()
        try:
            work, kept = request()
            ok = True
        except Exception:           # the window goes on; the run reports it
            traceback.print_exc(file=sys.stderr)
            work, kept, ok = 0.0, None, False
        reqs.append(Request(t - t0, clock() - t, ok, work, kept))
        if clock() - t0 >= seconds:
            break
    return Window(reqs, clock() - t0)


def median(values: list[float]) -> float:
    return statistics.median(values)
