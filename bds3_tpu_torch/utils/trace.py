"""The port's spans and counters.

`span(name)` marks a stretch of host work.  Under `torch.profiler` it is a
`record_function` span, on the profiler's clock beside the device's
kernels and copies, nested in the spans around it; otherwise it is one
shared no-op context and calls nothing in torch (`record_function` costs
~15 us a span even with no profiler running).  The profiler is the only
switch: a span costs a check of it when it is off.  A span around an
asynchronous torch call measures the enqueue; the device work under it is
read from the device trace by overlap.  `spanned(name)` puts each call of
a function in its span.

`count(name, n)` adds to one registry for the process; `counters()` reads
it, with the values of the readers that modules register with `mirror`
(the kernel wrappers' `.launches` attributes, which stay their store, as
`k1.launches`, `k2.launches` and `k3.launches`).
"""
from __future__ import annotations

import contextlib
import functools
from collections import defaultdict

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: defaultdict = defaultdict(int)
_MIRRORS: dict = {}


def span(name: str):
    """A context manager: a profiler span named `name` while a profiler
    records, else the shared no-op context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int | float = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] += n


def mirror(name: str, read) -> None:
    """Report `read()` as the counter `name`, for a count kept elsewhere."""
    _MIRRORS[name] = read


def counters() -> dict:
    """Every counter's total since the process started, with the mirrored
    counts."""
    return dict(_COUNTS, **{k: read() for k, read in _MIRRORS.items()})
