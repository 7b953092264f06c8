"""The reduction of a `torch.profiler` trace of the window.

The device's busy time is the union of the intervals in which any
operation ran on it (kernels, copies and fills), clipped to the window;
the window is the harness's own `portbench.window` span.  The profiler
mirrors host spans onto the device's timeline as annotations; those are
no device work and are left out.  Idle gaps, the stretches of the window
in which nothing ran on the device, are named by what the host was doing
at their middle: the innermost host span there, or else "after" the last
host span that had ended (`profile_cell` in chip_smoke.py takes the same
union).
"""
from __future__ import annotations

import dataclasses

import numpy as np

WINDOW_SPAN = "portbench.window"
TOP = 10          # entries of each breakdown list
NAME_CHARS = 120  # a name's length in the breakdown


@dataclasses.dataclass
class Trace:
    """Intervals in seconds on the trace's clock: (start, end, name)."""

    device: list
    host: list
    window: tuple

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self, ivs):
        lo, hi = self.window
        return [(max(a, lo), min(b, hi), n) for a, b, n in ivs
                if b > lo and a < hi]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals in the window, merged."""
        merged = []
        for a, b, _ in sorted(self._clipped(self.device)):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_s(self, contains: str) -> float:
        """Device seconds of the operations whose name holds `contains`."""
        return sum(b - a for a, b, n in self._clipped(self.device)
                   if contains in n)

    def top_device_ops(self, n: int = TOP) -> list:
        tot = {}
        for a, b, name in self._clipped(self.device):
            key = name[:NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = TOP) -> list:
        """The window's idle time summed by what the host was doing."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = [(a, b, name) for a, b, name in self.host
                if name != WINDOW_SPAN]
        hs = np.array([a for a, _, _ in host])
        he = np.array([b for _, b, _ in host])
        tot = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            idx = np.nonzero((hs <= mid) & (he >= mid))[0] if host else []
            if len(idx):
                inner = idx[np.argmin(he[idx] - hs[idx])]
                key = host[inner][2][:NAME_CHARS]
            elif host and (he <= mid).any():
                last = int(np.argmax(np.where(he <= mid, he, -np.inf)))
                key = f"after {host[last][2]}"[:NAME_CHARS]
            else:
                key = "(no host span)"
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]


def from_profiler(prof) -> Trace:
    """The Trace of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        iv = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(iv)
    spans = {n for _, _, n in host}
    dev = [iv for iv in dev if iv[2] not in spans]      # annotations
    marks = [(a, b) for a, b, n in host if n == WINDOW_SPAN]
    if marks:
        window = marks[0]
    else:
        every = dev + host
        window = (min(a for a, _, _ in every), max(b for _, b, _ in every))
    return Trace(dev, host, window)
