"""Streaming capture source: native pread + one-block lookahead.

The reference streams its 4.9 GB captures through `fread` one code
period at a time per channel (`BDS-3_B2a/tracking.m:237-254`), re-reading
the file once per channel.  Here the tracking driver consumes large
blocks (hundreds of MB) through a slice interface; this source serves
those slices with the native `pread` runtime (bds3_tpu/runtime, O(1)
page-cache pressure, POSIX_FADV_SEQUENTIAL) and overlaps the NEXT
block's disk read with the device compute of the current one via a
single lookahead thread — the IO analog of the fused kernel's window
DMA ring.

`track()` accepts any object with `__len__`/contiguous `__getitem__`
returning int8 numpy, so a StreamingCapture drops in wherever a memmap
or in-memory array does, without the driver holding the whole capture
in RAM or HBM.
"""
from __future__ import annotations

import threading

import numpy as np

from bds3_tpu_torch import runtime


class StreamingCapture:
    """Sequential-slice view over an int8 REAL8 capture file.

    Serves `cap[a:b]` via native pread; after each request it predicts
    the next block (same length, start advanced by the last observed
    stride) and reads it on a background thread, so strictly-advancing
    block loops (the tracking driver's schedule) hit the prefetched
    buffer.  Non-matching requests fall back to a synchronous read —
    correctness never depends on the prediction.
    """

    def __init__(self, path: str, skip_samples: int = 0):
        self.path = path
        self.skip = int(skip_samples)
        self._n = runtime.file_size(path) - self.skip
        if self._n <= 0:
            raise ValueError(f"empty capture {path!r} (skip {self.skip})")
        self.dtype = np.dtype(np.int8)
        self._lock = threading.Lock()
        self._thread = None
        self._pre_start = -1
        self._pre_buf = None
        self._last_start = None

    def __len__(self) -> int:
        return self._n

    @property
    def shape(self):
        return (self._n,)

    def _read(self, start: int, n: int) -> np.ndarray:
        n = max(0, min(n, self._n - start))
        if n <= 0:
            return np.zeros(0, np.int8)
        return runtime.pread_block(self.path, self.skip + start, n)

    def _prefetch(self, start: int, n: int) -> None:
        def work():
            buf = self._read(start, n)
            with self._lock:
                self._pre_start = start
                self._pre_buf = buf

        with self._lock:
            self._pre_start = -1
            self._pre_buf = None
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __getitem__(self, sl) -> np.ndarray:
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("StreamingCapture supports contiguous slices")
        start = 0 if sl.start is None else int(sl.start)
        stop = self._n if sl.stop is None else min(int(sl.stop), self._n)
        n = max(0, stop - start)

        buf = None
        if self._thread is not None:
            self._thread.join()
            with self._lock:
                if self._pre_start == start and self._pre_buf is not None \
                        and len(self._pre_buf) >= n:
                    buf = self._pre_buf[:n]
        if buf is None:
            buf = self._read(start, n)

        # predict the next block from the observed stride and read ahead
        if self._last_start is not None and start > self._last_start:
            stride = start - self._last_start
            self._prefetch(start + stride, n)
        self._last_start = start
        return buf
