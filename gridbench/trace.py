"""A profiled stretch of a run and what the per-layer readers take from it.

:func:`capture` runs a callable under ``torch.profiler`` (CPU activity, and
CUDA activity on a card), exports the Chrome trace to a temporary file in
``TMPDIR``, reads it and deletes it.  :class:`Trace` holds the device's
operations (kernels, copies, fills) and the host's aten operators with their
times, and the length of the profiled window by the host's clock.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device_ops = sorted(
            (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
        )
        self.host_ops = sorted(
            (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"
        )
        self._busy = self._merge()

    def _merge(self):
        out = []
        for a, b, _ in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def n_device_ops(self) -> int:
        return len(self.device_ops)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        their intervals)."""
        return sum(b - a for a, b in self._busy) * 1e-6

    def kernel_time(self, name_part: str) -> tuple[float, int]:
        """``(seconds, count)`` of the device operations whose name contains
        ``name_part``."""
        ds = [b - a for a, b, n in self.device_ops if name_part in n]
        return sum(ds) * 1e-6, len(ds)

    def top_device_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for a, b, n in self.device_ops:
            tot[n] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle gaps between operations, summed by the host
        operator running at each gap's middle (``python`` where none ran)."""
        starts = [h[0] for h in self.host_ops]
        tot = defaultdict(float)
        for (_, a), (b, _) in zip(self._busy[:-1], self._busy[1:]):
            mid = 0.5 * (a + b)
            name = "python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 200, -1), -1):
                if self.host_ops[j][1] >= mid:
                    name = self.host_ops[j][2]
                    break
            tot[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:k]


def capture(fn) -> Trace:
    """Run ``fn()`` under the profiler, the device synchronised at both
    ends, and read its trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="gridbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window)
