"""Lightweight observability: step-rate counters and profiler traces.

The counterpart of ``gym_anm_tpu.profiling``.  Two tools:

``StepRateCounter``
    A host-side throughput meter for rollout loops.  Records
    (steps, seconds) pairs per measured block and reports total / median
    rates.  Median-of-blocks is the robust statistic where single blocks
    see host-side latency noise.  On a CUDA device, :meth:`measure`
    synchronizes the device before it reads the clock, so a block's time
    includes the device work it queued.

``trace``
    Context manager around ``torch.profiler`` that writes a Chrome /
    Perfetto trace (``trace.json``) under a log directory, with the CUDA
    activity when a card is present.

``count_aten_ops``
    The aten operators a call dispatches, views excluded: on a card, an
    upper bound on the kernels it launches (a host-bound step's cost).

Example::

    counter = StepRateCounter(device="cuda")
    for _ in range(segments):
        with counter.measure(batch * n_steps):
            es, (rew, term) = env.rollout(es, n_steps)
    print(counter.summary())
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

__all__ = ["StepRateCounter", "count_aten_ops", "trace"]


class StepRateCounter:
    """Accumulates (env-steps, wall-seconds) samples; reports rates.

    ``device`` is where the measured work runs (default: the CPU, where
    measuring adds no synchronization)."""

    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self._samples: list[tuple[int, float]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def measure(self, n_steps: int):
        """Time a block that executes ``n_steps`` environment steps: the
        device's queued work is finished before the clock starts and before
        it stops."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self._samples.append((int(n_steps), time.perf_counter() - t0))

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    @property
    def total_steps(self) -> int:
        return sum(n for n, _ in self._samples)

    @property
    def total_seconds(self) -> float:
        return sum(t for _, t in self._samples)

    def rate(self) -> float:
        """Aggregate steps/s over all samples."""
        return self.total_steps / self.total_seconds if self.total_seconds else 0.0

    def median_rate(self) -> float:
        """Median of per-sample rates (robust to queueing outliers)."""
        if not self._samples:
            return 0.0
        return statistics.median(n / t for n, t in self._samples if t > 0)

    def reset(self) -> None:
        self._samples.clear()

    def summary(self) -> dict:
        return {
            "samples": self.n_samples,
            "total_steps": self.total_steps,
            "total_seconds": self.total_seconds,
            "steps_per_s": self.rate(),
            "median_steps_per_s": self.median_rate(),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``).  CPU activity always, CUDA activity when a card
    is available."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def count_aten_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count the aten operators it
    dispatches that are not views.  Returns ``(result, count)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                _Count.n += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        out = fn(*args, **kwargs)
    return out, _Count.n
