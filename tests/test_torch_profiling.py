"""The port's step-rate counter and profiler trace against the JAX
package's: the same (steps, seconds) samples give the same summary; a
trace of a CPU block writes a non-empty Chrome trace."""

import json
import os
import time

import pytest
import torch

from gym_anm_tpu.profiling import StepRateCounter as JaxStepRateCounter

from gym_anm_tpu_torch.profiling import StepRateCounter, trace


SAMPLES = [(4096, 0.25), (8192, 0.125), (100, 3.0), (7, 0.0), (4096, 0.3)]


def _feed(counter, monkeypatch):
    """Record ``SAMPLES`` through ``counter.measure`` on a clock that
    advances by each sample's seconds inside its block."""
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    for steps, seconds in SAMPLES:
        with counter.measure(steps):
            now[0] += seconds
    return counter


def test_step_rate_counter_summary_equals_jax(monkeypatch):
    port = _feed(StepRateCounter(), monkeypatch)
    jax_counter = _feed(JaxStepRateCounter(), monkeypatch)
    assert port.summary() == jax_counter.summary()
    assert port.summary()["samples"] == len(SAMPLES)
    assert port.rate() == pytest.approx(sum(n for n, _ in SAMPLES) / sum(t for _, t in SAMPLES))
    port.reset()
    jax_counter.reset()
    assert port.summary() == jax_counter.summary() == {
        "samples": 0, "total_steps": 0, "total_seconds": 0, "steps_per_s": 0.0, "median_steps_per_s": 0.0,
    }
    assert StepRateCounter().device == torch.device("cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]
