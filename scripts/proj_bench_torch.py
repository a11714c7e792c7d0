#!/usr/bin/env python
"""Time the exact-projection forms of ``gym_anm_tpu_torch/ops/projection.py``
on a CUDA device: the counterpart of ``scripts/proj_bench.py``.

    python3 scripts/proj_bench_torch.py [--batch 4096] [--steps 64] [--trials 7]
                                        [--env anm6easy feeder33 feeder141] [--dtype float32]

For each task's capability polytopes (ANM6Easy C=3, feeder33 C=7, feeder141
C=21 devices; 10 feet and 36 vertices, K=47 candidates each) it builds one
case at ``--batch`` lanes (the dynamic rows random, a quarter of them +inf;
points near the regions and far out; NaN, +inf and -inf set-points and an
empty region on a few lanes) and prints one JSON line a form
(``running_min``, ``stacked``, ``box_slants``):

* ``ms_call`` / ``graph_ms_call``: the median CUDA-event time of one call
  over runs of 20 calls, issued eagerly / replayed from a CUDA graph (null,
  with ``graph_error``, where a form's call cannot be captured);
* ``ms_step_loop`` / ``graph_ms_step_loop``: the same over a ``--steps``
  loop that feeds each result back into the next call's points (the JAX
  script's scan), per step;
* ``aten_ops``: the aten operators a call dispatches, views excluded;
  ``device_events``: the kernels and copies one call puts on the device
  (``torch.profiler``);
* ``peak_bytes``: the device memory a call allocates beyond its inputs;
* ``max_abs_diff`` from ``running_min`` on lanes with finite set-points,
  ``bit_identical`` to it on every lane (bit patterns, NaN included), and
  for ``box_slants`` the largest difference of squared distances;
* ``card``: the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORM_NAMES = ("running_min", "stacked", "box_slants")
GRAPH_CALLS = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def task_polytopes(env_name):
    """The task's grid spec, static normals ``[C, m, 2]`` and offsets ``[C, m]``."""
    from gym_anm_tpu_torch.core.grid import build_grid
    from gym_anm_tpu_torch.envs.anm6.network import network
    from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network

    net = {"anm6easy": lambda: network, "feeder33": make_feeder_network, "feeder141": make_multi_feeder_network}
    spec, _ = build_grid(net[env_name](), 0.25, 100, dtype=np.float64)
    G = np.concatenate([np.asarray(spec.gen_G), np.asarray(spec.des_G)], axis=0)
    h0 = np.concatenate([np.asarray(spec.gen_h0), np.asarray(spec.des_h0)], axis=0)
    return spec, G, h0


def make_case(spec, G, h0, B, seed=0):
    """NumPy float64 ``(px [C, B], py [C, B], h [C, m, B])`` (see the module
    docstring)."""
    from gym_anm_tpu_torch.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR

    C, n_gen = G.shape[0], spec.n_gen
    rng = np.random.default_rng(seed)
    h = np.repeat(h0[:, :, None], B, axis=2)
    cap = rng.uniform(0.0, 0.6, (C, B))
    cap[rng.uniform(size=(C, B)) < 0.25] = np.inf
    h[:, POLY_ROW_P_CAP] = cap
    floor = rng.uniform(0.0, 0.6, (C - n_gen, B))
    floor[rng.uniform(size=floor.shape) < 0.25] = np.inf
    h[n_gen:, POLY_ROW_P_FLOOR] = floor
    scale = np.where(np.arange(B) < B // 2, 0.3, 1.5)
    px = rng.uniform(-1.0, 1.0, (C, B)) * scale
    py = rng.uniform(-1.0, 1.0, (C, B)) * scale
    px[:, 0], py[:, 1] = np.nan, np.nan
    px[:, 2], py[:, 2] = np.nan, np.nan
    px[:, 3], py[:, 4] = np.inf, -np.inf
    px[:, 5], py[:, 5] = -np.inf, np.inf
    h[n_gen:, POLY_ROW_P_CAP, 6] = -0.5  # an empty region: p <= -0.5 and p >= 0.5
    h[n_gen:, POLY_ROW_P_FLOOR, 6] = -0.5
    return px, py, h


def projectors(G, device, dtype):
    from gym_anm_tpu_torch.ops.projection import BoxSlantsProjector, LanesProjector

    return {
        "running_min": LanesProjector(G, device, dtype, form="running_min"),
        "stacked": LanesProjector(G, device, dtype, form="stacked"),
        "box_slants": BoxSlantsProjector(G, device, dtype),
    }


def event_ms(fn, calls, trials, graph=False):
    """Median over ``trials`` of the CUDA-event time of ``calls`` calls of
    ``fn``, per call, after one warm-up; ``graph``: replayed from one CUDA
    graph of the calls."""
    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(calls)]
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    ts = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / calls)
    return float(np.median(ts))


def graph_ms(fn, calls, trials):
    """``event_ms`` from a CUDA graph, and why not where the calls cannot be
    captured (the running minimum indexes rows with a Python list, a copy
    from the host each call)."""
    try:
        return event_ms(fn, calls, trials, graph=True), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, str(e).splitlines()[0]


def device_events(fn) -> int:
    """The kernels and copies one call of ``fn`` puts on the device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def bench_task(env_name, B=4096, steps=64, trials=7, dtype=torch.float32, device="cuda", forms=FORM_NAMES,
               loop=True, calls=GRAPH_CALLS):
    """One row a form for a task's polytopes (see the module docstring);
    ``calls`` calls a timed run."""
    from gym_anm_tpu_torch.profiling import count_aten_ops

    spec, G, h0 = task_polytopes(env_name)
    px_np, py_np, h_np = make_case(spec, G, h0, B)
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)
    px, py, h = t(px_np), t(py_np), t(h_np)
    finite = torch.isfinite(px) & torch.isfinite(py)
    procs = projectors(G, device, dtype)

    def step_loop(proj):
        def run():
            x, y = px, py
            for _ in range(steps):
                x, y = proj(x, y, h)
                x, y = x * 0.99 + 0.01 * px, y * 0.99 + 0.01 * py
            return x, y

        return run

    ref_x, ref_y = procs["running_min"](px, py, h)
    K = 1 + len(procs["running_min"].feet) + len(procs["running_min"].vertices)
    rows = []
    for form in forms:
        proj = procs[form]
        call = lambda proj=proj: proj(px, py, h)
        (x, y), ops = count_aten_ops(call)
        row = {
            "env": env_name, "form": form, "B": B, "C": int(G.shape[0]), "dtype": str(dtype).split(".")[-1],
            "candidates": K,
            "ms_call": event_ms(call, calls, trials),
            "aten_ops": ops, "device_events": device_events(call), "peak_bytes": peak_bytes(call),
            "max_abs_diff": float(torch.maximum((x - ref_x).abs(), (y - ref_y).abs())[finite].max()),
            "bit_identical": bool(torch.equal(bits(x), bits(ref_x)) and torch.equal(bits(y), bits(ref_y))),
        }
        row["graph_ms_call"], row["graph_error"] = graph_ms(call, calls, trials)
        if form == "box_slants":
            d = lambda a, b: (a - px) ** 2 + (b - py) ** 2
            row["max_abs_dist_diff"] = float((d(x, y) - d(ref_x, ref_y)).abs()[finite].max())
        if loop:
            run = step_loop(proj)
            row["ms_step_loop"] = event_ms(run, 1, trials) / steps
            loop_ms = graph_ms(run, 1, trials)[0]
            row["graph_ms_step_loop"] = None if loop_ms is None else loop_ms / steps
            row["steps"] = steps
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--env", nargs="+", default=["anm6easy", "feeder33", "feeder141"],
                    choices=("anm6easy", "feeder33", "feeder141"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("proj_bench_torch: no CUDA device is available", file=sys.stderr)
        return 2
    from gym_anm_tpu_torch.core.grid import projection_form

    card = card_line()
    for env_name in args.env:
        for row in bench_task(env_name, args.batch, args.steps, args.trials, getattr(torch, args.dtype)):
            row.update(default_form=projection_form("cuda"), card=card)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
