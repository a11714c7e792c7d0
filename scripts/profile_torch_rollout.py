"""Where the time of one env step goes: the PyTorch port's ANM6Easy rollout
at B=4096 on a CUDA device, under ``torch.profiler``.

    python3 scripts/profile_torch_rollout.py [--batch 4096] [--steps 8] [--seed 0] [--trace PATH]

Warms up (build, reset, a few steps), then times ``--steps`` steps untraced
(host clock around work that ends in a synchronize) and profiles the same
number of steps.  Prints one JSON line: wall ms per step untraced and
traced, CUDA device events (kernels and copies) per step, device busy ms
per step (the sum of their durations on the one stream) and its share of
the traced step time, the tree-NR kernel's device time per launch, and the
top kernels by device time.  ``--trace PATH`` also writes the Chrome trace
of the profiled steps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import tree_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    env = BatchedEnv(make_core(dtype=torch.float32, device="cuda"), args.batch, generator=gen)
    es, _ = env.reset()
    es, _ = env.rollout(es, 4)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    es, _ = env.rollout(es, args.steps)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    launches0 = tree_cuda.KERNEL_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        es, _ = env.rollout(es, args.steps)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    tree_launches = tree_cuda.KERNEL_LAUNCHES - launches0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    tree_us = sum(t for name, (n, t) in by_name.items() if "tree_nr" in name)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": smi, "B": args.batch, "steps": args.steps,
        "untraced_ms_per_step": untraced_ms, "traced_ms_per_step": traced_ms,
        "cuda_events_per_step": len(kernels) / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_busy_share": busy_us / 1e3 / (traced_ms * args.steps),
        "tree_nr_launches": tree_launches,
        "tree_nr_ms_per_launch": tree_us / 1e3 / max(tree_launches, 1),
        "top_kernels": [
            {"name": name[:80], "count": n, "device_ms": t / 1e3} for name, (n, t) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
