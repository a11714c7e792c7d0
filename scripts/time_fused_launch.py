"""Host time of one launch of the fused-transition kernel's wrapper.

    python3 scripts/time_fused_launch.py [--env anm6easy] [--batch 4096] [--calls 200] [--trials 7]

Builds the task's fused-transition tables on the GPU, then times
``step_cuda.fused_transition_cuda`` on the host clock: ``--calls`` calls
issued back to back without a synchronisation (the launches queue on the
stream, so the host never waits for the card), per call, median over
``--trials``.  This is the wrapper's host work (argument checks, the output
allocation, the ctypes call and the launch), not the kernel's device time.
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="anm6easy", choices=("anm6easy", "feeder33"))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--trials", type=int, default=7)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fused_launch: no CUDA device is available", file=sys.stderr)
        return 2
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import step_cuda

    core = check.task_make_core(a.env)(dtype=torch.float32, device="cuda", pf_method="fused")
    env = BatchedEnv(core, a.batch, generator=torch.Generator(device="cuda").manual_seed(0))
    es, _ = env.reset()
    vars = core.next_vars_fn(es.state_vec, env.generator)
    lanes = step_cuda.pack_inputs(**core.transition_inputs(es, env.random_actions(), vars))
    st = core.grid.step
    kw = dict(x_tol=core.x_tol, max_iter=core.max_iter)
    step_cuda.fused_transition_cuda(st, lanes, **kw)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(a.trials):
        t0 = time.perf_counter()
        for _ in range(a.calls):
            step_cuda.fused_transition_cuda(st, lanes, **kw)
        per_call.append((time.perf_counter() - t0) / a.calls * 1e6)
        torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "env": a.env, "B": a.batch, "calls": a.calls, "trials": a.trials, "host_us_per_call": per_call,
        "median_host_us_per_call": float(np.median(per_call)), "gpu": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
