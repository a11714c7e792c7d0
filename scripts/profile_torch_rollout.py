"""Where the time of one env step goes: the PyTorch port's rollout of a task
(ANM6Easy unless ``--env feeder33`` or ``--env feeder141``) at B=4096 on a
CUDA device, under ``torch.profiler``; or of one training iteration.

    python3 scripts/profile_torch_rollout.py [--env anm6easy] [--pf tree] [--warm-start] [--batch 4096]
                                             [--steps 8] [--auto-reset {pool,step}] [--train {ppo,sac}]
                                             [--seed 0] [--trace PATH]

Warms up (build, reset, a few steps), then times ``--steps`` steps untraced
(host clock around work that ends in a synchronize) and profiles the same
number of steps, one rollout segment each (``--auto-reset``: terminated
lanes reborn, in pool mode from one pool of fresh states a segment).  With
``--train`` the unit is one iteration of the trainer with its default
configuration (PPO: a 64-step rollout and 32 minibatch updates; SAC: 32
collect steps and 32 updates), after one warm-up iteration.  Prints one
JSON line: wall ms per unit untraced and traced, CUDA device events
(kernels and copies) per unit, device busy ms per unit (the sum of their
durations on the one stream) and its share of the traced time, the
launches and device time per launch of the kernel of the ``--pf`` solver
path (tree: the tree-NR kernel, pallas and hybrid: the dense-NR kernel,
fused and fused_hybrid: the whole-transition kernel), and the top kernels
by device time.  ``--trace PATH`` also writes the Chrome trace of the
profiled unit.
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
    ap.add_argument("--env", default="anm6easy", choices=("anm6easy", "feeder33", "feeder141"))
    ap.add_argument("--pf", default="tree", help="pf_method of the core (tree, pallas, hybrid, fused, ...)")
    ap.add_argument("--warm-start", action="store_true", help="warm-start each step's solve")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--auto-reset", choices=("pool", "step"), default=None, help="rebirth terminated lanes")
    ap.add_argument("--train", choices=("ppo", "sac"), default=None, help="profile a training iteration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.core.transition import resolve_solver_path
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda
    from gym_anm_tpu_torch.rl import PPOTrainer, SACTrainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    core = check.task_make_core(args.env)(
        dtype=torch.float32, device="cuda", pf_method=args.pf, warm_start=args.warm_start
    )
    path, _ = resolve_solver_path(core.grid, args.pf)
    counter, kname = {
        "tree_kernel": (tree_cuda, "tree_nr"),
        "nr_kernel": (nr_cuda, "nr_dense"),
        "fused_kernel": (step_cuda, "step_fused"),
    }.get(path, (None, None))
    if args.train == "ppo":
        trainer = PPOTrainer(core, args.batch, generator=gen)
        state = [trainer.init_envs()]
        run = lambda: state.__setitem__(0, trainer.train_step(state[0])[0])
        units = 1
    elif args.train == "sac":
        trainer = SACTrainer(core, args.batch, generator=gen)
        es, rb, obs = trainer.init_envs()
        state = [trainer.warmup(es, rb, obs)]
        run = lambda: state.__setitem__(0, trainer.train_step(*state[0])[:3])
        units = 1
    else:
        env = BatchedEnv(core, args.batch, generator=gen, auto_reset=args.auto_reset is not None,
                         auto_reset_mode=args.auto_reset or "pool")
        state = [env.reset()[0]]
        state[0] = env.rollout(state[0], 4)[0]
        run = lambda: state.__setitem__(0, env.rollout(state[0], args.steps)[0])
        units = args.steps
    run()  # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / units

    launches0 = counter.KERNEL_LAUNCHES if counter else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / units
    launches = (counter.KERNEL_LAUNCHES if counter else 0) - launches0

    # Device events, without the ranges user annotations (such as
    # ``Optimizer.step``) mark on the device: those span kernels counted here.
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    kernel_us = sum(t for name, (n, t) in by_name.items() if kname and kname + "_kernel" in name)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    unit = "iteration" if args.train else "step"
    print(json.dumps({
        "card": smi, "env": args.env, "pf_method": args.pf, "warm_start": args.warm_start, "B": args.batch,
        "auto_reset": args.auto_reset, "train": args.train, "units": units, "unit": unit,
        "untraced_ms_per_" + unit: untraced_ms, "traced_ms_per_" + unit: traced_ms,
        "cuda_events_per_" + unit: len(kernels) / units,
        "device_busy_ms_per_" + unit: busy_us / 1e3 / units,
        "device_busy_share": busy_us / 1e3 / (traced_ms * units),
        "kernel": kname, "kernel_launches": launches,
        "kernel_ms_per_launch": kernel_us / 1e3 / max(launches, 1),
        "top_kernels": [
            {"name": name[:80], "count": n, "device_ms": t / 1e3} for name, (n, t) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
