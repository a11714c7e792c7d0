"""Where the time of one env step goes: the PyTorch port's rollout of a task
(ANM6Easy unless ``--env feeder33`` or ``--env feeder141``) at B=4096 on a
CUDA device, under ``torch.profiler``; or of one training iteration.

    python3 scripts/profile_torch_rollout.py [--env anm6easy] [--pf tree] [--warm-start] [--batch 4096]
                                             [--steps 8] [--auto-reset {pool,step}] [--train {ppo,sac}]
                                             [--fleet G] [--seed 0] [--trace PATH]

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
by device time.  ``--fleet G`` (anm6easy, feeder33) also profiles a step of
a domain-randomized fleet of G grid variants x ``--batch / G`` lanes
(``envs/randomized.py``, branch jitter 0.2) and prints its numbers under
``"fleet"``, next to the plain step's.  ``--trace PATH`` also writes the
Chrome trace of the profiled unit (with ``--fleet``, the fleet's).
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


def profile_unit(run, units, counter, kname, trace=None) -> dict:
    """Warm ``run`` up, time it untraced, then profile it: ``run`` executes
    ``units`` units (steps or iterations)."""
    from torch.profiler import ProfilerActivity, profile

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
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    return {
        "untraced_ms_per_unit": untraced_ms, "traced_ms_per_unit": traced_ms,
        "cuda_events_per_unit": len(kernels) / units,
        "device_busy_ms_per_unit": busy_us / 1e3 / units,
        "device_busy_share": busy_us / 1e3 / (traced_ms * units),
        "kernel": kname, "kernel_launches": launches,
        "kernel_ms_per_launch": kernel_us / 1e3 / max(launches, 1),
        "top_kernels": [
            {"name": name[:80], "count": n, "device_ms": t / 1e3} for name, (n, t) in top
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="anm6easy", choices=("anm6easy", "feeder33", "feeder141"))
    ap.add_argument("--pf", default="tree", help="pf_method of the core (tree, pallas, hybrid, fused, ...)")
    ap.add_argument("--warm-start", action="store_true", help="warm-start each step's solve")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--auto-reset", choices=("pool", "step"), default=None, help="rebirth terminated lanes")
    ap.add_argument("--train", choices=("ppo", "sac"), default=None, help="profile a training iteration")
    ap.add_argument("--fleet", type=int, default=0, metavar="G", help="also profile a fleet of G grid variants")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args()
    if args.fleet and (args.train or args.auto_reset or args.env == "feeder141"):
        ap.error("--fleet profiles rollouts of anm6easy or feeder33 without --train or --auto-reset")
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
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
    path, _ = resolve_solver_path(core.grid, args.pf, core.nr_pivot)
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
    out = profile_unit(run, units, counter, kname, args.trace if not args.fleet else None)
    if args.fleet:
        from gym_anm_tpu_torch.envs import randomized

        builder = {"anm6easy": randomized.randomized_anm6easy_cores,
                   "feeder33": randomized.randomized_feeder33_cores}[args.env]
        cores = builder(args.fleet, seed=args.seed, r_sigma=0.2, x_sigma=0.2, dtype=torch.float32, device="cuda",
                        pf_method=args.pf, warm_start=args.warm_start)
        fleet = randomized.MultiBatchedEnv(cores, args.batch // args.fleet, generator=gen)
        fstate = [fleet.reset()[0]]
        fstate[0] = fleet.rollout(fstate[0], 4)[0]
        frun = lambda: fstate.__setitem__(0, fleet.rollout(fstate[0], args.steps)[0])
        fleet_out = {"G": fleet.G, "L": fleet.L, **profile_unit(frun, units, counter, kname, args.trace)}
    unit = "iteration" if args.train else "step"
    named = lambda d: {k.replace("_unit", "_" + unit): v for k, v in d.items()}
    print(json.dumps({
        "card": smi, "env": args.env, "pf_method": args.pf, "warm_start": args.warm_start, "B": args.batch,
        "auto_reset": args.auto_reset, "train": args.train, "units": units, "unit": unit,
        **named(out), **({"fleet": named(fleet_out)} if args.fleet else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
