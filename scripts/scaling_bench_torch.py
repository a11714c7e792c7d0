#!/usr/bin/env python
"""Weak scaling of batched ANM6Easy stepping over 1, 2, 4, ... ranks.

The counterpart of ``scripts/scaling_bench.py``, with its defaults.  For
each rank count ``n`` (powers of two up to the machine's card count, or to
``--world`` with ``--backend gloo``), ``n`` spawned ranks
(``parallel/dryrun.py::run_ranks``, one a card) each step their own
``--per-device-batch`` lanes through ``tree`` (the tree-NR kernel on a
card): one warm-up rollout of ``--steps`` steps, then ``--iters`` timed
rollouts that every rank starts together after a barrier, each timed by
CUDA events on a card (the host clock on the CPU).  An iteration's time is
its slowest rank's.  Stepping issues no collective, so the efficiency is
bounded only by what the ranks share: the host's cores and memory.

    python scripts/scaling_bench_torch.py [--per-device-batch 512] [--steps 32] [--iters 5]
    python scripts/scaling_bench_torch.py --backend gloo --world 2   # CPU processes

Prints one JSON line a rank count: ``devices``, ``batch``, ``steps_per_s``
(global env-steps/s over the median iteration), ``efficiency`` (against
``devices`` times the 1-rank rate), the tree kernel's launches a step and
the card's ``nvidia-smi`` name and power limit (``host CPU`` over gloo).
Each rank count's ranks have ``parallel/dryrun.py::RANKS_TIMEOUT`` seconds
to report.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_rank(backend, batch, steps, iters):
    """In each rank: ``iters`` timed rollouts of its ``batch`` lanes (ms)."""
    import torch.distributed as dist

    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import tree_cuda
    from gym_anm_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device_type="cuda" if backend == "nccl" else "cpu")
    dev = sharding.rank_device(mesh)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(sharding.rank_seed(0, dist.get_rank()))
    env = BatchedEnv(make_core(torch.float32, dev), batch, generator=gen)
    es, _ = env.reset()
    es, _ = env.rollout(es, steps)  # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
    tree_cuda.KERNEL_LAUNCHES = 0
    ms = []
    for _ in range(iters):
        dist.barrier()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            es, (reward, _) = env.rollout(es, steps)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            es, (reward, _) = env.rollout(es, steps)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms": ms, "tree_nr_launches": tree_cuda.KERNEL_LAUNCHES, "finite": bool(torch.isfinite(reward).all()),
            "device": torch.cuda.get_device_name(dev) if cuda else "host CPU"}


def card_line():
    """The first card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--world", type=int, default=None, help="the largest rank count (gloo; nccl: every card)")
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    from gym_anm_tpu_torch.parallel.dryrun import run_ranks

    if args.backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("--backend nccl needs a card (use --backend gloo for CPU processes)")
        if args.world is not None:
            raise ValueError("--world is for gloo: over nccl the ranks are the machine's cards")
        n_max, card = torch.cuda.device_count(), card_line()
    else:
        n_max, card = args.world or 1, "host CPU"
    base = None
    for n in (d for d in (1, 2, 4, 8, 16) if d <= n_max):
        ranks = run_ranks(bench_rank, n, args.backend, (args.backend, args.per_device_batch, args.steps, args.iters))
        if not all(r["finite"] for r in ranks):
            raise AssertionError("non-finite rewards at %d ranks" % n)
        slowest = np.max([r["ms"] for r in ranks], axis=0)
        B = n * args.per_device_batch
        sps = B * args.steps / (float(np.median(slowest)) / 1e3)
        base = sps if base is None else base
        print(json.dumps({
            "devices": n, "batch": B, "steps": args.steps, "iters": args.iters, "steps_per_s": sps,
            "efficiency": sps / (base * n), "iteration_ms": slowest.tolist(),
            "timer": "cuda events" if args.backend == "nccl" else "host clock",
            "tree_nr_launches_a_step": ranks[0]["tree_nr_launches"] / (args.iters * args.steps),
            "device": ranks[0]["device"], "card": card, "backend": args.backend,
        }), flush=True)


if __name__ == "__main__":
    main()
