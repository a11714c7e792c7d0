#!/usr/bin/env python
"""Two simulated hosts joined in one ``torch.distributed`` process group.

The counterpart of ``scripts/multiproc_dist.py``.  On one machine, a
launcher process a host spawns its ranks (``parallel/dryrun.py::run_ranks``
with ``hosts=``); every rank joins through
``parallel/launch.py::init_from_env`` from torchrun-style variables (its
global ``RANK``, its host's ``LOCAL_RANK``, one TCP store on
``127.0.0.1``).  Each rank builds and steps only its own lanes of ANM6Easy
(``tree``: the tree-NR kernel on a card, its plain twin on the CPU), and
the mean reward over every host's lanes comes from one ``all_reduce``; it
must be identical, bit for bit, on every rank.

    python scripts/multiproc_dist_torch.py [--backend nccl|gloo]

``nccl`` (the default) needs one card a rank, four in all; ``gloo`` runs
CPU processes.  The ranks have ``parallel/dryrun.py::RANKS_TIMEOUT``
seconds to report.
Prints one JSON line a rank, then ``{"multiprocess_ok": true, ...}``.
"""

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HOSTS = 2
RANKS_PER_HOST = 2
LANES_PER_RANK = 64
STEPS = 8


def rank_rollout(backend, lanes, steps):
    """In each rank: a reset and a ``steps``-step rollout of its own
    ``lanes``, then the global means over every rank's lanes."""
    import torch.distributed as dist

    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import tree_cuda
    from gym_anm_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device_type="cuda" if backend == "nccl" else "cpu")
    dev = sharding.rank_device(mesh)
    rank = dist.get_rank()
    gen = torch.Generator(device=dev).manual_seed(sharding.rank_seed(0, rank))
    env = BatchedEnv(make_core(torch.float32, dev), lanes, generator=gen)
    es, _ = env.reset()
    tree_cuda.KERNEL_LAUNCHES = 0
    c0 = sharding.COLLECTIVES
    es, (reward, terminated) = env.rollout(es, steps)
    stepping = sharding.COLLECTIVES - c0
    launches = tree_cuda.KERNEL_LAUNCHES
    means = torch.stack([reward.mean(), terminated.float().mean()]).double()
    sharding.all_reduce_mean_(means, mesh)  # equal lanes a rank: the mean of means is the global mean
    return {
        "rank": rank, "local_rank": int(os.environ["LOCAL_RANK"]), "world": dist.get_world_size(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU", "local_lanes": lanes,
        "steps": steps, "tree_nr_launches": launches, "collectives_while_stepping": stepping,
        "collectives": sharding.COLLECTIVES - c0, "mean_reward": float(means[0]), "terminated_frac": float(means[1]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args(argv)

    from gym_anm_tpu_torch.parallel.dryrun import run_ranks

    world = HOSTS * RANKS_PER_HOST
    ranks = run_ranks(rank_rollout, world, args.backend, (args.backend, LANES_PER_RANK, STEPS), hosts=HOSTS)
    for r in ranks:
        print(json.dumps(r), flush=True)
    # The mean is a collective: every rank holds the same bits.
    if len({r["mean_reward"] for r in ranks}) != 1:
        raise AssertionError("the ranks disagree on the global mean reward: %s" % [r["mean_reward"] for r in ranks])
    if [r["local_rank"] for r in ranks] != list(range(RANKS_PER_HOST)) * HOSTS:
        raise AssertionError("the local ranks are not those of %d hosts" % HOSTS)
    if any(r["collectives_while_stepping"] or r["collectives"] != 1 for r in ranks):
        raise AssertionError("a rank issued collectives while stepping, or more than the one all_reduce")
    print(json.dumps({"multiprocess_ok": True, "backend": args.backend, "hosts": HOSTS,
                      "ranks_per_host": RANKS_PER_HOST, "global_lanes": world * LANES_PER_RANK,
                      "mean_reward": ranks[0]["mean_reward"], "terminated_frac": ranks[0]["terminated_frac"]}))


if __name__ == "__main__":
    main()
