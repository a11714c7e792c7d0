#!/usr/bin/env python
"""Batched DC-OPF MPC throughput of the PyTorch port on a CUDA device.

    python3 scripts/mpc_bench_torch.py [--batch 1024] [--horizon 1 3 10] [--iters 5] [--env-steps 8]
                                       [--warm] [--warm-shift] [--polish] [--f64] [--verify K]
                                       [--solver {dense,banded}] [--env {anm6easy,feeder33,feeder141}]
                                       [--profile ITERS] [--graph-iters K] [--device cuda]

The counterpart of ``scripts/mpc_bench.py``, with the same flags: times
``MPCAgentConstant.act_batch`` (``--solver banded``:
``MPCAgentConstantBanded``) -- the batched ADMM DC-OPF solve on the device,
per-lane adaptive rho, KKT refactorization between chunks -- over B lanes of
the task at each planning horizon.  The agent is built from the port's
``Simulator`` facade and the task core's action bounds; the bench state is
``--env-steps`` uniform random steps after a reset.  ``--warm`` steps the
fleet with the MPC's actions between timed solves and warm-starts each solve
from the previous iterate (``--warm-shift``: realigned by one stage).
``--polish`` adds the host float64 active-set polish, ``--f64`` solves in
float64, ``--graph-iters K`` sets the iterations one CUDA graph of the ADMM
holds (0: every kernel launched eagerly), ``--verify K`` checks K lanes of
the last solve against the HiGHS LP optimum (``agents.mpc.verify_lanes``).  ``--profile ITERS`` traces one chunk
of ITERS batched ADMM iterations (its KKT factorization included) under
``torch.profiler`` and reports, per iteration, the CUDA device events, the
device busy ms and the busy share of the traced time.  Times come from
``profiling.StepRateCounter`` (the device synchronized around each call).

Prints the card's name and power limit, then ONE JSON line per (batch,
horizon) config:

    {"metric": "mpc-solves/s", "value": N, "unit": "solves/s", "detail": {...}}
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def task(env_name):
    """``(make_core, network)`` of a task."""
    if env_name == "feeder33":
        from gym_anm_tpu_torch.envs.feeder33 import make_core
        from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network as net
    elif env_name == "feeder141":
        from gym_anm_tpu_torch.envs.feeder141 import make_core
        from gym_anm_tpu_torch.envs.feeder_networks import make_multi_feeder_network as net
    else:
        from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
        from gym_anm_tpu_torch.envs.anm6.network import network

        net = lambda: network
    return make_core, net()


def profile_admm(agent, state_vecs, iters):
    """One chunk of ``iters`` batched ADMM iterations on the bounds of
    ``state_vecs``, under ``torch.profiler`` (see ``profile_torch_rollout.py``)."""
    from profile_torch_rollout import profile_unit

    spec, base, d, N = agent.spec, agent.baseMVA, agent.spec.n_dev, agent.planning_steps
    sv = torch.as_tensor(state_vecs, device=agent.device).to(torch.float64)
    loads = (sv[:, np.asarray(spec.load_pos)] / base)[:, :, None].expand(-1, -1, N)
    pots = (sv[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base)[:, :, None].expand(-1, -1, N)
    lv, uv = agent.batch_bounds(loads, pots, sv[:, 2 * d : 2 * d + spec.n_des] / base)
    run = lambda: agent._admm_batch(lv, uv, max_chunks=1, chunk_len=iters)
    out = profile_unit(run, iters, None, None)
    out.pop("kernel"), out.pop("kernel_launches"), out.pop("kernel_ms_per_launch")
    return {"profile_iters": iters, **{k.replace("_per_unit", "_per_iter"): v for k, v in out.items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1024])
    ap.add_argument("--horizon", type=int, nargs="+", default=[1, 3, 10])
    ap.add_argument("--iters", type=int, default=5, help="timed act_batch calls")
    ap.add_argument("--env-steps", type=int, default=8, help="random env steps before the bench state")
    ap.add_argument("--warm", action="store_true",
                    help="receding-horizon mode: step the fleet with the MPC action between timed solves and "
                    "warm-start each solve from the previous ADMM iterate")
    ap.add_argument("--warm-shift", action="store_true",
                    help="with --warm: realign the carried ADMM iterate by one stage each step")
    ap.add_argument("--polish", action="store_true",
                    help="after the device ADMM, run the host float64 active-set polish per lane")
    ap.add_argument("--f64", action="store_true", help="run the ADMM solver in float64")
    ap.add_argument("--verify", type=int, default=0, metavar="K",
                    help="cross-check K sampled lanes of the final batch solve against the scipy HiGHS LP optimum")
    ap.add_argument("--solver", default="dense", choices=["dense", "banded"],
                    help="LP backend: dense (agents/mpc.py) or stage-banded (agents/mpc_banded.py)")
    ap.add_argument("--env", default="anm6easy", choices=["anm6easy", "feeder33", "feeder141"],
                    help="environment/network to bench on (feeder141 requires --solver banded)")
    ap.add_argument("--profile", type=int, default=0, metavar="ITERS",
                    help="also trace one chunk of ITERS ADMM iterations and report the device busy share")
    ap.add_argument("--graph-iters", type=int, default=None, metavar="K",
                    help="iterations a CUDA graph of the batched ADMM holds (0: eager launches; "
                    "default: the agent's GRAPH_ITERS)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from gym_anm_tpu_torch.agents import MPCAgentConstant, MPCAgentConstantBanded
    from gym_anm_tpu_torch.agents.mpc import verify_lanes
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.profiling import StepRateCounter
    from gym_anm_tpu_torch.simulator import Simulator

    device = torch.device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    agent_cls = MPCAgentConstantBanded if args.solver == "banded" else MPCAgentConstant
    make_core, network = task(args.env)
    sim = Simulator(network, delta_t=0.25, lamb=100, device=device)

    for B in args.batch:
        core = make_core(torch.float32, device)
        space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
        env = BatchedEnv(core, B)
        es, _ = env.reset()
        es, _ = env.rollout(es, args.env_steps)
        state_vecs = es.state_vec

        for N in args.horizon:
            agent = agent_cls(sim, space, core.gamma, planning_steps=N, solver_x64=args.f64, device=device)
            if args.graph_iters is not None:
                agent.GRAPH_ITERS = args.graph_iters
            counter = StepRateCounter(device=device)
            t0 = time.perf_counter()
            acts = agent.act_batch(state_vecs, warm_start=args.warm, warm_shift=args.warm_shift,
                                   polish=args.polish)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            first_s = time.perf_counter() - t0

            times = []
            es_run = es
            for _ in range(args.iters):
                if args.warm:
                    # Receding horizon: advance the fleet under the MPC policy
                    # and warm-start each solve from the previous iterate.
                    es_run, out = env.step(es_run, acts)
                    sv = out.state_vec
                else:
                    sv = state_vecs
                t0 = time.perf_counter()
                with counter.measure(B):
                    acts = agent.act_batch(sv, warm_start=args.warm, warm_shift=args.warm_shift,
                                           polish=args.polish)
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)

            detail = {
                "batch": B, "horizon": N, "env": args.env, "solver": args.solver, "warm_start": args.warm,
                "warm_shift": args.warm_shift, "polish": args.polish, "f64": args.f64,
                "graph_iters": agent.GRAPH_ITERS, "median_s_per_batch": med, "first_call_s": first_s,
                "device": str(device),
                "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "mean_abs_action_mw": float(acts.abs().mean()), "counter": counter.summary(),
            }
            if args.verify:
                detail.update(verify_lanes(agent, args.verify))
            if args.profile:
                detail.update(profile_admm(agent, state_vecs, args.profile))
            print(json.dumps({"metric": "mpc-solves/s", "value": counter.median_rate(), "unit": "solves/s",
                              "detail": detail}), flush=True)


if __name__ == "__main__":
    main()
