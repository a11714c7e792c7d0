"""Control a batched ANM6Easy fleet with the constant-forecast MPC policy,
on the port.

The PyTorch counterpart of examples/mpc_batched.py: ``agent.act_batch``
solves one multi-stage DC-OPF per environment lane in one batched ADMM on
the card and returns the ``[B, action_n]`` actions for ``BatchedEnv.step``
(``--device cpu`` for the CPU).  The agent is built from the ``Simulator``
facade over the same network; no Gymnasium environment is needed.

    python examples/torch_mpc_batched.py [--device cpu]
"""
import argparse
import types

import torch

from gym_anm_tpu_torch.agents import MPCAgentConstant
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.anm6.network import network
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.simulator import Simulator


def run(batch_size=16, horizon=3, steps=10, device="cuda"):
    core = make_core(torch.float32, device, pf_max_iter=100)
    env = BatchedEnv(core, batch_size, generator=torch.Generator(device=device).manual_seed(0))
    es, out = env.reset()

    sim = Simulator(network, delta_t=0.25, lamb=100, device=device)
    space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
    agent = MPCAgentConstant(sim, space, core.gamma, planning_steps=horizon, device=device)

    state_vecs = out.state_vec
    for t in range(steps):
        # warm_start: each solve resumes from the previous step's ADMM
        # iterate (receding-horizon warm start).
        actions = agent.act_batch(state_vecs, warm_start=True)
        es, out = env.step(es, actions.to(core.dtype))
        r, term = out.reward, out.terminated
        print(f"t={t}: mean r={float(r.mean()):+.4f}  worst r={float(r.min()):+.4f}  "
              f"collapsed={int(term.sum())}/{batch_size}")
        state_vecs = out.state_vec
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(device=args.device)
