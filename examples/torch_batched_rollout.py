"""Thousands of lockstep ANM6Easy environments on one card, on the port.

The PyTorch counterpart of examples/batched_rollout.py: 4096 ANM6Easy
lanes step 128 times through ``BatchedEnv.rollout``, each step's power flow
solved by the tree-NR kernel on the card (``--device cpu`` runs its plain
twin on the CPU), and the example prints the rate it measured and the
device it measured it on.

    python examples/torch_batched_rollout.py [--device cpu] [--batch 4096] [--steps 128]
"""
import argparse
import time

import torch

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv


def run(batch=4096, steps=128, device="cuda"):
    core = make_core(torch.float32, device)
    env = BatchedEnv(core, batch, generator=torch.Generator(device=device).manual_seed(0))
    sync = torch.cuda.synchronize if core.device.type == "cuda" else (lambda: None)

    es, first = env.reset()
    es, (rew, term) = env.rollout(es, steps)  # warm-up (the first call builds the kernel)
    sync()

    t0 = time.perf_counter()
    es, (rew, term) = env.rollout(es, steps)
    sync()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(core.device) if core.device.type == "cuda" else "the host CPU"
    print(f"{batch * steps / dt:,.0f} env-steps/s on {where}")
    return batch * steps / dt


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=128)
    args = parser.parse_args()
    run(args.batch, args.steps, args.device)
