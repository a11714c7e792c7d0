"""Long-horizon robust training on the 33-bus feeder, on the port: PPO and
SAC over a domain-randomized fleet.

The PyTorch counterpart of examples/train_robust_feeder33.py: one policy is
trained against G grid variants (nominal + lognormal branch impedance
jitter) stepped in lockstep on the card (``--device cpu`` for the CPU).
Histories are written as JSON with ``--out``.  The rate printed is the one
this run measured, updates, warm-up and the kernel's first build included.

    python examples/torch_train_robust_feeder33.py --algo ppo [--device cpu]
"""
import argparse
import json
import time

from gym_anm_tpu_torch.envs.randomized import (
    ppo_trainer_for_fleet, randomized_feeder33_cores, sac_trainer_for_fleet,
)
from gym_anm_tpu_torch.rl import PPOConfig, SACConfig


def run_ppo(iterations, n_variants, lanes, seed=0, out=None, device="cuda"):
    cores = randomized_feeder33_cores(n_variants, seed=seed, r_sigma=0.15, x_sigma=0.15, device=device)
    trainer = ppo_trainer_for_fleet(cores, lanes, config=PPOConfig(rollout_steps=64), seed=seed)
    t0 = time.time()
    history = trainer.train(iterations)
    elapsed = time.time() - t0
    steps = iterations * n_variants * lanes * trainer.cfg.rollout_steps
    _report("ppo", history, steps, elapsed, out, cores[0].device)
    return history


def run_sac(iterations, n_variants, lanes, seed=0, out=None, warmup_rounds=2, device="cuda"):
    cores = randomized_feeder33_cores(n_variants, seed=seed, r_sigma=0.15, x_sigma=0.15, device=device)
    trainer = sac_trainer_for_fleet(cores, lanes, config=SACConfig(), seed=seed)
    t0 = time.time()
    history = trainer.train(iterations, warmup_rounds=warmup_rounds)
    elapsed = time.time() - t0
    # The uniform-collect warm-up rounds are real environment steps too.
    steps = (iterations + warmup_rounds) * n_variants * lanes * trainer.cfg.collect_steps
    _report("sac", history, steps, elapsed, out, cores[0].device)
    return history


def _report(algo, history, env_steps, elapsed, out, device):
    for i, m in enumerate(history):
        if i % max(1, len(history) // 25) == 0 or i == len(history) - 1:
            extra = f" term={m['terminated_frac']:.3f}" if "terminated_frac" in m else ""
            print(f"{algo} iter {i}: mean_reward={m['mean_reward']:+.3f}{extra}")
    print(f"{algo}: {env_steps} env steps in {elapsed:.1f}s ({env_steps / elapsed:,.0f} steps/s on {device}, "
          "updates, warm-up and the first kernel build included)")
    if out:
        with open(out, "w") as f:
            json.dump({"algo": algo, "env_steps": env_steps, "elapsed_s": elapsed, "device": str(device),
                       "history": history}, f)
        print(f"wrote {out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="ppo", choices=["ppo", "sac", "both"])
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--variants", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--out", default=None, help="JSON history path (prefix when --algo both)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.algo in ("ppo", "both"):
        run_ppo(args.iterations, args.variants, args.lanes, out=(args.out and args.out + "_ppo.json") or None,
                device=args.device)
    if args.algo in ("sac", "both"):
        run_sac(args.iterations, args.variants, args.lanes, out=(args.out and args.out + "_sac.json") or None,
                device=args.device)
