"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``gym_anm_tpu_torch/csrc/`` and drives
the port's main path on the card, one JSON line per phase:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is off;
2. build: compiles the tree-NR kernel and reports the seconds it took;
3. kernel vs plain: the kernel against its plain PyTorch version at
   B=4096 float32 on the ANM6, feeder33 and feeder141 grids (converged
   flags agree on >= 99% of lanes, V to atol 5e-5 on lanes both versions
   converged, |dn_iter| <= 1 on >= 97% of those lanes and <= 4 on all),
   with the median time of each;
4. parity replay: ``tests/data/onchip_ref_anm6easy.npz`` through the port's
   ``EnvCore`` on the card, compared with the committed host-float64
   trajectory by ``check.compare_trajectories``;
5. rollout: ``BatchedEnv(make_core(torch.float32, "cuda"), 4096)``, one
   reset and a few 64-step rollouts with uniform random actions, with the
   kernel's launch count over that run.

It exits non-zero, printing no result, when no GPU is available or any
phase fails.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROLLOUT_B = 4096
ROLLOUT_T = 64
ROLLOUTS = 3
KERNEL_B = 4096
# Grids of the kernel check: (name, injection amplitude, x_tol); feeder141
# keeps the float32 mismatch-plateau tolerance of its task.
KERNEL_GRIDS = (("anm6", 0.3, 1e-5), ("feeder33", 0.05, 1e-5), ("feeder141", 0.02, 3e-5))
KERNEL_MAX_ITER = 12
V_ATOL = 5e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, n):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled; the port's contractions must run in full float32")
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    })
    return smi


def phase_build():
    from gym_anm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path), "ptxas": ptxas})


def phase_kernel_vs_plain():
    from gym_anm_tpu_torch.core.grid import build_grid
    from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
    from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
    from gym_anm_tpu_torch.ops import tree_cuda

    networks = {"anm6": anm6_network, "feeder33": make_feeder_network(), "feeder141": make_multi_feeder_network()}
    rows = []
    for name, amp, x_tol in KERNEL_GRIDS:
        spec, _ = build_grid(networks[name], 0.25, 100, dtype=np.float32)
        ds = tree_cuda.DeviceSchedule.from_spec(spec, "cuda", torch.float32)
        rng = np.random.default_rng(0)
        B, m = KERNEL_B, spec.n_bus - 1
        p = torch.tensor(rng.uniform(-amp, amp, (B, m)).astype(np.float32), device="cuda")
        q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (B, m)).astype(np.float32), device="cuda")
        zero = torch.zeros((1, B), device="cuda")
        pT = torch.cat([p.T, zero])[ds.slot_sel].contiguous()
        qT = torch.cat([q.T, zero])[ds.slot_sel].contiguous()

        kern = lambda: tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, x_tol=x_tol, max_iter=KERNEL_MAX_ITER)
        plain = lambda: tree_cuda.solve_pfe_tree_plain(ds, pT, qT, x_tol=x_tol, max_iter=KERNEL_MAX_ITER)
        vr_k, vi_k, d_k, it_k = kern()
        torch.cuda.synchronize()
        vr_p, vi_p, d_p, it_p = plain()
        torch.cuda.synchronize()

        ck, cp = (d_k <= x_tol).cpu().numpy(), (d_p <= x_tol).cpu().numpy()
        both = ck & cp
        bt = torch.as_tensor(both, device="cuda")
        err = max(float((vr_k - vr_p).abs()[:, bt].max()), float((vi_k - vi_p).abs()[:, bt].max()))
        dit = np.abs(it_k.cpu().numpy().astype(np.int64) - it_p.cpu().numpy())[both]
        row = {
            "phase": "kernel_vs_plain", "grid": name, "S": ds.sched.S, "levels": len(ds.sched.levels),
            "B": B, "x_tol": x_tol, "converged_frac": float(ck.mean()),
            "converged_agree": float((ck == cp).mean()), "max_abs_err": err, "atol": V_ATOL,
            "dit_le1_frac": float((dit <= 1).mean()), "dit_max": int(dit.max()),
            "ms": median_ms(kern, 50), "plain_ms": median_ms(plain, 5),
        }
        emit(row)
        if not (row["converged_agree"] >= 0.99 and err <= V_ATOL and row["dit_le1_frac"] >= 0.97 and row["dit_max"] <= 4):
            raise AssertionError("kernel disagrees with its plain version on %s: %s" % (name, row))
        rows.append(row)
    return rows


def phase_parity():
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.ops import tree_cuda

    data = check.load_reference("anm6easy")
    core = make_core(dtype=torch.float32, device="cuda")
    tree_cuda.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    sv, rw, tm = check.rollout_given(core, data["s0"], data["actions"], data["vars"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tree_cuda.KERNEL_LAUNCHES
    res = check.compare_trajectories(
        {k: data[k] for k in ("state_vec", "reward", "terminated")},
        {"state_vec": sv.cpu().numpy(), "reward": rw.cpu().numpy(), "terminated": tm.cpu().numpy()},
    )
    T, B = data["actions"].shape[:2]
    emit({"phase": "parity", "env": "anm6easy", "B": B, "T": T, "seconds": seconds, "launches": launches, **res})
    if not res["pass"]:
        raise AssertionError("parity replay failed: %s" % res)
    if launches < T + 1:
        raise AssertionError("the replay launched the kernel %d times, expected >= %d" % (launches, T + 1))


def phase_rollout():
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import tree_cuda

    env = BatchedEnv(make_core(dtype=torch.float32, device="cuda"), ROLLOUT_B)
    tree_cuda.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es, first = env.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    seconds, rewards, terms = [], [], []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, (reward, terminated) = env.rollout(es, ROLLOUT_T)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rewards.append(reward)
        terms.append(terminated)
    launches = tree_cuda.KERNEL_LAUNCHES

    reward = torch.cat(rewards)
    obs = env.core.observation(es)
    if reward.shape != (ROLLOUTS * ROLLOUT_T, ROLLOUT_B) or not bool(torch.isfinite(reward).all()):
        raise AssertionError("rollout rewards are not finite [T, B]")
    if obs.shape != (ROLLOUT_B, env.core.obs_n) or not bool(torch.isfinite(obs).all()):
        raise AssertionError("observations are not finite [B, obs_n]")
    if bool(first.terminated.any()):
        raise AssertionError("reset left %d lanes terminated" % int(first.terminated.sum()))
    if launches < 1 + ROLLOUTS * ROLLOUT_T:
        raise AssertionError("the main path launched the kernel %d times" % launches)
    steady = float(np.median(seconds[1:]))
    emit({
        "phase": "rollout", "env": "anm6easy", "B": ROLLOUT_B, "T": ROLLOUT_T, "rollouts": ROLLOUTS,
        "reset_s": reset_s, "rollout_s": seconds, "env_steps_per_s": ROLLOUT_B * ROLLOUT_T / steady,
        "terminated_frac": float(terms[-1][-1].float().mean()), "mean_reward": float(reward.mean()),
        "launches": launches,
    })
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import gym_anm_tpu_torch  # noqa: F401  (fails before any output where the package is absent)

        phase_device()
        phase_build()
        rows = phase_kernel_vs_plain()
        phase_parity()
        launches = phase_rollout()
    except Exception:
        traceback.print_exc()
        return 1
    main_row = rows[0]  # ANM6 at B=4096: the shapes the main path gives the kernel
    emit({"kernels": [{
        "name": "tree_nr",
        "route": "cuda",
        "source": "gym_anm_tpu_torch/csrc/tree_nr.cu",
        "replaces": "gym_anm_tpu/ops/pallas_tree.py:267",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
