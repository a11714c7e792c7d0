"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gym_anm_tpu_torch/csrc/`` and drives
the port's paths on the card, one JSON line per phase:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is off;
2. build: one ``nvcc`` call for the three kernels, with the seconds it took
   and each kernel instance's registers, stack (local memory) and spills;
   a tree-NR instance that spills or keeps a frame over 32 bytes fails;
3. kernel vs plain, each kernel against its plain PyTorch twin at B=4096
   float32: the tree-NR kernel (K1) on the ANM6, feeder33 and feeder141
   grids, each from the flat start and warm-started (the solved V of a
   nearby problem, its first lanes zeroed so that they flat-start); the
   dense-NR kernel (K2) on ANM6 and feeder33 with (chord 0, pivot off) and
   (chord 16, pivot on), each cold and warm-started as K1's rows are; the
   fused-transition kernel (K3) on ANM6 and
   feeder33 for ``fused`` and ``fused_hybrid`` and on feeder141 for
   ``fused`` (its tree form at S = 140), from inputs a rollout of the task
   gives.  The rule: converged flags agree on >= 99% of lanes; V (K1,
   K2) or every output field (K3) within 5e-5 on lanes both versions
   converged (the penalty, which scales voltages by lamb, within 5e-3);
   |dn_iter| <= 1 on >= 97% of those lanes.  Each row also says whether it
   was bit-identical (max |err| 0 and dn_iter 0) and gives the kernel's
   launch geometry (threads a lane, lanes a block, threads a block, dynamic
   shared bytes a block, resident blocks an SM); K1 rows carry their
   instance's ptxas figures.  A kernel's time is the median CUDA-event time
   of a CUDA graph of 20 launches, per launch (the device's time, not the
   wrapper's host work); a plain twin's the median of timed calls.  Each row
   carries the kernel's bound;
4. parity: ``tests/data/onchip_ref_{anm6easy,feeder33,feeder141}.npz``
   through every solver path of ``check.CHECK_CONFIG`` on the card, and
   warm-started through ANM6Easy's ``pallas`` and feeder33's ``hybrid``,
   compared with the committed host-float64 trajectories by
   ``check.compare_trajectories``, with the launch count of the kernel each
   path uses;
4b. projection: each task's capability polytopes (ANM6Easy, feeder33,
   feeder141) at B=4096 float32 through every form of
   ``ops/projection.py`` (``scripts/proj_bench_torch.py::bench_task``: the
   running minimum, the stacked form, box-slants): each form's CUDA-event
   time a call, eager and from a CUDA graph (where the form can be
   captured), its aten ops and device events a call, its peak memory, and
   the form ``GridTensors.from_spec`` chose for the card.  The stacked form
   must equal the running minimum bit for bit, box-slants be within 2e-5
   with squared distances within 2e-5.  Then ANM6Easy ``tree`` steps (16)
   from one reset state and one set of actions through each form in turn
   (running minimum, stacked, stacked, running minimum): env-steps/s,
   device events and busy ms a step; the two forms' final states, rewards
   and flags must agree bit for bit, as must the warm-started ANM6Easy
   ``pallas`` replay of the parity reference through each form;
5. rollout: ``BatchedEnv(make_core(pf_method=...), 4096)`` for ANM6Easy
   through the tree, pallas and fused paths (one reset and three 64-step
   rollouts), for feeder33 through the fused and tree paths and for
   feeder141 through the tree path (one reset and two 16-step rollouts),
   warm-started for ANM6Easy through the tree and pallas paths (one reset
   and two 64-step rollouts) and for feeder33 through the hybrid path, and
   with auto-reset for ANM6Easy through the tree path in pool and in step
   mode (reborn lanes must be live), with uniform random actions; each row
   names the projection form and gives the device events a step of 2
   profiled steps;
6. train: ``PPOTrainer`` (3 iterations) and ``SACTrainer`` (2 warm-up
   rounds and 3 iterations) with their default configurations over
   ANM6Easy at B=4096 (the tree path, pool auto-reset): each iteration's
   metrics and seconds; a non-finite loss or parameter fails;
7. fleet: domain-randomized fleets (``envs/randomized.py``) of G grid
   variants x L lanes at G x L = 4096, uniform random actions: ANM6Easy
   (G=4, tree; one reset and two 16-step rollouts), feeder33 with
   auto-reset (G=2, tree; two 8-step rollouts, no lane left terminated)
   and feeder33 on the fused path (G=2; two 8-step rollouts); each line
   with its env-steps/s (``profiling.StepRateCounter``, median of
   segments), launches, each variant's mean reward (each its own) and
   seconds; then ``ppo_trainer_for_fleet`` (1 iteration) and
   ``sac_trainer_for_fleet`` (1 warm-up round and 1 iteration) over the
   ANM6Easy fleet's cores at L=1024 with their default configurations.
   The path's kernel must have run once per variant per step;
8. mpc: the MPC DC-OPF agents (``agents/``, built from the ``simulator``
   facade) closing the loop through the tree-NR kernel: ANM6Easy at
   B=4096 with the dense constant-forecast agent (h3, float32; a cold and
   a warm ``act_batch``, then an 8-step closed loop of warm solves on a
   ``tree`` ``BatchedEnv``: terminated fraction <= 1% and mean reward > -5,
   the bar of ``tests/test_mpc.py``) and the banded perfect-forecast agent
   with the daily tables (h10; a cold solve, then a 4-step closed loop with
   the stage-shifted warm start); feeder141 at B=64 with the banded
   constant-forecast agent (h5, ``polish=True``; 4 lanes checked against
   the HiGHS LP optimum: gap and bound violation <= 1e-6), the agent's
   polish replaying ``tests/data/polish_calib_feeder141.npz`` (gap <= 1e-8,
   violation <= 1e-9) and a 2-step closed loop of cold solves.  The ADMM
   runs in float32.  Each row gives its solve seconds and the tree kernel's
   launches over its loop (>= one a step); every value must be finite;
9. gym: the Gymnasium-free cores of the Gymnasium adapters (the card has no
   Gymnasium), each row with the card's ``nvidia-smi`` line.  (a) ANM6Easy
   and (b) feeder33 through ``envs/vector_core.py::LockstepEnv``, the core
   of ``ANMVectorEnv``, at B=4096 in float32 on ``tree``: a full reset,
   then 64 (16) steps of uniform random NumPy actions, each step's results
   in one host copy: env-steps/s (median of timed segments after the
   first), exactly 2 tree-kernel launches a step (the step and the fresh
   states), the lanes reset (each returns reward 0, not terminated, its
   fresh state's observation), then 4 profiled steps (device events and
   busy ms a step); (c) the card against the CPU at B=64 over 8 steps from
   the same draws, made on the CPU, under ``check.compare_trajectories``'
   rule; (d) ``ANMEnv``'s one-lane ANM6Easy ``scan`` step in float64 with
   its host copy (``envs/single_core.py``), ms a step on the card and on
   the CPU, rewards equal within 1e-8; (e) lane 0 of (a) stepped 4 times
   into a replay file (``Simulator.set_sim_state``,
   ``render/replay.py::EpisodeRecorder``), its 4 frames parsed back;
10. plain paths, which must launch no kernel: the parity references
   replayed through feeder141's ``scan``, ``while``, ``hybrid`` and
   ``xla_hybrid`` (the plain dense solver) and through ``tree_xla`` (the
   tree kernel's plain twin) on every task, under the same rule; feeder141
   rollouts of chord-only ``hybrid`` at B=4096 (16 steps) and dense
   ``scan`` at B=256 (4 steps), each with its peak device memory, a profile
   of 2 more steps (device events, busy ms and busy share a step) and the
   card's ``nvidia-smi`` line;
11. parallel: (a) ``parallel/dryrun.py::dryrun_multidevice`` over ``nccl``
   on every card of the machine, one spawned rank a card, each joining
   through ``parallel/launch.py::init_from_env``, on the JAX dry run's
   mesh (``dp x tp``, tp 2 at an even count of 4 or more; on one card 1 x
   1): three PPO steps with the torso split over tp (each rank's
   parameters held against the unsharded update's), a SAC collect and
   update, a sharded feeder33 fleet collect with no collective, a sharded
   banded MPC solve equal to the unsharded one; then in each rank an
   ANM6Easy ``tree`` rollout of its share of a global B=4096: env-steps/s a
   rank, the tree kernel's launches (one a step) and the collectives counted
   while stepping (none).  On a one-card machine this is world size 1: it
   proves the NCCL path and the tree kernel under it, not scaling.  (b) The
   same dry run over four gloo ranks on the host CPU (``dp 2 x tp 2``; CPU
   time, not card time).  (c) ``scripts/multiproc_dist_torch.py``: two
   simulated hosts of two gloo ranks, each stepping its own lanes, the
   global mean reward from one ``all_reduce`` identical on every rank; over
   ``nccl`` too with two cards or more.  (d)
   ``scripts/scaling_bench_torch.py`` over 1..every card: a row a rank count
   (env-steps/s, efficiency, the tree kernel's launches a step, the card).

Every launch count is set to 0 just before a path runs and read just
after, and the path's kernel must have run once per step.

It exits non-zero, printing no result, when no GPU is available or any
phase fails.  The line before the last lists the kernels (K1 and K2 cold
and warm, K3), each with its launches on its ANM6Easy path (K1 cold: the
PPO run); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROLLOUT_B = 4096
# (env, pf_method, steps a rollout, rollouts[, warm_start[, auto-reset mode]]):
# ANM6Easy through each kernel's path, then feeder33, where the dense paths
# are device-bound, feeder141 through its one path, the warm-started paths,
# and ANM6Easy with auto-reset in both modes.
ROLLOUT_CASES = (
    ("anm6easy", "tree", 64, 3), ("anm6easy", "pallas", 64, 3), ("anm6easy", "fused", 64, 3),
    ("feeder33", "fused", 16, 2), ("feeder33", "tree", 16, 2), ("feeder141", "tree", 16, 2),
    ("anm6easy", "tree", 64, 2, True), ("anm6easy", "pallas", 64, 2, True), ("feeder33", "hybrid", 16, 2, True),
    ("anm6easy", "tree", 64, 2, False, "pool"), ("anm6easy", "tree", 64, 2, False, "step"),
)
# Replays warm-started: (env, pf_method); the method's CHECK_CONFIG budget.
WARM_REPLAYS = (("anm6easy", "pallas"), ("feeder33", "hybrid"))
# Replays through the plain paths, make_core's budgets: feeder141's dense and
# chord paths, and the tree kernel's plain twin on every task.
PLAIN_REPLAYS = tuple(("feeder141", m) for m in ("scan", "while", "hybrid", "xla_hybrid", "tree_xla")) + (
    ("anm6easy", "tree_xla"), ("feeder33", "tree_xla"),
)
# feeder141's plain paths in rollouts: (pf_method, B, steps), each then
# profiled over a few more steps.
PLAIN_ROLLOUTS = (("hybrid", 4096, 16), ("scan", 256, 4))
PLAIN_PROFILE_STEPS = 2
# The parallel phase's ANM6Easy rollout: the global batch, steps, steps a
# timed segment.
PARALLEL_B, PARALLEL_T, PARALLEL_SEG = 4096, 64, 16
# The gloo dry run on the host CPU: the JAX dry run's rule gives dp 2 x tp 2.
PARALLEL_GLOO_RANKS = 4
REPO = os.path.dirname(os.path.abspath(__file__))
# The trainers' runs at the full batch: PPO iterations, SAC warm-up rounds
# and iterations.
TRAIN_B = 4096
PPO_ITERS = 3
SAC_WARMUP, SAC_ITERS = 2, 3
# Domain-randomized fleets at G x L = 4096: (env, G, L, pf_method,
# auto-reset, steps a rollout, rollouts, branch jitter).  The second is the
# shape of the JAX package's multi-chip fleet collect.
FLEET_CASES = (
    ("anm6easy", 4, 1024, "tree", False, 16, 2, 0.2),
    ("feeder33", 2, 2048, "tree", True, 8, 2, 0.1),
    ("feeder33", 2, 2048, "fused", False, 8, 2, 0.1),
)
# The fleet trainers: ANM6Easy's fleet of FLEET_CASES[0] at this L.
FLEET_TRAIN_L = 1024
# The MPC phase: (env, agent, horizon, B, closed-loop steps, act_batch
# options of the loop's solves, polish, HiGHS lanes).
MPC_CASES = (
    ("anm6easy", "MPCAgentConstant", 3, 4096, 8, dict(warm_start=True), False, 0),
    ("anm6easy", "MPCAgentPerfectBanded", 10, 4096, 4, dict(warm_start=True, warm_shift=True), False, 0),
    ("feeder141", "MPCAgentConstantBanded", 5, 64, 2, dict(), True, 4),
)
# Gates: the ANM6Easy dense loop's (tests/test_mpc.py:153-156), the polished
# lanes' HiGHS gap (tests/test_mpc_banded.py:291) and bound violation (the
# polish's feasibility test, agents/mpc.py), the calibration replay's
# (tests/test_mpc_banded.py:328-329).
MPC_TERM_FRAC, MPC_MEAN_REWARD = 0.01, -5.0
MPC_GAP, MPC_VIOL = 1e-6, 1e-6
MPC_CALIB_GAP, MPC_CALIB_VIOL = 1e-8, 1e-9
# The gym phase: the lockstep core of ANMVectorEnv at B=4096, (env, steps,
# steps a timed segment), each profiled over a few more steps; the card
# against the CPU from the same draws at B=64; the one-lane program of
# ANMEnv.step; a replay of lane 0.
GYM_B = 4096
GYM_CASES = (("anm6easy", 64, 8), ("feeder33", 16, 4))
GYM_PROFILE_STEPS = 4
GYM_CHECK_B, GYM_CHECK_T = 64, 8
GYM_SINGLE_T = 32
GYM_REPLAY_STEPS = 4
KERNEL_B = 4096
# The projection phase: each task's polytopes at B=4096 through every form
# (scripts/proj_bench_torch.py, timed runs of 10 calls, 3 trials: the
# phase stays within ~30 s), box-slants' tolerance against the running
# minimum (tests/test_pallas_step.py:109-120), and the ANM6Easy tree
# rollouts of each form from one state and one set of actions, in the order
# running_min, stacked, stacked, running_min (steps a rollout).
PROJ_ENVS = ("anm6easy", "feeder33", "feeder141")
PROJ_CALLS, PROJ_TRIALS = 10, 3
BOX_SLANTS_ATOL = 2e-5
PROJ_AB_ORDER = ("running_min", "stacked", "stacked", "running_min")
PROJ_AB_T = 16
PROJ_PROFILE_STEPS = 2
# Grids of the tree-kernel check: (name, injection amplitude, x_tol);
# feeder141 keeps the float32 mismatch-plateau tolerance of its task.
TREE_GRIDS = (("anm6", 0.3, 1e-5), ("feeder33", 0.05, 1e-5), ("feeder141", 0.02, 3e-5))
TREE_MAX_ITER = 12
# Lanes of the warm rows whose warm point is zeroed (they flat-start).
WARM_ZEROED = 5
# Dense-NR checks: (grid, amplitude, chord_iters, pivot, max_iter = the task's budget for that path).
NR_CASES = (
    ("anm6", 0.3, 0, False, 10), ("anm6", 0.3, 16, True, 6),
    ("feeder33", 0.05, 0, False, 15), ("feeder33", 0.05, 16, True, 6),
)
# Fused-transition checks: (task, pf_method).
STEP_CASES = (
    ("anm6easy", "fused"), ("anm6easy", "fused_hybrid"), ("feeder33", "fused"), ("feeder33", "fused_hybrid"),
    ("feeder141", "fused"),
)
V_ATOL = 5e-5
PENALTY_ATOL = 5e-3
# The card's peak rates (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores, and device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_INFO = {
    "tree_nr": ("gym_anm_tpu_torch/csrc/tree_nr.cu", "gym_anm_tpu/ops/pallas_tree.py:267"),
    "nr_dense": ("gym_anm_tpu_torch/csrc/nr_dense.cu", "gym_anm_tpu/ops/pallas_nr.py:269"),
    "step_fused": ("gym_anm_tpu_torch/csrc/step_fused.cu", "gym_anm_tpu/ops/pallas_step.py:158"),
}
# The kernels with a warm form, and where the TPU kernel's warm form is.
WARM_FORMS = {
    "tree_nr": "gym_anm_tpu/ops/pallas_tree.py:268",
    "nr_dense": "gym_anm_tpu/ops/pallas_nr.py:270",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def event_ms(fn, launches, trials, graph=False):
    """Median over ``trials`` of the CUDA-event time of ``launches`` calls,
    per call, after one warm-up call.  With ``graph`` the calls are captured
    once into a CUDA graph and each trial replays it, so the time is the
    device's alone, not the host's time to issue the calls."""
    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(launches)]
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    ts = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / launches)
    return float(np.median(ts))


def bound(flops, nbytes):
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": int(flops), "bytes": int(nbytes)}


def agreement(conv_k, conv_p, diffs, it_k, it_p):
    """Flags, worst difference on lanes both converged, and iteration deltas."""
    both = conv_k & conv_p
    err = max(float(d[..., both].abs().max()) if bool(both.any()) else 0.0 for d in diffs)
    dit = (it_k.long() - it_p.long()).abs()[both].cpu().numpy()
    return {
        "converged_frac": float(conv_k.float().mean()), "converged_agree": float((conv_k == conv_p).float().mean()),
        "max_abs_err": err, "dit_le1_frac": float((dit <= 1).mean()), "dit_max": int(dit.max()),
    }


def bit_identical(row):
    return row["max_abs_err"] == 0.0 and row["dit_max"] == 0


def check_agreement(row, atol=V_ATOL):
    if not (row["converged_agree"] >= 0.99 and row["max_abs_err"] <= atol and row["dit_le1_frac"] >= 0.97
            and row["dit_max"] <= 4):
        raise AssertionError("kernel disagrees with its plain version: %s" % row)


def zero_counts():
    from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda

    for mod in (tree_cuda, nr_cuda, step_cuda):
        mod.KERNEL_LAUNCHES = 0


def read_counts():
    from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda

    return {"tree_nr": tree_cuda.KERNEL_LAUNCHES, "nr_dense": nr_cuda.KERNEL_LAUNCHES,
            "step_fused": step_cuda.KERNEL_LAUNCHES}


def path_kernel(core):
    """The kernel a core's solver path launches (None for the plain solver)."""
    from gym_anm_tpu_torch.core.transition import resolve_solver_path

    path, _ = resolve_solver_path(core.grid, core.pf_method, core.nr_pivot)
    return {"tree_kernel": "tree_nr", "nr_kernel": "nr_dense", "fused_kernel": "step_fused"}.get(path)


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


def ptxas_by_kernel(log):
    """Registers, stack frame and spill bytes of each kernel instance in
    ``nvcc -Xptxas -v`` output, keyed by the kernel and its size class's
    template arguments (``"tree_nr_kernel<8,16>"``: 8 threads a lane, at
    most 16 lanes a block)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            base = re.search(r"(tree_nr_kernel|nr_dense_kernel|step_fused_kernel)", name)
            args = re.search(r"SizeClassILi(\d+)ELi(\d+)E", name)
            cur = out.setdefault("%s<%s>" % (base.group(1) if base else name, ",".join(args.groups()) if args else ""), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    from gym_anm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    by_kernel = ptxas_by_kernel(log)
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path), "ptxas": by_kernel})
    for name, info in by_kernel.items():
        if name.startswith("tree_nr_kernel") and (info.get("spill_stores", 0) or info.get("spill_loads", 0)
                                                  or info.get("stack_frame", 0) > 32):
            raise AssertionError("%s spills or keeps a stack frame over 32 bytes: %s" % (name, info))
    return by_kernel


def make_grid(name):
    from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
    from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
    from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network

    net = {"anm6": lambda: anm6_network, "feeder33": make_feeder_network, "feeder141": make_multi_feeder_network}[name]()
    return GridTensors.from_spec(build_grid(net, 0.25, 100, dtype=np.float32)[0], "cuda", torch.float32)


def make_injections(m, amp, seed=0):
    rng = np.random.default_rng(seed)
    p = torch.tensor(rng.uniform(-amp, amp, (m, KERNEL_B)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (m, KERNEL_B)).astype(np.float32), device="cuda")
    return p, q


def tree_cases(warm=True):
    """``(grid, x_tol, ds, pT, qT, warm)`` for each tree-kernel row: each grid
    of :data:`TREE_GRIDS` cold, then (with ``warm``) warm.  The warm point is
    the solved V of a nearby problem (0.9x the injections) with its first
    lanes zeroed, so that they flat-start (``tests/test_pallas_tree.py``)."""
    from gym_anm_tpu_torch.ops import tree_cuda

    for name, amp, x_tol in TREE_GRIDS:
        g = make_grid(name)
        ds = g.tree
        p, q = make_injections(g.spec.n_bus - 1, amp)
        zero = torch.zeros((1, KERNEL_B), device="cuda")
        pT = torch.cat([p, zero])[ds.slot_sel].contiguous()
        qT = torch.cat([q, zero])[ds.slot_sel].contiguous()
        yield name, x_tol, ds, pT, qT, None
        if not warm:
            continue
        vr, vi = tree_cuda.solve_pfe_tree(ds, 0.9 * p.T, 0.9 * q.T, x_tol=x_tol, max_iter=TREE_MAX_ITER)[:2]
        vr = vr.clone()
        vr[:WARM_ZEROED] = 0.0
        yield name, x_tol, ds, pT, qT, tree_cuda.warm_point(ds, vr, vi)


def phase_tree_vs_plain(ptxas):
    from gym_anm_tpu_torch.ops import tree_cuda

    rows = []
    for name, x_tol, ds, pT, qT, warm in tree_cases():
        kw = dict(x_tol=x_tol, max_iter=TREE_MAX_ITER, init=warm)
        kern = lambda: tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, **kw)
        plain = lambda: tree_cuda.solve_pfe_tree_plain(ds, pT, qT, **kw)
        vr_k, vi_k, d_k, it_k = kern()
        vr_p, vi_p, d_p, it_p = plain()
        S, L = ds.sched.S, ds.levels.shape[0]
        its = collections.Counter(int(i) for i in it_k.cpu().numpy())
        flops = sum(c * tree_cuda.tree_nr_flops_per_lane(S, i, warm is not None) for i, c in its.items())
        tables = ds.ycols.numel() + ds.levels.numel() + ds.par.numel() + ds.children.numel()
        nbytes = 4 * ((4 if warm is None else 6) * S * KERNEL_B + 2 * KERNEL_B + tables)
        geometry = tree_cuda.tree_nr_geometry(ds)
        row = {
            "phase": "kernel_vs_plain", "kernel": "tree_nr", "grid": name, "warm": warm is not None, "S": S,
            "levels": L, "B": KERNEL_B, "x_tol": x_tol, "mean_iters": float(it_k.float().mean()),
            **agreement(d_k <= x_tol, d_p <= x_tol, [vr_k - vr_p, vi_k - vi_p], it_k, it_p),
            "ms": event_ms(kern, 20, 5, graph=True), "plain_ms": event_ms(plain, 1, 3), **bound(flops, nbytes),
            "geometry": geometry,
            "ptxas": next((v for k, v in ptxas.items() if k.startswith("tree_nr_kernel<%d," % geometry["threads_per_lane"])), None),
        }
        row["bit_identical"] = bit_identical(row) and bool(torch.equal(it_k, it_p))
        emit(row)
        check_agreement(row)
        rows.append(row)
    return rows


def nr_cases(warm=True):
    """``(grid, n, chord, pivot, max_iter, g, p, q, warm)`` for each dense-NR
    row: each setting of :data:`NR_CASES` cold, then (with ``warm``) warm.
    The warm point is the sanitised solved V of the problem scaled by 0.9,
    with its first lanes zeroed so that they flat-start, as for K1."""
    from gym_anm_tpu_torch.ops import nr_cuda
    from gym_anm_tpu_torch.ops.power_flow import warm_init_theta_vm

    for name, amp, chord, pivot, max_iter in NR_CASES:
        g = make_grid(name)
        n = g.spec.n_bus
        p, q = make_injections(n - 1, amp)
        yield name, n, chord, pivot, max_iter, g, p, q, None
        if not warm:
            continue
        kw = dict(x_tol=1e-5, max_iter=max_iter, chord_iters=chord, pivot=pivot)
        vr, vi = nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, 0.9 * p, 0.9 * q, **kw)[:2]
        vr = vr.clone()
        vr[:, :WARM_ZEROED] = 0.0
        th, vm, _ = warm_init_theta_vm(vr.T, vi.T, n - 1, torch.float32)
        yield name, n, chord, pivot, max_iter, g, p, q, (th.contiguous(), vm.contiguous())


def phase_nr_vs_plain():
    from gym_anm_tpu_torch.ops import nr_cuda

    rows = []
    for name, n, chord, pivot, max_iter, g, p, q, warm in nr_cases():
        kw = dict(x_tol=1e-5, max_iter=max_iter, chord_iters=chord, pivot=pivot, init=warm)
        kern = lambda: nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
        plain = lambda: nr_cuda.nr_core_plain(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
        vr_k, vi_k, d_k, it_k = kern()
        vr_p, vi_p, _, _, d_p, it_p = plain()
        # Chord steps come first: a lane's first min(it, chord) steps are chord steps.
        its = collections.Counter(int(i) for i in it_k.cpu().numpy())
        flops = sum(
            c * nr_cuda.nr_dense_flops_per_lane(n, i - min(i, chord), min(i, chord), warm is not None)
            for i, c in its.items()
        )
        lane_rows = 2 * (n - 1) * (1 if warm is None else 2) + 2 * n + 2  # p, q[, th, vm]; v_re, v_im; diff, it
        nbytes = 4 * (2 * n * n + (2 * n - 2) ** 2 + lane_rows * KERNEL_B)
        row = {
            "phase": "kernel_vs_plain", "kernel": "nr_dense", "grid": name, "warm": warm is not None, "n": n,
            "chord_iters": chord, "pivot": pivot, "max_iter": max_iter, "B": KERNEL_B,
            "mean_iters": float(it_k.float().mean()),
            **agreement(d_k <= 1e-5, d_p <= 1e-5, [vr_k - vr_p, vi_k - vi_p], it_k, it_p),
            "ms": event_ms(kern, 20, 5, graph=True), "plain_ms": event_ms(plain, 1, 3), **bound(flops, nbytes),
            "geometry": nr_cuda.nr_dense_geometry(n, chord),
        }
        row["bit_identical"] = bit_identical(row) and bool(torch.equal(it_k, it_p))
        emit(row)
        check_agreement(row)
        rows.append(row)
    return rows


def step_lanes(core, seed=0):
    """Transition inputs a rollout of the task gives, packed batch-last."""
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops import step_cuda

    env = BatchedEnv(core, KERNEL_B, generator=torch.Generator(device="cuda").manual_seed(seed))
    es, _ = env.reset()
    vars = core.next_vars_fn(es.state_vec, env.generator)
    return step_cuda.pack_inputs(**core.transition_inputs(es, env.random_actions(), vars))


def phase_step_vs_plain():
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.ops import step_cuda

    rows = []
    for env, method in STEP_CASES:
        core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method=method)
        st = core.grid.step
        lanes = step_lanes(core)
        chord = core.chord_iters if method == "fused_hybrid" else 0
        kw = dict(x_tol=core.x_tol, max_iter=core.max_iter, chord_iters=chord, pivot=core.nr_pivot)
        kern = lambda: step_cuda.fused_transition_cuda(st, lanes, **kw)
        plain = lambda: step_cuda.fused_transition_plain(st, lanes, **kw)
        k = step_cuda.unpack_outputs(st, kern())
        p = step_cuda.unpack_outputs(st, plain())
        conv_k, conv_p = k.diff[:, 0] <= core.x_tol, p.diff[:, 0] <= core.x_tol
        fields = [f for f in k._fields if f not in ("penalty", "n_iter")]
        it_k, it_p = k.n_iter[:, 0], p.n_iter[:, 0]
        agree = agreement(conv_k, conv_p, [(getattr(k, f) - getattr(p, f)).T for f in fields], it_k, it_p)
        pen = agreement(conv_k, conv_p, [(k.penalty - p.penalty).T], it_k, it_p)["max_abs_err"]
        its = collections.Counter(int(i) for i in it_k.cpu().numpy())
        flops = sum(
            c * step_cuda.step_fused_flops_per_lane(st, i - min(i, chord), min(i, chord), core.nr_pivot)
            for i, c in its.items()
        )
        tables = sum(t.numel() for t in st.f.values()) + sum(t.numel() for t in st.i.values())
        nbytes = 4 * ((sum(st.in_rows) + sum(st.out_rows)) * KERNEL_B + tables)
        row = {
            "phase": "kernel_vs_plain", "kernel": "step_fused", "env": env, "pf_method": method,
            "chord_iters": chord, "max_iter": core.max_iter, "B": KERNEL_B, "mean_iters": float(it_k.mean()),
            "form": "tree" if step_cuda.tree_form(st, chord, core.nr_pivot) else "dense",
            **agree, "penalty_max_abs_err": pen,
            "ms": event_ms(kern, 20, 5, graph=True), "plain_ms": event_ms(plain, 1, 3), **bound(flops, nbytes),
            "geometry": step_cuda.step_fused_geometry(st, chord, core.nr_pivot),
        }
        row["bit_identical"] = bit_identical(row) and pen == 0.0
        emit(row)
        check_agreement(row)
        if pen > PENALTY_ATOL:
            raise AssertionError("fused kernel's penalty disagrees with its plain version: %s" % row)
        rows.append(row)
    return rows


def phase_parity(plain=False):
    """The replays of every ``check.CHECK_CONFIG`` path and the warm ones, or
    (``plain``) those of :data:`PLAIN_REPLAYS`."""
    from gym_anm_tpu_torch import check

    if plain:
        runs = [(env, method, {}) for env, method in PLAIN_REPLAYS]
    else:
        runs = [(env, method, kw) for env, cfg in check.CHECK_CONFIG.items() for method, kw in cfg["methods"].items()]
        runs += [(env, method, dict(check.CHECK_CONFIG[env]["methods"][method], warm_start=True))
                 for env, method in WARM_REPLAYS]
    for env, method, kw in runs:
        data = check.load_reference(env)
        T = data["actions"].shape[0]
        core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method=method, **kw)
        kernel = path_kernel(core)
        zero_counts()
        t0 = time.perf_counter()
        sv, rw, tm = check.rollout_given(core, data["s0"], data["actions"], data["vars"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        res = check.compare_trajectories(
            {k: data[k] for k in ("state_vec", "reward", "terminated")},
            {"state_vec": sv.cpu().numpy(), "reward": rw.cpu().numpy(), "terminated": tm.cpu().numpy()},
        )
        emit({"phase": "parity", "env": env, "pf_method": method, "warm_start": core.warm_start,
              "B": data["actions"].shape[1], "T": T, "seconds": seconds, "kernel": kernel, "launches": counts, **res})
        if not res["pass"]:
            raise AssertionError("parity replay failed: %s %s %s" % (env, method, res))
        if kernel is not None and counts[kernel] < T + 1:
            raise AssertionError("the %s replay launched %s %d times, expected >= %d"
                                 % (method, kernel, counts[kernel], T + 1))
        if kernel is None and any(counts.values()):
            raise AssertionError("the plain %s %s replay launched a kernel: %s" % (env, method, counts))


def same_bits(a, b):
    """Tensors equal bit for bit, pairwise (floats by their bit patterns)."""
    view = lambda t: t.view(torch.int32 if t.dtype == torch.float32 else torch.int64) if t.is_floating_point() else t
    return all(torch.equal(view(x), view(y)) for x, y in zip(a, b))


def phase_projection(smi):
    """Every projection form on each task's polytopes at B=4096 float32
    (``scripts/proj_bench_torch.py``): the stacked form must equal the
    running minimum bit for bit, box-slants within 2e-5 with equal squared
    distances; then ANM6Easy ``tree`` steps of each form from the same state
    and actions, and the warm ``pallas`` replay through each form, which
    must agree bit for bit.  Reports the form ``GridTensors.from_spec``
    chose for the card."""
    import dataclasses

    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.core.grid import projection_form
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.ops.projection import LanesProjector

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import proj_bench_torch as bench

    t_phase = time.perf_counter()
    chosen = projection_form("cuda")
    for env_name in PROJ_ENVS:
        for row in bench.bench_task(env_name, KERNEL_B, trials=PROJ_TRIALS, loop=False, calls=PROJ_CALLS):
            emit({"phase": "projection", **row, "default_form": chosen, "card": smi})
            if row["form"] == "stacked" and not row["bit_identical"]:
                raise AssertionError("the stacked projection differs from the running minimum: %s" % row)
            if row["form"] == "box_slants" and not (row["max_abs_diff"] <= BOX_SLANTS_ATOL
                                                     and row["max_abs_dist_diff"] <= BOX_SLANTS_ATOL):
                raise AssertionError("box-slants is off the running minimum: %s" % row)

    core = make_core(torch.float32, device="cuda")
    if core.grid.projector.form != chosen:
        raise AssertionError("make_core built the %r form, from_spec chose %r" % (core.grid.projector.form, chosen))
    G = np.concatenate([np.asarray(core.spec.gen_G), np.asarray(core.spec.des_G)], axis=0)
    env = BatchedEnv(core, ROLLOUT_B)
    es0, _ = env.reset()
    actions = [env.random_actions() for _ in range(PROJ_AB_T)]

    def steps(es, acts):
        for a in acts:
            es, out = env.step(es, a)
        return es, out

    finals = {}
    for form in PROJ_AB_ORDER:
        core.grid = dataclasses.replace(core.grid, projector=LanesProjector(G, "cuda", torch.float32, form=form))
        zero_counts()
        (es, out), seconds = timed(lambda: steps(es0, actions))
        counts = read_counts()
        prof = profile(lambda: steps(es0, actions[:PROJ_PROFILE_STEPS]), PROJ_PROFILE_STEPS, None, None)
        emit({"phase": "projection_rollout", "env": "anm6easy", "pf_method": "tree", "form": form, "B": ROLLOUT_B,
              "T": PROJ_AB_T, "seconds": seconds, "env_steps_per_s": ROLLOUT_B * PROJ_AB_T / seconds,
              "device_events_per_step": prof["cuda_events_per_unit"],
              "device_busy_ms_per_step": prof["device_busy_ms_per_unit"],
              "untraced_ms_per_step": prof["untraced_ms_per_unit"], "launches": counts, "card": smi})
        if counts["tree_nr"] != PROJ_AB_T:
            raise AssertionError("the %s rollout launched the tree kernel %d times" % (form, counts["tree_nr"]))
        finals.setdefault(form, (es.state_vec, out.reward, out.terminated))
    if not same_bits(finals["running_min"], finals["stacked"]):
        raise AssertionError("the ANM6Easy tree steps differ between the projection forms")

    # The warm-started replay (whose calibrated paths may part from the
    # cold float64 reference on a tie) through both forms: bit for bit.
    data = check.load_reference("anm6easy")
    kw = dict(check.CHECK_CONFIG["anm6easy"]["methods"]["pallas"], warm_start=True)
    core = check.task_make_core("anm6easy")(dtype=torch.float32, device="cuda", pf_method="pallas", **kw)
    replays = {}
    for form in ("running_min", "stacked"):
        core.grid = dataclasses.replace(core.grid, projector=LanesProjector(G, "cuda", torch.float32, form=form))
        replays[form] = check.rollout_given(core, data["s0"], data["actions"], data["vars"])
        res = check.compare_trajectories(
            {k: data[k] for k in ("state_vec", "reward", "terminated")},
            dict(zip(("state_vec", "reward", "terminated"), (t.cpu().numpy() for t in replays[form]))),
        )
        emit({"phase": "projection_replay", "env": "anm6easy", "pf_method": "pallas", "warm_start": True,
              "form": form, **res, "card": smi})
        if not res["pass"]:
            raise AssertionError("the warm pallas replay through %s failed: %s" % (form, res))
    if not same_bits(replays["running_min"], replays["stacked"]):
        raise AssertionError("the warm pallas replay differs between the projection forms")
    emit({"phase": "projection", "part": "summary", "default_form": chosen,
          "seconds": time.perf_counter() - t_phase, "card": smi})


def phase_rollout(env_name, pf_method, T, rollouts, warm_start=False, auto_reset=None):
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs.batched import BatchedEnv

    core = check.task_make_core(env_name)(
        dtype=torch.float32, device="cuda", pf_method=pf_method, warm_start=warm_start
    )
    kernel = path_kernel(core)
    env = BatchedEnv(core, ROLLOUT_B, auto_reset=auto_reset is not None, auto_reset_mode=auto_reset or "pool")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    es, first = env.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    seconds, rewards, terms = [], [], []
    for _ in range(rollouts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, (reward, terminated) = env.rollout(es, T)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        rewards.append(reward)
        terms.append(terminated)
        if auto_reset is not None and bool(es.terminated.any()):
            raise AssertionError("auto-reset (%s) left %d lanes terminated" % (auto_reset, int(es.terminated.sum())))
    counts = read_counts()

    reward, terminated = torch.cat(rewards), torch.cat(terms)
    obs = env.core.observation(es)
    if reward.shape != (rollouts * T, ROLLOUT_B) or not bool(torch.isfinite(reward).all()):
        raise AssertionError("%s %s rollout rewards are not finite [T, B]" % (env_name, pf_method))
    if obs.shape != (ROLLOUT_B, env.core.obs_n) or not bool(torch.isfinite(obs).all()):
        raise AssertionError("%s %s observations are not finite [B, obs_n]" % (env_name, pf_method))
    if bool(first.terminated.any()):
        raise AssertionError("reset left %d lanes terminated" % int(first.terminated.sum()))
    if auto_reset is not None and not bool(terminated.any()):
        raise AssertionError("no lane terminated: auto-reset (%s) was not exercised" % auto_reset)
    if counts[kernel] < 1 + rollouts * T:
        raise AssertionError("the %s %s path launched %s %d times" % (env_name, pf_method, kernel, counts[kernel]))
    steady = float(np.median(seconds[1:]))
    prof = profile(lambda: env.rollout(es, PROJ_PROFILE_STEPS), PROJ_PROFILE_STEPS, None, None)
    emit({
        "phase": "rollout", "env": env_name, "pf_method": pf_method, "warm_start": warm_start,
        "projection_form": core.grid.projector.form, "device_events_per_step": prof["cuda_events_per_unit"],
        "auto_reset": auto_reset, "B": ROLLOUT_B, "T": T, "rollouts": rollouts, "reset_s": reset_s,
        "rollout_s": seconds, "env_steps_per_s": ROLLOUT_B * T / steady,
        # With auto-reset, the share of lane-steps that terminated (and were
        # reborn); without, the share of lanes terminated at the end.
        "terminated_frac": float((terminated if auto_reset else terms[-1][-1]).float().mean()),
        "mean_reward": float(reward.mean()), "kernel": kernel, "launches": counts,
    })
    return kernel, counts[kernel]


def profile(run, units, counter, kname):
    """``scripts/profile_torch_rollout.py::profile_unit``: ``run`` untraced,
    then under the profiler."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from profile_torch_rollout import profile_unit

    return profile_unit(run, units, counter, kname)


def phase_plain_rollout(pf_method, B, T, smi):
    """feeder141 through a plain path at B lanes: one reset, one T-step
    rollout of uniform random actions (no kernel may launch), the peak
    device memory, then a profile of a few more steps."""
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs.batched import BatchedEnv

    core = check.task_make_core("feeder141")(dtype=torch.float32, device="cuda", pf_method=pf_method)
    if path_kernel(core) is not None:
        raise AssertionError("feeder141 %s is not a plain path" % pf_method)
    env = BatchedEnv(core, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (es, first), reset_s = timed(env.reset)
    (es, (reward, terminated)), seconds = timed(lambda: env.rollout(es, T))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    obs = core.observation(es)
    what = "feeder141 %s rollout" % pf_method
    if any(counts.values()):
        raise AssertionError("%s launched a kernel: %s" % (what, counts))
    if reward.shape != (T, B) or not (bool(torch.isfinite(reward).all()) and bool(torch.isfinite(obs).all())):
        raise AssertionError("%s: rewards or observations not finite" % what)
    if bool(first.terminated.any()):
        raise AssertionError("%s: the reset left %d lanes terminated" % (what, int(first.terminated.sum())))
    prof = profile(lambda: env.rollout(es, PLAIN_PROFILE_STEPS), PLAIN_PROFILE_STEPS, None, None)
    emit({
        "phase": "rollout", "env": "feeder141", "pf_method": pf_method, "B": B, "T": T, "x_tol": core.x_tol,
        "max_iter": core.max_iter, "chord_iters": core.chord_iters, "reset_s": reset_s, "rollout_s": seconds,
        "ms_a_step": seconds * 1e3 / T, "env_steps_per_s": B * T / seconds, "peak_memory_bytes": peak,
        "terminated_frac": float(terminated[-1].float().mean()), "mean_reward": float(reward.mean()),
        "kernel": None, "launches": counts, "profiled_steps": PLAIN_PROFILE_STEPS,
        "profile": {k: v for k, v in prof.items() if k not in ("kernel", "kernel_launches", "kernel_ms_per_launch")},
        "card": smi,
    })


def _parallel_rollout(mesh, global_B=PARALLEL_B):
    """In each rank of the parallel phase: ANM6Easy ``tree`` over this rank's
    share of a global batch of ``global_B`` lanes, in timed segments."""
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.parallel import sharding

    dev = sharding.rank_device(mesh)
    lanes = sharding.batch_sharding(mesh).lanes(global_B)
    gen = torch.Generator(device=dev).manual_seed(sharding.rank_seed(0, sharding.dp_rank(mesh)))
    env = BatchedEnv(make_core(torch.float32, dev), lanes.stop - lanes.start, generator=gen)
    es, _ = env.reset()
    torch.cuda.synchronize(dev)
    zero_counts()
    c0 = sharding.COLLECTIVES
    seconds, rewards = [], []
    for _ in range(PARALLEL_T // PARALLEL_SEG):
        t0 = time.perf_counter()
        es, (reward, _) = env.rollout(es, PARALLEL_SEG)
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        rewards.append(reward)
    counts = read_counts()
    collectives = sharding.COLLECTIVES - c0
    reward = sharding.gather_batch(torch.cat(rewards).T.contiguous(), mesh)  # [B, T], every rank's lanes
    return {
        "card": torch.cuda.get_device_name(dev), "global_B": global_B, "local_B": env.batch_size,
        "T": PARALLEL_T, "segment_s": seconds,
        "env_steps_per_s": env.batch_size * PARALLEL_SEG / float(np.median(seconds[1:])),
        "launches": counts, "collectives_while_stepping": collectives,
        "gathered_B": reward.shape[0], "mean_reward": float(reward.mean()),
        "finite": bool(torch.isfinite(reward).all()),
    }


def run_script(name, *args, timeout):
    """``scripts/<name>`` in a fresh interpreter; its JSON lines.  It fails
    when the script fails or outlasts ``timeout`` (given a minute more than
    the script's spawns have, so that they end their ranks first)."""
    r = subprocess.run([sys.executable, "-u", os.path.join(REPO, "scripts", name), *args], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO)
    if r.returncode != 0:
        raise AssertionError("%s %s failed:\n%s\n%s" % (name, " ".join(args), r.stdout[-3000:], r.stderr[-3000:]))
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


def phase_parallel(smi):
    """(a) The dry run over NCCL on every card, one spawned rank a card, on
    the JAX dry run's ``dp x tp`` mesh, then :func:`_parallel_rollout` in
    each rank; (b) the dry run over four gloo ranks on the host CPU (``dp 2
    x tp 2``); (c) two simulated hosts of ranks stepping their own lanes
    (``scripts/multiproc_dist_torch.py``) over gloo, and over NCCL with four
    cards or more; (d) weak scaling over 1..every card
    (``scripts/scaling_bench_torch.py``)."""
    from gym_anm_tpu_torch.parallel.dryrun import RANKS_TIMEOUT, dryrun_multidevice, tp_for

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = dryrun_multidevice(world, "nccl", extra=_parallel_rollout)
    seconds = time.perf_counter() - t0
    note = ("world size 1, a 1 x 1 mesh: proves the NCCL path and the tree kernel under it, not scaling"
            if world == 1 else "one rank a card")
    for r in ranks:
        roll = r.pop("extra")
        emit({"phase": "parallel", "part": "a", "world": world, "mesh": {"dp": r["dp"], "tp": r["tp"]},
              "seconds": seconds, "note": note, "card": smi, **r, "rollout": roll})
        if (r["dp"], r["tp"]) != (world // tp_for(world), tp_for(world)):
            raise AssertionError("rank %d: a %d x %d mesh on %d cards" % (r["rank"], r["dp"], r["tp"], world))
        if roll["launches"]["tree_nr"] != PARALLEL_T or roll["collectives_while_stepping"] != 0:
            raise AssertionError("rank %d: %d tree kernel launches over %d steps, %d collectives while stepping"
                                 % (r["rank"], roll["launches"]["tree_nr"], PARALLEL_T,
                                    roll["collectives_while_stepping"]))
        if not roll["finite"] or roll["gathered_B"] != PARALLEL_B or r["backend"] != "nccl":
            raise AssertionError("rank %d: the sharded rollout is not the global batch over nccl" % r["rank"])

    t0 = time.perf_counter()
    ranks = dryrun_multidevice(PARALLEL_GLOO_RANKS, "gloo")
    seconds = time.perf_counter() - t0
    for r in ranks:
        emit({"phase": "parallel", "part": "b", "world": PARALLEL_GLOO_RANKS, "mesh": {"dp": r["dp"], "tp": r["tp"]},
              "seconds": seconds, "note": "host CPU processes (gloo): CPU time, not card time", "card": "host CPU",
              **r})
        if (r["dp"], r["tp"]) != (2, 2) or r["device"] != "cpu":
            raise AssertionError("rank %d: not a dp 2 x tp 2 mesh of CPU ranks" % r["rank"])

    runs = [("gloo", "host CPU")]
    if world >= 4:  # two hosts of two cards
        runs.append(("nccl", smi))
    for backend, card in runs:
        t0 = time.perf_counter()
        rows = run_script("multiproc_dist_torch.py", "--backend", backend, timeout=RANKS_TIMEOUT + 60)
        emit({"phase": "parallel", "part": "c", "backend": backend, "seconds": time.perf_counter() - t0,
              "card": card, "ranks": rows[:-1], **rows[-1]})
        if not rows[-1]["multiprocess_ok"] or len({r["mean_reward"] for r in rows[:-1]}) != 1:
            raise AssertionError("the simulated hosts disagree over %s: %s" % (backend, rows))
        if backend == "nccl" and any(r["tree_nr_launches"] != r["steps"] for r in rows[:-1]):
            raise AssertionError("a rank's rollout did not launch the tree kernel once a step: %s" % rows)

    t0 = time.perf_counter()
    spawns = 1 + int(np.log2(world))  # one a rank count: 1, 2, 4, ... cards
    rows = run_script("scaling_bench_torch.py", timeout=RANKS_TIMEOUT * spawns + 60)
    for row in rows:
        emit({"phase": "parallel", "part": "d", "seconds": time.perf_counter() - t0, **row})
    if [r["devices"] for r in rows][:1] != [1] or rows[0]["tree_nr_launches_a_step"] != 1.0 or rows[0]["card"] != smi:
        raise AssertionError("the 1-rank scaling row did not step the tree kernel once a step on this card: %s" % rows)


def check_finite(name, metrics, modules):
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    bad += [n for m in modules for n, p in m.named_parameters() if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError("%s: non-finite %s" % (name, bad))


def phase_train():
    """PPO, then SAC, with their default configurations over ANM6Easy at
    B=4096; returns the tree kernel's launches in the PPO run."""
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu_torch.rl import PPOTrainer, SACTrainer

    core = make_core(torch.float32, "cuda")
    kernel = path_kernel(core)
    ppo = PPOTrainer(core, TRAIN_B, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    es = ppo.init_envs()
    for it in range(PPO_ITERS):
        t0 = time.perf_counter()
        es, metrics = ppo.train_step(es)
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        emit({"phase": "train", "trainer": "ppo", "iteration": it, "B": TRAIN_B, "seconds": seconds,
              "env_steps": ppo.cfg.rollout_steps * TRAIN_B, **metrics})
        check_finite("ppo", metrics, [ppo.model])
    torch.cuda.synchronize()
    ppo_counts = read_counts()
    cfg = ppo.cfg
    if ppo_counts[kernel] < 1 + PPO_ITERS * (1 + cfg.rollout_steps):
        raise AssertionError("the PPO run launched %s %d times" % (kernel, ppo_counts[kernel]))

    sac = SACTrainer(core, TRAIN_B, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    es, rb, obs = sac.init_envs()
    for r in range(SAC_WARMUP):
        t0 = time.perf_counter()
        es, rb, obs = sac.warmup(es, rb, obs)
        torch.cuda.synchronize()
        emit({"phase": "train", "trainer": "sac", "warmup_round": r, "B": TRAIN_B, "seconds": time.perf_counter() - t0,
              "replay_size": rb.size})
    for it in range(SAC_ITERS):
        t0 = time.perf_counter()
        es, rb, obs, metrics = sac.train_step(es, rb, obs)
        metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        emit({"phase": "train", "trainer": "sac", "iteration": it, "B": TRAIN_B, "seconds": seconds,
              "env_steps": sac.cfg.collect_steps * TRAIN_B, "replay_size": rb.size, **metrics})
        check_finite("sac", metrics, [sac.actor, sac.critic, sac.target])
    torch.cuda.synchronize()
    sac_counts = read_counts()
    if sac_counts[kernel] < 1 + (SAC_WARMUP + SAC_ITERS) * (1 + sac.cfg.collect_steps):
        raise AssertionError("the SAC run launched %s %d times" % (kernel, sac_counts[kernel]))
    emit({"phase": "train", "kernel": kernel, "ppo_launches": ppo_counts, "sac_launches": sac_counts})
    return ppo_counts[kernel]


def fleet_cores(env_name, G, sigma, pf_method="tree"):
    from gym_anm_tpu_torch.envs.randomized import randomized_anm6easy_cores, randomized_feeder33_cores

    builder = {"anm6easy": randomized_anm6easy_cores, "feeder33": randomized_feeder33_cores}[env_name]
    return builder(G, seed=0, r_sigma=sigma, x_sigma=sigma, dtype=torch.float32, device="cuda", pf_method=pf_method)


def phase_fleet(env_name, G, L, pf_method, auto_reset, T, rollouts, sigma):
    from gym_anm_tpu_torch.envs.randomized import MultiBatchedEnv
    from gym_anm_tpu_torch.profiling import StepRateCounter

    cores = fleet_cores(env_name, G, sigma, pf_method)
    kernel = path_kernel(cores[0])
    fleet = MultiBatchedEnv(cores, L, auto_reset=auto_reset)
    counter = StepRateCounter(device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    states, first = fleet.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    rewards, terms = [], []
    for _ in range(rollouts):
        with counter.measure(G * L * T):
            states, (reward, terminated) = fleet.rollout(states, T)
        rewards.append(reward)
        terms.append(terminated)
        if auto_reset and any(bool(es.terminated.any()) for es in states):
            raise AssertionError("the %s fleet's auto-reset left lanes terminated" % env_name)
    counts = read_counts()

    reward, terminated = torch.cat(rewards), torch.cat(terms)
    what = "%s %s fleet" % (env_name, pf_method)
    if reward.shape != (rollouts * T, G, L) or not bool(torch.isfinite(reward).all()):
        raise AssertionError("%s rewards are not finite [T, G, L]" % what)
    obs = fleet.observation(states)
    if obs.shape != (G, L, fleet.obs_n) or not bool(torch.isfinite(obs).all()):
        raise AssertionError("%s observations are not finite [G, L, obs_n]" % what)
    if bool(first.terminated.any()):
        raise AssertionError("%s reset left %d lanes terminated" % (what, int(first.terminated.sum())))
    variant_means = reward.mean(dim=(0, 2)).tolist()
    if len(set(variant_means)) < G:
        raise AssertionError("%s: variants of different grids share a mean reward: %s" % (what, variant_means))
    if counts[kernel] < G * (1 + rollouts * T):
        raise AssertionError("%s launched %s %d times, expected >= %d"
                             % (what, kernel, counts[kernel], G * (1 + rollouts * T)))
    emit({
        "phase": "fleet", "env": env_name, "pf_method": pf_method, "G": G, "L": L, "B": G * L, "T": T,
        "rollouts": rollouts, "sigma": sigma, "auto_reset": auto_reset, "reset_s": reset_s,
        "seconds": counter.total_seconds, "env_steps_per_s": counter.median_rate(), "counter": counter.summary(),
        "variant_mean_reward": variant_means,
        "terminated_frac": float(terminated.float().mean()), "kernel": kernel, "launches": counts,
    })


def phase_fleet_train():
    """``ppo_trainer_for_fleet`` (1 iteration) and ``sac_trainer_for_fleet``
    (1 warm-up round and 1 iteration) over the first fleet's cores."""
    from gym_anm_tpu_torch.envs.randomized import ppo_trainer_for_fleet, sac_trainer_for_fleet

    env_name, G, _, _, _, _, _, sigma = FLEET_CASES[0]
    cores = fleet_cores(env_name, G, sigma)
    kernel = path_kernel(cores[0])
    B = G * FLEET_TRAIN_L

    ppo = ppo_trainer_for_fleet(cores, FLEET_TRAIN_L, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    es = ppo.init_envs()
    es, metrics = ppo.train_step(es)
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_finite("fleet ppo", metrics, [ppo.model])
    # A reset, a pool and the rollout's steps, each once per variant.
    need = G * (2 + ppo.cfg.rollout_steps)
    if counts[kernel] < need:
        raise AssertionError("the fleet PPO run launched %s %d times, expected >= %d" % (kernel, counts[kernel], need))
    emit({"phase": "fleet_train", "trainer": "ppo", "env": env_name, "G": G, "L": FLEET_TRAIN_L, "B": B,
          "iterations": 1, "seconds": seconds, "env_steps": ppo.cfg.rollout_steps * B, "launches": counts, **metrics})

    sac = sac_trainer_for_fleet(cores, FLEET_TRAIN_L, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    es, rb, obs = sac.init_envs()
    es, rb, obs = sac.warmup(es, rb, obs)
    es, rb, obs, metrics = sac.train_step(es, rb, obs)
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_finite("fleet sac", metrics, [sac.actor, sac.critic, sac.target])
    need = G * (1 + 2 * (1 + sac.cfg.collect_steps))
    if counts[kernel] < need:
        raise AssertionError("the fleet SAC run launched %s %d times, expected >= %d" % (kernel, counts[kernel], need))
    emit({"phase": "fleet_train", "trainer": "sac", "env": env_name, "G": G, "L": FLEET_TRAIN_L, "B": B,
          "warmup_rounds": 1, "iterations": 1, "seconds": seconds, "env_steps": 2 * sac.cfg.collect_steps * B,
          "replay_size": rb.size, "launches": counts, **metrics})


def timed(fn):
    """``fn()`` and its seconds, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def calibration_replay(agent):
    """The agent's polish on the committed float32 ADMM seed batch of
    feeder141 h5: the worst HiGHS gap and bound violation over its lanes."""
    root = os.path.dirname(os.path.abspath(__file__))
    data = np.load(os.path.join(root, "tests", "data", "polish_calib_feeder141.npz"))
    out, seconds = timed(lambda: agent._polish_batch(
        data["xs"].astype(np.float64), (None, data["z"], data["y"]), data["lv"], data["uv"]))
    gaps, viols = [], []
    for b in range(out.shape[0]):
        lv, uv, opt = data["lv"][b], data["uv"][b], data["highs_opt"][b]
        Ax = agent.apply_A_host(out[b])
        viols.append(float(max(np.max(np.maximum(0, lv - Ax)), np.max(np.maximum(0, Ax - uv)))))
        gaps.append(float(abs(agent.q @ out[b] - opt) / max(1.0, abs(opt))))
    return {"calib_lanes": out.shape[0], "calib_max_gap": max(gaps), "calib_max_violation": max(viols),
            "calib_seconds": seconds}


def phase_mpc(env_name, agent_name, N, B, loop_steps, loop_kw, polish, verify):
    import types

    from gym_anm_tpu_torch import agents, check
    from gym_anm_tpu_torch.agents.mpc import verify_lanes
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series
    from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
    from gym_anm_tpu_torch.envs.batched import BatchedEnv
    from gym_anm_tpu_torch.envs.feeder_networks import make_multi_feeder_network
    from gym_anm_tpu_torch.simulator import Simulator

    core = check.task_make_core(env_name)(dtype=torch.float32, device="cuda", pf_method="tree")
    kernel = path_kernel(core)
    network = {"anm6easy": lambda: anm6_network, "feeder141": make_multi_feeder_network}[env_name]()
    sim = Simulator(network, delta_t=0.25, lamb=100, device="cuda")
    space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
    kw = dict(P_loads=_get_load_time_series(), P_maxs=_get_gen_time_series()) if "Perfect" in agent_name else {}
    agent = getattr(agents, agent_name)(sim, space, core.gamma, planning_steps=N, device="cuda", **kw)
    env = BatchedEnv(core, B)
    es, first = env.reset()
    what = "%s %s h%d" % (env_name, agent_name, N)
    row = {"phase": "mpc", "env": env_name, "agent": agent_name, "horizon": N, "B": B,
           "solver_dtype": str(agent.dtype), "M": len(agent.l),
           "n": agent.nz, "polish": polish}

    # A cold solve (keeping its carry where the loop's solves are warm).
    acts, row["cold_s"] = timed(lambda: agent.act_batch(first.state_vec, polish=polish, **loop_kw))
    x = agent.last_batch_solution["x"]
    row["cold_mean_objective"] = float((x @ torch.as_tensor(agent.q, device=x.device)).mean())
    if verify:
        row.update(verify_lanes(agent, verify))
        if "verify_error" in row:
            raise AssertionError("%s: %s" % (what, row["verify_error"]))
        if not (row["verify_max_rel_obj_gap"] <= MPC_GAP and row["verify_max_bound_violation"] <= MPC_VIOL):
            raise AssertionError("%s: polished lanes off the HiGHS optimum: %s" % (what, row))
    if polish:
        row.update(calibration_replay(agent))
        if not (row["calib_max_gap"] <= MPC_CALIB_GAP and row["calib_max_violation"] <= MPC_CALIB_VIOL):
            raise AssertionError("%s: calibration replay missed its HiGHS optima: %s" % (what, row))

    # The closed loop: each step through K1 with the last solve's actions,
    # then the next (warm-started) solve from the step's state vectors.
    torch.cuda.synchronize()
    zero_counts()
    rewards, solve_s = [], []
    t0 = time.perf_counter()
    for _ in range(loop_steps):
        es, out = env.step(es, acts)
        rewards.append(out.reward)
        acts, s = timed(lambda: agent.act_batch(out.state_vec, polish=polish, **loop_kw))
        solve_s.append(s)
    loop_s = time.perf_counter() - t0
    counts = read_counts()
    reward = torch.stack(rewards)
    row.update({
        "loop_warm_start": bool(loop_kw.get("warm_start")), "loop_steps": loop_steps, "loop_solve_s": solve_s,
        "loop_s": loop_s,
        "mean_reward": float(reward.mean()), "terminated_frac": float(out.terminated.float().mean()),
        "mean_abs_action_mw": float(acts.abs().mean()), "kernel": kernel, "launches": counts,
    })
    emit(row)
    if not (bool(torch.isfinite(reward).all()) and bool(torch.isfinite(acts).all())
            and all(np.isfinite(v) for v in row.values() if isinstance(v, float))):
        raise AssertionError("%s: non-finite values: %s" % (what, row))
    if counts[kernel] < loop_steps:
        raise AssertionError("%s: the closed loop launched %s %d times" % (what, kernel, counts[kernel]))
    if agent_name == "MPCAgentConstant" and not (row["terminated_frac"] <= MPC_TERM_FRAC
                                                 and row["mean_reward"] > MPC_MEAN_REWARD):
        raise AssertionError("%s: the closed loop misses the MPC bar: %s" % (what, row))


def gym_card_row(smi, **row):
    """A gym row, with the card it was measured on."""
    return {"phase": "gym", **row, "card": smi}


def phase_gym_lockstep(env_name, T, seg, smi):
    """The lockstep core of ``ANMVectorEnv`` (``envs/vector_core.py``) at
    B=4096 in float32 on the task's ``tree`` path: a full reset, then ``T``
    steps of uniform random actions given as NumPy arrays, each step's
    results brought to the host in one copy, as ``ANMVectorEnv.step`` does.
    Returns the core and the last state."""
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs import vector_core

    from gym_anm_tpu_torch.ops import tree_cuda

    core = check.task_make_core(env_name)(dtype=torch.float32, device="cuda")
    kernel = path_kernel(core)
    lock = vector_core.LockstepEnv(core, GYM_B, seed=0)
    rng = np.random.default_rng(0)
    actions = rng.uniform(core.action_low, core.action_high, size=(T, GYM_B, core.action_n)).astype(np.float32)
    torch.cuda.synchronize()
    zero_counts()
    _, failed = lock.reset()
    reset_launches = read_counts()[kernel]
    needs = failed.cpu().numpy()
    # Next-step autoreset: a lane flagged by the previous step returns reward
    # 0, terminated False and the observation of the fresh state it now
    # holds; the observation check is counted on the card (a few small ops a
    # step, no sync), the rest is read from the step's host copy.
    mismatched = torch.zeros((), dtype=torch.long, device="cuda")
    fresh_failed = torch.zeros((), dtype=torch.long, device="cuda")
    seconds, rows = [], []
    for s in range(T // seg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(s * seg, (s + 1) * seg):
            needs_t = lock.needs_reset
            vs = lock.step(actions[t])
            mismatched += (needs_t[:, None] & (vs.obs != core.observation(lock.es))).sum()
            fresh_failed += (needs_t & lock.es.terminated).sum()
            obs, reward, term = vector_core.to_numpy(vs)
            rows.append((needs, obs, reward, term))
            needs = term
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()

    what = "gym %s lockstep" % env_name
    reset_lanes = 0
    for needs, obs, reward, term in rows:
        if obs.shape != (GYM_B, core.obs_n) or not (np.isfinite(obs).all() and np.isfinite(reward).all()):
            raise AssertionError("%s: observations or rewards not finite [B, obs_n]" % what)
        if (reward[needs] != 0).any() or term[needs].any():
            raise AssertionError("%s: a reset lane's step is not reward 0, not terminated" % what)
        reset_lanes += int(needs.sum())
    if int(mismatched):
        raise AssertionError("%s: %d observation entries of reset lanes are not their fresh state's"
                             % (what, int(mismatched)))
    per_step = (counts[kernel] - reset_launches) / T
    if per_step != 2:
        raise AssertionError("%s launched %s %s times a step, expected 2" % (what, kernel, per_step))
    if env_name == "feeder33" and reset_lanes == 0:
        raise AssertionError("%s: no lane was reset; the autoreset branch did not run" % what)

    prof = profile(lambda: [vector_core.to_numpy(lock.step(a)) for a in actions[:GYM_PROFILE_STEPS]],
                   GYM_PROFILE_STEPS, tree_cuda, kernel)
    emit(gym_card_row(
        smi, row="a" if env_name == "anm6easy" else "b", env=env_name, pf_method=core.pf_method, B=GYM_B, T=T,
        steps_a_segment=seg, segment_s=seconds, env_steps_per_s=GYM_B * seg / float(np.median(seconds[1:])),
        reset_launches=reset_launches, kernel=kernel, launches=counts, kernel_launches_a_step=per_step,
        lanes_reset=reset_lanes, fresh_states_failed=int(fresh_failed),
        terminated_frac=float(np.mean([r[3].mean() for r in rows])), mean_reward=float(np.mean([r[2] for r in rows])),
        profiled_steps=GYM_PROFILE_STEPS, profile={k: v for k, v in prof.items() if k != "top_kernels"},
    ))
    return core, lock.es


def phase_gym_card_vs_cpu(env_name, smi):
    """``GYM_CHECK_T`` lockstep steps at B=``GYM_CHECK_B`` on the card and on
    the CPU (the plain twins) from the same draws, made once on the CPU: the
    initial states, each step's vars and fresh states; every eighth lane is
    reset at the first step.  Held to ``check.compare_trajectories``' rule."""
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.envs import vector_core

    cores = {dev: check.task_make_core(env_name)(dtype=torch.float32, device=dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(0)
    s0 = cores["cpu"].init_state_fn(gen, GYM_CHECK_B)
    es = {dev: core.env_state_from_s0(s0.to(dev)) for dev, core in cores.items()}
    needs = {dev: (torch.arange(GYM_CHECK_B) % 8 == 0).to(dev) for dev in cores}
    lo, hi = (torch.as_tensor(a, dtype=torch.float32) for a in (cores["cpu"].action_low, cores["cpu"].action_high))
    traj = {dev: {"state_vec": [], "reward": [], "terminated": []} for dev in cores}
    zero_counts()
    for _ in range(GYM_CHECK_T):
        actions = lo + (hi - lo) * torch.rand((GYM_CHECK_B, lo.shape[0]), generator=gen)
        d = vector_core.draw(cores["cpu"], es["cpu"], gen)
        for dev, core in cores.items():
            es[dev], vs = vector_core.step(core, es[dev], needs[dev], actions.to(dev), d.vars.to(dev),
                                           d.fresh_s0.to(dev))
            needs[dev] = vs.terminated
            for k, v in (("state_vec", es[dev].state_vec), ("reward", vs.reward), ("terminated", vs.terminated)):
                traj[dev][k].append(v.cpu().numpy())
    counts = read_counts()
    ref, got = ({k: np.stack(v) for k, v in traj[dev].items()} for dev in ("cpu", "cuda"))
    res = check.compare_trajectories(ref, got)
    emit(gym_card_row(smi, row="c", env=env_name, B=GYM_CHECK_B, T=GYM_CHECK_T, launches=counts,
                      terminated_frac=float(ref["terminated"].mean()), **res))
    if not res["pass"]:
        raise AssertionError("gym %s: the card's lockstep steps disagree with the CPU's: %s" % (env_name, res))
    if counts["tree_nr"] != 2 * GYM_CHECK_T:
        raise AssertionError("gym %s: the card's steps launched tree_nr %d times" % (env_name, counts["tree_nr"]))


def phase_gym_single(smi):
    """The program ``ANMEnv.step`` runs (``envs/single_core.py``): a one-lane
    ANM6Easy ``EnvCore(pf_method="scan")`` step in float64 from host actions
    and vars, with its one host copy, on the card and on the CPU."""
    from gym_anm_tpu_torch.core.env_core import EnvCore
    from gym_anm_tpu_torch.core.grid import build_grid
    from gym_anm_tpu_torch.core.obs import state_values_spec
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series, make_core
    from gym_anm_tpu_torch.envs.anm6.network import network
    from gym_anm_tpu_torch.envs.single_core import reset_lane, step_lane

    spec, _ = build_grid(network, delta_t=0.25, lamb=100, dtype=np.float64)
    P_loads, P_maxs = _get_load_time_series(), _get_gen_time_series()
    s0 = make_core(torch.float64, device="cpu").init_state_fn(torch.Generator().manual_seed(3), 1)[0].numpy()
    actions = None
    ms, rewards = {}, {}
    for dev in ("cuda", "cpu"):
        core = EnvCore(spec, K=1, gamma=0.995, device=dev, dtype=torch.float64, costs_clipping=(1, 100),
                       obs_values=state_values_spec(spec, 1), aux_bounds=np.array([[0, 95]]), pf_method="scan")
        if actions is None:  # the same actions on both devices
            actions = np.random.default_rng(3).uniform(core.action_low, core.action_high,
                                                       size=(GYM_SINGLE_T + 1, core.action_n))
        es, converged, state, _ = reset_lane(core, s0)
        if not converged:
            raise AssertionError("gym single %s: the initial state did not converge" % dev)
        rewards[dev] = []
        for t, action in enumerate(actions):
            if t == 1:  # the first step warms up
                t0 = time.perf_counter()
            aux = int((state[-1] + 1) % 96)  # ANM6Easy.next_vars
            vars = np.concatenate([P_loads[:, aux], P_maxs[:, aux], [aux]])
            es, out = step_lane(core, es, action, vars)
            state = out.state
            rewards[dev].append(out.reward)
        ms[dev] = (time.perf_counter() - t0) * 1e3 / GYM_SINGLE_T
    div = float(np.max(np.abs(np.subtract(rewards["cuda"], rewards["cpu"]))))
    emit(gym_card_row(smi, row="d", env="anm6easy", pf_method="scan", dtype="float64", B=1, T=GYM_SINGLE_T,
                      ms_a_step={"cuda": ms["cuda"], "cpu": ms["cpu"]}, cuda_over_cpu=ms["cuda"] / ms["cpu"],
                      max_reward_div=div))
    if not (np.isfinite(rewards["cuda"]).all() and div <= 1e-8):
        raise AssertionError("gym single: the card's rewards disagree with the CPU's by %s" % div)


def phase_gym_replay(core, es, smi):
    """Lane 0 of the ANM6Easy lockstep run, stepped ``GYM_REPLAY_STEPS``
    times on the card, through the ``Simulator`` facade's
    ``set_sim_state`` and ``render/replay.py``'s ``EpisodeRecorder`` into a
    standalone HTML file, as ``ANMEnv.render(mode="replay")`` records one."""
    import datetime
    import tempfile

    from gym_anm_tpu_torch.envs.anm6.network import network
    from gym_anm_tpu_torch.core.env_core import take_lanes
    from gym_anm_tpu_torch.envs.single_core import render_frame_args, render_init_args, step_lane
    from gym_anm_tpu_torch.render.replay import EpisodeRecorder
    from gym_anm_tpu_torch.simulator import Simulator
    from gym_anm_tpu_torch.simulator.facade import _one_lane

    sim = Simulator(network, 0.25, 100, dtype=torch.float32, device="cuda")
    args, topology = render_init_args(sim.get_rendering_specs(), core.costs_clipping, sim.spec)
    recorder = EpisodeRecorder("ANM6Easy", *args, topology=topology)
    lane = take_lanes(es, torch.zeros(1, dtype=torch.long, device="cuda"))
    step = datetime.timedelta(minutes=15)
    date = datetime.datetime(2020, 1, 1) + step * int(lane.aux[0, 0])
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    for _ in range(GYM_REPLAY_STEPS):
        vars = core.next_vars_fn(lane.state_vec, gen)[0].cpu().numpy()
        lane, out = step_lane(core, lane, rng.uniform(core.action_low, core.action_high), vars)
        sim.set_sim_state(_one_lane(lane.sim), converged=not out.terminated)
        date += step
        recorder.frame(date, 0, *render_frame_args(sim, out.e_loss, out.penalty))
    with tempfile.TemporaryDirectory() as tmp:
        with open(recorder.write(os.path.join(tmp, "replay.html"))) as f:
            html = f.read()
    m = re.search(r"var REPLAY = (\{.*?\});</script>", html, re.S)
    data = json.loads(m.group(1).replace("<\\/", "</")) if m else {}
    frames = data.get("frames", [])
    finite = all(np.isfinite(fr[k]).all() for fr in frames for k in ("pInjections", "qInjections", "vMagn"))
    emit(gym_card_row(smi, row="e", env="anm6easy", frames=len(frames), html_bytes=len(html), finite=finite,
                      n_bus=len(data.get("init", {}).get("vMagnMin", []))))
    if len(frames) != GYM_REPLAY_STEPS or not finite or "setupReplay(REPLAY)" not in html:
        raise AssertionError("gym replay: %d frames embedded (expected %d), finite %s"
                             % (len(frames), GYM_REPLAY_STEPS, finite))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import gym_anm_tpu_torch  # noqa: F401  (fails before any output where the package is absent)

        smi = phase_device()
        ptxas = phase_build()
        checks = {
            "tree_nr": phase_tree_vs_plain(ptxas), "nr_dense": phase_nr_vs_plain(), "step_fused": phase_step_vs_plain(),
        }
        phase_parity()
        phase_projection(smi)
        runs = [(case, phase_rollout(*case)) for case in ROLLOUT_CASES]
        # Each kernel's launches on its ANM6Easy path without auto-reset,
        # cold and warm; K1 cold's on the main path of training.
        launches = {}
        for case, (kernel, n) in runs:
            if case[0] == "anm6easy" and len(case) <= 5:
                launches.setdefault((kernel, len(case) == 5 and case[4]), n)
        launches["tree_nr", False] = phase_train()
        for case in FLEET_CASES:
            phase_fleet(*case)
        phase_fleet_train()
        for case in MPC_CASES:
            phase_mpc(*case)
        for env_name, T, seg in GYM_CASES:
            core, es = phase_gym_lockstep(env_name, T, seg, smi)
            if env_name == "anm6easy":
                replay_core, replay_es = core, es
        for env_name in ("anm6easy", "feeder33"):
            phase_gym_card_vs_cpu(env_name, smi)
        phase_gym_single(smi)
        phase_gym_replay(replay_core, replay_es, smi)
        # The plain paths after every other timed phase, so that neither
        # their host loops nor their profiles can perturb those timings.
        phase_parity(plain=True)
        for case in PLAIN_ROLLOUTS:
            phase_plain_rollout(*case, smi)
        phase_parallel(smi)
    except Exception:
        traceback.print_exc()
        return 1
    kernels = []
    for name, rows in checks.items():
        source, replaces = KERNEL_INFO[name]
        for warm in ((False, True) if name in WARM_FORMS else (False,)):
            # ANM6 at B=4096 on the main path's settings, this form's rows.
            form = [r for r in rows if r.get("warm", False) == warm]
            main_row = form[0]
            errs = [max(r["max_abs_err"], r.get("penalty_max_abs_err", 0.0)) for r in form]
            kernels.append({
                "name": name + ("_warm" if warm else ""), "route": "cuda", "source": source,
                "replaces": WARM_FORMS[name] if warm else replaces, "launches": launches[name, warm],
                "max_abs_err": max(errs), "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"], "library_ms": None,
            })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
