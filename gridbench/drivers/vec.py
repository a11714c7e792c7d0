"""The Gymnasium vector surface: ``LockstepEnv.step`` in a closed loop.

Each step takes NumPy actions, uniform over the action space from a host
generator seeded with ``--seed``, and ends with the observation, reward and
flags in NumPy, as ``ANMVectorEnv.step`` hands them to Stable-Baselines3 or
CleanRL (``vector_core.to_numpy``: one device-to-host copy).  Next-step
autoreset: lanes that terminated take a fresh state on the following step.

Traffic keys: ``pf_method``, ``batch``, ``warmup_steps``, ``trace_steps``,
``record_every`` (one step in that many is offered to the check, at an
offset drawn from the seed) and ``judge_steps`` (how many of those the check
judges, a sample drawn from the seed).

End-to-end: ``vec_env_steps_per_s``, lane-steps completed (outputs in NumPy)
in the window over the window's seconds.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..harness import DriverOut
from ..sample import Reservoir
from .rollout import build_core, launch_counters


def run(cell) -> DriverOut:
    from gym_anm_tpu_torch.envs.vector_core import LockstepEnv, to_numpy

    tr = cell.traffic
    B = int(tr["batch"])
    core = build_core(cell)
    env = LockstepEnv(core, B, seed=cell.seed)
    host = np.random.default_rng(cell.seed)
    lo = np.asarray(core.action_low, dtype=np.float32)
    hi = np.asarray(core.action_high, dtype=np.float32)
    drawn = {}
    f_vars, f_init = core.next_vars_fn, core.init_state_fn

    def next_vars_fn(s, generator):
        drawn["vars"] = f_vars(s, generator)
        return drawn["vars"]

    def init_state_fn(generator, batch_size):
        drawn["s0"] = f_init(generator, batch_size)
        return drawn["s0"]

    core.next_vars_fn, core.init_state_fn = next_vars_fn, init_state_fn
    if cell.patch is not None:
        cell.patch(core, env)
    env.reset()

    def act():
        return (lo + (hi - lo) * host.random((B, lo.shape[0]), dtype=np.float32)).astype(np.float32)

    def step(a):
        return to_numpy(env.step(a))

    for _ in range(int(tr["warmup_steps"])):
        step(act())

    every = int(tr["record_every"])
    offset = random.Random(cell.seed).randrange(every)
    kept = Reservoir(int(tr["judge_steps"]), cell.seed)
    failed = 0
    l0 = launch_counters()
    win = cell.open_window()
    k = 0
    while True:
        a = act()
        slot = kept.offer() if k % every == offset else None
        keep = slot is not None
        if keep:
            es, needs = env.es, env.needs_reset
        obs, reward, term = step(a)
        failed += int((~np.isfinite(obs)).any(axis=1).sum() + (~np.isfinite(reward)).sum())
        if keep:
            kept.add(slot, {
                "kind": "vec_step", "soc": es.sim.des_soc, "term_in": es.terminated, "sv_in": es.state_vec,
                "needs_reset": needs, "actions": torch.from_numpy(a), "vars": drawn["vars"],
                "fresh_s0": drawn["s0"],
                "obs": torch.from_numpy(obs), "reward": torch.from_numpy(reward),
                "terminated": torch.from_numpy(term),
                "es_sv": env.es.state_vec, "es_term": env.es.terminated,
                "es_v": (env.es.sim.bus_v_re, env.es.sim.bus_v_im),
            })
        k += 1
        win.add(B)
        if win.elapsed() >= cell.seconds:
            break
    win.close()
    l1 = launch_counters()
    counters = {"steps": k, "window_s": win.seconds, "launches": {n: l1[n] - l0[n] for n in l0}}

    trace = None
    if cell.trace:
        from ..trace import capture

        n = int(tr["trace_steps"])
        l0 = launch_counters()
        trace = capture(lambda: [step(act()) for _ in range(n)])
        l1 = launch_counters()
        counters["traced"] = {"steps": n, "launches": {m: l1[m] - l0[m] for m in l0}}
    return DriverOut(metrics={"vec_env_steps_per_s": win.rate()}, attempted=win.work, failed=failed,
                     records=kept.records(), counters=counters, trace=trace)
