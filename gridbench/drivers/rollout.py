"""Lockstep rollouts: ``BatchedEnv.rollout`` segments back to back.

Traffic keys: ``pf_method``, ``batch``, ``auto_reset_mode`` (``"pool"``),
``segment_steps``, ``trace_segments`` (segments profiled with ``--trace 1``),
``judge_segments`` (the segments the check judges, a sample of the window's
drawn from the seed) and ``record_per_segment`` (the steps judged in each).
Actions are uniform over the action space, drawn by the env's generator,
which ``--seed`` seeds; so are the initial states, the task's variables and
the pool draws.

End-to-end: ``rollout_env_steps_per_s``, lane-steps of the segments completed
in the window over the window's seconds; the window closes on a device
synchronisation.
"""

from __future__ import annotations

import importlib
import random
import time

import torch

from ..harness import DriverOut
from ..sample import Reservoir


class Recorder:
    """Wraps the env's ``step_fn`` and the task's hooks (on the instances)
    to keep references to the inputs and outputs of the sampled steps and
    to time every ``step_fn`` call (host time, no synchronisation)."""

    def __init__(self, env, seed: int, per_segment: int, segment_steps: int, keep_segments: int):
        self.core = env.core
        self.rng = random.Random(seed)
        self.per_segment, self.T = per_segment, segment_steps
        self.on = False
        self.kept = Reservoir(keep_segments, seed)
        self._slot = None
        self.step_s = 0.0
        self.steps = 0
        self._want = set()
        self._k = 0
        self._vars = None
        self._pool = None
        self._pool_id = -1
        f_step, f_vars, f_init = env.step_fn, self.core.next_vars_fn, self.core.init_state_fn

        def init_state_fn(generator, batch_size):
            s0 = f_init(generator, batch_size)
            self._pool = s0
            return s0

        def next_vars_fn(s, generator):
            v = f_vars(s, generator)
            self._vars = v
            return v

        def step_fn(es, actions, generator=None, fresh=None):
            t = time.perf_counter()
            es_new, out = f_step(es, actions, generator, fresh)
            self.step_s += time.perf_counter() - t
            self.steps += 1
            if self.on and self._k in self._want:
                self._record(es, actions, fresh, es_new, out)
            self._k += 1
            return es_new, out

        self.core.init_state_fn, self.core.next_vars_fn, env.step_fn = init_state_fn, next_vars_fn, step_fn

    def segment(self):
        """Before a segment: whether it is kept for the check (a reservoir
        drawn from the seed) and which of its steps."""
        self._k = 0
        self._slot = self.kept.offer() if self.on else None
        self._want = set(self.rng.sample(range(self.T), self.per_segment)) if self._slot is not None else set()
        self._pool_id = -1

    def _record(self, es, actions, fresh, es_new, out):
        if self._pool_id < 0:
            self._pool_id = self.kept.seen
            self.kept.add(self._slot, {"kind": "pool", "id": self._pool_id, "s0": self._pool, "sv": fresh.state_vec,
                                       "term": fresh.terminated, "v": (fresh.sim.bus_v_re, fresh.sim.bus_v_im)})
        self.kept.add(self._slot, {
            "kind": "rollout_step", "pool": self._pool_id,
            "soc": es.sim.des_soc, "term_in": es.terminated, "sv_in": es.state_vec,
            "actions": actions, "vars": self._vars,
            "sv": out.state_vec, "obs": out.obs, "reward": out.reward, "term": out.terminated,
            "v": (es_new.sim.bus_v_re, es_new.sim.bus_v_im), "es_term": es_new.terminated,
        })


def launch_counters():
    from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda

    return {"k1": tree_cuda.KERNEL_LAUNCHES, "k2": nr_cuda.KERNEL_LAUNCHES, "k3": step_cuda.KERNEL_LAUNCHES}


def build_core(cell):
    """The task's core from the configuration file, on the cell's device."""
    cfg, tr = cell.config, cell.traffic
    mod = importlib.import_module(cfg["program"]["make_core"])
    return mod.make_core(dtype=getattr(torch, cfg["dtype"]), device=cell.device, pf_method=tr["pf_method"],
                         network=cfg["network"])


def sync(cell):
    if cell.device == "cuda":
        torch.cuda.synchronize()


def run(cell) -> DriverOut:
    from gym_anm_tpu_torch.envs.batched import BatchedEnv

    tr = cell.traffic
    B, T = int(tr["batch"]), int(tr["segment_steps"])
    core = build_core(cell)
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    env = BatchedEnv(core, B, generator=gen, auto_reset=True, auto_reset_mode=tr["auto_reset_mode"])
    rec = Recorder(env, cell.seed, int(tr["record_per_segment"]), T, int(tr["judge_segments"]))
    if cell.patch is not None:
        cell.patch(core, env)
    es, _ = env.reset()
    # Warm up: one segment builds and loads the kernels and runs every
    # shape of the window.
    rec.segment()
    es, _ = env.rollout(es, T)
    sync(cell)

    rec.on = True
    l0 = launch_counters()
    bad = torch.zeros((), dtype=torch.int64, device=cell.device)
    steps0, step_s0 = rec.steps, rec.step_s
    win = cell.open_window()
    segments = 0
    while True:
        rec.segment()
        es, (reward, _) = env.rollout(es, T)
        bad += (~torch.isfinite(reward)).sum()
        segments += 1
        win.add(B * T)
        if win.elapsed() >= cell.seconds:
            break
    sync(cell)
    win.close()
    rec.on = False
    l1 = launch_counters()
    counters = {
        "segments": segments, "steps": segments * T, "window_s": win.seconds,
        "step_fn_s": rec.step_s - step_s0, "step_fn_calls": rec.steps - steps0,
        "launches": {k: l1[k] - l0[k] for k in l0},
    }

    trace = None
    if cell.trace:
        from ..trace import capture

        n = int(tr["trace_segments"])
        state = {"es": es}

        def traced():
            for _ in range(n):
                rec.segment()
                state["es"], _ = env.rollout(state["es"], T)

        l0 = launch_counters()
        trace = capture(traced)
        l1 = launch_counters()
        counters["traced"] = {"segments": n, "steps": n * T, "launches": {k: l1[k] - l0[k] for k in l0}}
    failed = int(bad)
    return DriverOut(metrics={"rollout_env_steps_per_s": win.rate()}, attempted=win.work, failed=failed,
                     records=rec.kept.records(), counters=counters, trace=trace)
