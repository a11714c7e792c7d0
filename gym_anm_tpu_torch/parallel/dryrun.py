"""The multi-device dry run: every sharded training path on ``n`` ranks.

The counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX
package, at its sizes.  :func:`dryrun_multidevice` spawns one process a
device with ``torch.multiprocessing`` (start method ``spawn``: a forked
child cannot use a CUDA context its parent made), joins them in a process
group through a ``FileStore`` in a temporary directory (no TCP port) and
runs in each rank, over :func:`~.sharding.make_mesh`:

* three dp PPO steps over ANM6Easy ``tree`` (every parameter bit-identical
  across ranks after each step, at least one collective an update);
* one SAC collect plus update;
* a feeder33 fleet collect (``MultiBatchedEnv`` of 2 variants, pool
  auto-reset, 2 steps), each rank holding ``L / world`` lanes of each
  variant, with no collective while it steps;
* a banded MPC ``act_batch(sharding=)`` on feeder33, equal to the
  unsharded solve.

The backend is ``nccl`` on cards (rank ``r`` on ``cuda:r``) and ``gloo`` on
the CPU (one thread a rank, BLAS included); neither falls back to the
other.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue as queue_mod
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import sharding

# The thread counts of the numerical libraries a CPU rank reads at start.
CPU_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# The JAX dry run's PPO and SAC settings (__graft_entry__.py:98-99, 231).
PPO_STEPS = 3
HIDDEN = (32, 32)
# The sharded banded MPC's tolerance against the unsharded solve (MW): the
# lanes are independent, but a batch's ADMM stops on its worst lane, so the
# two solves stop at different iterations.
MPC_ATOL = 1e-6


def _rank_main(rank, world, backend, store_path, fn, args, results):
    """One rank: join the group, run ``fn(*args)``, report to the parent (a
    raised exception reaches the parent through ``torch.multiprocessing``)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    # By value: a tensor put as is would be shared through a descriptor
    # that dies with the rank.
    results.put((rank, pickle.dumps(out)))


def run_ranks(fn, world: int, backend: str, args=(), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` spawned ranks joined in a ``backend``
    process group; returns their results in rank order.

    ``fn`` and its results are pickled (a function of an importable
    module).  Raises with the rank's traceback when a rank fails, and kills
    every rank and raises ``TimeoutError`` when they have not all ended
    after ``timeout`` seconds (a hung rendezvous among them).
    """
    results = torch.multiprocessing.get_context("spawn").Queue()
    out = {}

    def drain():
        while True:
            try:
                rank, res = results.get_nowait()
            except queue_mod.Empty:
                return
            out[rank] = pickle.loads(res)

    # A CPU rank runs on one thread, BLAS included: the variables are read
    # when a rank imports numpy and torch, so they are set for its start.
    one_thread = {k: "1" for k in CPU_THREAD_VARS} if backend == "gloo" else {}
    saved = {k: os.environ.get(k) for k in one_thread}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(one_thread)
        try:
            ctx = torch.multiprocessing.start_processes(
                _rank_main, (world, backend, os.path.join(tmp, "store"), fn, args, results), nprocs=world,
                join=False, daemon=True, start_method="spawn",
            )
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        try:
            # A rank's results reach the queue's pipe only as the parent
            # reads it, so the parent drains it while the ranks run.
            while not ctx.join(timeout=1.0):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError("%d of %d ranks reported within %.0f s" % (len(out), world, timeout))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        deadline = time.monotonic() + 10.0
        while len(out) < world and time.monotonic() < deadline:
            drain()
            time.sleep(0.01)
        results.close()
    if len(out) < world:
        raise RuntimeError("ranks %s ended without reporting" % sorted(set(range(world)) - set(out)))
    return [out[r] for r in range(world)]


def digest(*modules) -> str:
    """A hash of every parameter's bytes: equal on two ranks only when their
    parameters are bit-identical."""
    h = hashlib.sha256()
    for m in modules:
        for t in (m.parameters() if isinstance(m, torch.nn.Module) else [m]):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dryrun_ppo(mesh, dev) -> dict:
    from ..envs.anm6.anm6_easy import make_core
    from ..rl.ppo import PPOConfig, PPOTrainer

    B = max(4 * mesh.size(), 8)
    cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1, hidden=HIDDEN)
    trainer = PPOTrainer(make_core(torch.float32, dev), B, cfg, seed=0, mesh=mesh)
    es = trainer.init_envs()
    digests, collectives = [], []
    for _ in range(PPO_STEPS):
        c0 = sharding.COLLECTIVES
        es, metrics = trainer.train_step(es)
        collectives.append(sharding.COLLECTIVES - c0)
        digests.append(digest(trainer.model))
    return {"batch": B, "local_batch": trainer.B, "steps": PPO_STEPS, "updates_a_step": cfg.epochs * cfg.minibatches,
            "collectives_a_step": collectives, "param_digests": digests,
            **{k: float(v) for k, v in metrics.items()}}


def _dryrun_sac(mesh, dev) -> dict:
    from ..envs.anm6.anm6_easy import make_core
    from ..rl.sac import SACConfig, SACTrainer

    B = max(4 * mesh.size(), 8)
    cfg = SACConfig(hidden=HIDDEN, buffer_capacity=B * 8, collect_steps=4, grad_steps=2, train_batch=16)
    trainer = SACTrainer(make_core(torch.float32, dev), B, cfg, seed=1, mesh=mesh)
    es, rb, obs = trainer.init_envs()
    es, rb, obs = trainer.warmup(es, rb, obs)
    c0 = sharding.COLLECTIVES
    es, rb, obs, metrics = trainer.train_step(es, rb, obs)
    return {"batch": B, "local_batch": trainer.B, "replay_size": rb.size, "collectives": sharding.COLLECTIVES - c0,
            "param_digest": digest(trainer.actor, trainer.critic, trainer.target, trainer.log_alpha),
            **{k: float(v) for k, v in metrics.items()}}


def _dryrun_fleet(mesh, dev) -> dict:
    from ..envs.randomized import MultiBatchedEnv, randomized_feeder33_cores

    cores = randomized_feeder33_cores(2, seed=0, r_sigma=0.1, x_sigma=0.1, dtype=torch.float32, device=dev)
    L = 2 * mesh.size()
    local = sharding.batch_sharding(mesh).lanes(L)
    gen = torch.Generator(device=dev).manual_seed(sharding.rank_seed(21, mesh.get_local_rank()))
    fleet = MultiBatchedEnv(cores, local.stop - local.start, auto_reset=True, generator=gen)
    states, _ = fleet.reset()
    c0 = sharding.COLLECTIVES
    fresh = fleet.fresh_states()  # the auto-reset pool
    rewards = []
    for _ in range(2):
        states, out = fleet.step_fn(states, fleet.random_actions(), fresh=fresh)
        rewards.append(out.reward)
    collectives = sharding.COLLECTIVES - c0
    reward = sharding.gather_batch(torch.stack(rewards).permute(2, 0, 1), mesh)  # [L, T, G], every rank's lanes
    return {"variants": len(cores), "lanes_per_variant": L, "local_lanes_per_variant": fleet.L, "steps": 2,
            "collectives_while_stepping": collectives, "mean_reward": float(reward.mean()),
            "finite": bool(torch.isfinite(reward).all())}


def _dryrun_mpc(mesh, dev) -> dict:
    import types

    from ..agents import MPCAgentConstantBanded
    from ..envs.feeder33 import make_core
    from ..envs.feeder_networks import make_feeder_network
    from ..simulator import Simulator

    core = make_core(torch.float32, dev)
    sim = Simulator(make_feeder_network(), delta_t=0.25, lamb=100, device=dev)
    space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
    agent = MPCAgentConstantBanded(sim, space, core.gamma, safety_margin=0.9, planning_steps=2, solver_x64=True,
                                   device=dev)
    B = max(2 * mesh.size(), 4)
    s0 = core.init_state_fn(torch.Generator(device=dev).manual_seed(33), B)  # the same global batch on every rank
    sv = core.state_vec(core.env_state_from_s0(s0))
    c0 = sharding.COLLECTIVES
    acts = agent.act_batch(sv, sharding=sharding.batch_sharding(mesh))
    collectives = sharding.COLLECTIVES - c0
    whole = agent.act_batch(sv)
    return {"batch": B, "horizon": agent.planning_steps, "shape": list(acts.shape),
            "finite": bool(torch.isfinite(acts).all()), "collectives": collectives,
            "max_abs_diff_unsharded": float((acts - whole).abs().max())}


def _dryrun_rank(backend, extra):
    device_type = "cuda" if backend == "nccl" else "cpu"
    mesh = sharding.make_mesh(device_type=device_type)
    dev = sharding.rank_device(mesh)
    out = {"rank": mesh.get_local_rank(), "world": mesh.size(), "backend": dist.get_backend(), "device": str(dev)}
    for name, part in (("ppo", _dryrun_ppo), ("sac", _dryrun_sac), ("fleet", _dryrun_fleet), ("mpc", _dryrun_mpc)):
        t0 = time.perf_counter()
        out[name] = part(mesh, dev)
        out[name]["seconds"] = time.perf_counter() - t0
    if extra is not None:
        out["extra"] = extra(mesh)
    return out


def check_dryrun(ranks: list) -> None:
    """Raise unless the ranks' dry runs hold: parameters bit-identical across
    ranks after each PPO step and after SAC's; at least one collective a PPO
    update; none while the fleet steps; finite MPC actions equal to the
    unsharded solve's, gathered by one collective."""
    r0 = ranks[0]
    for r in ranks:
        same = (r["ppo"]["param_digests"], r["sac"]["param_digest"]) == (r0["ppo"]["param_digests"],
                                                                       r0["sac"]["param_digest"])
        if not same:
            raise AssertionError("the ranks' parameters differ after a dp update (rank %d)" % r["rank"])
        if min(r["ppo"]["collectives_a_step"]) < r["ppo"]["updates_a_step"]:
            raise AssertionError("a dp PPO step issued fewer collectives than updates: %s" % r["ppo"])
        if r["fleet"]["collectives_while_stepping"] != 0 or not r["fleet"]["finite"]:
            raise AssertionError("the sharded fleet collect issued collectives or non-finite rewards: %s" % r["fleet"])
        mpc = r["mpc"]
        if not (mpc["finite"] and mpc["collectives"] == 1 and mpc["max_abs_diff_unsharded"] <= MPC_ATOL):
            raise AssertionError("the sharded MPC solve differs from the unsharded one: %s" % mpc)
        if not all(np.isfinite(v) for v in (r["ppo"]["loss"], r["sac"]["critic_loss"], r["fleet"]["mean_reward"])):
            raise AssertionError("non-finite dry-run metrics on rank %d" % r["rank"])


def dryrun_multidevice(n_devices: int, backend: str, extra=None, timeout: float = 600.0) -> list:
    """Run the dry run on ``n_devices`` ranks over ``backend`` (``"nccl"``:
    one card a rank; ``"gloo"``: CPU processes) and check it
    (:func:`check_dryrun`).  ``extra(mesh) -> dict`` (a function of an
    importable module), when given, runs in each rank after the dry run, its
    result under ``"extra"``.  Returns one dict per rank."""
    if backend not in sharding.BACKENDS.values():
        raise ValueError("backend must be one of %s" % sorted(sharding.BACKENDS.values()))
    ranks = run_ranks(_dryrun_rank, int(n_devices), backend, (backend, extra), timeout=timeout)
    check_dryrun(ranks)
    return ranks
