"""The multi-device dry run: every sharded training path on ``n`` ranks.

The counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX
package, at its sizes and with its mesh: ``tp = 2`` when ``n`` is even and
at least 4, else 1, over a ``dp x tp`` mesh (``dp = n // tp``).
:func:`dryrun_multidevice` spawns one process a device with
``torch.multiprocessing`` (start method ``spawn``: a forked child cannot use
a CUDA context its parent made), joins them through
:func:`~.launch.init_from_env` and runs in each rank, over
:func:`~.sharding.make_mesh`:

* three PPO steps over ANM6Easy ``tree`` on the ``dp x tp`` mesh, the
  actor-critic's torso split over tp (parameters bit-identical across the
  ranks of one tp coordinate after each step; each rank's shards equal to
  its slice of an unsharded model fed the same minibatches; at least one dp
  and, with tp, one tp collective an update);
* one SAC collect plus update (dp only: the ranks of one dp coordinate
  repeat it);
* a feeder33 fleet collect (``MultiBatchedEnv`` of 2 variants, pool
  auto-reset, 2 steps), each dp coordinate holding ``L / dp`` lanes of each
  variant, with no collective while it steps;
* a banded MPC ``act_batch(sharding=)`` on feeder33, equal to the
  unsharded solve.

The backend is ``nccl`` on cards (a rank on card ``LOCAL_RANK`` of its
host) and ``gloo`` on the CPU (one thread a rank, BLAS included); neither
falls back to the other.  :func:`run_ranks` with ``hosts > 1`` simulates
that many hosts on one machine: a launcher process a host, each spawning
its ranks, all meeting through one TCP store.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue as queue_mod
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import launch, sharding

# The thread counts of the numerical libraries a CPU rank reads at start.
CPU_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# The JAX dry run's PPO and SAC settings (__graft_entry__.py:98-99, 231).
PPO_STEPS = 3
HIDDEN = (32, 32)
# The sharded banded MPC's tolerance against the unsharded solve (MW): the
# lanes are independent, but a batch's ADMM stops on its worst lane, so the
# two solves stop at different iterations.
MPC_ATOL = 1e-6
# The tp model's parameters against the unsharded model's after the same
# updates, in the dry run's float32: the split products round differently
# (a float64 update agrees to 1e-12, tests/test_torch_tensor_parallel.py).
PPO_TP_ATOL = 1e-5
# The rendezvous store's address: every simulated host is this machine.
ADDR = "127.0.0.1"
# Seconds a spawn's ranks have to report before they are ended.
RANKS_TIMEOUT = 600.0


def tp_for(n_devices: int) -> int:
    """The JAX dry run's tp width for ``n_devices``
    (``__graft_entry__.py:96``)."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def _rank_main(local_rank, first_rank, world, backend, port, fn, args, results):
    """One rank: take its place from the launch variables, join the group
    (:func:`~.launch.init_from_env`), run ``fn(*args)``, report to the parent
    (a raised exception reaches the parent through ``torch.multiprocessing``)."""
    rank = first_rank + local_rank
    # The parent serves the store (see run_ranks): every rank, rank 0
    # included, joins it as a client, as under torchrun's agent.
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank), MASTER_ADDR=ADDR,
                      MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True")
    launch.init_from_env(backend)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    # By value: a tensor put as is would be shared through a descriptor
    # that dies with the rank.
    results.put((rank, pickle.dumps(out)))


def _spawn(first_rank, nprocs, world, backend, port, fn, args, results):
    return torch.multiprocessing.start_processes(
        _rank_main, (first_rank, world, backend, port, fn, args, results), nprocs=nprocs, join=False, daemon=True,
        start_method="spawn",
    )


def _stop(ctx):
    """End every process of ``ctx`` still running: a terminate, then a kill
    after 10 s."""
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    for p in ctx.processes:
        p.join(10.0)
        if p.is_alive():
            p.kill()
            p.join()


def _exit_on_term(signum, frame):
    sys.exit(128 + signum)


def _host_main(host, per_host, world, backend, port, fn, args, results, cards):
    """One simulated host: its ``per_host`` ranks (global ranks ``host *
    per_host ...``) spawned and waited for.  Over ``nccl`` the host sees only
    its cards (``cards[host]``), as a real host does, so ``LOCAL_RANK``
    picks among them.  A terminate ends its ranks with it."""
    signal.signal(signal.SIGTERM, _exit_on_term)
    if cards is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards[host])
    ctx = _spawn(host * per_host, per_host, world, backend, port, fn, args, results)
    try:
        while not ctx.join(timeout=1.0):
            pass
    finally:
        _stop(ctx)


def _visible_cards() -> list:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        return visible.split(",")
    return [str(i) for i in range(torch.cuda.device_count())]


def run_ranks(fn, world: int, backend: str, args=(), timeout: float = RANKS_TIMEOUT, hosts: int = 1) -> list:
    """Run ``fn(*args)`` in ``world`` spawned ranks joined in a ``backend``
    process group; returns their results in rank order.

    The ranks meet through a TCP store that this process serves on
    ``127.0.0.1`` for as long as they run, on a port the store itself took
    (so no other process can take it between its choice and its use).
    ``hosts > 1`` simulates that many hosts: a launcher process a host, each spawning
    ``world / hosts`` ranks with their own ``LOCAL_RANK`` (over ``nccl``,
    each host sees its own cards).  ``fn`` and its results are pickled (a
    function of an importable module).  Raises with the rank's traceback
    when a rank fails, and ends every process and raises ``TimeoutError``
    when they have not all ended after ``timeout`` seconds (a hung
    rendezvous among them).
    """
    world, hosts = int(world), int(hosts)
    if hosts < 1 or world % hosts:
        raise ValueError("%d ranks do not split evenly over %d hosts" % (world, hosts))
    cards = None
    if backend == "nccl" and hosts > 1:
        visible = _visible_cards()
        if len(visible) < world:
            raise RuntimeError("%d nccl ranks need %d cards, this machine has %d" % (world, world, len(visible)))
        per = world // hosts
        cards = [visible[h * per:(h + 1) * per] for h in range(hosts)]
    store = dist.TCPStore(ADDR, 0, is_master=True, wait_for_workers=False)
    port = store.port
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
    # when a rank imports numpy and torch, so they are set for its start
    # (a launcher passes its own on to its ranks).
    one_thread = {k: "1" for k in CPU_THREAD_VARS} if backend == "gloo" else {}
    saved = {k: os.environ.get(k) for k in one_thread}
    os.environ.update(one_thread)
    try:
        if hosts == 1:
            ctx = _spawn(0, world, world, backend, port, fn, args, results)
        else:
            # Not daemons: a launcher spawns processes of its own.
            ctx = torch.multiprocessing.start_processes(
                _host_main, (world // hosts, world, backend, port, fn, args, results, cards), nprocs=hosts,
                join=False, daemon=False, start_method="spawn",
            )
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    try:
        # A rank's results reach the queue's pipe only as the parent reads
        # it, so the parent drains it while the ranks run.
        while not ctx.join(timeout=1.0):
            drain()
            if time.monotonic() > deadline:
                raise TimeoutError("%d of %d ranks reported within %.0f s" % (len(out), world, timeout))
    finally:
        _stop(ctx)
        del store
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
    """Three PPO steps on the mesh; beside them an unsharded model (dp only,
    over the same dp group) takes the same minibatches, and each rank's
    parameters are held against their slice of it after each step."""
    from ..envs.anm6.anm6_easy import make_core
    from ..rl.ppo import PPOConfig, PPOTrainer, tp_shard_state_dict

    B = max(4 * sharding.dp_size(mesh), 8)
    tp, tp_rank = sharding.tp_size(mesh), sharding.tp_rank(mesh)
    cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1, hidden=HIDDEN)
    core = make_core(torch.float32, dev)
    trainer = PPOTrainer(core, B, cfg, seed=0, mesh=mesh)
    unsharded = PPOTrainer(core, B, cfg, seed=0, mesh=mesh if tp == 1 else mesh[sharding.ENV_AXIS])
    batches, per_update = [], []

    def update(batch, _update=trainer.update):
        batches.append(batch)
        c0, t0 = sharding.COLLECTIVES, sharding.TP_COLLECTIVES
        loss = _update(batch)
        tp_n = sharding.TP_COLLECTIVES - t0
        per_update.append((sharding.COLLECTIVES - c0 - tp_n, tp_n))
        return loss

    trainer.update = update
    es = trainer.init_envs()
    digests, collectives, shard_diffs = [], [], []
    for _ in range(PPO_STEPS):
        c0 = sharding.COLLECTIVES
        es, metrics = trainer.train_step(es)
        collectives.append(sharding.COLLECTIVES - c0)
        digests.append(digest(trainer.model))
        for batch in batches:
            unsharded.update(batch)
        batches.clear()
        want = unsharded.model.state_dict()
        if tp > 1:
            want = tp_shard_state_dict(want, HIDDEN, tp, tp_rank)
        shard_diffs.append(max(float((v - want[k]).abs().max()) for k, v in trainer.model.state_dict().items()))
    return {"batch": B, "local_batch": trainer.B, "steps": PPO_STEPS, "updates_a_step": cfg.epochs * cfg.minibatches,
            "collectives_a_step": collectives, "dp_tp_collectives_an_update": per_update, "param_digests": digests,
            "max_abs_diff_unsharded": shard_diffs, **{k: float(v) for k, v in metrics.items()}}


def _dryrun_sac(mesh, dev) -> dict:
    from ..envs.anm6.anm6_easy import make_core
    from ..rl.sac import SACConfig, SACTrainer

    B = max(4 * sharding.dp_size(mesh), 8)
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
    L = 2 * sharding.dp_size(mesh)
    local = sharding.batch_sharding(mesh).lanes(L)
    gen = torch.Generator(device=dev).manual_seed(sharding.rank_seed(21, sharding.dp_rank(mesh)))
    fleet = MultiBatchedEnv(cores, local.stop - local.start, auto_reset=True, generator=gen)
    states, _ = fleet.reset()
    c0 = sharding.COLLECTIVES
    fresh = fleet.fresh_states()  # the auto-reset pool
    rewards = []
    for _ in range(2):
        states, out = fleet.step_fn(states, fleet.random_actions(), fresh=fresh)
        rewards.append(out.reward)
    collectives = sharding.COLLECTIVES - c0
    reward = sharding.gather_batch(torch.stack(rewards).permute(2, 0, 1), mesh)  # [L, T, G], every shard's lanes
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
    B = max(2 * sharding.dp_size(mesh), 4)
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
    world = dist.get_world_size()
    mesh = sharding.make_mesh(device_type=device_type, tp=tp_for(world))
    dev = sharding.rank_device(mesh)
    out = {"rank": dist.get_rank(), "world": world, "local_rank": int(os.environ["LOCAL_RANK"]),
           "dp": sharding.dp_size(mesh), "tp": sharding.tp_size(mesh), "dp_rank": sharding.dp_rank(mesh),
           "tp_rank": sharding.tp_rank(mesh), "backend": dist.get_backend(), "device": str(dev)}
    for name, part in (("ppo", _dryrun_ppo), ("sac", _dryrun_sac), ("fleet", _dryrun_fleet), ("mpc", _dryrun_mpc)):
        t0 = time.perf_counter()
        out[name] = part(mesh, dev)
        out[name]["seconds"] = time.perf_counter() - t0
    if extra is not None:
        out["extra"] = extra(mesh)
    return out


def check_dryrun(ranks: list) -> None:
    """Raise unless the ranks' dry runs hold: PPO parameters bit-identical
    across the ranks of one tp coordinate after each step, and each rank's
    within :data:`PPO_TP_ATOL` of its slice of the unsharded model; at least
    one dp collective an update, and one tp collective with tp; SAC's
    parameters bit-identical across every rank; no collective while the
    fleet steps; finite MPC actions equal to the unsharded solve's, gathered
    by one collective."""
    by_tp = {}
    for r in ranks:
        ppo = r["ppo"]
        if ppo["param_digests"] != by_tp.setdefault(r["tp_rank"], ppo["param_digests"]):
            raise AssertionError("the PPO parameters of tp rank %d differ across dp (rank %d)"
                                 % (r["tp_rank"], r["rank"]))
        if r["sac"]["param_digest"] != ranks[0]["sac"]["param_digest"]:
            raise AssertionError("the ranks' SAC parameters differ after a dp update (rank %d)" % r["rank"])
        if max(ppo["max_abs_diff_unsharded"]) > PPO_TP_ATOL:
            raise AssertionError("rank %d's PPO parameters left the unsharded update's: %s" % (r["rank"], ppo))
        if min(ppo["collectives_a_step"]) < ppo["updates_a_step"]:
            raise AssertionError("a dp PPO step issued fewer collectives than updates: %s" % ppo)
        dp_n, tp_n = zip(*ppo["dp_tp_collectives_an_update"])
        if min(dp_n) < 1 or min(tp_n) < (1 if r["tp"] > 1 else 0):
            raise AssertionError("a PPO update lacked its dp or tp collective (rank %d): %s" % (r["rank"], ppo))
        if r["fleet"]["collectives_while_stepping"] != 0 or not r["fleet"]["finite"]:
            raise AssertionError("the sharded fleet collect issued collectives or non-finite rewards: %s" % r["fleet"])
        mpc = r["mpc"]
        if not (mpc["finite"] and mpc["collectives"] == 1 and mpc["max_abs_diff_unsharded"] <= MPC_ATOL):
            raise AssertionError("the sharded MPC solve differs from the unsharded one: %s" % mpc)
        if not all(np.isfinite(v) for v in (r["ppo"]["loss"], r["sac"]["critic_loss"], r["fleet"]["mean_reward"])):
            raise AssertionError("non-finite dry-run metrics on rank %d" % r["rank"])


def dryrun_multidevice(n_devices: int, backend: str, extra=None, timeout: float = RANKS_TIMEOUT) -> list:
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
