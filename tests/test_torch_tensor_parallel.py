"""The PPO actor-critic split over a ``tp`` mesh dimension, on two gloo ranks.

One spawn serves the file: a module-scoped fixture runs :func:`_rank` on a
``dp 1 x tp 2`` mesh through ``parallel/dryrun.py::run_ranks(hosts=2)``,
two simulated hosts of one rank each, joined through the TCP store of
``parallel/launch.py::init_from_env``.  In float64 at ``hidden=(32, 32)``,
from numpy weights carried in through ``params_from_flax``: the tp forward
against the JAX package's flax ``ActorCritic``, and two clipped PPO updates
against the unsharded port's on the same global minibatch, both run in
this process; and SAC on the same mesh, which uses only its dp dimension.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gym_anm_tpu_torch.parallel import launch, sharding
from gym_anm_tpu_torch.parallel.dryrun import run_ranks


HIDDEN = (32, 32)
TP = 2
TIMEOUT = 180.0
N = 48  # minibatch rows
# Low enough that the clip engages on this minibatch (checked below).
MAX_GRAD_NORM = 0.05
SHARDED = ("torso.0.weight", "torso.0.bias", "torso.1.weight")
ATOL = 1e-12


def _core():
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core

    return make_core(torch.float64, "cpu")


def _inputs():
    """Flax-layout numpy weights, observations and a minibatch ``(obs, u,
    logp_old, adv, ret)``, from a seed."""
    core = _core()
    obs_n, act_n = core.obs_gather.n, core.action_n
    rng = np.random.default_rng(10)
    sizes = (obs_n,) + HIDDEN
    dense = lambda a, b: {"kernel": rng.normal(size=(a, b)) / np.sqrt(a), "bias": 0.1 * rng.normal(size=b)}
    params = {"Dense_%d" % i: dense(a, b) for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    params["Dense_2"], params["Dense_3"] = dense(HIDDEN[-1], act_n), dense(HIDDEN[-1], 1)
    params["log_std"] = -0.5 + 0.1 * rng.normal(size=act_n)
    obs = rng.normal(size=(N, obs_n))
    batch = (obs, np.tanh(rng.normal(size=(N, act_n))), rng.normal(size=N) - 3.0, 5.0 * rng.normal(size=N),
             3.0 * rng.normal(size=N))
    return {"params": params}, obs, batch


def _trainer(weights, mesh=None):
    from gym_anm_tpu_torch.rl import PPOConfig, PPOTrainer
    from gym_anm_tpu_torch.rl.ppo import params_from_flax

    t = PPOTrainer(_core(), 8, PPOConfig(hidden=HIDDEN, max_grad_norm=MAX_GRAD_NORM), seed=3, mesh=mesh)
    tp, r = (1, 0) if mesh is None else (sharding.tp_size(mesh), sharding.tp_rank(mesh))
    t.model.load_state_dict(params_from_flax(weights, HIDDEN, tp=tp, tp_rank=r))
    return t


def _state(t):
    return {k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()}


def _rank(weights, obs, batch):
    """In each rank: the launch's coordinates, the tp forward and two tp
    updates (with their collectives) on the whole minibatch."""
    mesh = sharding.make_mesh(device_type="cpu", tp=TP)
    try:
        sharding.make_mesh(device_type="cpu", tp=3)
        tp3 = "accepted"
    except ValueError:
        tp3 = "refused"
    t = _trainer(weights, mesh)
    with torch.no_grad():
        forward = [x.numpy().copy() for x in t.model(torch.tensor(obs))]  # log_std is the parameter
    batch = tuple(torch.tensor(x) for x in batch)
    counts = []
    for _ in range(2):
        c0, t0 = sharding.COLLECTIVES, sharding.TP_COLLECTIVES
        t.update(batch)
        tp_n = sharding.TP_COLLECTIVES - t0
        counts.append((sharding.COLLECTIVES - c0 - tp_n, tp_n))
    lanes = sharding.batch_sharding(mesh).lanes(8)
    # SAC is dp only: on this mesh both tp ranks hold every lane and the
    # same replicated weights.
    from gym_anm_tpu_torch.parallel.dryrun import digest
    from gym_anm_tpu_torch.rl import SACConfig, SACTrainer

    sac = SACTrainer(_core(), 8, SACConfig(hidden=HIDDEN, buffer_capacity=64, train_batch=16), seed=1, mesh=mesh)
    sac.update(tuple(torch.tensor(x) for x in (obs[:16], batch[1][:16], batch[3][:16], obs[16:32],
                                                  np.arange(16) % 5 == 0)))
    return {
        "env": {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}, "rank": dist.get_rank(),
        "device": str(sharding.rank_device(mesh)), "names": mesh.mesh_dim_names,
        "coords": (sharding.dp_size(mesh), sharding.dp_rank(mesh), sharding.tp_size(mesh), sharding.tp_rank(mesh)),
        "tp3": tp3, "lanes": (lanes.start, lanes.stop), "forward": forward, "state": _state(t), "counts": counts,
        "sac": (sac.B, sac.train_batch, digest(sac.actor, sac.critic, sac.target, sac.log_alpha)),
    }


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks(_rank, TP, "gloo", inputs, timeout=TIMEOUT, hosts=2)


def test_launch_coordinates_and_mesh(ranks, monkeypatch):
    for r, rank in enumerate(ranks):
        # Two hosts of one rank: each is local rank 0 of its host.
        assert rank["env"] == {"RANK": str(r), "LOCAL_RANK": "0", "WORLD_SIZE": "2"} and rank["rank"] == r
        assert rank["device"] == "cpu" and rank["names"] == ("env", "tp") and rank["tp3"] == "refused"
        assert rank["coords"] == (1, 0, 2, r) and rank["lanes"] == (0, 8)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    for var in launch.LAUNCH_VARS:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv(var)
        with pytest.raises(RuntimeError, match=var):
            launch.init_from_env("gloo")
    monkeypatch.setenv(var, env[var])
    cards = torch.cuda.device_count()  # one past the last card, on any machine
    monkeypatch.setenv("LOCAL_RANK", str(cards))
    with pytest.raises(RuntimeError, match="LOCAL_RANK=%d, but this host sees %d cards" % (cards, cards)):
        launch.init_from_env("nccl")
    with pytest.raises(ValueError, match="backend"):
        launch.init_from_env("mpi")
    assert not dist.is_initialized()


def test_tp_forward_equals_flax(ranks, inputs):
    import jax.numpy as jnp

    from gym_anm_tpu.rl.ppo import ActorCritic as FlaxActorCritic

    weights, obs, _ = inputs
    mean, log_std, value = FlaxActorCritic(action_n=len(weights["params"]["log_std"]), hidden=HIDDEN).apply(
        weights, jnp.asarray(obs))
    for rank in ranks:
        for got, want in zip(rank["forward"], (mean, log_std, value)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_clipped_tp_update_equals_unsharded(ranks, inputs):
    weights, _, batch = inputs
    one = _trainer(weights)
    tbatch = tuple(torch.tensor(x) for x in batch)
    loss, _ = one.loss(tbatch)
    loss.backward()
    norm = torch.sqrt(sum(p.grad.pow(2).sum() for p in one.model.parameters()))
    assert norm > 4 * MAX_GRAD_NORM  # the clip engages
    for _ in range(2):
        one.update(tbatch)
    want = _state(one)
    shards = [rank["state"] for rank in ranks]
    for k, v in want.items():
        if k in SHARDED:
            axis = 1 if k == "torso.1.weight" else 0
            np.testing.assert_allclose(np.concatenate([s[k] for s in shards], axis=axis), v, rtol=0, atol=ATOL)
        else:
            np.testing.assert_allclose(shards[0][k], v, rtol=0, atol=ATOL)
            np.testing.assert_array_equal(shards[1][k], shards[0][k])
    assert shards[0]["torso.0.weight"].shape == (HIDDEN[0] // TP, weights["params"]["Dense_0"]["kernel"].shape[0])


def test_tp_collectives_and_sac_on_the_mesh(ranks):
    for rank in ranks:
        # dp: the gradient all-reduce and the advantage mean and variance;
        # tp: the row-parallel forward and the clip's sum of squares.
        assert rank["counts"] == [(3, 2), (3, 2)]
        assert rank["sac"][:2] == (8, 16) and rank["sac"] == ranks[0]["sac"]
