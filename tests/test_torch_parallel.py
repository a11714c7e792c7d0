"""Data-parallel batching over ``torch.distributed``, on a two-rank gloo group.

One spawn serves the file: a module-scoped fixture runs
``parallel/dryrun.py::dryrun_multidevice(2, "gloo")`` (three dp PPO steps,
a SAC collect and update, a sharded feeder33 fleet collect, a sharded banded
MPC solve; the dry run checks itself), then :func:`_rank_checks` in each rank,
and returns the ranks' dicts; the spawn is killed and the fixture fails
after ``TIMEOUT`` seconds.  Against single-process results: the sharded
replay of the ANM6Easy reference (``tree``, float64), a sharded MPC solve
(dense h3, float64) and one PPO and one SAC update on a fixed global
minibatch split over the ranks, with parameters bit-identical across
ranks.  The gathered replay is held against the JAX package's committed
float64 reference too."""

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.parallel import sharding
from gym_anm_tpu_torch.parallel.dryrun import digest, dryrun_multidevice


WORLD = 2
TIMEOUT = 240.0
REPLAY_T = 16
# The float64 bound of tests/test_torch_solver_replays.py: the reference's
# own storage is float32.
F64_ATOL = 1e-6


def _anm6(dtype=torch.float64):
    from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core

    return make_core(dtype, "cpu")


def _helpers(mesh):
    r = mesh.get_local_rank()
    bs = sharding.batch_sharding(mesh)
    try:
        bs.lanes(7)
        uneven = "accepted"
    except ValueError:
        uneven = "refused"
    tree = {"a": torch.arange(8), "b": (np.ones((8, 2)) * np.arange(8)[:, None], 3)}
    c0 = sharding.COLLECTIVES
    local = sharding.shard_batch(tree, mesh)
    placed = sharding.COLLECTIVES - c0
    back = sharding.gather_batch(local, mesh)
    gathered = sharding.COLLECTIVES - c0 - placed
    mine = torch.full((3,), float(r + 1))
    rep = sharding.replicated(mesh).place(mine)
    refused = []
    for kw in ({"n_devices": WORLD + 1}, {"device_type": "cuda"}):
        try:
            sharding.make_mesh(**kw)
        except ValueError:
            refused.append(sorted(kw))
    return {
        "lanes": (bs.lanes(8).start, bs.lanes(8).stop), "uneven": uneven, "local_a": local["a"].tolist(),
        "local_b": local["b"][0].numpy(), "local_n": local["b"][1], "placed_collectives": placed,
        "gathered": bool(torch.equal(back["a"], tree["a"])) and np.array_equal(back["b"][0].numpy(), tree["b"][0]),
        "gather_collectives": gathered, "replicated": rep.tolist(), "kept": mine.tolist(), "refused": refused,
    }


def _replay(mesh):
    """The ANM6Easy reference's first ``REPLAY_T`` steps, each rank replaying
    its half of the lanes (``tree``, float64); the trajectory gathered."""
    data = check.load_reference("anm6easy")
    lanes_first = lambda a: np.moveaxis(a[:REPLAY_T], 1, 0)
    inputs = (data["s0"], lanes_first(data["actions"]), lanes_first(data["vars"]))
    s0, actions, vars_ = sharding.shard_batch(inputs, mesh)
    c0 = sharding.COLLECTIVES
    sv, rw, tm = check.rollout_given(_anm6(), s0, actions.transpose(0, 1), vars_.transpose(0, 1))
    stepping = sharding.COLLECTIVES - c0
    sv, rw, tm = sharding.gather_batch((sv.transpose(0, 1), rw.T, tm.T), mesh)
    return {"local_lanes": int(s0.shape[0]), "collectives_while_stepping": stepping,
            "state_vec": sv.transpose(0, 1).numpy(), "reward": rw.T.numpy(), "terminated": tm.T.numpy()}


def _mpc(mesh):
    import types

    from gym_anm_tpu_torch.agents import MPCAgentConstant
    from gym_anm_tpu_torch.envs.anm6.network import network
    from gym_anm_tpu_torch.simulator import Simulator

    core = _anm6()
    sim = Simulator(network, delta_t=0.25, lamb=100, device="cpu")
    space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
    agent = MPCAgentConstant(sim, space, core.gamma, planning_steps=3, solver_x64=True, device="cpu")
    sv = core.state_vec(core.env_state_from_s0(core.init_state_fn(torch.Generator().manual_seed(7), 4)))
    sharded = agent.act_batch(sv, sharding=sharding.batch_sharding(mesh))
    return {"sharded": sharded.numpy(), "whole": agent.act_batch(sv).numpy()}


def _minibatch(n, obs_n, act_n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, obs_n)), rng.uniform(-0.9, 0.9, (n, act_n)), rng


def _max_diff(a, b):
    return max(float((x - y).detach().abs().max()) for x, y in zip(a.parameters(), b.parameters()))


def _updates(mesh):
    """One PPO and one SAC update (two of each, Adam's state included) on a
    fixed global minibatch: each rank its half, against one process on the
    whole, from the same weights."""
    from gym_anm_tpu_torch.rl import PPOConfig, PPOTrainer, SACConfig, SACTrainer

    half = lambda xs: tuple(x[sharding.batch_sharding(mesh).lanes(x.shape[0])] for x in xs)
    core = _anm6()
    obs_n, act_n = core.obs_gather.n, core.action_n
    out = {}

    cfg = PPOConfig(hidden=(32, 32))
    dp, one = PPOTrainer(core, 8, cfg, seed=3, mesh=mesh), PPOTrainer(core, 8, cfg, seed=3)
    obs, u, rng = _minibatch(64, obs_n, act_n, 5)
    batch = tuple(torch.tensor(x) for x in (obs, u, rng.normal(size=64) - 3.0, 2.0 * rng.normal(size=64) + 0.5,
                                           rng.normal(size=64)))
    c0 = sharding.COLLECTIVES
    for _ in range(2):
        loss_one, loss_dp = one.update(batch), dp.update(half(batch))
    out["ppo"] = {"max_param_diff": _max_diff(dp.model, one.model), "digest": digest(dp.model),
                  "collectives": sharding.COLLECTIVES - c0, "local_B": dp.B,
                  "losses": (float(loss_one), float(sharding.all_reduce_mean_(loss_dp, mesh)))}

    cfg = SACConfig(hidden=(32, 32), buffer_capacity=64, train_batch=16)
    dp, one = SACTrainer(core, 8, cfg, seed=3, mesh=mesh), SACTrainer(core, 8, cfg, seed=3)
    obs, u, rng = _minibatch(16, obs_n, act_n, 6)
    batch = tuple(torch.tensor(x) for x in (obs, u, 10.0 * rng.normal(size=16), obs + 0.1 * rng.normal(size=obs.shape),
                                           rng.uniform(size=16) < 0.25))
    eps = tuple(torch.tensor(rng.normal(size=(16, act_n))) for _ in range(2))
    for _ in range(2):
        one.update(batch, *eps)
        dp.update(half(batch), *half(eps))
    out["sac"] = {
        "max_param_diff": max(_max_diff(getattr(dp, m), getattr(one, m)) for m in ("actor", "critic", "target")),
        "log_alpha_diff": float((dp.log_alpha - one.log_alpha).detach().abs()),
        "digest": digest(dp.actor, dp.critic, dp.target, dp.log_alpha), "capacity": dp.capacity,
        "train_batch": dp.train_batch,
    }
    return out


def _rank_checks(mesh):
    return {"helpers": _helpers(mesh), "replay": _replay(mesh), "mpc": _mpc(mesh), "updates": _updates(mesh)}


@pytest.fixture(scope="module")
def ranks():
    return dryrun_multidevice(WORLD, "gloo", extra=_rank_checks, timeout=TIMEOUT)


def test_dryrun_over_gloo(ranks):
    assert [r["rank"] for r in ranks] == [0, 1] and {r["backend"] for r in ranks} == {"gloo"}
    for r in ranks:
        assert r["ppo"]["batch"] == 8 and r["ppo"]["local_batch"] == 4 and min(r["ppo"]["collectives_a_step"]) > 0
        assert r["fleet"]["collectives_while_stepping"] == 0 and r["fleet"]["local_lanes_per_variant"] == 2
        assert r["mpc"]["shape"] == [4, 14] and r["mpc"]["max_abs_diff_unsharded"] <= 1e-6
        assert r["ppo"]["param_digests"] == ranks[0]["ppo"]["param_digests"]
        assert r["sac"]["param_digest"] == ranks[0]["sac"]["param_digest"]


def test_sharding_helpers(ranks):
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(device_type="cpu")
    for r, rank in enumerate(ranks):
        h = rank["extra"]["helpers"]
        assert h["lanes"] == (4 * r, 4 * r + 4) and h["uneven"] == "refused"
        assert h["local_a"] == list(range(4 * r, 4 * r + 4)) and h["local_n"] == 3
        np.testing.assert_array_equal(h["local_b"][:, 0], np.arange(4 * r, 4 * r + 4))
        assert h["placed_collectives"] == 0 and h["gathered"] and h["gather_collectives"] == 2
        assert h["replicated"] == [1.0, 1.0, 1.0] and h["kept"] == [float(r + 1)] * 3
        assert h["refused"] == [["n_devices"], ["device_type"]]


def test_sharded_replay_equals_single_process(ranks):
    data = check.load_reference("anm6easy")
    sl = lambda a: a[:REPLAY_T]
    sv, rw, tm = check.rollout_given(_anm6(), data["s0"], sl(data["actions"]), sl(data["vars"]))
    for rank in ranks:
        got = rank["extra"]["replay"]
        assert got["local_lanes"] == 128 and got["collectives_while_stepping"] == 0
        np.testing.assert_array_equal(got["terminated"], tm.numpy())
        np.testing.assert_allclose(got["state_vec"], sv.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got["reward"], rw.numpy(), rtol=0, atol=1e-10)
    assert 0 < tm[-1].float().mean() < 1
    ref = {k: data[k][:REPLAY_T] for k in ("state_vec", "reward", "terminated")}
    res = check.compare_trajectories(ref, {k: ranks[0]["extra"]["replay"][k] for k in ref})
    assert res["pass"] and res["term_mismatch_frac"] == 0.0, res
    assert res["max_state_div"] <= F64_ATOL and res["max_reward_div"] <= F64_ATOL, res


def test_sharded_mpc_equals_unsharded(ranks):
    for rank in ranks:
        m = rank["extra"]["mpc"]
        assert m["sharded"].shape == (4, 6) and np.isfinite(m["sharded"]).all()
        np.testing.assert_allclose(m["sharded"], m["whole"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(m["sharded"], ranks[0]["extra"]["mpc"]["sharded"])


def test_dp_updates_equal_single_process(ranks):
    for rank in ranks:
        u = rank["extra"]["updates"]
        assert u["ppo"]["local_B"] == 4 and u["ppo"]["collectives"] == 2 * 3
        assert u["ppo"]["max_param_diff"] <= 1e-10
        assert abs(u["ppo"]["losses"][0] - u["ppo"]["losses"][1]) <= 1e-10
        assert u["ppo"]["digest"] == ranks[0]["extra"]["updates"]["ppo"]["digest"]
        assert (u["sac"]["capacity"], u["sac"]["train_batch"]) == (32, 8)
        assert u["sac"]["max_param_diff"] <= 1e-10 and u["sac"]["log_alpha_diff"] <= 1e-10
        assert u["sac"]["digest"] == ranks[0]["extra"]["updates"]["sac"]["digest"]
