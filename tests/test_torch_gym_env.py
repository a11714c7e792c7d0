"""The port's Gymnasium single environments against the JAX package's, in float64.

* ``ANM6Easy`` of both packages, built with the same seed, through a reset
  and 24 steps of actions drawn in the action space from
  ``np.random.default_rng(0)``: observations, rewards, ``terminated``,
  ``e_loss``, ``penalty``, the simulator's state dict and its complex bus
  and branch currents agree to 1e-8; ``date`` and ``year_count`` are equal.
  A current's angle is held where |I| >= 1e-4 p.u.: a bus without a device
  carries the power flow's residual current (up to its 1e-5 tolerance),
  whose angle moves by |dI| / |I| for a last-bit change dI.
  ``Feeder33Env`` through 4 steps likewise, against the JAX episode
  recorded by ``scripts/gen_torch_test_refs.py`` in
  ``tests/data/torch_refs_gym_env.npz`` (its programs take a minute to
  compile).
* An episode driven into the terminal absorbing state
  (``tests/test_env.py``'s collapsing 2-bus env) agrees too.
* ``Feeder141Env`` (port only: the JAX package's dense solver takes too
  long to compile at 141 buses): a reset and 2 steps equal the port's own
  ``EnvCore.step`` on the same inputs.

The surface's quick cases (``tests/test_env.py``'s, the ids, the copies)
are in ``tests/test_torch_gym_surface.py``.  This file holds only the few
tests that compile JAX programs: pytest-xdist's ``loadfile`` schedule
starts files with more tests first, so a file of few tests runs after the
suite's long-running files have started.
"""

import datetime as dt
import json
import os

import numpy as np
import torch

from gym_anm_tpu.envs.anm6.anm6_easy import ANM6Easy as JaxANM6Easy
from gym_anm_tpu.envs.anm_env import ANMEnv as JaxANMEnv

from gym_anm_tpu_torch.core.env_core import EnvCore
from gym_anm_tpu_torch.envs.anm6.anm6_easy import ANM6Easy
from gym_anm_tpu_torch.envs.anm_env import ANMEnv
from gym_anm_tpu_torch.envs.feeder33 import Feeder33Env
from gym_anm_tpu_torch.envs.feeder141 import Feeder141Env


ATOL = 1e-8
# Currents below this (p.u.) have no angle to hold (see the docstring).
MIN_CURRENT = 1e-4


def _snapshot(sim):
    """The state dict and the complex bus and branch currents of a facade."""
    hs = sim._state_arrays()
    return sim.state, {"bus": dict(zip(sim.buses, hs.bus_i[np.asarray(sim.spec.bus_sorted)])),
                       "branch": dict(zip(sim.branches, hs.br_i_from))}


def _assert_state_close(snap, jsnap):
    (state, cur), (jstate, jcur) = snap, jsnap
    for kind in cur:
        assert list(cur[kind]) == list(jcur[kind])
        np.testing.assert_allclose(list(cur[kind].values()), list(jcur[kind].values()), rtol=0, atol=ATOL)
    small = {"bus_i_ang": "bus", "branch_i_ang": "branch"}
    assert list(state) == list(jstate)
    for q in state:
        assert list(state[q]) == list(jstate[q]), q
        for unit in state[q]:
            ids = [i for i in jstate[q][unit] if q not in small or abs(jcur[small[q]][i]) >= MIN_CURRENT]
            assert list(state[q][unit]) == list(jstate[q][unit]), (q, unit)
            np.testing.assert_allclose([state[q][unit][i] for i in ids], [jstate[q][unit][i] for i in ids], rtol=0,
                                       atol=ATOL, err_msg="%s/%s" % (q, unit))


def simple_network():
    return {
        "baseMVA": 100,
        "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 200, -200, 200, -200] + [None] * 7,
                [1, 1, -1, 0.2, 0, -10] + [None] * 9,
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 3, 1, 0]]),
    }


def _simple_env_classes(base, **kw):
    """The 2-bus env of tests/test_env.py and its collapsing variant over the
    ``ANMEnv`` of either package (``kw``: the port's device)."""

    class SimpleEnv(base):
        def __init__(self, observation="state", K=1):
            super().__init__(simple_network(), observation, K, 0.25, 0.9, 100, np.array([[0, 10]] * K), (1, 100), 1,
                             **kw)

        def init_state(self):
            n_dev, n_des, n_gen = 2, 0, 0
            s = np.zeros(2 * n_dev + n_des + n_gen + self.K)
            s[1] = -self.np_random.uniform(0, 5)
            s[self.simulator.N_device + 1] = s[1] * 0.2
            return s

        def next_vars(self, s_t):
            return np.array([-5 * self.np_random.uniform()] + [1.0] * self.K)

    class CollapsingEnv(SimpleEnv):
        def __init__(self):
            net = simple_network()
            net["device"][1][5] = -1e6  # unbounded load
            base.__init__(self, net, "state", 1, 0.25, 0.9, 100, np.array([[0, 10]]), (1, 100), 1, **kw)

        def init_state(self):
            s = np.zeros(2 * 2 + 1)
            s[1] = -1.0
            return s

        def next_vars(self, s_t):
            return np.array([-1e6, 1.0])  # catastrophic load -> collapse

    return SimpleEnv, CollapsingEnv


SimpleEnv, CollapsingEnv = _simple_env_classes(ANMEnv, device="cpu")


def _episode(env, actions, seed=0):
    """Reset and step ``env`` through ``actions``: every step's outputs and
    the simulator's state after it."""
    obs, _ = env.reset(seed=seed)
    rows = [dict(obs=obs, snap=_snapshot(env.simulator), date=env.date, year=env.year_count)]
    for a in actions:
        obs, r, term, trunc, info = env.step(a)
        rows.append(dict(obs=obs, r=r, term=term, trunc=trunc, e_loss=env.e_loss, penalty=env.penalty,
                         snap=_snapshot(env.simulator), date=env.date, year=env.year_count, state=env.state))
    return rows


def _assert_episodes_agree(rows, jrows):
    assert len(rows) == len(jrows)
    for t, (row, jrow) in enumerate(zip(rows, jrows)):
        np.testing.assert_allclose(row["obs"], jrow["obs"], rtol=0, atol=ATOL, err_msg="obs %d" % t)
        assert row["date"] == jrow["date"] and row["year"] == jrow["year"], t
        _assert_state_close(row["snap"], jrow["snap"])
        if t:
            assert row["term"] == jrow["term"] and row["trunc"] == jrow["trunc"], t
            for k in ("r", "e_loss", "penalty", "state"):
                np.testing.assert_allclose(row[k], jrow[k], rtol=0, atol=ATOL, err_msg="%s %d" % (k, t))


def _recorded_episode(name):
    """A JAX episode as ``scripts/gen_torch_test_refs.py`` records it, in
    the rows :func:`_episode` gives, and its actions."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_gym_env.npz")) as z:
        actions, rows = z[name + "/actions"], json.loads(str(z[name + "/episode"]))
    key = lambda i: tuple(i) if isinstance(i, list) else i  # a branch's ID is a (from, to) tuple
    for row in rows:
        (state, cur) = row["snap"]
        row["snap"] = ({q: {u: {key(i): x for i, x in d} for u, d in v} for q, v in state},
                       {kind: {key(i): complex(re, im) for i, re, im in c} for kind, c in cur})
        row["obs"] = np.asarray(row["obs"])
        row["date"] = dt.datetime.fromisoformat(row["date"])
        if "state" in row:
            row["state"] = np.asarray(row["state"])
    return actions, rows


def _actions(space, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(space.low, space.high) for _ in range(n)]


def test_anm6easy_matches_jax():
    env, jenv = ANM6Easy(device="cpu"), JaxANM6Easy()
    assert isinstance(env.reset(seed=0)[0], np.ndarray)
    actions = _actions(env.action_space, 24)
    rows, jrows = _episode(env, actions), _episode(jenv, actions)
    _assert_episodes_agree(rows, jrows)
    assert rows[-1]["date"] == rows[0]["date"] + 24 * dt.timedelta(minutes=15)
    np.testing.assert_array_equal(env.action_space.low, jenv.action_space.low)
    np.testing.assert_array_equal(env.observation_space.high, jenv.observation_space.high)


def test_feeder33_matches_jax():
    env = Feeder33Env(seed=1, device="cpu")
    actions = _actions(env.action_space, 4, seed=1)
    jactions, jrows = _recorded_episode("feeder33")  # JaxFeeder33Env(seed=1), the same actions
    np.testing.assert_array_equal(np.stack(actions), jactions, err_msg="re-run scripts/gen_torch_test_refs.py")
    _assert_episodes_agree(_episode(env, actions, seed=5), jrows)


def test_absorbing_episode_matches_jax():
    env, jenv = CollapsingEnv(), _simple_env_classes(JaxANMEnv)[1]()
    actions = [np.zeros(env.action_space.shape)] * 3
    rows, jrows = _episode(env, actions, seed=1), _episode(jenv, actions, seed=1)
    assert [r["term"] for r in rows[1:]] == [True] * 3
    _assert_episodes_agree(rows, jrows)


def test_feeder141_steps_equal_its_core():
    env = Feeder141Env(seed=0, device="cpu")
    core = EnvCore(env.simulator.spec, K=1, gamma=0.995, device="cpu", dtype=torch.float64, costs_clipping=(1, 100),
                   obs_values=env.obs_values, aux_bounds=np.array([[0, 95]]), pf_method="scan")
    s0 = []
    init_state = env.init_state
    env.init_state = lambda: s0.append(init_state()) or s0[-1]
    obs, _ = env.reset(seed=3)
    es = core.env_state_from_s0(torch.tensor(s0[-1])[None])
    np.testing.assert_array_equal(obs, core.observation(es)[0].numpy())
    vars_seen = []
    next_vars = env.next_vars
    env.next_vars = lambda s: vars_seen.append(next_vars(s)) or vars_seen[-1]
    for a in _actions(env.action_space, 2, seed=2):
        obs, r, term, _, _ = env.step(a)
        es, out = core.step(es, torch.tensor(a)[None], torch.tensor(vars_seen[-1])[None])
        assert not term and not bool(out.terminated[0])
        np.testing.assert_array_equal(obs, out.obs[0].numpy())
        np.testing.assert_array_equal(env.state, out.state_vec[0].numpy())
        assert (r, env.e_loss, env.penalty) == (float(out.reward[0]), float(out.e_loss[0]), float(out.penalty[0]))
    v = np.hypot(es.sim.bus_v_re.numpy(), es.sim.bus_v_im.numpy())[0, env.simulator.spec.bus_sorted]
    np.testing.assert_allclose(list(env.simulator.state["bus_v_magn"]["pu"].values()), v, rtol=0, atol=1e-15)
