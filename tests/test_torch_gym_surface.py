"""The port's Gymnasium surface: the quick cases, on the CPU in float64.

* ``tests/test_env.py``'s cases on a port ``SimpleEnv``: the observation
  modes, bad specs and arguments raising the same error types, the vars and
  initial-state size errors, determinism for a seed, the absorbing state, a
  valid state dict;
* the copies of ``envs/utils.py`` (``check_env_args``) and
  ``envs/anm6/utils.py`` (``random_date``) against the originals; the three
  namespaced ids through ``gymnasium.make``, Gymnasium's ``check_env``, the
  card as the default device, the lazy names of ``gym_anm_tpu_torch.envs``;
* ``tests/test_vector_env.py``'s cases on ``ANMVectorEnv``: spaces and
  shapes in either float type, seed determinism, cores without task hooks
  or an observation spec rejected;
* ``render/{rendering,servers,replay}.py`` are the JAX package's modules
  (docstrings aside), and the port's ``web/app.js`` and ``web/styles.css``
  are byte-equal to the JAX package's, so ``tests/test_replay_artifact.py``'s
  pinned ``frameAttrs`` holds for the port's client too.

None of them compiles a JAX program; the comparisons that do are in
``tests/test_torch_{gym_env,vector_env,render}.py``.
"""

import ast
import inspect
import os

import gymnasium as gym
import numpy as np
import pytest
import torch

from gym_anm_tpu.envs import utils as jax_env_utils
from gym_anm_tpu.envs.anm6 import utils as jax_anm6_utils
from gym_anm_tpu.render import rendering as jax_rendering
from gym_anm_tpu.render import replay as jax_replay
from gym_anm_tpu.render import servers as jax_servers

from gym_anm_tpu_torch.core.env_core import EnvCore
from gym_anm_tpu_torch.envs import utils as env_utils
from gym_anm_tpu_torch.envs.anm6 import utils as anm6_utils
from gym_anm_tpu_torch.envs.anm6.anm6_easy import ANM6Easy, make_core
from gym_anm_tpu_torch.envs.anm_env import ANMEnv
from gym_anm_tpu_torch.envs.feeder33 import Feeder33Env
from gym_anm_tpu_torch.envs.feeder141 import Feeder141Env
from gym_anm_tpu_torch.envs.vector import ANMVectorEnv
from gym_anm_tpu_torch.errors import ArgsError, EnvInitializationError, EnvNextVarsError, ObsSpaceError
from gym_anm_tpu_torch.render import rendering, replay, servers
from tests import test_replay_artifact as artifact
from tests.test_torch_gym_env import CollapsingEnv, SimpleEnv, simple_network


# ---------------------------------------------------------------------------
# tests/test_env.py's cases on the port.
# ---------------------------------------------------------------------------
def test_full_state_observation():
    env = SimpleEnv("state")
    o, _ = env.reset(seed=1)
    assert o.shape == (2 * 2 + 0 + 0 + 1,)
    np.testing.assert_allclose(o, env.state)


def test_list_observation_space():
    env = SimpleEnv([("bus_p", [1], "MW"), ("dev_q", "all"), ("aux", [0])])
    o, _ = env.reset(seed=1)
    assert o.shape == (4,)
    b = env.simulator.state_bounds
    np.testing.assert_allclose(env.observation_space.low[0], b["bus_p"][1]["MW"][0])
    np.testing.assert_allclose(env.observation_space.high[1], b["dev_q"][0]["MVAr"][1])
    o2, r, term, trunc, _ = env.step(env.action_space.sample())
    np.testing.assert_allclose(o2[0], env.simulator.state["bus_p"]["MW"][1], atol=1e-9)
    np.testing.assert_allclose(o2[3], 1.0)  # aux


def test_callable_observation():
    env = SimpleEnv(lambda s: s[:2])
    o, _ = env.reset(seed=1)
    assert o.shape == (2,)
    assert env.observation_space.shape == (2,)
    o2, r, term, trunc, _ = env.step(env.action_space.sample())
    np.testing.assert_allclose(o2, env.state[:2])


@pytest.mark.parametrize(
    "observation, error",
    [
        ([("nonexistent_quantity", "all")], ObsSpaceError),
        ([("bus_p", [99])], ObsSpaceError),
        ([("bus_p", [0], "furlongs")], ObsSpaceError),
        (42, ArgsError),
    ],
)
def test_bad_observation_specs(observation, error):
    with pytest.raises(error):
        SimpleEnv(observation)


def test_bad_env_args():
    class BadK(SimpleEnv):
        def __init__(self):
            ANMEnv.__init__(self, simple_network(), "state", -1, 0.25, 0.9, 100, device="cpu")

    with pytest.raises(ArgsError):
        BadK()


@pytest.mark.parametrize("hook", ["next_vars", "init_state"])
def test_hook_size_errors(hook):
    env = SimpleEnv()
    if hook == "init_state":
        env.init_state = lambda: np.zeros(3)
        with pytest.raises(EnvInitializationError):
            env.reset(seed=1)
    else:
        env.reset(seed=1)
        env.next_vars = lambda s_t: np.zeros(5)
        with pytest.raises(EnvNextVarsError):
            env.step(env.action_space.sample())


def test_deterministic_given_seed():
    env1, env2 = SimpleEnv(), SimpleEnv()
    o1, _ = env1.reset(seed=33)
    o2, _ = env2.reset(seed=33)
    np.testing.assert_array_equal(o1, o2)
    env1.action_space.seed(3)
    env2.action_space.seed(3)
    for _ in range(5):
        a1, a2 = env1.action_space.sample(), env2.action_space.sample()
        np.testing.assert_array_equal(a1, a2)
        s1, s2 = env1.step(a1), env2.step(a2)
        np.testing.assert_array_equal(s1[0], s2[0])
        assert s1[1] == s2[1]


def test_terminal_absorbing_state():
    """After collapse: zero obs, r = -c2/(1-gamma) once, then r=0 forever."""
    env = CollapsingEnv()
    env.reset(seed=1)
    a = env.action_space.sample()
    o, r, term, trunc, _ = env.step(a)
    assert term
    np.testing.assert_allclose(o, np.zeros_like(o))
    np.testing.assert_allclose(r, -100 / (1 - 0.9))
    assert env.e_loss == 1 and env.penalty == 100
    o, r, term, trunc, _ = env.step(a)
    assert term and r == 0.0
    np.testing.assert_allclose(o, np.zeros_like(o))


def test_reset_gives_valid_state_dict():
    env = SimpleEnv()
    env.reset(seed=2)
    st = env.simulator.state
    assert set(st.keys()) >= {"bus_p", "dev_p", "bus_v_magn", "branch_s"}
    np.testing.assert_allclose(st["bus_v_magn"]["pu"][0], 1.0)


# ---------------------------------------------------------------------------
# The copies of host code, and the registered ids.
# ---------------------------------------------------------------------------
def _body(module):
    """A module's AST without its docstring."""
    tree = ast.parse(inspect.getsource(module))
    tree.body = [n for n in tree.body if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    return ast.dump(tree)


@pytest.mark.parametrize("pair", [(env_utils, jax_env_utils), (anm6_utils, jax_anm6_utils)],
                         ids=["check_env_args", "random_date"])
def test_host_copies_equal_the_originals(pair):
    assert _body(pair[0]) == _body(pair[1])


@pytest.mark.parametrize(
    "args",
    [
        (-1, 0.25, 100, 0.9, "state", None),
        (1, 0.0, 100, 0.9, "state", None),
        (1, 0.25, -1, 0.9, "state", None),
        (1, 0.25, 100, 1.5, "state", None),
        (1, 0.25, 100, 0.9, 42, None),
        (1, 0.25, 100, 0.9, "state", np.zeros((2, 2))),
        (1, 0.25, 100, 0.9, [("bus_p", [7])], None),
        (1, 0.25, 100, 0.9, [("aux", [3])], None),
        (1, 0.25, 100, 0.9, [("bus_p", [0], "kV")], None),
        (1, 0.25, 100, 0.9, [("bus_p", [0], "MW")], None),
    ],
)
def test_check_env_args_matches_jax(args):
    bounds = SimpleEnv().simulator.state_bounds
    outcome = []
    for fn in (env_utils.check_env_args, jax_env_utils.check_env_args):
        try:
            fn(*args[:4], args[4], args[5], bounds)
            outcome.append(None)
        except Exception as e:  # noqa: BLE001 - the two raise their own packages' types
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == (args[4] == [("bus_p", [0], "MW")])


def test_random_date_matches_jax():
    draws = [fn(np.random.default_rng(4), 2020) for fn in (anm6_utils.random_date, jax_anm6_utils.random_date)]
    assert draws[0] == draws[1] and draws[0].year == 2020


@pytest.mark.parametrize("name", ["ANM6Easy-v0", "ANMFeeder33-v0", "ANMFeeder141-v0"])
def test_gym_make_namespaced_ids(name):
    env = gym.make("gym_anm_tpu_torch.envs.registration:gym_anm_tpu_torch/" + name, device="cpu")
    obs, _ = env.reset(seed=0)
    assert env.observation_space.contains(obs)
    obs, r, term, trunc, _ = env.step(env.action_space.sample())
    assert obs.shape == env.observation_space.shape and np.isfinite(r)
    assert env.unwrapped._core.device == torch.device("cpu")
    env.close()


def test_check_env_anm6easy():
    from gymnasium.utils.env_checker import check_env

    check_env(ANM6Easy(device="cpu"), skip_render_check=True)


def test_default_device_is_the_card():
    """Like ``make_core()``, an environment built without ``device`` computes
    on the card, and without one it raises: there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for build in (make_core, ANM6Easy, Feeder33Env, Feeder141Env):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()


def test_envs_package_reaches_the_gymnasium_classes():
    """``gym_anm_tpu_torch.envs`` names the Gymnasium classes as the JAX
    package's ``envs`` does, importing their modules on first access."""
    import gym_anm_tpu_torch.envs as envs
    from gym_anm_tpu_torch.envs.anm6.anm6 import ANM6

    assert (envs.ANMEnv, envs.ANM6, envs.ANM6Easy, envs.ANMVectorEnv) == (ANMEnv, ANM6, ANM6Easy, ANMVectorEnv)
    import gym_anm_tpu_torch.envs.feeder33 as feeder33

    with pytest.raises(AttributeError):
        envs.Feeder33Env
    with pytest.raises(AttributeError):
        feeder33.ANM6Easy


# ---------------------------------------------------------------------------
# ANMVectorEnv: tests/test_vector_env.py's cases.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def venv():
    return ANMVectorEnv(make_core(torch.float64, device="cpu"), num_envs=8, seed=0)


def test_spaces(venv):
    core = venv.core
    assert venv.single_action_space.shape == (core.action_n,)
    assert venv.single_observation_space.shape == (core.obs_n,)
    assert venv.action_space.shape == (8, core.action_n)
    assert venv.observation_space.shape == (8, core.obs_n)
    assert venv.metadata["autoreset_mode"] == gym.vector.AutoresetMode.NEXT_STEP
    np.testing.assert_array_equal(venv.single_action_space.high, core.action_high)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reset_and_step_shapes(dtype):
    venv = ANMVectorEnv(make_core(dtype, device="cpu"), num_envs=8, seed=0)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    assert venv.single_observation_space.dtype == venv.single_action_space.dtype == np_dtype
    obs, info = venv.reset(seed=1)
    assert obs.shape == (8, venv.core.obs_n) and obs.dtype == np_dtype
    assert venv.observation_space.contains(obs.astype(np.float32))
    assert info["reset_failed"].dtype == bool and not info["reset_failed"].any()
    obs, rew, term, trunc, info = venv.step(venv.action_space.sample())
    assert obs.shape == (8, venv.core.obs_n) and obs.dtype == rew.dtype == np_dtype
    assert rew.shape == (8,) and term.shape == (8,) and trunc.shape == (8,)
    assert term.dtype == bool and not trunc.any()
    assert isinstance(info, dict)


def test_seed_determinism():
    v1 = ANMVectorEnv(make_core(torch.float64, device="cpu"), num_envs=4, seed=7)
    v2 = ANMVectorEnv(make_core(torch.float64, device="cpu"), num_envs=4, seed=7)
    o1, _ = v1.reset(seed=5)
    o2, _ = v2.reset(seed=5)
    np.testing.assert_array_equal(o1, o2)
    a = np.tile(np.asarray(v1.single_action_space.high), (4, 1))
    for _ in range(3):
        r1, r2 = v1.step(a), v2.step(a)
        np.testing.assert_array_equal(r1[0], r2[0])
        np.testing.assert_array_equal(r1[1], r2[1])


@pytest.mark.parametrize("missing", ["hooks", "observation spec"])
def test_rejects_incomplete_core(missing):
    core = make_core(torch.float64, device="cpu")
    kw = dict(obs_values=core.obs_values) if missing == "hooks" else dict(
        init_state_fn=core.init_state_fn, next_vars_fn=core.next_vars_fn)
    broken = EnvCore(core.spec, K=1, gamma=0.99, device="cpu", dtype=torch.float64, **kw)
    with pytest.raises(ValueError, match=missing):
        ANMVectorEnv(broken, num_envs=2)


# ---------------------------------------------------------------------------
# The renderer's copies.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", [(rendering, jax_rendering), (servers, jax_servers), (replay, jax_replay)],
                         ids=["rendering", "servers", "replay"])
def test_modules_equal_the_originals(pair):
    assert _body(pair[0]) == _body(pair[1])
    assert pair[0].__file__ != pair[1].__file__


@pytest.mark.parametrize("name", ["app.js", "styles.css"])
def test_web_client_byte_equal(name):
    assert rendering.WEB_FOLDER != jax_rendering.WEB_FOLDER
    assert replay.WEB_FOLDER == rendering.WEB_FOLDER
    with open(os.path.join(rendering.WEB_FOLDER, name), "rb") as f, \
            open(os.path.join(jax_rendering.WEB_FOLDER, name), "rb") as g:
        assert f.read() == g.read()


def test_package_root_holds_the_client():
    from gym_anm_tpu_torch.utils import get_package_root

    assert rendering.WEB_FOLDER == os.path.join(get_package_root(), "render", "web")


def test_port_client_frame_attrs_pinned(monkeypatch):
    monkeypatch.setattr(artifact, "APP_JS", os.path.join(rendering.WEB_FOLDER, "app.js"))
    artifact.test_frame_attrs_source_pinned()
