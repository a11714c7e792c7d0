"""The Gymnasium adapter: base class for gym-anm-style environments.

The counterpart of ``gym_anm_tpu.envs.anm_env.ANMEnv`` (reference
``gym_anm/envs/anm_env.py``): the same constructor signature plus
``device`` and ``dtype``, task hooks (``init_state()``/``next_vars()``),
observation mini-language, reset retry loop, terminal semantics, cost
clipping, spaces, error behaviour, simulated date clock and render
lifecycle.  Every step is one :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
step on a one-lane batch through the plain Newton-Raphson solver
(``pf_method="scan"``, as the JAX adapter runs it), and its results reach
the host in one device-to-host copy; that program is
:mod:`.single_core`, which imports no Gymnasium.

This module imports Gymnasium.
"""

from __future__ import annotations

import datetime as dt
from copy import deepcopy
from typing import Optional

import numpy as np
import gymnasium as gym
import torch
from gymnasium import spaces

from ..constants import STATE_VARIABLES
from ..core.env_core import EnvCore, EnvState
from ..errors import (
    EnvInitializationError,
    EnvNextVarsError,
    ObsNotSupportedError,
    ObsSpaceError,
)
from ..simulator import Simulator
from ..simulator.facade import _one_lane
from .anm6.utils import random_date
from .single_core import render_frame_args, render_init_args, reset_lane, step_lane, to_host
from .utils import check_env_args


class ANMEnv(gym.Env):
    """Base class for ANM reinforcement-learning environments.

    Parameters mirror the reference (anm_env.py:79-113): ``network`` dict,
    ``observation`` ("state" | list of (quantity, ids|'all', unit?) |
    callable), ``K`` aux vars, ``delta_t`` (hours), ``gamma``, ``lamb``,
    optional ``aux_bounds``, ``costs_clipping=(c1, c2)``, ``seed``.
    ``device`` is where the environment computes (the card unless the
    caller passes ``"cpu"``) and ``dtype`` its float type (float64, the
    reference's precision, by default).

    Every environment renders (``render(mode="human"|"replay")``,
    ``write_replay``): the browser client lays out any topology.
    """

    metadata = {"render_modes": ["human", "replay"]}

    def __init__(
        self,
        network,
        observation,
        K,
        delta_t,
        gamma,
        lamb,
        aux_bounds=None,
        costs_clipping=None,
        seed=None,
        device="cuda",
        dtype=torch.float64,
    ):
        super().reset(seed=seed)

        self.K = K
        self.gamma = gamma
        self.lamb = lamb
        self.delta_t = delta_t
        self.aux_bounds = aux_bounds

        if costs_clipping is None:
            c1, c2 = np.inf, np.inf
        else:
            c1 = np.inf if costs_clipping[0] is None else costs_clipping[0]
            c2 = np.inf if costs_clipping[1] is None else costs_clipping[1]
        self.costs_clipping = (c1, c2)

        self.simulator = Simulator(network, self.delta_t, self.lamb, dtype=dtype, device=device)

        check_env_args(K, delta_t, lamb, gamma, observation, aux_bounds, self.simulator.state_bounds)

        # Canonical state layout (anm_env.py:139-147).
        self.state_values = [
            ("dev_p", "all", "MW"),
            ("dev_q", "all", "MVAr"),
            ("des_soc", "all", "MWh"),
            ("gen_p_max", "all", "MW"),
            ("aux", "all", None),
        ]
        self.state_values = self._expand_all_ids(self.state_values)
        self.state_N = sum(len(s[1]) for s in self.state_values)

        # Observation spec (anm_env.py:497-521).
        self.obs_values = self._build_observation_space(observation)

        # The JAX adapter's solver (its EnvCore default): the plain dense NR,
        # which also solves meshed networks.
        self._core = EnvCore(
            self.simulator.spec,
            K=K,
            gamma=gamma,
            device=device,
            dtype=dtype,
            costs_clipping=self.costs_clipping,
            obs_values=self.obs_values,
            aux_bounds=aux_bounds,
            pf_method="scan",
        )
        self._es: Optional[EnvState] = None
        self._obs_host: Optional[np.ndarray] = None  # the core's observation of _es

        self.action_space = spaces.Box(
            low=np.asarray(self._core.action_low), high=np.asarray(self._core.action_high), dtype=np.float64
        )
        self.observation_space = self.observation_bounds()
        if self.observation_space is not None:
            self.observation_N = self.observation_space.shape[0]

        self.state = None
        self.terminated = False
        self.render_mode = None
        self.timestep = 0
        self.e_loss = 0.0
        self.penalty = 0.0
        self.pfe_converged = None

        # Rendering / simulated-clock state (reference anm6.py:38-44,
        # generalized to every environment).
        self.network_specs = self.simulator.get_rendering_specs()
        self.timestep_length = dt.timedelta(minutes=int(60 * delta_t))
        self.date = None
        self.date_init = None
        self.year_count = 0
        self.skipped_frames = None
        self.is_rendering = False

    # ------------------------------------------------------------------
    # Task hooks (to be implemented by subclasses; anm_env.py:158-191).
    # ------------------------------------------------------------------
    def init_state(self):
        """Sample an initial state vector s0 (MW/MVAr/MWh layout)."""
        raise NotImplementedError

    def next_vars(self, s_t):
        """Sample the internal variables [P_load, P_pot_gen, aux]."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def observation_bounds(self):
        """Bounds of the observation space (anm_env.py:193-233)."""
        if self.obs_values is None:
            return None
        core = self._core
        return spaces.Box(low=np.asarray(core.obs_gather.low), high=np.asarray(core.obs_gather.high), dtype=np.float64)

    def observation(self, s_t):
        """o_t extracted from the current simulator state and clipped into the
        observation space (anm_env.py:313-331). Overridable."""
        return np.clip(self._obs_host, self.observation_space.low, self.observation_space.high)

    # ------------------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        """Reset the environment (anm_env.py:235-311)."""
        super().reset(seed=seed, options=options)

        self.terminated = False
        self.timestep = 0
        self.e_loss = 0.0
        self.penalty = 0.0

        expected = self._core.expected_s0_n
        n_init_states_max = 100
        init_state_found = False
        n_init_states = 0
        while not init_state_found:
            n_init_states += 1
            s0 = np.asarray(self.init_state(), dtype=np.float64)
            if s0.size != expected:
                raise EnvInitializationError(
                    "Expected size of initial state s0 is %d but actual is %d" % (expected, s0.size)
                )
            es, init_state_found, state, obs_host = reset_lane(self._core, s0)
            if n_init_states == n_init_states_max:
                raise EnvInitializationError(
                    "No non-terminal state found out of %d initial states for environment %s"
                    % (n_init_states_max, type(self).__name__)
                )

        self._es = es
        self._obs_host = obs_host
        self.simulator.set_sim_state(_one_lane(es.sim), converged=True)
        self.pfe_converged = True
        self.state = state

        obs = self.observation(self.state)

        if self.observation_space is None:
            # dtype=float64 (the reference leaves the Box at its float32
            # default, which fails Gymnasium's contains() dtype check for
            # float64 observations).
            self.observation_space = spaces.Box(
                low=-np.ones(len(obs)) * np.inf, high=np.ones(len(obs)) * np.inf, dtype=np.float64
            )
            self.observation_N = self.observation_space.shape[0]

        err_msg = "Observation %r (%s) invalid." % (obs, type(obs))
        assert self.observation_space.contains(obs), err_msg

        if self.terminated:
            self.state = self._terminal_state(self.state_N)
            obs = self._terminal_state(self.observation_N)

        # Restart the simulated date clock.  The render session (if any)
        # survives resets, and the date draw comes *after* the init_state
        # retry loop so the np_random call order matches the reference
        # exactly (reference anm6.py:124-141).
        self.year_count = 0
        if options is not None and "date_init" in options:
            self.date_init = options["date_init"]
        else:
            self.date_init = random_date(self.np_random, 2020)
        self.date = self.date_init

        return obs, {}

    def step(self, action):
        """Take one control action (anm_env.py:333-453)."""
        err_msg = "Action %r (%s) invalid." % (action, type(action))
        assert self.action_space.contains(action), err_msg

        truncated = False
        info = {}

        # 0. Remain in the terminal absorbing state.
        if self.terminated:
            obs = self._terminal_state(self.observation_N)
            return obs, 0.0, self.terminated, truncated, info

        # 1. Sample internal variables.
        vars = np.asarray(self.next_vars(self.state), dtype=np.float64)
        expected_size = self._core.expected_vars_n
        if vars.size != expected_size:
            raise EnvNextVarsError(
                "Next vars vector has size %d but expected is %d" % (vars.size, expected_size)
            )
        aux = vars[self.simulator.N_load + self.simulator.N_non_slack_gen :]
        assert len(aux) == self.K, "Only {} auxiliary variables are generated, but K={} are expected.".format(
            len(aux), self.K
        )

        # 2-4. The core: transition + reward + terminal masking, on a
        # one-lane batch; its scalars, state and observation reach the host
        # in one copy.
        es, out = step_lane(self._core, self._es, action, vars)
        self._es = es
        self._obs_host = out.obs
        self.terminated = out.terminated
        self.e_loss = out.e_loss
        self.penalty = out.penalty
        self.simulator.set_sim_state(_one_lane(es.sim), converged=not self.terminated)
        self.pfe_converged = not self.terminated
        r = out.reward

        if not self.terminated:
            self.state = out.state
            obs = self.observation(self.state)
            err_msg = "Observation %r (%s) invalid." % (obs, type(obs))
            assert self.observation_space.contains(obs), err_msg
        else:
            self.state = self._terminal_state(self.state_N)
            obs = self._terminal_state(self.observation_N)

        # 5. Update the timestep and the simulated clock (reference
        # anm6.py:113-122, generalized).
        self.timestep += 1
        if self.date is not None:
            self.date += self.timestep_length
            self.year_count = (self.date - self.date_init).days // 365

        return obs, r, self.terminated, truncated, info

    # ------------------------------------------------------------------
    # Rendering (reference anm6.py:46-239, lifted to the base class: the
    # browser client is topology-generic, so every environment renders).
    # ------------------------------------------------------------------
    def render(self, mode="human", skip_frames=0):
        """Render the current state of the network in the browser
        (reference anm6.py:46-111). ``skip_frames`` updates the
        visualization only every ``skip_frames + 1`` calls.

        ``mode="replay"`` records frames in memory instead of pushing them
        to live servers; ``write_replay(path)`` then writes one standalone
        HTML file with timeline controls (render/replay.py)."""
        if self.render_mode is None:
            if mode not in ["human", "replay"]:
                raise NotImplementedError()

            self.render_mode = mode
            self.skipped_frames = 0
            rendered_network_specs = ["dev_type", "dev_p", "dev_q", "branch_s", "bus_v", "des_soc"]
            specs = {s: self.network_specs[s] for s in rendered_network_specs}
            self._init_render(specs)

            self.render(mode=mode, skip_frames=skip_frames)
            self.is_rendering = True
        else:
            self.skipped_frames = (self.skipped_frames + 1) % (skip_frames + 1)
            if self.skipped_frames:
                return

            self._update_render(*render_frame_args(self.simulator, self.e_loss, self.penalty))

    def reset_date(self, date_init):
        """Reset the visualization date (and the year count)."""
        self.date_init = date_init
        self.date = date_init

    def _init_render(self, network_specs):
        """Boot the rendering servers and send the init frame
        (reference anm6.py:148-187)."""
        from ..render import rendering

        title = type(self).__name__
        args, topology = render_init_args(network_specs, self.costs_clipping, self.simulator.spec)

        if self.render_mode == "replay":
            from ..render.replay import EpisodeRecorder

            self.recorder = EpisodeRecorder(title, *args, topology=topology)
        else:
            self.http_server, self.ws_server = rendering.start(title, *args, topology=topology)

    def _update_render(self, dev_p, dev_q, branch_s, des_soc, gen_p_max, bus_v_magn, costs, network_collapsed):
        """Push one state frame to the visualization (reference anm6.py:189-227)."""
        if self.render_mode == "replay":
            self.recorder.frame(
                self.date, self.year_count, dev_p, dev_q, branch_s, des_soc,
                gen_p_max, bus_v_magn, costs, network_collapsed,
            )
            return

        from ..render import rendering

        rendering.update(
            self.ws_server.address,
            self.date,
            self.year_count,
            dev_p,
            dev_q,
            branch_s,
            des_soc,
            gen_p_max,
            bus_v_magn,
            costs,
            network_collapsed,
        )

    def write_replay(self, path):
        """Write the recorded episode (``render(mode="replay")``) as one
        standalone HTML file with timeline controls; returns the path."""
        if getattr(self, "recorder", None) is None:
            raise RuntimeError('no recorded frames: call render(mode="replay") while stepping first')
        return self.recorder.write(path)

    def close(self):
        """Terminate the rendering servers (reference anm6.py:229-239); a
        replay recording has no processes to stop (the recorder stays
        readable); closing a never-rendered environment is a no-op."""
        if self.is_rendering and self.render_mode != "replay":
            from ..render import rendering

            try:
                rendering.close(self.http_server, self.ws_server)
            except AttributeError:
                pass
        self.render_mode = None

    # ------------------------------------------------------------------
    def _build_observation_space(self, observation):
        """Handle the three observation-spec modes (anm_env.py:497-521)."""
        if isinstance(observation, str) and observation == "state":
            obs_values = deepcopy(self.state_values)
        elif isinstance(observation, list):
            obs_values = deepcopy(observation)
            for idx, o in enumerate(obs_values):
                if len(o) == 2:
                    obs_values[idx] = tuple(list(o) + [STATE_VARIABLES[o[0]][0]])
        elif callable(observation):
            obs_values = None
            self.observation = observation
        else:
            raise ObsSpaceError()

        return self._expand_all_ids(obs_values)

    def _expand_all_ids(self, values):
        """Translate the 'all' option into concrete ID lists (anm_env.py:523-549)."""
        if values is not None:
            spec = self.simulator.spec
            for idx, o in enumerate(values):
                if isinstance(o[1], str) and o[1] == "all":
                    if "bus" in o[0]:
                        ids = list(spec.bus_ids)
                    elif "dev" in o[0]:
                        ids = list(spec.dev_ids)
                    elif "des" in o[0]:
                        ids = list(spec.des_ids)
                    elif "gen" in o[0]:
                        ids = list(spec.gen_ids)
                    elif "branch" in o[0]:
                        ids = list(spec.branch_ids)
                    elif o[0] == "aux":
                        ids = list(range(0, self.K))
                    else:
                        raise ObsNotSupportedError(o[0], STATE_VARIABLES.keys())
                    values[idx] = (o[0], ids, o[2])
        return values

    def _construct_state(self):
        """The canonical state vector s_t (anm_env.py:551-560)."""
        return to_host(self._core.state_vec(self._es))[0]

    def _extract_state_variables(self, values):
        """Extract given (quantity, ids, unit) values from the simulator state
        (anm_env.py:562-592)."""
        full_state = self.simulator.state
        out = []
        for value in values:
            for idx in value[1]:
                if value[0] in full_state.keys():
                    o = full_state[value[0]][value[2]][idx]
                elif value[0] == "aux":
                    o = self.state[idx - self.K]
                else:
                    raise ObsNotSupportedError(value[0], STATE_VARIABLES.keys())
                out.append(o)
        return np.array(out)

    def _terminal_state(self, n):
        """The absorbing zero-state (anm_env.py:594-608)."""
        return np.zeros(n)
