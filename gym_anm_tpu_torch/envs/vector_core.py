"""The lockstep core of :class:`~gym_anm_tpu_torch.envs.vector.ANMVectorEnv`.

The counterpart of the jitted ``_full_reset`` / ``_step`` of
``gym_anm_tpu.envs.vector`` (vector.py:91-122), without Gymnasium, so that
it runs where Gymnasium is not installed.  All ``num_envs`` environments of
an :class:`~gym_anm_tpu_torch.core.env_core.EnvCore` step in lockstep on the
core's device.

Autoreset follows Gymnasium's **next-step** semantics: a lane that
terminates at step *t* ignores its action at *t+1*, takes a fresh initial
state (one attempt) and reports its observation with reward 0 and
``terminated`` False.  As in the JAX package, the fresh states of every
lane are computed every step (no host sync decides whether any lane needs
one), so on the ``tree`` path the power-flow kernel runs twice a step: once
in ``core.step`` and once in ``core.env_state_from_s0``.

The draws (:func:`draw`) are kept apart from their use (:func:`step`):
torch cannot reproduce ``jax.random``, so a test feeds :func:`step` the
draws the JAX package made.

On a CUDA device :meth:`LockstepEnv.step` replays :func:`step` from a CUDA
graph (``core/graph.py``) wherever the core solves in a kernel; the draws
and the host copies stay eager.  The module counters
``LOCKSTEP_GRAPH_CAPTURES``, ``LOCKSTEP_GRAPH_REPLAYS`` and
``LOCKSTEP_EAGER_CALLS`` count how the process's steps ran.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.env_core import EnvCore, EnvState, select_env, state_from_tensors, state_tensors
from ..core.graph import GraphedStep, graph_key, graphed

# How this process's LockstepEnv steps ran: graphs captured, steps replayed
# from a graph, and steps run eagerly (a graph's warm-up step included).
LOCKSTEP_GRAPH_CAPTURES = 0
LOCKSTEP_GRAPH_REPLAYS = 0
LOCKSTEP_EAGER_CALLS = 0
_COUNTERS = (globals(), "LOCKSTEP_GRAPH_CAPTURES", "LOCKSTEP_GRAPH_REPLAYS", "LOCKSTEP_EAGER_CALLS")


class VectorDraw(NamedTuple):
    vars: torch.Tensor  # [B, vars_n]: the internal variables of the step
    fresh_s0: torch.Tensor  # [B, s0_n]: a fresh initial state for every lane


class VectorStep(NamedTuple):
    obs: torch.Tensor  # [B, obs_n]
    reward: torch.Tensor  # [B]
    terminated: torch.Tensor  # [B] bool; also the lanes to reset next step


def draw(core: EnvCore, es: EnvState, generator: torch.Generator) -> VectorDraw:
    """The step's random inputs, in this order on ``generator``: the vars of
    every lane (``core.next_vars_fn``), then a fresh ``s0`` for every lane
    (``core.init_state_fn``)."""
    vars = core.next_vars_fn(core.state_vec(es), generator)
    return VectorDraw(vars=vars, fresh_s0=core.init_state_fn(generator, es.state_vec.shape[0]))


def step(core: EnvCore, es: EnvState, needs_reset, actions, vars, fresh_s0) -> tuple[EnvState, VectorStep]:
    """One lockstep step given its draws: ``core.step``, then the fresh
    states, then the lane select (vector.py:103-121).  The lanes flagged in
    ``needs_reset [B]`` return their fresh observation, reward 0 and
    ``terminated`` False; the returned ``terminated`` flags the lanes to
    reset on the next step."""
    es_new, out = core.step(es, actions, vars)
    es_fresh = core.env_state_from_s0(fresh_s0)
    es_out = select_env(needs_reset, es_fresh, es_new)
    obs = torch.where(needs_reset[:, None], core.observation(es_fresh), out.obs)
    reward = torch.where(needs_reset, torch.zeros_like(out.reward), out.reward)
    terminated = out.terminated & ~needs_reset
    return es_out, VectorStep(obs=obs, reward=reward, terminated=terminated)


def _step_eager(core, es, needs_reset, actions, vars, fresh_s0):
    """:func:`step` as eager launches, counted in ``LOCKSTEP_EAGER_CALLS``."""
    global LOCKSTEP_EAGER_CALLS
    LOCKSTEP_EAGER_CALLS += 1
    return step(core, es, needs_reset, actions, vars, fresh_s0)


def _graph_step(core, carried, held, inputs):
    """:func:`step` on a GraphedStep's lists: the state and ``needs_reset``
    in, the state and ``terminated`` out, carried; one block of outputs."""
    *state, needs_reset = carried
    es, vs = step(core, state_from_tensors(state), needs_reset, *inputs)
    return state_tensors(es) + [vs.terminated], [[vs.obs, vs.reward]]


def to_numpy(vs: VectorStep) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(obs, reward, terminated)`` as NumPy arrays, in one device-to-host
    copy (obs and reward keep the core's float type)."""
    n = vs.obs.shape[1]
    host = torch.cat([vs.obs, vs.reward[:, None], vs.terminated[:, None].to(vs.obs.dtype)], dim=1).cpu().numpy()
    return host[:, :n], host[:, n], host[:, n + 1] > 0.5


class LockstepEnv:
    """``num_envs`` lockstep environments of ``core`` with next-step
    autoreset, on the core's device: tensors in, tensors out.

    ``core`` needs the task hooks ``init_state_fn``/``next_vars_fn`` and an
    observation spec (a core built by a task's ``make_core``).  ``seed``
    seeds the one ``torch.Generator`` (on the core's device) that every
    draw takes; ``reset_attempts`` is the rejection-sampling budget of a
    full reset (None: the task's ``core.reset_attempts``); an autoreset
    takes one attempt, which keeps the batch in lockstep.

    On a CUDA device each :meth:`step` replays :func:`step` from a CUDA
    graph (``core/graph.py``) unless the core solves on a plain solver; the
    values are the eager step's.  Other attributes of the core are read when
    the graph is captured.
    """

    def __init__(self, core: EnvCore, num_envs: int, seed: Optional[int] = None,
                 reset_attempts: Optional[int] = None):
        if core.init_state_fn is None or core.next_vars_fn is None:
            raise ValueError("ANMVectorEnv needs an EnvCore with the init_state_fn/next_vars_fn task hooks")
        if core.obs_gather is None:
            raise ValueError("ANMVectorEnv needs an EnvCore with an explicit observation spec")
        self.core = core
        self.num_envs = int(num_envs)
        self.reset_attempts = int(core.reset_attempts if reset_attempts is None else reset_attempts)
        self.generator = torch.Generator(device=core.device).manual_seed(0 if seed is None else int(seed))
        self.es: Optional[EnvState] = None
        self.needs_reset: Optional[torch.Tensor] = None  # [B] bool: lanes to autoreset on the next step
        self._graphs: dict = {}  # graph_key -> GraphedStep

    def reset(self, seed: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """A full reset of every lane: ``(obs [B, obs_n], failed [B])``.  A
        lane whose attempts all failed is terminated (the absorbing zero
        state) and is flagged to autoreset on the next step."""
        if seed is not None:
            self.generator.manual_seed(int(seed))
        self.es, out = self.core.reset(self.generator, self.num_envs, attempts=self.reset_attempts)
        self.needs_reset = out.failed
        return out.obs, out.failed

    def step(self, actions) -> VectorStep:
        """One lockstep step of ``actions [B, action_n]`` (MW/MVAr)."""
        if self.es is None:
            raise RuntimeError("call reset() before step()")
        core, es, needs = self.core, self.es, self.needs_reset
        actions = torch.as_tensor(actions, device=core.device).to(core.dtype)
        d = draw(core, es, self.generator)
        if not graphed(core, es.state_vec.device):
            self.es, vs = _step_eager(core, es, needs, actions, d.vars, d.fresh_s0)
        else:
            ins = [actions, *(torch.as_tensor(t, device=core.device) for t in d)]
            key = graph_key(core, [es.state_vec, needs] + ins)
            run = self._graphs.get(key)
            if run is None:
                run = self._graphs[key] = GraphedStep(partial(_graph_step, core), core.grid, _COUNTERS)
            (*state, terminated), ((obs, reward),) = run(state_tensors(es) + [needs], [], ins)
            self.es, vs = state_from_tensors(state), VectorStep(obs=obs, reward=reward, terminated=terminated)
        self.needs_reset = vs.terminated
        return vs
