"""Batched lockstep environments on one device.

The counterpart of ``gym_anm_tpu.envs.batched.BatchedEnv``: an
:class:`~gym_anm_tpu_torch.core.env_core.EnvCore` steps a whole ``[B, ...]``
batch of environments at once; on a CUDA device the power flow of every
lane (or, on the fused paths, the whole transition) runs in the kernel of
the core's ``pf_method``.  Terminated lanes stay in the absorbing zero
state (the reference's semantics, anm_env.py:365-367) unless ``auto_reset``
re-initialises them in the same step, from a pool of fresh states drawn
once per rollout segment (``"pool"``) or from a single-attempt reset every
step (``"step"``).

On a CUDA device :meth:`BatchedEnv.step_fn` replays each step that draws
nothing itself (with a pool, or without auto-reset) and solves in a kernel
from a CUDA graph (``core/graph.py``); the task's hooks and every draw stay
eager, in the eager step's order.  The module counters
``STEP_GRAPH_CAPTURES``, ``STEP_GRAPH_REPLAYS`` and ``STEP_EAGER_CALLS``
count how the process's steps ran.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.env_core import (EnvCore, EnvState, StepOut, select_env, state_from_tensors, state_tensors,
                             take_lanes)
from ..core.graph import GraphedStep, graph_key, graphed
from ..errors import EnvInitializationError

# How this process's BatchedEnv steps ran: graphs captured, steps replayed
# from a graph, and steps run eagerly (a graph's warm-up step included).
STEP_GRAPH_CAPTURES = 0
STEP_GRAPH_REPLAYS = 0
STEP_EAGER_CALLS = 0
_COUNTERS = (globals(), "STEP_GRAPH_CAPTURES", "STEP_GRAPH_REPLAYS", "STEP_EAGER_CALLS")


class BatchedStep(NamedTuple):
    obs: torch.Tensor  # [B, obs_n]
    reward: torch.Tensor  # [B]
    terminated: torch.Tensor  # [B] bool
    state_vec: torch.Tensor  # [B, state_n]


class BatchedEnv:
    """``batch_size`` lockstep environments of ``core``.

    ``device`` defaults to the core's device (and must equal it);
    ``generator`` is the source of all randomness (initial states, the
    task's internal variables, the auto-reset pool indices, the uniform
    actions of :meth:`rollout`) and defaults to a generator on that device
    seeded with 0.

    ``auto_reset``: terminated lanes are re-initialised in the same step
    (RL training); without it they stay in the absorbing zero state.
    ``auto_reset_mode``: ``"pool"`` (default) samples one batch of B fresh
    states per rollout segment (:meth:`fresh_states`) and each reborn lane
    draws its own random entry from it; ``"step"`` runs a single-attempt
    reset every step.  Direct :meth:`step` / :meth:`step_fn` calls without
    a pool always reset per step.  ``reset_attempts`` is the
    rejection-sampling budget of :meth:`reset` (default: the task's
    ``core.reset_attempts``).
    """

    def __init__(
        self,
        core: EnvCore,
        batch_size: int,
        device=None,
        generator: Optional[torch.Generator] = None,
        auto_reset: bool = False,
        reset_attempts: Optional[int] = None,
        auto_reset_mode: str = "pool",
    ):
        self.core = core
        self.batch_size = int(batch_size)
        self.device = core.device if device is None else torch.device(device)
        if self.device != core.device:
            raise ValueError("BatchedEnv device %s differs from the core's %s" % (self.device, core.device))
        if auto_reset_mode not in ("pool", "step"):
            raise ValueError("auto_reset_mode must be 'pool' or 'step'")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.auto_reset = bool(auto_reset)
        self.auto_reset_mode = auto_reset_mode
        self.reset_attempts = int(core.reset_attempts if reset_attempts is None else reset_attempts)
        self._action_low = torch.as_tensor(core.action_low, device=self.device).to(core.dtype)
        self._action_high = torch.as_tensor(core.action_high, device=self.device).to(core.dtype)
        self._graphs: dict = {}  # graph_key -> GraphedStep

    # ------------------------------------------------------------------
    def fresh_states(self, generator: Optional[torch.Generator] = None) -> EnvState:
        """One batch of B fresh (physics-reconciled) initial states, a
        single attempt each: the pool of ``"pool"`` mode, and the reset of
        ``"step"`` mode.  Costs one reset transition."""
        gen = self.generator if generator is None else generator
        return self.core.env_state_from_s0(self.core.init_state_fn(gen, self.batch_size))

    def draw(self, fresh: EnvState, generator: Optional[torch.Generator] = None) -> EnvState:
        """Each lane's own random entry of the pool ``fresh`` (drawn with
        replacement, so lanes reborn in one step are independent)."""
        return take_lanes(fresh, self.draw_index(generator))

    def draw_index(self, generator: Optional[torch.Generator] = None, out: Optional[torch.Tensor] = None):
        """:meth:`draw`'s pool index of each lane, ``[B]`` int64 (into
        ``out`` if given)."""
        gen = self.generator if generator is None else generator
        return torch.randint(0, self.batch_size, (self.batch_size,), generator=gen, device=self.device, out=out)

    def rebirth(self, es_new: EnvState, out: StepOut, es_fresh: EnvState) -> tuple[EnvState, StepOut]:
        """Replace the lanes ``out`` reports terminated by ``es_fresh``:
        their state, observation and state vector (reward and ``terminated``
        stay the step's)."""
        core = self.core
        reset_now = out.terminated
        lanes = reset_now[:, None]
        es_final = select_env(reset_now, es_fresh, es_new)
        obs = torch.where(lanes, core.observation(es_fresh), out.obs)
        state_vec = torch.where(lanes, core.state_vec(es_fresh), out.state_vec)
        return es_final, out._replace(obs=obs, state_vec=state_vec)

    def step_fn(
        self, es: EnvState, actions, generator: Optional[torch.Generator] = None, fresh: Optional[EnvState] = None
    ) -> tuple[EnvState, StepOut]:
        """One batched step: ``actions [B, action_n]`` in MW/MVAr; the
        internal variables come from the task's ``next_vars_fn``.  With
        ``auto_reset``, terminated lanes are reborn in the same step from
        the pool ``fresh`` (:meth:`draw`) or, without one, from a
        single-attempt reset (:meth:`fresh_states`).

        On a CUDA device the step is replayed from a CUDA graph
        (``core/graph.py``) unless it resets lanes in step mode or solves on
        a plain solver; the values are the eager step's.  Other attributes
        of the core are read when the graph is captured."""
        gen = self.generator if generator is None else generator
        core = self.core
        if not self.auto_reset:
            fresh = None  # a step without auto-reset draws from no pool
        if (self.auto_reset and fresh is None) or not graphed(core, es.state_vec.device):
            return self._step_eager(es, actions, gen, fresh)
        vars = torch.as_tensor(core.next_vars_fn(core.state_vec(es), gen), device=self.device)
        actions = torch.as_tensor(actions, device=self.device)
        pool = [] if fresh is None else state_tensors(fresh)
        key = graph_key(core, [es.state_vec, actions, vars] + pool[-1:])  # pool[-1]: its state_vec
        run = self._graphs.get(key)
        if run is None:
            idx = [torch.empty((self.batch_size,), dtype=torch.int64, device=self.device)] if pool else []
            run = self._graphs[key] = GraphedStep(self._graph_step, core.grid, _COUNTERS, drawn=idx)
        if pool:
            self.draw_index(gen, out=run.drawn[0])
        state, ((reward, terminated, e_loss, penalty), (obs, state_vec)) = run(
            state_tensors(es), pool, [actions, vars])
        return state_from_tensors(state), StepOut(obs, reward, terminated, state_vec, e_loss, penalty)

    def _step_eager(
        self, es: EnvState, actions, generator: Optional[torch.Generator] = None, fresh: Optional[EnvState] = None
    ) -> tuple[EnvState, StepOut]:
        """:meth:`step_fn` as eager launches (its path on the CPU, with a
        step-mode reset and on a plain solver): the draws, in the graphed
        step's order (the vars, then with auto-reset the pool index or, in
        step mode, the fresh states), then :meth:`_step`."""
        global STEP_EAGER_CALLS
        STEP_EAGER_CALLS += 1
        core = self.core
        gen = self.generator if generator is None else generator
        vars = core.next_vars_fn(core.state_vec(es), gen)
        idx = None
        if self.auto_reset and fresh is None:
            fresh = self.fresh_states(gen)
        elif self.auto_reset:
            idx = self.draw_index(gen)
        return self._step(es, actions, vars, fresh, idx)

    def _step(self, es, actions, vars, fresh=None, idx=None):
        """The step given its draws, which the graph captures: ``core.step``,
        then with auto-reset the rebirth of the terminated lanes from
        ``fresh`` (its lanes ``idx`` where given: a pool)."""
        es_new, out = self.core.step(es, actions, vars)
        if not self.auto_reset:
            return es_new, out
        return self.rebirth(es_new, out, fresh if idx is None else take_lanes(fresh, idx))

    def _graph_step(self, carried, held, inputs):
        """:meth:`_step` on a GraphedStep's lists (the pool and its index if
        any); two blocks of outputs, the per-lane scalars and the wider."""
        actions, vars, *idx = inputs
        pool = state_from_tensors(held) if held else None
        es, out = self._step(state_from_tensors(carried), actions, vars, pool, *idx)
        scalars = [out.reward, out.terminated, out.e_loss, out.penalty]
        return state_tensors(es), [scalars, [out.obs, out.state_vec]]

    # ------------------------------------------------------------------
    def reset(self, strict: bool = False) -> tuple[EnvState, BatchedStep]:
        """Reset all lanes with ``reset_attempts`` rejection-sampling rounds.

        A lane whose attempts all fail comes back terminated (the absorbing
        zero state).  With ``strict=True`` such a lane raises
        :class:`~gym_anm_tpu_torch.errors.EnvInitializationError` instead,
        the reference's behaviour after its budget (anm_env.py:284-289); it
        costs one host sync.
        """
        es, out = self.core.reset(self.generator, self.batch_size, attempts=self.reset_attempts)
        if strict:
            n_failed = int(out.failed.sum())
            if n_failed:
                raise EnvInitializationError(
                    "No non-terminal state found out of %d initial states for %d/%d lanes"
                    % (self.reset_attempts, n_failed, self.batch_size)
                )
        zero = torch.zeros((self.batch_size,), dtype=self.core.dtype, device=self.device)
        return es, BatchedStep(obs=out.obs, reward=zero, terminated=out.failed, state_vec=out.state_vec)

    def step(self, es: EnvState, actions) -> tuple[EnvState, BatchedStep]:
        """One batched step (:meth:`step_fn` without a pool)."""
        es, out = self.step_fn(es, actions)
        return es, BatchedStep(obs=out.obs, reward=out.reward, terminated=out.terminated, state_vec=out.state_vec)

    def random_actions(self) -> torch.Tensor:
        """Uniform actions over the action space, ``[B, action_n]``."""
        u = torch.rand(
            (self.batch_size, self.core.action_n), generator=self.generator, device=self.device, dtype=self.core.dtype
        )
        return u * (self._action_high - self._action_low) + self._action_low

    def rollout(self, es: EnvState, n_steps: int, policy_fn: Optional[Callable] = None, policy_args=None):
        """``n_steps`` steps, one segment.

        ``policy_fn(policy_args, obs [B, obs_n], generator) -> [B,
        action_n]`` picks the actions; without one they are uniform over
        the action space.  In ``"pool"`` auto-reset mode one pool of fresh
        states is drawn for the segment.  Returns ``(es, (reward [T, B],
        terminated [T, B]))``, or ``(es, (obs [T, B, obs_n], actions [T, B,
        action_n], reward, terminated))`` with a policy.
        """
        fresh = self.fresh_states() if self.auto_reset and self.auto_reset_mode == "pool" else None
        ys = []
        for _ in range(int(n_steps)):
            if policy_fn is None:
                obs, actions = None, self.random_actions()
            else:
                obs = self.core.observation(es)
                actions = policy_fn(policy_args, obs, self.generator)
            es, out = self.step_fn(es, actions, fresh=fresh)
            ys.append((out.reward, out.terminated) if policy_fn is None else (obs, actions, out.reward, out.terminated))
        return es, tuple(torch.stack(y) for y in zip(*ys))
