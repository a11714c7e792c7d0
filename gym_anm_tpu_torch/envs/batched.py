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

On a CUDA device a step is a few hundred small kernels, and launching them
one by one from the host takes several times their device time.  So
:meth:`BatchedEnv.step_fn` replays each step from a CUDA graph
(:class:`StepGraph`) wherever the step draws nothing itself (with a pool, or
without auto-reset) and solves in a kernel.  The task's hooks and every
generator draw stay eager calls, in the eager step's order; the step-mode
reset, the plain solvers and CPU tensors run eagerly.  The module counters
``STEP_GRAPH_CAPTURES``, ``STEP_GRAPH_REPLAYS`` and ``STEP_EAGER_CALLS``
count how the process's steps ran.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.env_core import EnvCore, EnvState, StepOut, select_env
from ..core.state import SIM_FIELDS, SimState
from ..core.transition import capturable, resolve_solver_path
from ..errors import EnvInitializationError
from ..ops import host_counters

# How this process's BatchedEnv steps ran: graphs captured, steps replayed
# from a graph, and steps run eagerly (a graph's warm-up step included).
STEP_GRAPH_CAPTURES = 0
STEP_GRAPH_REPLAYS = 0
STEP_EAGER_CALLS = 0


class BatchedStep(NamedTuple):
    obs: torch.Tensor  # [B, obs_n]
    reward: torch.Tensor  # [B]
    terminated: torch.Tensor  # [B] bool
    state_vec: torch.Tensor  # [B, state_n]


def take_lanes(es: EnvState, idx) -> EnvState:
    """Lanes ``idx [B']`` of a batched state (a gather, no physics)."""
    sim = SimState(**{k: getattr(es.sim, k)[idx] for k in SIM_FIELDS})
    return EnvState(sim=sim, aux=es.aux[idx], terminated=es.terminated[idx], state_vec=es.state_vec[idx])


def _state_tensors(es: EnvState) -> list:
    """The tensors of ``es``: its SimState fields, ``aux``, ``terminated``
    and ``state_vec``, in that order."""
    return [getattr(es.sim, k) for k in SIM_FIELDS] + [es.aux, es.terminated, es.state_vec]


def _env_state(ts) -> EnvState:
    """The inverse of :func:`_state_tensors`."""
    n = len(SIM_FIELDS)
    return EnvState(sim=SimState(**dict(zip(SIM_FIELDS, ts[:n]))), aux=ts[n], terminated=ts[n + 1],
                    state_vec=ts[n + 2])


class _Packing:
    """Tensors of fixed shapes and dtypes laid out in one byte buffer, the
    tensors of each dtype side by side (16-byte aligned)."""

    def __init__(self, like):
        by_dtype = {}
        for i, t in enumerate(like):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.n, self.groups, off = len(like), [], 0
        for dtype, pos in by_dtype.items():
            off = -(-off // 16) * 16
            numels = [like[i].numel() for i in pos]
            nbytes = sum(numels) * dtype.itemsize
            self.groups.append((dtype, off, nbytes, numels, [like[i].shape for i in pos], pos))
            off += nbytes
        self.nbytes = off

    def views(self, buf) -> list:
        """The packed tensors as views of the byte buffer ``buf``."""
        out = [None] * self.n
        for dtype, off, nbytes, numels, shapes, pos in self.groups:
            for i, part, shape in zip(pos, buf[off : off + nbytes].view(dtype).split(numels), shapes):
                out[i] = part.view(shape)
        return out

    def copy(self, dst, src):
        """``dst[i] <- src[i]`` for this packing's views ``dst``: one foreach
        copy a dtype."""
        for *_, pos in self.groups:
            torch._foreach_copy_([dst[i] for i in pos], [src[i] for i in pos])


def cuda_graph(fn):
    """Capture ``fn``'s device work into a CUDA graph and return its replay.
    ``fn``'s host code runs once, during the capture; no kernel runs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def counted_graph(fn):
    """:func:`cuda_graph` of ``fn``, with the kernels' host counters
    (``ops.HOST_COUNTERS``: their launches, K1's lane-solves) kept exact.
    The capture runs ``fn``'s host code once, so the counts it made are
    taken back, and each call of the returned replay adds them again."""
    counters = host_counters()
    before = [getattr(module, name) for module, name in counters]
    graph = cuda_graph(fn)
    counts = []
    for (module, name), n0 in zip(counters, before):
        n = getattr(module, name) - n0
        if n:
            setattr(module, name, n0)
            counts.append((module, name, n))

    def replay():
        graph()
        for module, name, n in counts:
            setattr(module, name, getattr(module, name) + n)

    return replay


class StepGraph:
    """One :class:`BatchedEnv` step replayed from a CUDA graph, for one shape
    of inputs.

    The graph reads the state, the actions, the internal variables and, with
    a pool, the pool and each lane's pool index from static buffers; it
    writes the step's outputs into two blocks of its own, the per-lane
    scalars (reward, ``terminated``, energy loss, penalty) and the wider
    outputs (observation, state vector), and the new state over the state
    it read.  A call:

    * takes the internal variables its caller drew, draws the pool indices
      (after them, as the eager step does, with :meth:`BatchedEnv.draw_index`)
      into their buffer and copies the actions and variables in;
    * copies the state in only when ``es`` is not the state the previous
      call returned (the graph left that one in place), and the pool only
      when it is another pool than the last;
    * replays, then copies the three blocks out (three launches), so that no
      later replay writes into a tensor a call returned, and a kept reward
      holds neither the observation nor the state.

    A returned state's fields are views of one block, so a kept field keeps
    the whole state alive: clone a field to keep it alone.  A state is
    matched by identity: a returned state changed in place is not copied in
    again.  The first call runs eagerly (it loads the kernels and makes the
    libraries' handles) and the second captures (:func:`counted_graph`, which
    keeps the kernels' host counters exact).
    """

    def __init__(self, env: "BatchedEnv"):
        self.env = env
        self.grid = env.core.grid  # held, so that its id keys this graph alone
        self.warm = False
        self.replay = None
        self.last = None  # the state the previous call returned
        self.pool_src = None  # the pool last copied in

    def __call__(self, es: EnvState, actions, vars, generator, fresh):
        global STEP_GRAPH_REPLAYS
        env = self.env
        if not self.warm:
            self.warm = True
            return env._step_after_vars(es, actions, vars, generator, fresh)
        if self.replay is None:
            self._capture(es, actions, vars, fresh)
        if fresh is not None:
            env.draw_index(generator, out=self.idx)
        self.inputs.copy(self.input_views, [actions, vars])
        if es is not self.last:
            self.state.copy(self.state_views, _state_tensors(es))
        if fresh is not None and fresh is not self.pool_src:
            self.pool.copy(self.pool_views, _state_tensors(fresh))
            self.pool_src = fresh
        self.replay()
        STEP_GRAPH_REPLAYS += 1
        self.last = _env_state(self.state.views(self.state_buf.clone()))
        blocks = [packing.views(buf.clone()) for packing, buf in zip(self.out, self.out_bufs)]
        return self.last, StepOut(*(blocks[b][i] for b, i in self.out_map))

    def _capture(self, es, actions, vars, fresh):
        global STEP_GRAPH_CAPTURES
        dev = self.env.device
        buf = lambda p: torch.zeros((p.nbytes,), dtype=torch.uint8, device=dev)
        self.state = _Packing(_state_tensors(es))
        self.state_buf = buf(self.state)
        self.state_views = self.state.views(self.state_buf)
        self.inputs = _Packing([actions, vars])
        self.input_views = self.inputs.views(buf(self.inputs))
        self.idx = self.pool = self.pool_views = self.out_bufs = None
        if fresh is not None:
            self.idx = torch.zeros((self.env.batch_size,), dtype=torch.int64, device=dev)
            self.pool = _Packing(_state_tensors(fresh))
            self.pool_views = self.pool.views(buf(self.pool))
        self.replay = counted_graph(self._run)
        STEP_GRAPH_CAPTURES += 1

    def _run(self):
        """The captured step: the step's outputs into their blocks, the
        per-lane ones (1-D) and the wider ones, allocated at the capture and
        so in the graph's memory; then the new state over the old (the step
        makes every state tensor anew, so none of them reads the old
        state's memory)."""
        pool = None if self.pool is None else _env_state(self.pool_views)
        es_new, out = self.env._step_given(_env_state(self.state_views), *self.input_views, pool, self.idx)
        where, blocks = {}, ([], [])  # an output seen twice is copied once
        for t in out:
            if id(t) not in where:
                b = int(t.dim() != 1)
                where[id(t)] = (b, len(blocks[b]))
                blocks[b].append(t)
        if self.out_bufs is None:
            self.out_map = [where[id(t)] for t in out]
            self.out = [_Packing(block) for block in blocks]
            self.out_bufs = [torch.empty((p.nbytes,), dtype=torch.uint8, device=self.env.device) for p in self.out]
            self.out_views = [p.views(buf) for p, buf in zip(self.out, self.out_bufs)]
        for packing, views, block in zip(self.out, self.out_views, blocks):
            packing.copy(views, block)
        self.state.copy(self.state_views, _state_tensors(es_new))


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

    # The device type whose steps replay a StepGraph.
    _graph_device = "cuda"

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
        self._graphs: dict = {}  # input shapes -> StepGraph

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

        On a CUDA device the step is replayed from a :class:`StepGraph`, one
        for each shape of the inputs, TF32 setting (a captured product keeps
        its own) and ``core.grid`` (which a caller may swap, e.g. for another
        projection form), unless it resets lanes in step mode or solves on a
        plain solver; the values are the eager step's.  Other attributes of
        the core are read when the graph is captured."""
        gen = self.generator if generator is None else generator
        core = self.core
        if not self.auto_reset:
            fresh = None  # a step without auto-reset draws from no pool
        if (es.state_vec.device.type != self._graph_device or (self.auto_reset and fresh is None)
                or not capturable(resolve_solver_path(core.grid, core.pf_method)[0])):
            return self._step_eager(es, actions, gen, fresh)
        vars = torch.as_tensor(core.next_vars_fn(core.state_vec(es), gen), device=self.device)
        actions = torch.as_tensor(actions, device=self.device)
        key = (es.state_vec.shape, es.state_vec.dtype, actions.shape, actions.dtype, vars.shape, vars.dtype,
               None if fresh is None else fresh.state_vec.shape, torch.backends.cuda.matmul.allow_tf32,
               id(core.grid))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(self)
        return graph(es, actions, vars, gen, fresh)

    def _step_eager(
        self, es: EnvState, actions, generator: Optional[torch.Generator] = None, fresh: Optional[EnvState] = None
    ) -> tuple[EnvState, StepOut]:
        """:meth:`step_fn` as eager launches (its path on the CPU, with a
        step-mode reset and on a plain solver)."""
        core = self.core
        gen = self.generator if generator is None else generator
        return self._step_after_vars(es, actions, core.next_vars_fn(core.state_vec(es), gen), gen, fresh)

    def _step_after_vars(self, es, actions, vars, gen, fresh):
        global STEP_EAGER_CALLS
        STEP_EAGER_CALLS += 1
        es_new, out = self.core.step(es, actions, vars)
        if not self.auto_reset:
            return es_new, out
        es_fresh = self.fresh_states(gen) if fresh is None else self.draw(fresh, gen)
        return self.rebirth(es_new, out, es_fresh)

    def _step_given(self, es, actions, vars, fresh, idx):
        """The step a :class:`StepGraph` captures: it draws nothing; ``idx``
        are the lanes' pool indices (:meth:`draw`'s)."""
        es_new, out = self.core.step(es, actions, vars)
        if not self.auto_reset:
            return es_new, out
        return self.rebirth(es_new, out, take_lanes(fresh, idx))

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
