"""The environment core on tensors.

The counterpart of ``gym_anm_tpu.core.env_core``: the reference's
``ANMEnv.step``/``reset`` control flow (``anm_env.py:235-453``) over a
leading batch axis of lockstep environments:

* action splitting [P_gen, Q_gen, P_des, Q_des] ordered by device ID
  (anm_env.py:393-410),
* ``next_vars`` -> [P_load, P_pot, aux] splitting (anm_env.py:376-391),
* cost clipping and the terminal reward ``-c2 / (1 - gamma)``
  (anm_env.py:423-432),
* terminal absorbing zero states (anm_env.py:365-367, 444-448),
* reset rejection sampling with masked retries (anm_env.py:266-289).

Terminality is data, not control flow: a diverged power flow sets a
per-lane ``terminated`` flag and the lane's state becomes the absorbing
zero state, so a batch stays in lockstep.

The task hooks take an explicit ``torch.Generator``:

* ``init_state_fn(generator, batch_size) -> s0 [B, k]`` in the reference's
  MW/MVAr/MWh layout ``[dev_p, dev_q, des_soc, gen_p_max, aux]``;
* ``next_vars_fn(state_vec [B, n], generator) -> [B, n_load + n_gen + K]``
  ``= [P_load (MW), P_pot (MW), aux]``.

Observations are a compiled gather of the packed observables
(``obs_values``, :mod:`.obs`), the clipped state vector when the gather is
the state's, or a callable ``obs_fn`` of the state vector.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..errors import EnvInitializationError
from .grid import GridSpec, GridTensors
from .obs import GatherSpec, compile_gather, pack_observables, state_values_spec
from .state import SIM_FIELDS, SimState, select_state, zeros_state
from .transition import PF_METHODS, sim_reset, transition


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Batched dynamic state; ``state_vec`` caches the canonical state
    vector s_t (zeros in the absorbing state)."""

    sim: SimState
    aux: torch.Tensor  # [B, K]
    terminated: torch.Tensor  # [B] bool
    state_vec: torch.Tensor  # [B, state_n]


class StepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    state_vec: torch.Tensor
    e_loss: torch.Tensor
    penalty: torch.Tensor


class ResetOut(NamedTuple):
    obs: torch.Tensor
    state_vec: torch.Tensor
    failed: torch.Tensor  # True if every attempt failed
    n_tries: torch.Tensor


_SIM_TENSORS = operator.attrgetter(*SIM_FIELDS)


def state_tensors(es: EnvState) -> list:
    """The tensors of ``es``: its SimState fields, ``aux``, ``terminated``
    and ``state_vec``, in that order."""
    return [*_SIM_TENSORS(es.sim), es.aux, es.terminated, es.state_vec]


def state_from_tensors(ts) -> EnvState:
    """The inverse of :func:`state_tensors`."""
    n = len(SIM_FIELDS)
    return EnvState(sim=SimState(*ts[:n]), aux=ts[n], terminated=ts[n + 1], state_vec=ts[n + 2])


def take_lanes(es: EnvState, idx) -> EnvState:
    """Lanes ``idx [B']`` of a batched state (a gather, no physics)."""
    return state_from_tensors([t[idx] for t in state_tensors(es)])


def _lanes(pred, x):
    """``pred [B]`` shaped to broadcast against ``x [B, ...]``."""
    return pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))


def select_env(pred, a: EnvState, b: EnvState) -> EnvState:
    """Per-lane ``pred ? a : b``."""
    return EnvState(
        sim=select_state(pred, a.sim, b.sim),
        aux=torch.where(_lanes(pred, b.aux), a.aux, b.aux),
        terminated=torch.where(pred, a.terminated, b.terminated),
        state_vec=torch.where(_lanes(pred, b.state_vec), a.state_vec, b.state_vec),
    )


class EnvCore:
    """Static environment configuration + batched step/reset.

    ``device`` and ``dtype`` are where and in what type the core computes;
    the grid's tables are moved there once.  ``pf_method`` is one of
    :data:`~gym_anm_tpu_torch.core.transition.PF_METHODS`; ``chord_iters``
    (the hybrid methods' chord prefix) and ``nr_pivot`` (partial pivoting in
    the dense NR elimination) keep the JAX package's defaults.
    ``warm_start`` warm-starts each step's power flow from the previous
    step's solved bus voltages (every path but the fused ones; reset solves
    and absorbing or reborn lanes flat-start); off by default, as the
    reference flat-starts every solve.

    ``obs_values`` (a list of ``(quantity, ids, unit)``) compiles into
    ``obs_gather``; when it is the state vector's layout the observation is
    the clipped state vector itself.  Without it, ``obs_fn(state_vec [B,
    state_n]) -> [B, k]`` gives the observation, and without either the
    state vector stands in for it (``obs_n`` is then None, as in the JAX
    package).
    """

    def __init__(
        self,
        spec: GridSpec,
        K: int,
        gamma: float,
        device,
        dtype: torch.dtype,
        costs_clipping=(None, None),
        obs_values=None,
        aux_bounds=None,
        init_state_fn: Optional[Callable] = None,
        next_vars_fn: Optional[Callable] = None,
        obs_fn: Optional[Callable] = None,
        x_tol: float = 1e-5,
        max_iter: int = 100,
        pf_method: str = "tree",
        reset_attempts: int = 10,
        chord_iters: int = 16,
        nr_pivot: bool = False,
        warm_start: bool = False,
    ):
        if pf_method not in PF_METHODS:
            raise ValueError("pf_method %r is not supported; the port has %s" % (pf_method, PF_METHODS))
        self.spec = spec
        self.device = torch.device(device)
        self.dtype = dtype
        self.grid = GridTensors.from_spec(spec, self.device, dtype)
        self.K = int(K)
        self.gamma = float(gamma)
        c1 = np.inf if costs_clipping is None or costs_clipping[0] is None else float(costs_clipping[0])
        c2 = np.inf if costs_clipping is None or costs_clipping[1] is None else float(costs_clipping[1])
        self.costs_clipping = (c1, c2)
        self.aux_bounds = aux_bounds
        self.init_state_fn = init_state_fn
        self.next_vars_fn = next_vars_fn
        self.obs_fn = obs_fn
        self.x_tol = x_tol
        self.max_iter = max_iter
        self.pf_method = pf_method
        self.reset_attempts = int(reset_attempts)
        self.chord_iters = int(chord_iters)
        self.nr_pivot = bool(nr_pivot)
        self.warm_start = bool(warm_start)
        if self.warm_start and pf_method in ("fused", "fused_hybrid"):
            raise ValueError(
                "warm_start is not supported on the fused whole-transition kernel "
                "(pf_method=%r); use 'pallas'/'hybrid'/'tree'" % (pf_method,)
            )

        self.state_values = state_values_spec(spec, self.K)
        self.state_gather = compile_gather(spec, self.state_values, self.K, aux_bounds)
        self.state_n = self.state_gather.n
        self.obs_values = obs_values
        self.obs_gather: Optional[GatherSpec] = None
        self.obs_n = None
        self._obs_is_state = False
        if obs_values is not None:
            self.obs_gather = compile_gather(spec, obs_values, self.K, aux_bounds)
            self.obs_n = self.obs_gather.n
            # Fully observable: the observation is the state vector itself
            # (same gather indices and scales), so no packing is needed.
            self._obs_is_state = bool(
                np.array_equal(self.obs_gather.idx, self.state_gather.idx)
                and np.allclose(self.obs_gather.scale, self.state_gather.scale)
            )
            t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
            self._obs_tables = GatherSpec(
                idx=t(self.obs_gather.idx).long(), scale=t(self.obs_gather.scale).to(dtype),
                low=t(self.obs_gather.low).to(dtype), high=t(self.obs_gather.high).to(dtype),
            )
            self._bus_sorted = t(np.asarray(spec.bus_sorted, dtype=np.int64))

        # Action bounds [P_gen, Q_gen, P_des, Q_des] x baseMVA, each block
        # ordered by device ID (simulator.py:341-380, anm_env.py:475-495).
        base = spec.baseMVA
        gen_pos, des_pos = np.asarray(spec.gen_pos), np.asarray(spec.des_pos)
        self.action_low = np.concatenate(
            [
                np.asarray(spec.gen_p_min) * base,
                np.asarray(spec.dev_q_min)[gen_pos] * base,
                np.asarray(spec.dev_p_min)[des_pos] * base,
                np.asarray(spec.dev_q_min)[des_pos] * base,
            ]
        )
        self.action_high = np.concatenate(
            [
                np.asarray(spec.gen_p_max) * base,
                np.asarray(spec.dev_q_max)[gen_pos] * base,
                np.asarray(spec.dev_p_max)[des_pos] * base,
                np.asarray(spec.dev_q_max)[des_pos] * base,
            ]
        )
        self.action_n = self.action_low.shape[0]
        self.expected_s0_n = 2 * spec.n_dev + spec.n_des + spec.n_gen + self.K
        self.expected_vars_n = spec.n_load + spec.n_gen + self.K

    # ------------------------------------------------------------------
    def _zeros(self, B: int) -> SimState:
        return zeros_state(self.spec, (B,), self.device, self.dtype)

    def _compute_state_vec(self, sim: SimState, aux, terminated):
        # The canonical layout [dev_p (MW), dev_q (MVAr), des_soc (MWh),
        # gen_p_max (MW), aux] (anm_env.py:139-147) is a concat of SimState
        # fields.
        base = self.spec.baseMVA
        vec = torch.cat(
            [sim.dev_p * base, sim.dev_q * base, sim.des_soc * base, sim.gen_p_pot * base, aux.to(self.dtype)],
            dim=-1,
        )
        return torch.where(_lanes(terminated, vec), torch.zeros_like(vec), vec)

    @property
    def obs_from_state_vec(self) -> bool:
        """True when observations never read raw ``SimState`` fields (the
        fully observable path, a callable ``obs_fn``, or no observation
        specification)."""
        return self.obs_gather is None or self._obs_is_state

    def state_vec(self, es: EnvState):
        """The canonical state vector s_t (cached on the EnvState)."""
        return es.state_vec

    def observation(self, es: EnvState):
        """o_t = clip(extract(s_t)) (anm_env.py:313-331), zeros if terminal."""
        if self.obs_gather is not None and self._obs_is_state:
            obs = torch.clamp(es.state_vec, self._obs_tables.low, self._obs_tables.high)
        elif self.obs_gather is not None:
            obs = self._obs_tables(pack_observables(self.spec, es.sim, es.aux, self._bus_sorted), clip=True)
        elif self.obs_fn is not None:
            obs = self.obs_fn(self.state_vec(es))
            obs = obs[:, None] if obs.dim() == 1 else obs
        else:
            # No observation specification: the state vector stands in.
            obs = self.state_vec(es)
        return torch.where(_lanes(es.terminated, obs), torch.zeros_like(obs), obs)

    # ------------------------------------------------------------------
    def transition_inputs(self, es: EnvState, action, vars) -> dict:
        """The p.u. inputs of :func:`~gym_anm_tpu_torch.core.transition.transition`
        for a step from ``es`` with ``action [B, action_n]`` (MW/MVAr) and
        ``vars [B, vars_n] = [P_load (MW), P_pot (MW), aux]``."""
        spec = self.spec
        base = spec.baseMVA
        n_gen, n_des, n_load = spec.n_gen, spec.n_des, spec.n_load
        vars = torch.as_tensor(vars, device=self.device).to(self.dtype)
        if vars.shape[-1] != self.expected_vars_n:
            raise ValueError(
                "Next vars vector has size %d but expected is %d" % (vars.shape[-1], self.expected_vars_n)
            )
        action = torch.as_tensor(action, device=self.device).to(self.dtype)
        return dict(
            des_soc=es.sim.des_soc,
            P_load=vars[:, :n_load] / base,
            P_pot=vars[:, n_load : n_load + n_gen] / base,
            P_set_gen=action[:, :n_gen] / base,
            Q_set_gen=action[:, n_gen : 2 * n_gen] / base,
            P_set_des=action[:, 2 * n_gen : 2 * n_gen + n_des] / base,
            Q_set_des=action[:, 2 * n_gen + n_des :] / base,
        )

    def step(self, es: EnvState, action, vars) -> tuple[EnvState, StepOut]:
        """One batched step given pre-sampled internal variables.

        ``action [B, action_n]`` in MW/MVAr, ``vars [B, vars_n] = [P_load
        (MW), P_pot (MW), aux]``.
        """
        args = self.transition_inputs(es, action, vars)
        n_aux = self.expected_vars_n - self.K
        aux_new = torch.as_tensor(vars, device=self.device).to(self.dtype)[:, n_aux:]

        res = transition(
            self.grid,
            **args,
            x_tol=self.x_tol,
            max_iter=self.max_iter,
            pf_method=self.pf_method,
            chord_iters=self.chord_iters,
            nr_pivot=self.nr_pivot,
            v_init=(es.sim.bus_v_re, es.sim.bus_v_im) if self.warm_start else None,
        )

        c1, c2 = self.costs_clipping
        full = lambda v: torch.full_like(res.e_loss, v)
        newly_term = ~res.pfe_converged
        e_c = torch.sign(res.e_loss) * torch.clamp(torch.abs(res.e_loss), 0.0, c1)
        p_c = torch.clamp(res.penalty, 0.0, c2)
        r = torch.where(newly_term, full(-c2 / (1.0 - self.gamma)), -(e_c + p_c))

        prev = es.terminated
        term = prev | newly_term
        sim_new = select_state(term, self._zeros(aux_new.shape[0]), res.state)
        aux_out = torch.where(_lanes(term, aux_new), torch.zeros_like(aux_new), aux_new)
        state_vec = self._compute_state_vec(sim_new, aux_out, term)
        es_new = EnvState(sim=sim_new, aux=aux_out, terminated=term, state_vec=state_vec)

        r = torch.where(prev, full(0.0), r)
        e_out = torch.where(term, full(c1), e_c)
        p_out = torch.where(term, full(c2), p_c)
        return es_new, StepOut(
            obs=self.observation(es_new),
            reward=r,
            terminated=term,
            state_vec=state_vec,
            e_loss=e_out,
            penalty=p_out,
        )

    def step_with_generator(self, es: EnvState, action, generator: torch.Generator):
        """One step sampling the internal variables with ``next_vars_fn``."""
        return self.step(es, action, self.next_vars_fn(es.state_vec, generator))

    # ------------------------------------------------------------------
    def env_state_from_s0(self, s0) -> EnvState:
        """Apply initial-state vectors ``s0 [B, k]`` (no retry loop).

        A lane whose load flow diverges on s0 comes back **terminated** with
        the absorbing zero state, exactly like an in-episode grid collapse.
        """
        spec = self.spec
        s0 = torch.as_tensor(s0, device=self.device).to(self.dtype)
        if s0.shape[-1] != self.expected_s0_n:
            # Mirrors anm_env.py:274-277.
            raise EnvInitializationError(
                "Expected size of initial state s0 is %d but actual is %d" % (self.expected_s0_n, s0.shape[-1])
            )
        sim = sim_reset(
            self.grid, s0, x_tol=self.x_tol, max_iter=self.max_iter, pf_method=self.pf_method,
            chord_iters=self.chord_iters, nr_pivot=self.nr_pivot,
        )
        aux = s0[:, 2 * spec.n_dev + spec.n_des + spec.n_gen :]
        terminated = ~sim.pfe_converged
        sim = select_state(terminated, self._zeros(s0.shape[0]), sim)
        aux = torch.where(_lanes(terminated, aux), torch.zeros_like(aux), aux)
        return EnvState(
            sim=sim, aux=aux, terminated=terminated, state_vec=self._compute_state_vec(sim, aux, terminated)
        )

    def reset(self, generator: torch.Generator, batch_size: int, attempts: Optional[int] = None):
        """Rejection-sample initial states until the load flow converges.

        Attempt 1 resets every lane; each further attempt (up to
        ``attempts``, default ``reset_attempts``) resamples only the lanes
        still terminated.  Exhaustion is reported per lane via ``failed``.
        """
        if attempts is None:
            attempts = self.reset_attempts
        es = self.env_state_from_s0(self.init_state_fn(generator, batch_size))
        tries = torch.ones((batch_size,), dtype=torch.int32, device=self.device)
        for _ in range(attempts - 1):
            retry = es.terminated
            if not bool(retry.any()):
                break
            es = select_env(retry, self.env_state_from_s0(self.init_state_fn(generator, batch_size)), es)
            tries = tries + retry.to(torch.int32)
        return es, ResetOut(
            obs=self.observation(es), state_vec=es.state_vec, failed=es.terminated, n_tries=tries
        )
