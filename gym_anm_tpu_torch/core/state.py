"""The dynamic simulator state: a dataclass of tensors.

The counterpart of ``gym_anm_tpu.core.state``: every electrical quantity is
stored once, in per-unit / radians, in internal ordering, with complex
quantities as (re, im) real pairs.  Fields carry a leading batch axis
``[B, ...]`` on the batched path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import GridSpec


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic state of the grid after one transition (p.u. / rad).

    Bus arrays use internal order (slack first); device arrays use ascending
    device-ID order; branch arrays use input order.
    """

    dev_p: torch.Tensor  # [..., d]
    dev_q: torch.Tensor  # [..., d]
    des_soc: torch.Tensor  # [..., n_des]
    gen_p_pot: torch.Tensor  # [..., n_gen] clipped potentials (state "gen_p_max")
    bus_v_re: torch.Tensor  # [..., n]
    bus_v_im: torch.Tensor  # [..., n]
    bus_i_re: torch.Tensor  # [..., n]
    bus_i_im: torch.Tensor  # [..., n]
    bus_p: torch.Tensor  # [..., n]
    bus_q: torch.Tensor  # [..., n]
    br_if_re: torch.Tensor  # [..., b] current i_from
    br_if_im: torch.Tensor  # [..., b]
    br_it_re: torch.Tensor  # [..., b] current i_to
    br_it_im: torch.Tensor  # [..., b]
    br_p_from: torch.Tensor  # [..., b]
    br_q_from: torch.Tensor  # [..., b]
    br_p_to: torch.Tensor  # [..., b]
    br_q_to: torch.Tensor  # [..., b]
    br_s: torch.Tensor  # [..., b] signed apparent-power flow (branch.py:198)
    pfe_converged: torch.Tensor  # [...] bool


SIM_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def zeros_state(spec: GridSpec, batch_shape=(), device="cpu", dtype=torch.float32) -> SimState:
    """An all-zeros SimState (the terminal absorbing state)."""
    z = lambda k: torch.zeros(tuple(batch_shape) + (k,), device=device, dtype=dtype)
    return SimState(
        dev_p=z(spec.n_dev),
        dev_q=z(spec.n_dev),
        des_soc=z(spec.n_des),
        gen_p_pot=z(spec.n_gen),
        bus_v_re=z(spec.n_bus),
        bus_v_im=z(spec.n_bus),
        bus_i_re=z(spec.n_bus),
        bus_i_im=z(spec.n_bus),
        bus_p=z(spec.n_bus),
        bus_q=z(spec.n_bus),
        br_if_re=z(spec.n_branch),
        br_if_im=z(spec.n_branch),
        br_it_re=z(spec.n_branch),
        br_it_im=z(spec.n_branch),
        br_p_from=z(spec.n_branch),
        br_q_from=z(spec.n_branch),
        br_p_to=z(spec.n_branch),
        br_q_to=z(spec.n_branch),
        br_s=z(spec.n_branch),
        pfe_converged=torch.zeros(tuple(batch_shape), device=device, dtype=torch.bool),
    )


def select_state(pred: torch.Tensor, a: SimState, b: SimState) -> SimState:
    """Per-lane ``pred ? a : b`` over every field (``pred`` is ``[B]`` bool)."""
    out = {}
    for name in SIM_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        p = pred.reshape(pred.shape + (1,) * (y.dim() - pred.dim()))
        out[name] = torch.where(p, x, y)
    return SimState(**out)


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy (arrays from other frameworks may be read-only)
    dt = torch.bool if a.dtype == np.bool_ else dtype
    return torch.as_tensor(a, device=device).to(dt)


def sim_state_from_numpy(fields, device="cpu", dtype=torch.float32) -> SimState:
    """A SimState from a mapping (or object) holding the 20 fields as arrays,
    e.g. a ``gym_anm_tpu`` ``SimState`` converted with ``np.asarray``."""
    get = fields.__getitem__ if isinstance(fields, dict) else lambda k: getattr(fields, k)
    return SimState(**{k: _tensor(get(k), device, dtype) for k in SIM_FIELDS})


def env_state_from_numpy(sim, aux, terminated, state_vec, device="cpu", dtype=torch.float32):
    """An :class:`~gym_anm_tpu_torch.core.env_core.EnvState` from NumPy
    arrays (``sim`` as for :func:`sim_state_from_numpy`)."""
    from .env_core import EnvState

    return EnvState(
        sim=sim_state_from_numpy(sim, device, dtype),
        aux=_tensor(aux, device, dtype),
        terminated=_tensor(np.asarray(terminated, dtype=bool), device, dtype),
        state_vec=_tensor(state_vec, device, dtype),
    )
