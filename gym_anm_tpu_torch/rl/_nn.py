"""Pieces the PPO and SAC trainers share: layers initialised as the JAX
package's flax layers are, observation normalisation, the tanh-squashed
Gaussian's log-density, the optimiser state as a checkpointable tree, and
the mapping of flax parameter trees onto the port's modules."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..parallel.tensor import all_reduce_sum_tp_

LOG_2PI = math.log(2.0 * math.pi)


def dense(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    """A linear layer initialised as ``flax.linen.Dense``: weights from
    LeCun's truncated normal (variance 1 / n_in), zero bias."""
    layer = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978  # the truncation's variance correction
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        layer.bias.zero_()
    return layer


def obs_norm_tables(core, dtype, device):
    """``(centre, scale)`` that normalise observations by the finite parts
    of the observation bounds (``core.obs_gather``)."""
    low = np.asarray(core.obs_gather.low, dtype=np.float64)
    high = np.asarray(core.obs_gather.high, dtype=np.float64)
    finite = np.isfinite(low) & np.isfinite(high)
    with np.errstate(invalid="ignore"):
        centre = np.where(finite, (low + high) / 2, 0.0)
        scale = np.where(finite, np.maximum((high - low) / 2, 1e-3), 1.0)
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)
    return t(centre), t(scale)


def squashed_logp(eps, log_std, u):
    """Log-density of ``u = tanh(mean + std eps)`` summed over the action,
    with the tanh correction."""
    return torch.sum(-0.5 * (eps**2) - log_std - 0.5 * LOG_2PI - torch.log(1 - u**2 + 1e-6), dim=-1)


def clip_by_global_norm_(params, max_norm: float, sharded=(), tp_group=None):
    """Scale the gradients of ``params`` in place as
    ``optax.clip_by_global_norm`` does: unchanged while their global norm is
    below ``max_norm``, else ``(g / norm) * max_norm``.  No host sync.

    ``sharded`` (a subset of ``params``) holds this rank's shards of
    tensor-parallel parameters: their squares are summed over ``tp_group``
    before the replicated ones are added, so every tp rank clips by the
    whole model's norm."""
    split = {id(p) for p in sharded}
    grads = [p.grad for p in params if p.grad is not None]
    norm_sq = sum(torch.sum(p.grad * p.grad) for p in params if p.grad is not None and id(p) not in split)
    if split:
        part = sum(torch.sum(p.grad * p.grad) for p in sharded if p.grad is not None)
        norm_sq = all_reduce_sum_tp_(part, tp_group) + norm_sq
    norm = torch.sqrt(norm_sq)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def adam_state(opt: torch.optim.Adam) -> dict:
    """The moments and step counts of an Adam optimiser as a tree of
    tensors, in parameter order (zeros before its first step)."""
    out = {"step": [], "exp_avg": [], "exp_avg_sq": []}
    for p in (p for group in opt.param_groups for p in group["params"]):
        st = opt.state.get(p, {})
        out["step"].append(torch.as_tensor(st.get("step", 0.0), dtype=torch.float32).reshape(()).cpu())
        out["exp_avg"].append(st.get("exp_avg", torch.zeros_like(p)))
        out["exp_avg_sq"].append(st.get("exp_avg_sq", torch.zeros_like(p)))
    return out


def load_adam_state(opt: torch.optim.Adam, tree: dict) -> None:
    """Restore :func:`adam_state` output into ``opt``."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for i, p in enumerate(params):
        if float(tree["step"][i]) == 0.0:
            opt.state.pop(p, None)
            continue
        opt.state[p] = {
            "step": tree["step"][i].clone(),
            "exp_avg": tree["exp_avg"][i].to(p.device).clone(),
            "exp_avg_sq": tree["exp_avg_sq"][i].to(p.device).clone(),
        }


def flax_dense(prefix: str, params: dict) -> dict:
    """The ``state_dict`` entries of the ``nn.Linear`` at ``prefix`` from a
    flax Dense's ``{"kernel": [in, out], "bias": [out]}`` (NumPy arrays)."""
    return {prefix + ".weight": torch.as_tensor(np.asarray(params["kernel"]).T.copy()),
            prefix + ".bias": torch.as_tensor(np.asarray(params["bias"]).copy())}
