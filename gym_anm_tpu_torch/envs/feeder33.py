"""The 33-bus feeder task on tensors.

The counterpart of ``make_core`` of ``gym_anm_tpu.envs.feeder33``: a
synthetic radial 33-bus feeder (three laterals, 32 loads, 5 renewable
generators, 2 storage units; the network is
:func:`~gym_anm_tpu_torch.envs.feeder_networks.make_feeder_network`) with
stochastic loads around a daily profile and stochastic renewable potentials,
and one auxiliary variable: the time-of-day index.

The hooks draw from a ``torch.Generator``, so samples differ from the JAX
PRNG streams; the distributions are the same.

The Gymnasium class ``Feeder33Env`` lives in :mod:`.feeder33_gym` and is
reached here too, imported on first access.
"""

from __future__ import annotations

import math

import numpy as np
import torch

K = 1


def _daily(t):
    """Smooth daily demand factor in [0.5, 1] peaking in the evening."""
    return 0.75 + 0.25 * torch.sin(2 * math.pi * (t / 96.0 - 0.3))


def pf_max_iter_for(pf_method: str) -> int:
    """The JAX package's calibrated NR budget for this task: 10 for the
    tree solves (rollout-measured p100 = 6, +4 margin), 6 for the true-NR
    tail of the hybrid methods, 15 for dense pure NR."""
    if pf_method in ("hybrid", "xla_hybrid", "fused_hybrid"):
        return 6
    if pf_method in ("tree", "tree_xla"):
        return 10
    return 15


def make_core(
    dtype=torch.float32, device="cuda", pf_max_iter=None, pf_method="tree", chord_iters=16, nr_pivot=False,
    warm_start=False, network=None, x_tol=1e-5,
):
    """Build the feeder33 :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
    computing on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``dtype``.  ``pf_max_iter=None`` takes :func:`pf_max_iter_for`.
    ``warm_start`` warm-starts each step's solve from the previous step's
    voltages (every method but the fused ones, off by default).  ``network`` replaces the
    33-bus feeder with another radial network dict under the same dynamics
    (the 141-bus task, ``envs/feeder141.py``; Baran and Wu's feeder,
    ``envs/baranwu33.py``).  An initial state's reactive loads take each
    load's own Q/P ratio."""
    from ..core.env_core import EnvCore
    from ..core.grid import build_grid
    from ..core.obs import state_values_spec
    from .feeder_networks import make_feeder_network

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    net = make_feeder_network() if network is None else network
    spec, _ = build_grid(net, delta_t=0.25, lamb=100, dtype=np_dtype)
    device = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np_dtype), device=device)
    load_scale = t(-np.asarray(spec.load_p_min) * spec.baseMVA)
    load_qp = t(spec.load_qp)
    pv_scale = t(np.asarray(spec.gen_p_max) * spec.baseMVA)
    soc_max_mwh = t(np.asarray(spec.des_soc_max) * spec.baseMVA)
    load_pos = torch.as_tensor(np.asarray(spec.load_pos, dtype=np.int64), device=device)
    gen_pos = torch.as_tensor(np.asarray(spec.gen_pos, dtype=np.int64), device=device)
    n_dev, n_des, n_gen, n_load = spec.n_dev, spec.n_des, spec.n_gen, spec.n_load

    def uniform(generator, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device, dtype=dtype)

    def init_state_fn(generator, batch_size):
        B = int(batch_size)
        t0 = torch.randint(0, 96, (B,), generator=generator, device=device).to(dtype)
        loads = -load_scale * _daily(t0)[:, None] * uniform(generator, (B, n_load), 0.3, 0.9)
        pots = pv_scale * uniform(generator, (B, n_gen), 0.2, 1.0)
        soc = uniform(generator, (B, n_des), 0.0, 1.0) * soc_max_mwh
        s = torch.zeros((B, 2 * n_dev + n_des + n_gen + K), dtype=dtype, device=device)
        s[:, load_pos] = loads
        s[:, n_dev + load_pos] = loads * load_qp
        s[:, gen_pos] = pots
        s[:, 2 * n_dev + n_des : 2 * n_dev + n_des + n_gen] = pots
        s[:, 2 * n_dev : 2 * n_dev + n_des] = soc
        s[:, -1] = t0
        return s

    def next_vars_fn(s_t, generator):
        B = s_t.shape[0]
        aux = torch.remainder(s_t[:, -1] + 1, 96)
        loads = -load_scale * _daily(aux)[:, None] * uniform(generator, (B, n_load), 0.3, 0.9)
        pots = pv_scale * uniform(generator, (B, n_gen), 0.2, 1.0)
        return torch.cat([loads, pots, aux[:, None]], dim=-1)

    return EnvCore(
        spec,
        K=K,
        gamma=0.995,
        device=device,
        dtype=dtype,
        costs_clipping=(1, 100),
        obs_values=state_values_spec(spec, K),  # fully observable
        aux_bounds=np.array([[0, 95]]),
        init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn,
        x_tol=x_tol,
        max_iter=pf_max_iter_for(pf_method) if pf_max_iter is None else pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        nr_pivot=nr_pivot,
        warm_start=warm_start,
        # Feeder initial states essentially always converge; one masked
        # retry round covers the tail (JAX package calibration).
        reset_attempts=2,
    )


def __getattr__(name):
    # The Gymnasium class, imported only when asked for: the batched path
    # (make_core and the hooks) never imports Gymnasium.
    if name == "Feeder33Env":
        from .feeder33_gym import Feeder33Env

        return Feeder33Env
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
