"""The ANM6Easy task on tensors (reference ``envs/anm6_env/anm6_easy.py``).

Fully observable 6-bus task with deterministic 24-hour load/generation
profiles (piecewise-constant segments joined by linear ramps, 96
quarter-hour steps) and one auxiliary variable: the time-of-day index.

The counterpart of ``make_core`` and the pure hooks of
``gym_anm_tpu.envs.anm6.anm6_easy``.  The hooks draw from a
``torch.Generator``, so samples differ from the JAX PRNG streams; the
distribution is the same.

The Gymnasium class ``ANM6Easy`` lives in :mod:`.anm6_easy_gym` and is
reached here too, imported on first access.
"""

from __future__ import annotations

import numpy as np
import torch


def _profile(levels, ramps=None):
    """Build one 96-step daily profile: 25 + 7 + 13 + 7 + 13 + 7 + 13 + 7 + 4
    entries of [s1, s12, s2, s23, s3, s23[::-1], s2, s12[::-1], s1[:4]]
    (anm6_easy.py:77-132)."""
    s1, s12, s2, s23, s3 = levels
    return np.concatenate((s1, s12, s2, s23, s3, s23[::-1], s2, s12[::-1], s1[:4]))


def _get_load_time_series():
    """Fixed 24-hour load time-series, shape (3, 96) (anm6_easy.py:77-107)."""
    # Residential load (device 1).
    P1 = _profile(
        (-np.ones(25), np.linspace(-1.5, -4.5, 7), -5 * np.ones(13), np.linspace(-4.625, -2.375, 7), -2 * np.ones(13))
    )
    # Industrial load (device 3).
    P3 = _profile(
        (-4 * np.ones(25), np.linspace(-4.75, -9.25, 7), -10 * np.ones(13), np.linspace(-11.25, -18.75, 7), -20 * np.ones(13))
    )
    # EV-charging-station load (device 5).
    P5 = _profile(
        (np.zeros(25), np.linspace(-3.125, -21.875, 7), -25 * np.ones(13), np.linspace(-21.875, -3.125, 7), np.zeros(13))
    )
    P_loads = np.vstack((P1, P3, P5))
    assert P_loads.shape == (3, 96)
    return P_loads


def _get_gen_time_series():
    """Fixed 24-hour maximum-generation time-series, shape (2, 96)
    (anm6_easy.py:110-132)."""
    # Residential PV aggregation (device 2).
    P2 = _profile(
        (np.zeros(25), np.linspace(0.5, 3.5, 7), 4 * np.ones(13), np.linspace(7.25, 36.75, 7), 30 * np.ones(13))
    )
    # Wind farm (device 4).
    P4 = _profile(
        (40 * np.ones(25), np.linspace(36.375, 14.625, 7), 11 * np.ones(13), np.linspace(14.725, 36.375, 7), 40 * np.ones(13))
    )
    P_maxs = np.vstack((P2, P4))
    assert P_maxs.shape == (2, 96)
    return P_maxs


def make_core(
    dtype=torch.float32, device="cuda", pf_max_iter=None, pf_method="tree", chord_iters=16, nr_pivot=False,
    warm_start=False, network=None,
):
    """Build the ANM6Easy :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
    computing on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``dtype`` (fully observable: the observation is the state vector).

    ``pf_method`` is any of
    :data:`~gym_anm_tpu_torch.core.transition.PF_METHODS`; ``"tree"`` is the
    default, ``"pallas"`` the JAX package's previous one.
    ``pf_max_iter=None`` takes the JAX package's calibrated budget of 10 for
    every method (every converging solve finishes in <= 8 iterations; its
    parity check runs ``"hybrid"`` with 6, see ``check.CHECK_CONFIG``).
    ``warm_start`` warm-starts each step's solve from the previous step's
    voltages (every method but the fused ones, off by default).
    ``network`` replaces the canonical 6-bus dict (the same topology and
    device layout), as the domain-randomized fleets of
    :mod:`gym_anm_tpu_torch.envs.randomized` do."""
    from ...core.env_core import EnvCore
    from ...core.grid import build_grid
    from ...core.obs import state_values_spec
    from .network import network as canonical

    if network is None:
        network = canonical
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    spec, _ = build_grid(network, delta_t=0.25, lamb=100, dtype=np_dtype)
    device = torch.device(device)
    P_loads = torch.as_tensor(_get_load_time_series(), device=device).to(dtype)
    P_maxs = torch.as_tensor(_get_gen_time_series(), device=device).to(dtype)
    K = 1
    return EnvCore(
        spec,
        K=K,
        gamma=0.995,
        device=device,
        dtype=dtype,
        costs_clipping=(1, 100),
        obs_values=state_values_spec(spec, K),  # fully observable
        aux_bounds=np.array([[0, 95]]),
        init_state_fn=lambda generator, batch_size: anm6easy_init_state(generator, batch_size, P_loads, P_maxs),
        next_vars_fn=lambda s, generator: anm6easy_next_vars(s, P_loads, P_maxs),
        max_iter=10 if pf_max_iter is None else pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        nr_pivot=nr_pivot,
        warm_start=warm_start,
        # Every ANM6Easy s0 converges on attempt 1 (JAX package calibration).
        reset_attempts=1,
    )


def anm6easy_init_state(generator: torch.Generator, batch_size: int, P_loads, P_maxs):
    """ANM6Easy initial-state distribution, ``[B, 18]``.

    Matches the reference distribution (anm6_easy.py:25-52), including its
    p.u.-valued generator-Q / SoC quirks: generator Q is sampled over the
    p.u. bounds (+-0.3 / +-0.5) and the SoC over [0, 1] although the state
    vector is in MVAr / MWh.
    """
    n_dev, n_gen, n_des, K = 7, 2, 1, 1
    device, dtype = P_loads.device, P_loads.dtype
    B = int(batch_size)
    t0 = torch.randint(0, 96, (B,), generator=generator, device=device)
    u = torch.rand((B, 3), generator=generator, device=device, dtype=dtype)

    state = torch.zeros((B, 2 * n_dev + n_des + n_gen + K), dtype=dtype, device=device)
    state[:, -1] = t0.to(dtype)
    qp_ratio = 0.2
    for i, dev_id in enumerate([1, 3, 5]):
        state[:, dev_id] = P_loads[i, t0]
        state[:, n_dev + dev_id] = P_loads[i, t0] * qp_ratio
    q_bounds = ((-0.3, 0.3), (-0.5, 0.5))
    for idx, dev_id in enumerate([2, 4]):
        state[:, 2 * n_dev + n_des + idx] = P_maxs[idx, t0]
        state[:, dev_id] = P_maxs[idx, t0]
        lo, hi = q_bounds[idx]
        state[:, n_dev + dev_id] = lo + (hi - lo) * u[:, idx]
    state[:, 2 * n_dev] = u[:, 2]
    return state


def anm6easy_next_vars(s_t, P_loads, P_maxs):
    """ANM6Easy ``next_vars`` (anm6_easy.py:54-65): table lookup by the
    next time of day, ``[B, 6] = [P_load (3), P_pot (2), aux]``."""
    aux = torch.remainder(s_t[:, -1] + 1, 96).to(torch.int64)
    return torch.cat([P_loads[:, aux].T, P_maxs[:, aux].T, aux.to(P_loads.dtype)[:, None]], dim=-1)


def __getattr__(name):
    # The Gymnasium class, imported only when asked for: the batched path
    # (make_core and the hooks) never imports Gymnasium.
    if name == "ANM6Easy":
        from .anm6_easy_gym import ANM6Easy

        return ANM6Easy
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
