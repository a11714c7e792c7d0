"""Trajectory-parity check on tensors.

The counterpart of ``gym_anm_tpu.check``: fixed initial states, actions and
internal variables are committed to the repo (``tests/data/onchip_ref_*.npz``)
together with the host-float64 trajectory they produce;
:func:`rollout_given` replays the identical inputs through the port and
:func:`compare_trajectories` compares states, rewards and termination
decisions step by step.  ``load_reference`` and ``compare_trajectories``
are NumPy copies of the JAX package's functions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")


def ref_path(env_name: str) -> str:
    return os.path.join(DATA_DIR, "onchip_ref_%s.npz" % env_name)


def rollout_given(core, s0, actions, vars_seq):
    """Replay a fixed (s0, actions, vars) trajectory through ``core``.

    ``s0 [B, k]``, ``actions [T, B, action_n]``, ``vars_seq [T, B, vars_n]``
    (arrays or tensors).  Returns ``(state_vec [T, B, n], reward [T, B],
    terminated [T, B])`` as tensors on the core's device, in its dtype.
    """
    t = lambda a: torch.as_tensor(np.asarray(a), device=core.device).to(core.dtype)
    actions, vars_seq = t(actions), t(vars_seq)
    es = core.env_state_from_s0(t(s0))
    svs, rws, tms = [], [], []
    for action, vars in zip(actions, vars_seq):
        es, out = core.step(es, action, vars)
        svs.append(out.state_vec)
        rws.append(out.reward)
        tms.append(out.terminated)
    return torch.stack(svs), torch.stack(rws), torch.stack(tms)


def compare_trajectories(ref, got, term_tol=0.02, state_tol=5e-3, reward_tol=5e-3):
    """Step-by-step comparison of a chip trajectory against the committed
    host-f64 reference.

    ref/got: dicts with state_vec [T, B, n], reward [T, B], terminated
    [T, B] (numpy).  States and rewards are compared only while a lane's
    termination history matches the reference (a lane that diverges at a
    different step legitimately holds a different absorbing state
    afterwards).  State divergence is measured relative to the per-feature
    dynamic range (max |state| over the reference trajectory, floored at 1).

    Returns a dict: term_mismatch_frac, max_state_div, max_reward_div,
    final_terminated_frac, n_compared, pass.
    """
    r_term = np.asarray(ref["terminated"], dtype=bool)
    g_term = np.asarray(got["terminated"], dtype=bool)
    T, B = r_term.shape

    # A lane counts as mismatched once its termination flag ever disagrees.
    disagree = np.cumsum(r_term != g_term, axis=0) > 0  # [T, B]
    term_mismatch_frac = float(disagree[-1].mean())

    # Valid comparison mask: termination history agrees so far AND the lane
    # is not yet terminated (absorbing zero states are trivially equal).
    valid = ~disagree & ~r_term  # [T, B]

    r_sv = np.asarray(ref["state_vec"], dtype=np.float64)
    g_sv = np.asarray(got["state_vec"], dtype=np.float64)
    scale = np.maximum(np.abs(r_sv).max(axis=(0, 1)), 1.0)  # [n]
    div = np.abs(g_sv - r_sv) / scale  # [T, B, n]
    div = np.where(valid[:, :, None], div, 0.0)
    max_state_div = float(div.max()) if valid.any() else 0.0

    r_rw = np.asarray(ref["reward"], dtype=np.float64)
    g_rw = np.asarray(got["reward"], dtype=np.float64)
    rw_scale = max(np.abs(r_rw).max(), 1.0)
    rdiv = np.where(valid, np.abs(g_rw - r_rw) / rw_scale, 0.0)
    max_reward_div = float(rdiv.max()) if valid.any() else 0.0

    ok = (
        term_mismatch_frac <= term_tol
        and max_state_div <= state_tol
        and max_reward_div <= reward_tol
    )
    return {
        "term_mismatch_frac": round(term_mismatch_frac, 6),
        "max_state_div": round(max_state_div, 8),
        "max_reward_div": round(max_reward_div, 8),
        "ref_final_terminated_frac": round(float(r_term[-1].mean()), 6),
        "got_final_terminated_frac": round(float(g_term[-1].mean()), 6),
        "n_compared_lane_steps": int(valid.sum()),
        "pass": bool(ok),
    }


def load_reference(env_name: str) -> dict:
    """Load the committed inputs + host-f64 trajectory for an env."""
    with np.load(ref_path(env_name)) as z:
        return {k: z[k] for k in z.files}
