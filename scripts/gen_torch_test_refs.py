#!/usr/bin/env python
"""Record the JAX package's outputs that the PyTorch port's CPU tests hold
the port against, so that those tests compile no JAX program.

Each ``tests/test_torch_<name>.py`` that reads a reference has one file
``tests/data/torch_refs_<name>.npz``.  This script rebuilds each test's own
inputs with numpy and the JAX package alone (the same seeds, shapes and
committed trajectories the test uses), runs the JAX code the test compared
against live, in float64 on the CPU, and writes the outputs beside the
inputs (or beside a SHA-256 digest of large inputs).  Each test checks that
its inputs are the recorded ones before it compares.

Usage:
    python scripts/gen_torch_test_refs.py [--only env step ...]
    (the script forces JAX onto the CPU in float64 itself)
"""

import argparse
import hashlib
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")


def digest(*arrays):
    """SHA-256 of the arrays' float64 bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    return h.hexdigest()


def save(name, arrays):
    path = os.path.join(DATA, "torch_refs_%s.npz" % name)
    np.savez_compressed(path, **arrays)
    print("%s: %d arrays, %d bytes" % (os.path.relpath(path, ROOT), len(arrays), os.path.getsize(path)))


def _sim_fields():
    import dataclasses

    from gym_anm_tpu.core.state import SimState

    return tuple(f.name for f in dataclasses.fields(SimState))


def _env_state(prefix, jes):
    """An env state's arrays under ``prefix/``."""
    out = {"%s/sim/%s" % (prefix, k): np.asarray(getattr(jes.sim, k)) for k in _sim_fields()}
    out.update({"%s/%s" % (prefix, k): np.asarray(getattr(jes, k)) for k in ("aux", "terminated", "state_vec")})
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_env.py


T_STEPS = 4  # test_torch_env.T_STEPS
FEEDER33_RUNS = (("scan", False), ("hybrid", False))  # test_torch_env.JAX_RUNS["feeder33"]


def refs_env():
    from gym_anm_tpu import check
    from gym_anm_tpu.envs.feeder33 import make_core as f33_make_core
    from gym_anm_tpu.envs.feeder141 import make_core as f141_make_core

    ref = check.load_reference("feeder33")
    args = [np.asarray(a, np.float64) for a in (ref["s0"], ref["actions"][:T_STEPS], ref["vars"][:T_STEPS])]
    out = {"feeder33/inputs_sha256": np.array(digest(*args))}
    for method, warm in FEEDER33_RUNS:
        core = f33_make_core(dtype=jnp.float64, pf_method=method, warm_start=warm)
        sv, rw, tm = check.rollout_given(core, *args)
        for k, v in (("state_vec", sv), ("reward", rw), ("terminated", tm)):
            out["feeder33/%s/%s" % (method, k)] = np.asarray(v)

    # test_feeder141_hooks_and_refusals: the JAX core's constants and refusals.
    jcore = f141_make_core(dtype=jnp.float32)
    for k in ("max_iter", "x_tol", "state_n", "action_n", "K"):
        out["feeder141/" + k] = np.asarray(getattr(jcore, k))
    out["feeder141/action_low"] = np.asarray(jcore.action_low)
    out["feeder141/f64_x_tol"] = np.asarray(f141_make_core(dtype=jnp.float64).x_tol)
    for method in ("pallas", "fused", "fused_hybrid"):
        try:
            f141_make_core(pf_method=method)
        except ValueError as e:
            out["feeder141/refusal/" + method] = np.array(str(e))
        else:
            raise AssertionError("feeder141 accepted pf_method=%r" % method)
    save("env", out)


# ---------------------------------------------------------------------------
# tests/test_torch_step.py


def _set_points(spec, B, seed, dtype):
    """test_torch_step._set_points."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, (B,) + np.shape(lo)).astype(dtype)
    gen = np.asarray(spec.gen_pos)
    des = np.asarray(spec.des_pos)
    q_lo, q_hi = np.asarray(spec.dev_q_min), np.asarray(spec.dev_q_max)
    return dict(
        des_soc=u(np.asarray(spec.des_soc_min), np.asarray(spec.des_soc_max)),
        P_load=u(np.asarray(spec.load_p_min), np.zeros(spec.n_load)),
        P_pot=u(np.zeros(spec.n_gen), np.asarray(spec.gen_p_max)),
        P_set_gen=u(np.zeros(spec.n_gen), 1.2 * np.asarray(spec.gen_p_max)),
        Q_set_gen=u(1.2 * q_lo[gen], 1.2 * q_hi[gen]),
        P_set_des=u(np.asarray(spec.dev_p_min)[des], np.asarray(spec.dev_p_max)[des]),
        Q_set_des=u(q_lo[des], q_hi[des]),
    )


def refs_step():
    from jax.experimental.pallas import tpu as pltpu

    import gym_anm_tpu.ops.pallas_step as pallas_step
    from gym_anm_tpu.core import transition as T
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.envs.anm6.network import network

    spec, _ = build_grid(network, 0.25, 100, dtype=np.float32)
    args = _set_points(spec, 128, 0, np.float32)
    old = pallas_step.FORCE_INTERPRET
    pallas_step.FORCE_INTERPRET = True
    try:
        path = T.resolve_solver_path(spec, "fused", args["des_soc"], args["P_load"])[0]
        with pltpu.force_tpu_interpret_mode():
            r = T.transition(spec, **{k: jnp.asarray(v) for k, v in args.items()}, pf_method="fused", max_iter=10)
    finally:
        pallas_step.FORCE_INTERPRET = old
    out = {"fused/inputs/" + k: v for k, v in args.items()}
    out["fused/path"] = np.array(path)
    out["fused/pfe_converged"] = np.asarray(r.pfe_converged)
    out.update({"fused/state/" + k: np.asarray(getattr(r.state, k)) for k in _sim_fields()})
    out["fused/e_loss"] = np.asarray(r.e_loss)
    out["fused/penalty"] = np.asarray(r.penalty)
    save("step", out)


# ---------------------------------------------------------------------------
# tests/test_torch_gym_env.py


def _snapshot_json(sim):
    """test_torch_gym_env._snapshot, as JSON-ready (key, value) lists that
    keep the keys' types and order."""
    hs = sim._state_arrays()
    bus = list(zip(sim.buses, hs.bus_i[np.asarray(sim.spec.bus_sorted)]))
    branch = list(zip(sim.branches, hs.br_i_from))
    cur = [[kind, [[k, float(v.real), float(v.imag)] for k, v in rows]] for kind, rows in (("bus", bus), ("branch", branch))]
    state = [[q, [[u, [[i, float(x)] for i, x in d.items()]] for u, d in v.items()]] for q, v in sim.state.items()]
    return [state, cur]


def _episode_json(env, actions, seed):
    """test_torch_gym_env._episode, as JSON-ready rows."""
    obs, _ = env.reset(seed=seed)
    rows = [dict(obs=np.asarray(obs).tolist(), snap=_snapshot_json(env.simulator), date=env.date.isoformat(),
                 year=env.year_count)]
    for a in actions:
        obs, r, term, trunc, _ = env.step(a)
        rows.append(dict(obs=np.asarray(obs).tolist(), r=float(r), term=bool(term), trunc=bool(trunc),
                         e_loss=float(env.e_loss), penalty=float(env.penalty), snap=_snapshot_json(env.simulator),
                         date=env.date.isoformat(), year=env.year_count, state=np.asarray(env.state).tolist()))
    return rows


def refs_gym_env():
    from gym_anm_tpu.envs.feeder33 import Feeder33Env

    env = Feeder33Env(seed=1)
    rng = np.random.default_rng(1)  # test_torch_gym_env._actions(space, 4, seed=1)
    actions = [rng.uniform(env.action_space.low, env.action_space.high) for _ in range(4)]
    rows = _episode_json(env, actions, seed=5)
    save("gym_env", {"feeder33/actions": np.stack(actions), "feeder33/episode": np.array(json.dumps(rows))})


# ---------------------------------------------------------------------------
# tests/test_torch_vector_env.py


def refs_vector_env():
    from gym_anm_tpu.envs.anm6.anm6_easy import make_core
    from gym_anm_tpu.envs.vector import ANMVectorEnv

    B = 16
    jenv = ANMVectorEnv(make_core(dtype=jnp.float64), num_envs=B, seed=0)
    jcore = jenv.core
    jenv.reset(seed=2)
    jes = jenv._es
    needs = np.zeros(B, dtype=bool)
    needs[[3, 11]] = True

    @jax.jit
    def draws(es, key):  # vector.py:95-107
        k_vars, k_reset = jax.random.split(key)
        if jcore.stochastic_vars:
            vars = jax.vmap(jcore.next_vars_fn)(jcore.state_vec(es), jax.random.split(k_vars, B))
        else:
            vars = jax.vmap(jcore.next_vars_fn, in_axes=(0, None))(jcore.state_vec(es), k_vars)
        return vars, jax.vmap(jcore.init_state_fn)(jax.random.split(k_reset, B))

    out = _env_state("init", jes)
    out["needs0"] = needs
    rng = np.random.default_rng(0)
    for t in range(6):
        actions = rng.uniform(np.asarray(jcore.action_low), np.asarray(jcore.action_high),
                              size=(B, int(jcore.action_n)))
        key = jax.random.PRNGKey(100 + t)
        vars, s0 = draws(jes, key)
        jes, jobs, jrew, jterm, jnext = jenv._jit_step(jes, jnp.asarray(needs), jnp.asarray(actions), key)
        p = "step%d/" % t
        out.update({p + "actions": actions, p + "vars": np.asarray(vars), p + "s0": np.asarray(s0),
                    p + "obs": np.asarray(jobs), p + "reward": np.asarray(jrew), p + "terminated": np.asarray(jterm),
                    p + "needs_next": np.asarray(jnext)})
        out.update({p + "es/" + k: np.asarray(v) for k, v in (
            ("terminated", jes.terminated), ("state_vec", jes.state_vec),
            ("bus_v_re", jes.sim.bus_v_re), ("bus_v_im", jes.sim.bus_v_im))})
        needs = np.asarray(jnext)
    save("vector_env", out)


# ---------------------------------------------------------------------------
# tests/test_torch_power_flow.py


PF_KW = dict(x_tol=1e-9, max_iter=8, chord_iters=6)  # test_torch_power_flow.KW


def refs_power_flow():
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.envs.feeder33 import _NETWORK
    from gym_anm_tpu.ops.power_flow import solve_pfe

    # test_torch_power_flow._case_f64("feeder33"): B=48, seed 1, amplitude 0.05.
    jspec, _ = build_grid(_NETWORK, 0.25, 100, dtype=np.float64)
    rng = np.random.default_rng(1)
    m, amp = jspec.n_bus - 1, 0.05
    p = rng.uniform(-amp, amp, (48, m))
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (48, m))
    p[:3] *= 40.0
    run = jax.jit(lambda Yr, Yi, p, q: {k: solve_pfe(Yr, Yi, p, q, method=k, **PF_KW) for k in ("scan", "while", "hybrid")})
    out = {"feeder33/p": p, "feeder33/q": q}
    for method, v in run(jspec.Y_re, jspec.Y_im, p, q).items():
        out.update({"feeder33/%s/%d" % (method, i): np.asarray(x) for i, x in enumerate(v)})
    save("power_flow", out)


# ---------------------------------------------------------------------------
# tests/test_torch_randomized.py


def refs_randomized():
    from gym_anm_tpu.envs.randomized import MultiBatchedEnv, randomized_anm6easy_cores

    # test_torch_randomized._jax_anm6_fleet
    jcores = randomized_anm6easy_cores(3, seed=0, r_sigma=0.2, x_sigma=0.2, dtype=jnp.float64)
    fleet = MultiBatchedEnv(jcores, lanes_per_variant=8)
    states, _ = fleet.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(jcores[0].action_low), np.asarray(jcores[0].action_high)
    actions = rng.uniform(lo, hi, (3, 3, 8, lo.shape[0]))
    out = {"anm6/actions": actions}
    for g, s in enumerate(states):
        out.update(_env_state("anm6/init/%d" % g, s))
    js = states
    for t in range(3):
        js, o = fleet.step(js, jnp.asarray(actions[t]), jax.random.PRNGKey(10 + t))
        out.update({"anm6/step%d/%s" % (t, k): np.asarray(getattr(o, k))
                    for k in ("obs", "state_vec", "reward", "terminated")})
    save("randomized", out)


# ---------------------------------------------------------------------------
# tests/test_torch_projection.py and tests/test_torch_projection_forms.py


def _task_polytopes():
    """Each task's static normals ``[C, m, 2]`` and static offsets ``[C, m]``."""
    from gym_anm_tpu.core.grid import build_grid
    from gym_anm_tpu.envs.anm6.network import network
    from gym_anm_tpu.envs.feeder33 import _NETWORK as F33
    from gym_anm_tpu.envs.feeder141 import _NETWORK as F141

    out = {}
    for name, net in (("anm6", network), ("feeder33", F33), ("feeder141", F141)):
        spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
        G = np.concatenate([spec.gen_G, spec.des_G], axis=0)
        h0 = np.concatenate([spec.gen_h0, spec.des_h0], axis=0)
        out[name] = (spec, np.asarray(G), np.asarray(h0))
    return out


def forms_case(G, h0, n_gen, B, seed):
    """Inputs of the projection-forms tests on one task: the dynamic rows (P
    cap of every device, P floor of the storage units) random, a quarter of
    them +inf; points near the regions and far out; then NaN, +inf and -inf
    set-points on a few lanes each, and lanes whose regions are empty (a cap
    below the floor: no candidate is valid, the point comes back)."""
    from gym_anm_tpu.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR

    C, m, _ = G.shape
    rng = np.random.default_rng(seed)
    h = np.repeat(h0[:, :, None], B, axis=2)
    cap = rng.uniform(0.0, 0.6, (C, B))
    cap[rng.uniform(size=(C, B)) < 0.25] = np.inf
    h[:, POLY_ROW_P_CAP] = cap
    floor = rng.uniform(0.0, 0.6, (C - n_gen, B))
    floor[rng.uniform(size=floor.shape) < 0.25] = np.inf
    h[n_gen:, POLY_ROW_P_FLOOR] = floor
    scale = np.where(np.arange(B) < B // 2, 0.3, 1.5)
    px = rng.uniform(-1.0, 1.0, (C, B)) * scale
    py = rng.uniform(-1.0, 1.0, (C, B)) * scale
    px[:, 0] = np.nan
    py[:, 1] = np.nan
    px[:, 2], py[:, 2] = np.nan, np.nan
    px[:, 3] = np.inf
    py[:, 4] = -np.inf
    px[:, 5], py[:, 5] = -np.inf, np.inf
    # An empty region on a storage unit: discharge cap -0.5 (p <= -0.5) and
    # charge cap -0.5 (p >= 0.5).
    h[n_gen:, POLY_ROW_P_CAP, 6] = -0.5
    h[n_gen:, POLY_ROW_P_FLOOR, 6] = -0.5
    return px, py, h


FORMS_B = 64
FORMS_SEED = 11


def refs_projection():
    from gym_anm_tpu.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR
    from gym_anm_tpu.ops.projection import (
        project_box_slants_lanes,
        project_polytope,
        project_polytope_lanes,
        project_polytope_lanes_stacked,
    )

    tasks = _task_polytopes()
    out = {}
    # test_torch_projection.test_projection_matches_jax: the ANM6 polytopes,
    # seeds 0-2, B=512.
    spec, G, h0 = tasks["anm6"]
    C = G.shape[0]
    lanes = jax.jit(lambda px, py, h: project_polytope_lanes(px, py, G, h))
    points = jax.jit(lambda pts, h: project_polytope(pts, jnp.broadcast_to(G, (pts.shape[0],) + G.shape), h))
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        B = 512
        h = np.repeat(h0[:, :, None], B, axis=2)
        h[: spec.n_gen, POLY_ROW_P_CAP] = rng.uniform(0.0, 0.6, (spec.n_gen, B))
        h[spec.n_gen :, POLY_ROW_P_CAP] = rng.uniform(0.0, 0.6, (spec.n_des, B))
        h[spec.n_gen :, POLY_ROW_P_FLOOR] = rng.uniform(0.0, 0.6, (spec.n_des, B))
        scale = np.where(np.arange(B) < B // 2, 0.3, 1.5)
        px = rng.uniform(-1.0, 1.0, (C, B)) * scale
        py = rng.uniform(-1.0, 1.0, (C, B)) * scale
        jx, jy = lanes(jnp.asarray(px), jnp.asarray(py), jnp.asarray(h))
        pts = np.stack([px.T, py.T], axis=-1)
        ref = np.asarray(points(jnp.asarray(pts), jnp.asarray(np.moveaxis(h, 2, 0))))
        p = "matches/%d/" % seed
        out.update({p + "inputs_sha256": np.array(digest(px, py, h)), p + "lanes_x": np.asarray(jx),
                    p + "lanes_y": np.asarray(jy), p + "points": ref})
    save("projection", out)

    # test_torch_projection_forms: each task's polytopes, every JAX form.
    out = {}
    for name, (spec, G, h0) in tasks.items():
        px, py, h = forms_case(G, h0, spec.n_gen, FORMS_B, FORMS_SEED)
        p = name + "/"
        out.update({p + "G": G, p + "px": px, p + "py": py, p + "h": h})
        args = (jnp.asarray(px), jnp.asarray(py), G, jnp.asarray(h))
        for form, fn in (("running_min", project_polytope_lanes), ("stacked", project_polytope_lanes_stacked),
                         ("box_slants", project_box_slants_lanes)):
            x, y = fn(*args)
            out[p + form + "/x"], out[p + form + "/y"] = np.asarray(x), np.asarray(y)
        pts = np.stack([px.T, py.T], axis=-1)  # [B, C, 2]
        Gb = np.broadcast_to(G, (FORMS_B,) + G.shape)
        out[p + "polytope"] = np.asarray(project_polytope(jnp.asarray(pts), jnp.asarray(Gb), jnp.asarray(np.moveaxis(h, 2, 0))))
        # eps= reaches the lanes form: a tolerance of 0.05 admits points up
        # to 0.05 (1 + |h|) outside a row.
        x, y = project_polytope_lanes(*args, eps=0.05)
        out[p + "running_min_eps/x"], out[p + "running_min_eps/y"] = np.asarray(x), np.asarray(y)
    save("projection_forms", out)


REFS = {
    "env": refs_env,
    "step": refs_step,
    "gym_env": refs_gym_env,
    "vector_env": refs_vector_env,
    "power_flow": refs_power_flow,
    "randomized": refs_randomized,
    "projection": refs_projection,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(REFS), help="record only these test files' references")
    args = ap.parse_args()
    for name in args.only or REFS:
        REFS[name]()


if __name__ == "__main__":
    main()
