"""The port's ANM6Easy env core against the JAX package's, in float64.

The same initial states, actions and internal variables (made with numpy)
go through ``env_state_from_s0`` and ``step`` of both cores; the JAX PRNG
streams cannot be reproduced, so the task hooks are checked for what they
must give: ``next_vars`` exactly, and initial states on the profile tables
and inside their bounds.

The feeder33 runs and feeder141's core constants and refusals are the JAX
package's outputs recorded by ``scripts/gen_torch_test_refs.py`` in
``tests/data/torch_refs_env.npz`` (their programs take minutes to compile);
the ANM6Easy runs compare live."""

import functools
import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu.envs.anm6.anm6_easy import make_core as jax_make_core

from gym_anm_tpu_torch.core.state import SIM_FIELDS, env_state_from_numpy
from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series, make_core


def _inputs(core, B, seed):
    """Initial states from the port's distribution and uniform actions."""
    g = torch.Generator().manual_seed(seed)
    s0 = core.init_state_fn(g, B).numpy()
    rng = np.random.default_rng(seed)
    lo, hi = core.action_low, core.action_high
    actions = rng.uniform(lo, hi, (2, B, lo.shape[0]))
    return s0, actions


def _step_both(core, jcore, jstep, es, jes, action):
    vars = core.next_vars_fn(es.state_vec, None)
    jvars = jax.vmap(jcore.next_vars_fn, in_axes=(0, None))(jes.state_vec, None)
    np.testing.assert_array_equal(vars.numpy(), np.asarray(jvars))
    es, out = core.step(es, torch.tensor(action), vars)
    jes, jout = jstep(jes, jnp.asarray(action), jvars)
    return es, out, jes, jout


def _assert_out_close(out, jout):
    np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(jout.terminated))
    for k in ("state_vec", "obs", "reward", "e_loss", "penalty"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(jout, k)), rtol=0, atol=1e-8, err_msg=k)


def test_env_core_matches_jax_f64():
    # A 3-iteration power-flow budget leaves some step solves unconverged,
    # so both live and terminated lanes occur.
    core = make_core(dtype=torch.float64, device="cpu", pf_max_iter=3)
    jcore = jax_make_core(dtype=jnp.float64, pf_max_iter=3)
    B = 128
    s0, actions = _inputs(core, B, 0)

    es = core.env_state_from_s0(torch.tensor(s0))
    jes = jax.jit(jcore.env_state_from_s0)(s0)
    np.testing.assert_array_equal(es.terminated.numpy(), np.asarray(jes.terminated))
    np.testing.assert_allclose(es.state_vec.numpy(), np.asarray(jes.state_vec), rtol=0, atol=1e-8)
    np.testing.assert_allclose(core.observation(es).numpy(), np.asarray(jcore.observation(jes)), rtol=0, atol=1e-8)

    prev0 = es.terminated.numpy()
    jstep = jax.jit(jcore.step)  # one compile for both steps
    es, out, jes, jout = _step_both(core, jcore, jstep, es, jes, actions[0])
    _assert_out_close(out, jout)
    # Newly collapsed lanes get the terminal reward -c2 / (1 - gamma); lanes
    # terminated before the step get 0.
    new = out.terminated.numpy() & ~prev0
    assert new.any() and not out.terminated.numpy().all()
    np.testing.assert_allclose(out.reward.numpy()[new], -100.0 / (1.0 - 0.995))
    assert not out.reward.numpy()[prev0].any()

    # The JAX state carried into the port (its arrays as numpy) steps alike.
    carried = env_state_from_numpy(
        {k: np.asarray(getattr(jes.sim, k)) for k in SIM_FIELDS},
        np.asarray(jes.aux), np.asarray(jes.terminated), np.asarray(jes.state_vec), device="cpu", dtype=torch.float64,
    )
    es2, out2, _, jout2 = _step_both(core, jcore, jstep, carried, jes, actions[1])
    _assert_out_close(out2, jout2)
    # Terminated lanes earn 0 and stay in the zero state.
    prev = out.terminated
    assert bool((out2.reward[prev] == 0).all()) and bool((out2.state_vec[prev] == 0).all())
    assert bool((out2.obs[prev] == 0).all())


def test_init_state_on_profiles_and_in_bounds():
    core = make_core(dtype=torch.float32, device="cpu")
    s0 = core.init_state_fn(torch.Generator().manual_seed(1), 4096).numpy().astype(np.float64)
    loads, gens = _get_load_time_series(), _get_gen_time_series()
    t0 = s0[:, -1].astype(int)
    assert np.array_equal(s0[:, -1], t0) and t0.min() >= 0 and t0.max() <= 95
    assert len(np.unique(t0)) == 96
    for i, dev_id in enumerate([1, 3, 5]):
        np.testing.assert_allclose(s0[:, dev_id], loads[i, t0], rtol=1e-6)
        np.testing.assert_allclose(s0[:, 7 + dev_id], 0.2 * loads[i, t0], rtol=1e-6)
    for idx, (dev_id, qmax) in enumerate(zip([2, 4], [0.3, 0.5])):
        np.testing.assert_allclose(s0[:, dev_id], gens[idx, t0], rtol=1e-6)
        np.testing.assert_allclose(s0[:, 15 + idx], gens[idx, t0], rtol=1e-6)
        q = s0[:, 7 + dev_id]
        assert q.min() >= -qmax and q.max() <= qmax and q.std() > 0.2 * qmax
    soc = s0[:, 14]
    assert soc.min() >= 0.0 and soc.max() <= 1.0 and soc.std() > 0.2
    # Slack entries and the storage injection start at zero.
    assert not s0[:, [0, 6, 7, 13]].any()
    # Every sampled state converges (the task's reset budget is 1).
    es, out = core.reset(torch.Generator().manual_seed(2), 256)
    assert not bool(out.failed.any()) and int(out.n_tries.max()) == 1


# Each port method against the JAX method it reproduces on this CPU (the JAX
# package runs "pallas"/"fused" as its scan solver and "fused_hybrid"/
# "xla_hybrid" as its hybrid solver off the TPU).
JAX_METHOD = {
    "tree": "tree", "pallas": "scan", "fused": "scan", "scan": "scan", "while": "while",
    "hybrid": "hybrid", "fused_hybrid": "hybrid", "xla_hybrid": "hybrid",
}
T_STEPS = 4
# The warm-started run solves to this mismatch: in the first step some lanes'
# warm and flat mismatches tie to the last bit (a bus whose injection was
# zero at the reset leaves the same mismatch at both points), so which start
# a lane takes is decided by rounding, which XLA's fusion of the JAX program
# moves.  Solved this far, both starts end at the same point to ~1e-12.
WARM_X_TOL = 1e-10
# The dense warm runs, held to 1e-8 MW/MVAr, solve further still: a solve to
# x_tol p.u. leaves the slack power up to ~x_tol x baseMVA from another
# framework's solve of the same point.
DENSE_WARM_X_TOL = 1e-11


def _warm_x_tol(method):
    return WARM_X_TOL if method == "tree" else DENSE_WARM_X_TOL
# The JAX runs each task's cases compare against: (method, warm_start).
JAX_RUNS = {
    "anm6easy": (
        ("scan", False), ("while", False), ("hybrid", False), ("tree", True), ("scan", True), ("hybrid", True),
    ),
    "feeder33": (("scan", False), ("hybrid", False)),
}


def _jax_replay(jcore, s0, actions, vars_seq):
    """The body of ``gym_anm_tpu.check.rollout_given``, traced inside a larger
    program."""
    es0 = jcore.env_state_from_s0(s0)

    def body(es, xs):
        es, out = jcore.step(es, *xs)
        return es, (out.state_vec, out.reward, out.terminated)

    return jax.lax.scan(body, es0, (actions, vars_seq))[1]


REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_env.npz")


@functools.lru_cache(maxsize=None)
def _refs():
    with np.load(REFS) as z:
        return {k: z[k] for k in z.files}


def _digest(*arrays):
    """``scripts/gen_torch_test_refs.py::digest``."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _jax_trajectories(env):
    """The first ``T_STEPS`` steps of the committed reference inputs through
    the JAX package's core for every run of ``JAX_RUNS[env]``, in float64:
    ANM6Easy's compiled as one program (one compile instead of one a run),
    feeder33's read from the recorded reference."""
    from gym_anm_tpu_torch import check

    ref = check.load_reference(env)
    args = [np.asarray(a, np.float64) for a in (ref["s0"], ref["actions"][:T_STEPS], ref["vars"][:T_STEPS])]
    if env == "feeder33":
        refs = _refs()
        assert str(refs["feeder33/inputs_sha256"]) == _digest(*args), "re-run scripts/gen_torch_test_refs.py"
        return {(m, w): [refs["feeder33/%s/%s" % (m, k)] for k in ("state_vec", "reward", "terminated")]
                for m, w in JAX_RUNS[env]}
    cores = {}
    for method, warm in JAX_RUNS[env]:
        cores[method, warm] = jax_make_core(dtype=jnp.float64, pf_method=method, warm_start=warm)
        if warm:
            cores[method, warm].x_tol = _warm_x_tol(method)
    run = jax.jit(lambda s0, a, v: {key: _jax_replay(c, s0, a, v) for key, c in cores.items()})
    return {key: [np.asarray(x) for x in traj] for key, traj in run(*map(jnp.asarray, args)).items()}


def _port_matches_jax(env, method, warm_start=False, atol=1e-7):
    """A few steps of the committed reference inputs through the port's core
    and the JAX package's, in float64, with the task's calibrated budgets."""
    from gym_anm_tpu_torch import check

    ref = check.load_reference(env)
    core = check.task_make_core(env)(dtype=torch.float64, device="cpu", pf_method=method, warm_start=warm_start)
    if warm_start:
        core.x_tol = _warm_x_tol(JAX_METHOD[method])
    sv, rw, tm = check.rollout_given(core, ref["s0"], ref["actions"][:T_STEPS], ref["vars"][:T_STEPS])
    jsv, jrw, jtm = _jax_trajectories(env)[JAX_METHOD[method], warm_start]
    np.testing.assert_array_equal(tm.numpy(), jtm)
    np.testing.assert_allclose(sv.numpy(), jsv, rtol=0, atol=atol)
    np.testing.assert_allclose(rw.numpy(), jrw, rtol=0, atol=atol)


@pytest.mark.parametrize(
    "env, method",
    [("anm6easy", m) for m in ("pallas", "hybrid", "fused", "fused_hybrid", "scan", "while", "xla_hybrid")]
    + [("feeder33", m) for m in ("pallas", "hybrid", "fused", "fused_hybrid")],
)
def test_env_core_methods_match_jax_f64(env, method):
    _port_matches_jax(env, method)


def test_env_core_warm_start_matches_jax_f64():
    """``warm_start=True`` on the tree path: each step's solve starts from
    the previous step's voltages (reset solves and absorbing lanes from the
    flat start), in the port and in the JAX package alike (to
    ``WARM_X_TOL``)."""
    _port_matches_jax("anm6easy", "tree", warm_start=True)


@pytest.mark.parametrize("method", ["pallas", "hybrid", "scan"])
def test_env_core_warm_start_dense_matches_jax_f64(method):
    """``warm_start=True`` on the dense paths (the dense-NR kernel's warm
    form and the plain solver's ``init=``), against the JAX package's warm
    scan and hybrid solvers (to ``DENSE_WARM_X_TOL``)."""
    _port_matches_jax("anm6easy", method, warm_start=True, atol=1e-8)


def test_feeder33_hooks():
    from gym_anm_tpu_torch.envs.feeder33 import make_core as f33_make_core, pf_max_iter_for

    core = f33_make_core(dtype=torch.float32, device="cpu")
    spec = core.spec
    assert core.max_iter == 10 and pf_max_iter_for("hybrid") == 6 and pf_max_iter_for("pallas") == 15
    g = torch.Generator().manual_seed(0)
    s0 = core.init_state_fn(g, 512).numpy().astype(np.float64)
    assert s0.shape == (512, core.expected_s0_n)
    t0 = s0[:, -1]
    assert np.array_equal(t0, np.round(t0)) and t0.min() >= 0 and t0.max() <= 95
    daily = 0.75 + 0.25 * np.sin(2 * np.pi * (t0 / 96.0 - 0.3))
    load_pos, gen_pos = np.asarray(spec.load_pos), np.asarray(spec.gen_pos)
    frac = s0[:, load_pos] / (-np.asarray(spec.load_p_min) * spec.baseMVA * daily[:, None])
    assert -0.9 - 1e-5 <= frac.min() and frac.max() <= -0.3 + 1e-5
    np.testing.assert_allclose(s0[:, spec.n_dev + load_pos], 0.25 * s0[:, load_pos], rtol=1e-6)
    pots = s0[:, gen_pos] / (np.asarray(spec.gen_p_max) * spec.baseMVA)
    assert 0.2 - 1e-6 <= pots.min() and pots.max() <= 1.0 + 1e-6
    np.testing.assert_array_equal(s0[:, 2 * spec.n_dev + spec.n_des : -1], s0[:, gen_pos])
    soc = s0[:, 2 * spec.n_dev : 2 * spec.n_dev + spec.n_des] / (np.asarray(spec.des_soc_max) * spec.baseMVA)
    assert soc.min() >= 0.0 and soc.max() <= 1.0 and soc.std() > 0.2
    vars = core.next_vars_fn(torch.tensor(s0, dtype=torch.float32), g).numpy()
    assert vars.shape == (512, core.expected_vars_n)
    np.testing.assert_array_equal(vars[:, -1], (t0 + 1) % 96)
    es, out = core.reset(g, 128)
    assert not bool(out.failed.any())


def test_feeder141_hooks_and_refusals():
    from gym_anm_tpu_torch.envs.feeder141 import make_core as f141_make_core

    core = f141_make_core(dtype=torch.float32, device="cpu")
    # The JAX package's feeder141 core (float32) and its refusals, recorded.
    j = {k[len("feeder141/"):]: v for k, v in _refs().items() if k.startswith("feeder141/")}
    assert core.spec.n_bus == 141 and core.pf_method == "tree" and core.grid.tree is not None
    assert (core.max_iter, core.x_tol) == (int(j["max_iter"]), float(j["x_tol"])) == (18, 3e-5)
    assert (core.state_n, core.action_n, core.K) == tuple(int(j[k]) for k in ("state_n", "action_n", "K"))
    np.testing.assert_array_equal(core.action_low, j["action_low"])
    f64 = f141_make_core(dtype=torch.float64, device="cpu", warm_start=True)
    assert f64.x_tol == float(j["f64_x_tol"]) == 1e-5 and f64.warm_start
    # The JAX package refuses the three dense-kernel methods here; the port
    # refuses two of them, and "fused" only with pivoting: without it, its
    # whole-transition kernel solves this radial grid in its tree form.
    for method in ("pallas", "fused", "fused_hybrid"):
        kw = dict(nr_pivot=True) if method == "fused" else {}
        with pytest.raises(ValueError, match="unsupported at 141 buses"):
            f141_make_core(device="cpu", pf_method=method, **kw)
        assert "unsupported at 141 buses" in str(j["refusal/" + method])
    for method in ("hybrid", "xla_hybrid", "scan", "while", "tree_xla", "fused"):
        assert f141_make_core(device="cpu", pf_method=method).pf_method == method
    fused = f141_make_core(device="cpu", pf_method="fused")
    assert (fused.max_iter, fused.x_tol) == (18, 3e-5) and fused.grid.step.tree is fused.grid.tree
    g = torch.Generator().manual_seed(0)
    es, out = core.reset(g, 16)
    assert not bool(out.failed.any()) and out.state_vec.shape == (16, core.state_n)
    vars = core.next_vars_fn(es.state_vec, g)
    assert vars.shape == (16, core.expected_vars_n)
    np.testing.assert_array_equal(vars[:, -1].numpy(), ((es.state_vec[:, -1] + 1) % 96).numpy())
