"""feeder141's plain paths replayed through the committed references.

No JAX program is compiled at 141 buses here: feeder141's paths are held in
float64 against the reference the JAX package made in float64 through
``scan`` (``tests/data/onchip_ref_feeder141.npz``): the dense NR paths on 8
lanes and 4 steps, the chord-only, ``tree_xla`` and ``fused`` (the
whole-transition kernel's plain twin in its tree form) paths on all 64
lanes and 16 steps, with no kernel launch counted; ``check.run_check`` replays a
reference through a path.  Few tests, so that the file runs after the
longest files have started."""

import torch

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.envs.feeder141 import make_core
from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda

# The float64 reference's own storage is float32: 5e-8 of the state's range.
F64_ATOL = 1e-6


def _counts():
    return tree_cuda.KERNEL_LAUNCHES, nr_cuda.KERNEL_LAUNCHES, step_cuda.KERNEL_LAUNCHES


def _replay(method, lanes, T):
    """The feeder141 reference's first ``lanes`` lanes and ``T`` steps through
    ``method`` in float64 on the CPU, compared under the ``check.py`` rule;
    no kernel launch is counted."""
    data = check.load_reference("feeder141")
    before = _counts()
    core = make_core(dtype=torch.float64, device="cpu", pf_method=method)
    sv, rw, tm = check.rollout_given(core, data["s0"][:lanes], data["actions"][:T, :lanes], data["vars"][:T, :lanes])
    assert _counts() == before
    ref = {k: data[k][:T, :lanes] for k in ("state_vec", "reward", "terminated")}
    return check.compare_trajectories(ref, {"state_vec": sv.numpy(), "reward": rw.numpy(), "terminated": tm.numpy()})


def test_feeder141_dense_nr_replays_f64():
    for method in ("scan", "while"):
        res = _replay(method, 8, 4)
        assert res["term_mismatch_frac"] == 0.0 and res["n_compared_lane_steps"] == 32, method
        assert res["max_state_div"] <= F64_ATOL and res["max_reward_div"] <= F64_ATOL, (method, res)


def test_feeder141_chord_only_replays_f64():
    for method in ("hybrid", "xla_hybrid"):
        res = _replay(method, 64, 16)
        assert res["pass"] and res["term_mismatch_frac"] == 0.0 and res["n_compared_lane_steps"] == 64 * 16, method


def test_feeder141_tree_xla_replays_f64():
    res = _replay("tree_xla", 64, 16)
    assert res["pass"] and res["term_mismatch_frac"] == 0.0 and res["n_compared_lane_steps"] == 64 * 16
    assert res["max_state_div"] <= F64_ATOL and res["max_reward_div"] <= F64_ATOL


def test_feeder141_fused_replays_f64():
    res = _replay("fused", 64, 16)
    assert res["pass"] and res["term_mismatch_frac"] == 0.0 and res["n_compared_lane_steps"] == 64 * 16
    assert res["max_state_div"] <= F64_ATOL and res["max_reward_div"] <= F64_ATOL


def test_run_check():
    for env, method in (("anm6easy", "scan"), ("feeder141", "tree_xla")):
        res = check.run_check(env, check.task_make_core(env), methods={method: {}}, dtype=torch.float64,
                              device="cpu")
        assert set(res) == {method, "pass"} and res["pass"] and res[method]["pass"], env
        assert res[method]["term_mismatch_frac"] <= (0.0 if env == "feeder141" else 0.02)
