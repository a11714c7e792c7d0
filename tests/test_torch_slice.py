"""The port's ANM6Easy slice end to end on the CPU.

Replays ``tests/data/onchip_ref_anm6easy.npz`` (B=256, T=64: committed
initial states, actions, internal variables and the host-float64
trajectory they produce) through the port:

* in float64 against the JAX package's ``check.rollout_given`` in float64:
  termination equal everywhere, states and rewards to 1e-7;
* in float32 against the committed reference under the ``check.py`` rule.

Also drives ``BatchedEnv`` (reset, uniform-action rollout) at a small
batch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu import check as jcheck
from gym_anm_tpu.envs.anm6.anm6_easy import make_core as jax_make_core

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.ops import tree_cuda


@pytest.fixture(scope="module")
def ref():
    return check.load_reference("anm6easy")


def test_replay_f64_matches_jax(ref):
    sv, rw, tm = check.rollout_given(make_core(dtype=torch.float64), ref["s0"], ref["actions"], ref["vars"])
    jsv, jrw, jtm = jcheck.rollout_given(jax_make_core(dtype=jnp.float64), ref["s0"], ref["actions"], ref["vars"])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))
    assert 0.2 < tm.numpy()[-1].mean() < 0.8
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), rtol=0, atol=1e-7)
    np.testing.assert_allclose(rw.numpy(), np.asarray(jrw), rtol=0, atol=1e-7)


def test_replay_f32_passes_reference_check(ref):
    core = make_core(dtype=torch.float32)
    sv, rw, tm = check.rollout_given(core, ref["s0"], ref["actions"], ref["vars"])
    assert sv.dtype == torch.float32 and sv.shape == ref["state_vec"].shape
    res = check.compare_trajectories(
        {k: ref[k] for k in ("state_vec", "reward", "terminated")},
        {"state_vec": sv.numpy(), "reward": rw.numpy(), "terminated": tm.numpy()},
    )
    assert res["pass"], res
    assert res["term_mismatch_frac"] == 0.0


def test_batched_env_rollout_cpu():
    core = make_core(dtype=torch.float32, device="cpu")
    env = BatchedEnv(core, 64, generator=torch.Generator().manual_seed(3))
    before = tree_cuda.KERNEL_LAUNCHES
    es, first = env.reset()
    assert first.obs.shape == (64, 18) and not bool(first.terminated.any())
    assert bool((first.obs[:, -1] >= 0).all()) and bool((first.obs[:, -1] <= 95).all())
    es, (reward, terminated) = env.rollout(es, 4)
    assert reward.shape == (4, 64) and terminated.shape == (4, 64)
    assert bool(torch.isfinite(reward).all())
    # Terminated lanes stay terminated; the time of day advances on live lanes.
    assert bool((terminated[1:] >= terminated[:-1]).all())
    live = ~terminated[-1]
    np.testing.assert_array_equal(
        es.state_vec[live, -1].numpy(), ((first.state_vec[live, -1] + 4) % 96).numpy()
    )
    assert tree_cuda.KERNEL_LAUNCHES == before  # CPU tensors never launch the kernel
    with pytest.raises(ValueError, match="device"):
        BatchedEnv(core, 8, device="meta")
