"""Checkpoint and resume of the port's state trees (``checkpoint.py``), the
cases of ``tests/test_checkpoint.py`` on tensors: a mid-episode
``EnvState`` resumes the exact trajectory; structure, shape and dtype
mismatches raise; a plain tree of tensors, arrays and scalars round-trips;
trainers' checkpoints restore weights and optimiser state."""

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.checkpoint import load_pytree, save_pytree
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.rl import PPOConfig, PPOTrainer, SACConfig, SACTrainer


def _leaves(tree):
    from gym_anm_tpu_torch.checkpoint import _flatten

    out = []
    _flatten(tree, out)
    return out


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_env_state_roundtrip_resumes_identically(tmp_path):
    """Saving mid-episode and resuming reproduces the exact trajectory."""
    core = make_core(torch.float32, "cpu")
    env = BatchedEnv(core, 4, generator=torch.Generator().manual_seed(3))
    es, _ = env.reset()
    mid = torch.tensor(0.5 * (core.action_low + core.action_high), dtype=torch.float32)
    actions = mid[None].repeat(4, 1)
    es1, _ = env.step(es, actions)

    path = str(tmp_path / "mid_episode.npz")
    save_pytree(path, es1)
    es1b = load_pytree(path, like=es1)
    _tree_equal(es1, es1b)
    assert type(es1b) is type(es1) and es1b.sim.bus_v_re.dtype == torch.float32

    es2a, out2a = env.step(es1, actions)
    es2b, out2b = env.step(es1b, actions)
    _tree_equal(es2a, es2b)
    np.testing.assert_array_equal(out2a.reward.numpy(), out2b.reward.numpy())


def test_structure_and_shape_mismatches_raise(tmp_path):
    core = make_core(torch.float32, "cpu")
    es, _ = BatchedEnv(core, 2).reset()
    path = str(tmp_path / "state.npz")
    save_pytree(path, es)
    # Wrong structure: a plain dict is not an EnvState.
    with pytest.raises(ValueError, match="structure"):
        load_pytree(path, like={"a": torch.zeros(3)})
    # Wrong batch size: same structure, other leaf shapes.
    es8, _ = BatchedEnv(core, 8).reset()
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, like=es8)
    # Wrong dtype.
    es64, _ = BatchedEnv(make_core(torch.float64, "cpu"), 2).reset()
    with pytest.raises(ValueError, match="dtype"):
        load_pytree(path, like=es64)


def test_plain_pytree_roundtrip(tmp_path):
    tree = {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": (torch.ones(3), 7 * torch.ones(())),
        "n": torch.tensor(5),
        "meta": [np.arange(4, dtype=np.int16), 3, 0.5, True, None],
    }
    path = str(tmp_path / "tree.npz")
    save_pytree(path, tree)
    back = load_pytree(path, like=tree)
    _tree_equal(tree, back)
    assert back["meta"][1:] == [3, 0.5, True, None] and back["n"].dtype == torch.int64
    assert isinstance(back["b"], tuple) and back["meta"][0].dtype == np.int16


def test_trainer_checkpoints_roundtrip(tmp_path):
    core = make_core(torch.float32, "cpu")
    cfg = PPOConfig(rollout_steps=4, minibatches=2, epochs=1, hidden=(16, 16))
    t1 = PPOTrainer(core, 8, cfg, seed=0)
    t1.train(1)
    path = str(tmp_path / "ppo.npz")
    t1.save(path)
    t2 = PPOTrainer(core, 8, cfg, seed=1)
    t2.load(path)
    _tree_equal(t1._tree(), t2._tree())

    scfg = SACConfig(buffer_capacity=64, collect_steps=2, grad_steps=2, train_batch=16, hidden=(16, 16))
    s1 = SACTrainer(core, 8, scfg, seed=0)
    s1.train(1, warmup_rounds=1)
    path = str(tmp_path / "sac.npz")
    s1.save(path)
    s2 = SACTrainer(core, 8, scfg, seed=1)
    s2.load(path)
    _tree_equal(s1._tree(), s2._tree())
