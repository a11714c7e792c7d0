"""The port's examples (``examples/torch_*.py``) on the CPU, at their
smallest sizes.

Each case calls an example's ``run(...)`` (or the functions it has in its
place; of ``torch_train_robust_feeder33``, ``run_ppo``, whose fleet
``run_sac`` builds the same way) with ``device="cpu"``; the examples are
grouped into four tests so that the file stays small in the suite's
schedule.  What an example fixes inside (a trainer's rollout length, an
MPC's horizon and solver budget) is cut here through :func:`_smaller`, so
that every line of the example runs in a fraction of a second; the
trainers and agents themselves are held at full size by their own tests
(``tests/test_torch_ppo.py``, ``tests/test_torch_sac.py``,
``tests/test_torch_mpc*.py``).
"""

import importlib.util
import json
import math
import os

import torch


EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location("torch_example_" + name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smaller(cls, **small):
    """``cls`` with the keyword arguments ``small`` in place of the
    example's own."""
    return lambda *args, **kw: cls(*args, **{**kw, **small})


class _ShortADMM:
    """An MPC agent whose ADMM stops after its first chunk."""

    def _admm(self, lv, uv, **kw):
        return super()._admm(lv, uv, **{**kw, "max_chunks": 1})


def _finite(history, *keys):
    return all(math.isfinite(m[k]) for m in history for k in keys)


def test_rollout_and_env_examples(capsys, monkeypatch):
    rate = _example("torch_batched_rollout").run(batch=8, steps=2, device="cpu")
    assert rate > 0 and "env-steps/s on the host CPU" in capsys.readouterr().out

    fleet = _example("torch_randomized_fleet")
    means = fleet.run(n_variants=2, lanes=4, steps=2, device="cpu")
    assert len(means) == 2 and all(math.isfinite(m) for m in means)
    from gym_anm_tpu_torch import rl

    monkeypatch.setattr(rl, "PPOConfig", _smaller(rl.PPOConfig, rollout_steps=2))  # imported by train_robust
    history = fleet.train_robust(n_variants=2, lanes=4, iterations=1, device="cpu")
    assert len(history) == 1 and _finite(history, "loss", "mean_reward")

    simple = _example("torch_simple_env")
    rewards = simple.run(steps=2, device="cpu")
    assert len(rewards) == 2 and all(math.isfinite(r) for r in rewards)
    assert simple.SimpleEnvironment(device="cpu").simulator.N_bus == 2

    from gym_anm_tpu_torch.envs.anm_env import ANMEnv

    template = _example("torch_new_env_template").CustomEnvironment
    assert issubclass(template, ANMEnv)
    assert {"init_state", "next_vars", "observation_bounds", "render", "close"} <= set(vars(template))


def test_training_examples():
    ppo = _example("torch_train_ppo")
    ppo.PPOConfig = _smaller(ppo.PPOConfig, rollout_steps=2)
    history = ppo.run(iterations=1, batch=8, device="cpu")
    assert len(history) == 1 and _finite(history, "loss", "mean_reward")
    sac = _example("torch_train_sac")
    sac.SACConfig = _smaller(sac.SACConfig, collect_steps=2, grad_steps=2, train_batch=16)
    history = sac.run(iterations=1, batch=8, device="cpu")
    assert len(history) == 1 and _finite(history, "critic_loss", "actor_loss", "alpha", "mean_reward")


def test_robust_feeder33_example(tmp_path):
    example = _example("torch_train_robust_feeder33")
    example.PPOConfig = _smaller(example.PPOConfig, rollout_steps=2)
    out = tmp_path / "ppo.json"
    history = example.run_ppo(1, 2, 2, out=str(out), device="cpu")
    assert len(history) == 1 and _finite(history, "mean_reward")
    written = json.loads(out.read_text())
    assert written["env_steps"] == 2 * 2 * 2 and written["device"] == "cpu" and written["history"] == history


def test_mpc_examples():
    out = _example("torch_mpc_batched").run(batch_size=2, horizon=2, steps=1, device="cpu")
    assert out.reward.shape == (2,) and bool(torch.isfinite(out.reward).all())
    for name, agent in (("torch_mpc_constant", "MPCAgentConstant"), ("torch_mpc_perfect", "MPCAgentPerfect")):
        example = _example(name)
        short = type("Short" + agent, (_ShortADMM, getattr(example, agent)), {})
        setattr(example, agent, _smaller(short, planning_steps=2))
        rewards = example.run(steps=1, device="cpu")
        assert len(rewards) == 1 and math.isfinite(rewards[0])
