"""Interact with the port's ANM6Easy-v0 task using random actions, with rendering.

The PyTorch counterpart of examples/random_agent.py: the environment comes
from ``gymnasium.make`` through the port's namespaced id, computes on the
card (``--device cpu`` for the CPU), and each step is rendered live in the
browser, or recorded and written as one standalone HTML file with
``--replay PATH``.

    python examples/torch_random_agent.py [--device cpu] [--steps 10] [--replay episode.html]
"""
import argparse
import time

import gymnasium as gym

ENV_ID = "gym_anm_tpu_torch.envs.registration:gym_anm_tpu_torch/ANM6Easy-v0"


def run(device="cuda", steps=10, replay=None):
    env = gym.make(ENV_ID, device=device)
    o, _ = env.reset(seed=0)
    mode = "human" if replay is None else "replay"
    env.unwrapped.render(mode=mode)

    for i in range(steps):
        a = env.action_space.sample()
        o, r, terminated, _, _ = env.step(a)
        env.unwrapped.render()
        print(f"t={i}, r_t={r:.3f}")
        if replay is None:
            time.sleep(0.5)  # otherwise the rendering is too fast for the human eye

        if terminated:
            o, _ = env.reset()
    if replay is not None:
        print("replay written to", env.unwrapped.write_replay(replay))
    env.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--replay", default=None, help="write a replay HTML file here instead of rendering live")
    args = parser.parse_args()
    run(args.device, args.steps, args.replay)
