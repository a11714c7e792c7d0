"""gym-anm-tpu-torch: the PyTorch / CUDA port of gym-anm-tpu.

Batched lockstep Active Network Management environments on an NVIDIA GPU.
Plain tensor code is PyTorch; the tree-structured Newton-Raphson power-flow
solve is a hand-written CUDA kernel (``csrc/tree_nr.cu``), built at first
use.  The package mirrors the module paths of the JAX package
``gym_anm_tpu`` and imports neither JAX nor Gymnasium.

Main path: :func:`gym_anm_tpu_torch.envs.anm6.anm6_easy.make_core` ->
:class:`gym_anm_tpu_torch.envs.batched.BatchedEnv` -> ``EnvCore.step`` ->
``transition`` -> ``ops.tree_cuda.solve_pfe_tree``.
"""
