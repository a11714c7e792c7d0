"""gym-anm-tpu-torch: the PyTorch / CUDA port of gym-anm-tpu.

Batched lockstep Active Network Management environments on an NVIDIA GPU.
Plain tensor code is PyTorch; the three kernels of the JAX package are
hand-written CUDA kernels, built at first use: the tree-structured
Newton-Raphson power flow (``csrc/tree_nr.cu``), the dense Newton-Raphson
power flow (``csrc/nr_dense.cu``) and the whole transition
(``csrc/step_fused.cu``).  The package mirrors the module paths of the JAX package
``gym_anm_tpu`` and imports neither JAX nor Gymnasium.

Main path: :func:`gym_anm_tpu_torch.envs.anm6.anm6_easy.make_core` ->
:class:`gym_anm_tpu_torch.envs.batched.BatchedEnv` -> ``EnvCore.step`` ->
``transition`` -> ``ops.tree_cuda.solve_pfe_tree`` (``pf_method="tree"``),
``ops.nr_cuda.solve_pfe_nr`` (``"pallas"``, ``"hybrid"``) or
``ops.step_cuda.fused_transition`` (``"fused"``, ``"fused_hybrid"``).
Training: :mod:`gym_anm_tpu_torch.rl` (PPO, SAC) over ``BatchedEnv`` with
auto-reset; :mod:`gym_anm_tpu_torch.checkpoint` saves and restores state
trees.  Domain randomization: :mod:`gym_anm_tpu_torch.envs.randomized`
(G perturbed grid variants x L lanes, ``MultiBatchedEnv``, and the fleet
trainers); step rates and profiler traces:
:mod:`gym_anm_tpu_torch.profiling`.
"""
