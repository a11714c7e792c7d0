"""gym-anm-tpu-torch: the PyTorch / CUDA port of gym-anm-tpu.

Batched lockstep Active Network Management environments on an NVIDIA GPU.
Plain tensor code is PyTorch; the three kernels of the JAX package are
hand-written CUDA kernels, built at first use: the tree-structured
Newton-Raphson power flow (``csrc/tree_nr.cu``), the dense Newton-Raphson
power flow (``csrc/nr_dense.cu``) and the whole transition
(``csrc/step_fused.cu``).  The package mirrors the module paths of the JAX package
``gym_anm_tpu`` and imports no JAX.  Only the Gymnasium adapters import
Gymnasium, and nothing imports them unasked: ``envs/anm_env.py``
(``ANMEnv``), ``envs/anm6/anm6.py``, ``envs/anm6/anm6_easy_gym.py``,
``envs/feeder33_gym.py``, ``envs/feeder141_gym.py``, ``envs/vector.py``
(``ANMVectorEnv``, over the Gymnasium-free lockstep core of
``envs/vector_core.py``) and ``envs/registration.py`` (the ids
``gym_anm_tpu_torch/ANM6Easy-v0``, ``.../ANMFeeder33-v0`` and
``.../ANMFeeder141-v0``).  ``render/`` draws any environment in the
browser, live or as a standalone replay file.

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
