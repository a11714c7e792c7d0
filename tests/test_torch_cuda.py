"""The port's CUDA tree-NR kernel on a GPU (every test skips without one).

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

* the kernel against its plain PyTorch version on the ANM6, feeder33 and
  feeder141 grids, at a batch that is not a multiple of the block size;
* the wrapper refuses float64 and non-contiguous inputs;
* the ANM6Easy env core on the GPU (kernel) against the same core on the
  CPU (plain version), from the same initial states and actions.
"""

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops import tree_cuda
from gym_anm_tpu_torch.ops.tree_cuda import DeviceSchedule


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _slot_inputs(name, B, amp):
    net = {"anm6": anm6_network, "feeder33": make_feeder_network(), "feeder141": make_multi_feeder_network()}[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float32)
    ds = DeviceSchedule.from_spec(spec, "cuda", torch.float32)
    rng = np.random.default_rng(0)
    m = spec.n_bus - 1
    p = torch.tensor(rng.uniform(-amp, amp, (B, m)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (B, m)).astype(np.float32), device="cuda")
    zero = torch.zeros((1, B), device="cuda")
    pT = torch.cat([p.T, zero])[ds.slot_sel].contiguous()
    qT = torch.cat([q.T, zero])[ds.slot_sel].contiguous()
    return ds, pT, qT


@pytest.mark.gpu
@pytest.mark.parametrize("name, amp, x_tol", [("anm6", 0.3, 1e-5), ("feeder33", 0.05, 1e-5), ("feeder141", 0.02, 3e-5)])
def test_cuda_kernel_matches_plain(name, amp, x_tol):
    _need_cuda()
    ds, pT, qT = _slot_inputs(name, 1000, amp)
    before = tree_cuda.KERNEL_LAUNCHES
    k = tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, x_tol=x_tol, max_iter=12)
    torch.cuda.synchronize()
    assert tree_cuda.KERNEL_LAUNCHES == before + 1
    pl = tree_cuda.solve_pfe_tree_plain(ds, pT, qT, x_tol=x_tol, max_iter=12)
    ck, cp = k[2] <= x_tol, pl[2] <= x_tol
    assert float((ck == cp).float().mean()) >= 0.99 and float(ck.float().mean()) > 0.9
    both = ck & cp
    assert float((k[0] - pl[0]).abs()[:, both].max()) <= 5e-5
    assert float((k[1] - pl[1]).abs()[:, both].max()) <= 5e-5
    dit = (k[3] - pl[3]).abs()[both]
    assert float((dit <= 1).float().mean()) >= 0.97 and int(dit.max()) <= 4


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    ds, pT, qT = _slot_inputs("anm6", 256, 0.3)
    before = tree_cuda.KERNEL_LAUNCHES
    with pytest.raises(TypeError):
        tree_cuda.solve_pfe_tree_cuda(ds, pT.double(), qT.double())
    with pytest.raises(ValueError, match="contiguous"):
        tree_cuda.solve_pfe_tree_cuda(ds, pT.T.contiguous().T, qT)
    with pytest.raises(TypeError):  # the dispatcher has no float64 GPU path
        tree_cuda.solve_pfe_tree(ds, pT.T.double(), qT.T.double())
    assert tree_cuda.KERNEL_LAUNCHES == before


@pytest.mark.gpu
def test_cuda_env_core_matches_cpu():
    _need_cuda()
    gpu, cpu = make_core(torch.float32, "cuda"), make_core(torch.float32, "cpu")
    B, T = 512, 4
    s0 = cpu.init_state_fn(torch.Generator().manual_seed(0), B)
    rng = np.random.default_rng(0)
    actions = rng.uniform(cpu.action_low, cpu.action_high, (T, B, cpu.action_n)).astype(np.float32)
    before = tree_cuda.KERNEL_LAUNCHES
    es_g, es_c = gpu.env_state_from_s0(s0.cuda()), cpu.env_state_from_s0(s0)
    for t in range(T):
        es_g, out_g = gpu.step_with_generator(es_g, torch.tensor(actions[t], device="cuda"), None)
        es_c, out_c = cpu.step_with_generator(es_c, torch.tensor(actions[t]), None)
        agree = (out_g.terminated.cpu() == out_c.terminated)
        assert float(agree.float().mean()) >= 0.99
        live = agree & ~out_c.terminated
        torch.testing.assert_close(out_g.state_vec.cpu()[live], out_c.state_vec[live], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(out_g.reward.cpu()[live], out_c.reward[live], rtol=1e-4, atol=1e-3)
    assert tree_cuda.KERNEL_LAUNCHES == before + 1 + T
