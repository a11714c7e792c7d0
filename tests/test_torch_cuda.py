"""The port's CUDA kernels on a GPU (every test skips without one).

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

* each kernel (tree NR, dense NR, the fused transition) against its plain
  PyTorch twin on the card, at a batch that is not a multiple of the block
  size;
* the wrappers refuse float64 and non-contiguous inputs, and the dense
  kernels grids beyond their 64-unknown system;
* the ANM6Easy env core on the GPU (kernel) against the same core on the
  CPU (plain version), from the same initial states and actions, for the
  tree and the fused paths.
"""

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda
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


def _agree(conv_k, conv_p, pairs, atol, it_k=None, it_p=None):
    """The kernels' agreement rule: converged flags on >= 99% of lanes, the
    values within atol on lanes both converged, |dn_iter| <= 1 on >= 97%."""
    assert float((conv_k == conv_p).float().mean()) >= 0.99 and float(conv_k.float().mean()) > 0.5
    both = conv_k & conv_p
    for a, b in pairs:
        assert float((a - b).abs()[..., both].max()) <= atol
    if it_k is not None:
        dit = (it_k.long() - it_p.long()).abs()[both]
        assert float((dit <= 1).float().mean()) >= 0.97 and int(dit.max()) <= 4


@pytest.mark.gpu
@pytest.mark.parametrize("chord, pivot", [(0, False), (16, True)])
@pytest.mark.parametrize("name, amp", [("anm6", 0.3), ("feeder33", 0.05)])
def test_cuda_nr_kernel_matches_plain(name, amp, chord, pivot):
    _need_cuda()
    net = {"anm6": anm6_network, "feeder33": make_feeder_network()}[name]
    g = GridTensors.from_spec(build_grid(net, 0.25, 100, dtype=np.float32)[0], "cuda", torch.float32)
    rng = np.random.default_rng(1)
    m, B = g.spec.n_bus - 1, 1000
    p = torch.tensor(rng.uniform(-amp, amp, (m, B)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (m, B)).astype(np.float32), device="cuda")
    kw = dict(x_tol=1e-5, max_iter=15, chord_iters=chord, pivot=pivot)
    before = nr_cuda.KERNEL_LAUNCHES
    vr, vi, d, it = nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
    torch.cuda.synchronize()
    assert nr_cuda.KERNEL_LAUNCHES == before + 1
    pvr, pvi, _, _, pd, pit = nr_cuda.nr_core_plain(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
    _agree(d <= 1e-5, pd <= 1e-5, [(vr, pvr), (vi, pvi)], 5e-5, it, pit)


def _step_lanes(core, B, seed):
    """Transition inputs a rollout of the task would give, packed batch-last."""
    env = BatchedEnv(core, B, generator=torch.Generator(device=core.device).manual_seed(seed))
    es, _ = env.reset()
    vars = core.next_vars_fn(es.state_vec, env.generator)
    return step_cuda.pack_inputs(**core.transition_inputs(es, env.random_actions(), vars))


@pytest.mark.gpu
@pytest.mark.parametrize("chord", [0, 16])
@pytest.mark.parametrize("env", ["anm6easy", "feeder33"])
def test_cuda_step_kernel_matches_plain(env, chord):
    _need_cuda()
    core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method="fused")
    st = core.grid.step
    lanes = _step_lanes(core, 1000, 2)
    kw = dict(x_tol=1e-5, max_iter=15, chord_iters=chord)
    before = step_cuda.KERNEL_LAUNCHES
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, **kw))
    torch.cuda.synchronize()
    assert step_cuda.KERNEL_LAUNCHES == before + 1
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, **kw))
    fields = [f for f in k._fields if f not in ("penalty", "n_iter")]
    conv_k, conv_p = k.diff[:, 0] <= 1e-5, p.diff[:, 0] <= 1e-5
    _agree(conv_k, conv_p, [(getattr(k, f).T, getattr(p, f).T) for f in fields], 5e-5, k.n_iter[:, 0], p.n_iter[:, 0])
    _agree(conv_k, conv_p, [(k.penalty.T, p.penalty.T)], 5e-3)


@pytest.mark.gpu
def test_cuda_dense_kernels_refuse_what_they_do_not_take():
    _need_cuda()
    g = GridTensors.from_spec(build_grid(anm6_network, 0.25, 100, dtype=np.float32)[0], "cuda", torch.float32)
    p = torch.zeros((5, 64), device="cuda")
    before = nr_cuda.KERNEL_LAUNCHES, step_cuda.KERNEL_LAUNCHES
    with pytest.raises(TypeError):
        nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p.double(), p.double())
    with pytest.raises(ValueError, match="contiguous"):
        nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p.T.contiguous().T, p)
    with pytest.raises(TypeError):  # the dispatcher has no float64 GPU path
        nr_cuda.solve_pfe_nr(g.Y_re.double(), g.Y_im.double(), g.J0inv.double(), p.T.double(), p.T.double())
    spec141, _ = build_grid(make_multi_feeder_network(), 0.25, 100, dtype=np.float32)
    g141 = GridTensors.from_spec(spec141, "cuda", torch.float32)
    p141 = torch.zeros((140, 64), device="cuda")
    with pytest.raises(ValueError, match="64"):
        nr_cuda.solve_pfe_nr_cuda(g141.Y_re, g141.Y_im, g141.J0inv, p141, p141)
    st = g.step
    lanes = torch.zeros((sum(st.in_rows), 64), device="cuda")
    with pytest.raises(TypeError):
        step_cuda.fused_transition_cuda(st, lanes.double())
    with pytest.raises(ValueError, match="contiguous"):
        step_cuda.fused_transition_cuda(st, lanes.T.contiguous().T)
    g64 = GridTensors.from_spec(build_grid(anm6_network, 0.25, 100, dtype=np.float64)[0], "cuda", torch.float64)
    with pytest.raises(TypeError):
        step_cuda.fused_transition_cuda(g64.step, lanes.double())
    assert (nr_cuda.KERNEL_LAUNCHES, step_cuda.KERNEL_LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    # Two float32 solves converged to x_tol = 1e-5 p.u. may sit a few x_tol
    # apart, i.e. a few 1e-3 MW/MVAr in the state vector (baseMVA = 100).
    # The fused path's kernel and CPU twin also differ in the projection and
    # flows, and its slack power has been seen 1.6e-3 MVAr apart on one lane.
    "pf_method, counter, atol", [("tree", tree_cuda, 1e-3), ("fused", step_cuda, 5e-3)], ids=["tree", "fused"]
)
def test_cuda_env_core_matches_cpu(pf_method, counter, atol):
    _need_cuda()
    gpu = make_core(torch.float32, "cuda", pf_method=pf_method)
    cpu = make_core(torch.float32, "cpu", pf_method=pf_method)
    B, T = 512, 4
    s0 = cpu.init_state_fn(torch.Generator().manual_seed(0), B)
    rng = np.random.default_rng(0)
    actions = rng.uniform(cpu.action_low, cpu.action_high, (T, B, cpu.action_n)).astype(np.float32)
    before = counter.KERNEL_LAUNCHES
    es_g, es_c = gpu.env_state_from_s0(s0.cuda()), cpu.env_state_from_s0(s0)
    for t in range(T):
        es_g, out_g = gpu.step_with_generator(es_g, torch.tensor(actions[t], device="cuda"), None)
        es_c, out_c = cpu.step_with_generator(es_c, torch.tensor(actions[t]), None)
        agree = (out_g.terminated.cpu() == out_c.terminated)
        assert float(agree.float().mean()) >= 0.99
        live = agree & ~out_c.terminated
        torch.testing.assert_close(out_g.state_vec.cpu()[live], out_c.state_vec[live], rtol=1e-4, atol=atol)
        torch.testing.assert_close(out_g.reward.cpu()[live], out_c.reward[live], rtol=1e-4, atol=atol)
    assert counter.KERNEL_LAUNCHES == before + 1 + T
