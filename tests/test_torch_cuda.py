"""The port's CUDA kernels on a GPU (every test skips without one).

Imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

* each kernel (tree NR, dense NR, the fused transition) against its plain
  PyTorch twin on the card, bit for bit at B in {1, 37, 1000}, so that
  teams and blocks are left partly filled; K1 on its three grids, cold and
  warm, with NaN and never-converging lanes; K2 cold and warm, and with
  pivoting on NaN, infinite and diverging lanes and on systems whose pivot searches
  meet ties and NaN columns, and K3 on a projection whose two nearest
  candidates tie;
* K3's tree form at B=4096 on ANM6Easy, feeder33, Baran and Wu's feeder
  (the budget of 15) and feeder141 (S = 140, past the dense form's 64
  unknowns, the budget of 18) in its launch geometry: bit for bit its plain
  twin, and its V, mismatch and iterations K1's on the same injections,
  counted as a tree launch, adding its iterations to its own counters and
  nothing to K1's; K3's dense form (pivoting, a chord prefix, a meshed
  grid) bit for bit its twin, counting no tree launch;
* the wrappers refuse float64 and non-contiguous inputs, the dense kernels
  grids beyond their 64-unknown system, and a launch whose lanes do not fit
  a block's shared memory raises;
* the ANM6Easy env core on the GPU (kernel) against the same core on the
  CPU (plain version), from the same initial states and actions, for the
  tree and pallas paths (each cold and warm-started) and the fused path;
* a domain-randomized fleet on the GPU against the same fleet on the CPU,
  per variant (ANM6Easy on the tree path, feeder33 on the fused path, the
  latter given the same internal variables), launching its path's kernel
  once per variant per step;
* ``StepRateCounter.measure`` on the card counts the device work its block
  queued;
* the lockstep core of ``ANMVectorEnv`` (``envs/vector_core.py``) on the
  card against the CPU from the same draws, reset lanes included, launching
  the tree kernel twice a step; its steps replayed from their CUDA graph
  against the eager steps, bit for bit, at B=4096 on ANM6Easy and feeder33
  (``tree``); the one-lane float64 step of ``ANMEnv``
  (``envs/single_core.py``) on the card against the CPU;
* the MPC agents' batched float64 solve (dense and banded) on the card
  against the same solve on the CPU, and a dense agent closing the loop of
  a B=64 ANM6Easy fleet through the tree kernel;
* feeder141's chord-only ``hybrid`` and ``tree_xla`` paths on the card
  against the committed reference, launching no kernel; the plain solver's
  chord product runs without TF32 when TF32 is on globally and matches a
  float64 product to float32 rounding; ``make_mesh`` over NCCL at world size 1;
* the projection's stacked form equal to the running minimum bit for bit
  on the card, box-slants within 2e-5, and the card's default form;
* ``BatchedEnv.step_fn`` replayed from its CUDA graph against the eager
  step, bit for bit, at B=4096: two pool rollouts of ANM6Easy (``tree``),
  feeder33 and feeder141 (``fused``, every K3 launch in the tree form) with
  the same kernel launches and K3 iteration counts, and one
  ``PPOTrainer.train_step``;
* K1's iteration counters: a launch adds what the plain twin's count of the
  same solve adds; graphed pool rollouts of ANM6Easy and Baran and Wu's
  feeder add what the eager rollouts' launches returned, and equal the eager
  steps bit for bit.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.envs.randomized import MultiBatchedEnv, randomized_anm6easy_cores, randomized_feeder33_cores
from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda
from gym_anm_tpu_torch.ops.power_flow import warm_init_theta_vm
from gym_anm_tpu_torch.ops.tree_cuda import DeviceSchedule
from gym_anm_tpu_torch.profiling import StepRateCounter


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
@pytest.mark.parametrize("B", [1, 37, 1000])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name, amp, x_tol", [("anm6", 0.3, 1e-5), ("feeder33", 0.05, 1e-5), ("feeder141", 0.02, 3e-5)])
def test_cuda_kernel_matches_plain(name, amp, x_tol, warm, B):
    """Bit for bit, from the flat start and warm-started (the solved V of a
    nearby problem, a few lanes zeroed so that they flat-start), with a NaN
    lane and a lane that never converges among healthy ones."""
    _need_cuda()
    ds, pT, qT = _slot_inputs(name, B, amp)
    if B > 2:
        pT[1, 0] = float("nan")
        pT[:, 1] *= 60.0
    init = None
    if warm:
        vr, vi = tree_cuda.solve_pfe_tree_plain(ds, 0.9 * pT, 0.9 * qT, x_tol=x_tol, max_iter=12)[:2]
        th, vm = torch.atan2(vi, vr), torch.sqrt(vr * vr + vi * vi)
        th[:, 2:5], vm[:, 2:5] = 0.0, 1.0  # these lanes flat-start
        init = (torch.nan_to_num(th, 0.0, 0.0, 0.0).contiguous(), torch.nan_to_num(vm, 1.0, 1.0, 1.0).contiguous())
    before = tree_cuda.KERNEL_LAUNCHES
    k = tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, x_tol=x_tol, max_iter=12, init=init)
    torch.cuda.synchronize()
    assert tree_cuda.KERNEL_LAUNCHES == before + 1
    pl = tree_cuda.solve_pfe_tree_plain(ds, pT, qT, x_tol=x_tol, max_iter=12, init=init)
    for a, b in zip(k, pl):
        _assert_same(a, b)
    conv = k[2] <= x_tol
    if B > 2:
        assert torch.isnan(k[2][0]) and int(k[3][0]) == 0 and not bool(conv[:2].any())
        assert float(conv[2:].float().mean()) > 0.9
    else:
        assert bool(conv.all())


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
    with pytest.raises(TypeError):
        tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, init=(pT.double(), qT.double()))
    with pytest.raises(ValueError, match="shape"):
        tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, init=(pT[:, :8].contiguous(), qT[:, :8].contiguous()))
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


def _assert_same(a, b):
    """Bit for bit, NaN where NaN (+0 and -0 count as equal)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _dense_grid(name):
    net = {"anm6": anm6_network, "feeder33": make_feeder_network()}[name]
    return GridTensors.from_spec(build_grid(net, 0.25, 100, dtype=np.float32)[0], "cuda", torch.float32)


def _nr_both(g, p, q, **kw):
    """The dense-NR kernel and its plain twin bit for bit; the kernel's
    mismatch."""
    before = nr_cuda.KERNEL_LAUNCHES
    vr, vi, d, it = nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
    torch.cuda.synchronize()
    assert nr_cuda.KERNEL_LAUNCHES == before + 1
    pvr, pvi, _, _, pd, pit = nr_cuda.nr_core_plain(g.Y_re, g.Y_im, g.J0inv, p, q, **kw)
    for a, b in ((vr, pvr), (vi, pvi), (d, pd), (it, pit)):
        _assert_same(a, b)
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 1000])
@pytest.mark.parametrize("chord, pivot", [(0, False), (16, True)])
@pytest.mark.parametrize("name, amp", [("anm6", 0.3), ("feeder33", 0.05)])
def test_cuda_nr_kernel_matches_plain(name, amp, chord, pivot, B):
    _need_cuda()
    g = _dense_grid(name)
    rng = np.random.default_rng(1)
    m = g.spec.n_bus - 1
    p = torch.tensor(rng.uniform(-amp, amp, (m, B)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (m, B)).astype(np.float32), device="cuda")
    d = _nr_both(g, p, q, x_tol=1e-5, max_iter=15, chord_iters=chord, pivot=pivot)
    assert float((d <= 1e-5).float().mean()) > 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 1000])
@pytest.mark.parametrize("chord, pivot", [(0, False), (16, True)])
@pytest.mark.parametrize("name, amp", [("anm6", 0.3), ("feeder33", 0.05)])
def test_cuda_nr_kernel_warm_matches_plain(name, amp, chord, pivot, B):
    """The warm form bit for bit: the warm point is the solved V of a
    nearby problem (0.9x the injections), a few lanes zeroed so that they
    flat-start, beside a NaN lane and a lane that never converges."""
    _need_cuda()
    g = _dense_grid(name)
    rng = np.random.default_rng(3)
    m = g.spec.n_bus - 1
    p = torch.tensor(rng.uniform(-amp, amp, (m, B)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.6 * amp, 0.6 * amp, (m, B)).astype(np.float32), device="cuda")
    kw = dict(x_tol=1e-5, max_iter=15, chord_iters=chord, pivot=pivot)
    vr, vi = nr_cuda.nr_core_plain(g.Y_re, g.Y_im, g.J0inv, 0.9 * p, 0.9 * q, **kw)[:2]
    th, vm, _ = warm_init_theta_vm(vr.T, vi.T, m, torch.float32)
    if B > 5:
        p[0, 0] = float("nan")
        p[:, 1] *= 1e3
        th[:, 2:5], vm[:, 2:5] = 0.0, 1.0
    d = _nr_both(g, p, q, **kw, init=(th.contiguous(), vm.contiguous()))
    conv = d <= 1e-5
    if B > 5:
        assert torch.isnan(d[0]) and not bool(conv[:2].any())
        assert float(conv[2:].float().mean()) > 0.9
    else:
        assert bool(conv.all())


@pytest.mark.gpu
@pytest.mark.parametrize("chord", [0, 16])
@pytest.mark.parametrize("name, amp", [("anm6", 0.3), ("feeder33", 0.05)])
def test_cuda_nr_kernel_pivoted_bad_lanes_match_plain(name, amp, chord):
    """NaN, infinite and collapsing lanes end unconverged in both versions,
    with the same NaN or inf, beside healthy lanes of the same teams."""
    _need_cuda()
    g = _dense_grid(name)
    rng = np.random.default_rng(2)
    m, B = g.spec.n_bus - 1, 45
    p = rng.uniform(-amp, amp, (m, B)).astype(np.float32)
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (m, B)).astype(np.float32)
    p[0, 1] = np.nan
    q[m - 1, 9] = np.inf
    p[:, 17] *= 1e6  # a collapse: the Jacobian goes singular, the lane inf/NaN
    p[:, 30] *= 1e3
    p[:, 44] = 0.0  # the flat start is already the solution
    q[:, 44] = 0.0
    pc, qc = torch.tensor(p, device="cuda"), torch.tensor(q, device="cuda")
    d = _nr_both(g, pc, qc, x_tol=1e-5, max_iter=10, chord_iters=chord, pivot=True).cpu()
    bad = [1, 9, 17, 30]
    assert not bool((d[bad] <= 1e-5).any()) and bool(torch.isnan(d[1]))
    assert float((d[[b for b in range(B) if b not in bad]] <= 1e-5).float().mean()) > 0.9


def _tie_system(n, singular, seed=3):
    """Y = j Yim with Yim zero on the diagonal and, off it, half +1 and half
    -1 in each row: the flat-start Jacobian is zero on its diagonal and +-1
    off it, so the first pivot searches meet ties.  With ``singular`` bus 3
    is cut off: its column of J is zero, the elimination divides 0 by 0 and
    every later pivot column is NaN."""
    rng = np.random.default_rng(seed)
    Yim = np.zeros((n, n), np.float32)
    for i in range(n):
        Yim[i, np.arange(n) != i] = rng.permutation(np.repeat(np.float32([1, -1]), (n - 1) // 2))
    if singular:
        Yim[3, :] = 0.0
        Yim[:, 3] = 0.0
    m = n - 1
    t = lambda a: torch.tensor(a, device="cuda")
    return types.SimpleNamespace(Y_re=t(np.zeros_like(Yim)), Y_im=t(Yim), J0inv=t(np.zeros((2 * m, 2 * m), np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("n", [9, 33])  # nn = 16 and 64: both team sizes
def test_cuda_nr_kernel_pivot_ties_match_plain(n, singular):
    _need_cuda()
    g = _tie_system(n, singular)
    rng = np.random.default_rng(4)
    p = torch.tensor(rng.uniform(-0.3, 0.3, (n - 1, 40)).astype(np.float32), device="cuda")
    q = torch.tensor(rng.uniform(-0.2, 0.2, (n - 1, 40)).astype(np.float32), device="cuda")
    d = _nr_both(g, p, q, x_tol=1e-5, max_iter=6, chord_iters=0, pivot=True)
    if singular:
        assert bool(torch.isnan(d).all())


def _step_lanes(core, B, seed):
    """Transition inputs a rollout of the task would give, packed batch-last."""
    env = BatchedEnv(core, B, generator=torch.Generator(device=core.device).manual_seed(seed))
    es, _ = env.reset()
    vars = core.next_vars_fn(es.state_vec, env.generator)
    return step_cuda.pack_inputs(**core.transition_inputs(es, env.random_actions(), vars))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 1000])
@pytest.mark.parametrize("chord", [0, 16])
@pytest.mark.parametrize("env", ["anm6easy", "feeder33"])
def test_cuda_step_kernel_matches_plain(env, chord, B):
    _need_cuda()
    core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method="fused")
    st = core.grid.step
    lanes = _step_lanes(core, B, 2)
    kw = dict(x_tol=1e-5, max_iter=15, chord_iters=chord)
    before = step_cuda.KERNEL_LAUNCHES
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, **kw))
    torch.cuda.synchronize()
    assert step_cuda.KERNEL_LAUNCHES == before + 1
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, **kw))
    for f in k._fields:
        _assert_same(getattr(k, f), getattr(p, f))
    assert float((k.diff <= 1e-5).float().mean()) > 0.9


def _fused_core(env_name):
    if env_name == "baranwu33":
        from gym_anm_tpu_torch.envs.baranwu33 import make_core as baranwu33_make_core

        return baranwu33_make_core(torch.float32, "cuda", pf_method="fused")
    return check.task_make_core(env_name)(dtype=torch.float32, device="cuda", pf_method="fused")


# K3's tree-form geometry on an H100 (threads a lane, lanes a block, threads
# a block, shared bytes a block, blocks an SM): the 33-bus feeders' 32 x 8
# lanes with the scratch after the planes, feeder141's 16 lanes of one warp
# with the scratch overlaid on the planes, one block an SM.
TREE_GEOMETRY = {
    "anm6easy": (8, 16, 128, 13044, 8),
    "feeder33": (32, 8, 256, 31296, 4),
    "feeder141": (32, 16, 512, 225256, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("env_name", ["anm6easy", "feeder33", "baranwu33", "feeder141"])
def test_cuda_step_tree_form_matches_plain_and_k1(env_name):
    """At B=4096 with the task's ``fused`` budget (15; 18 on feeder141), K3
    solves in the tree form: one tree launch, its lanes' iterations added to
    its own counters and nothing to K1's, every output row its plain twin's
    bit for bit; with the same bus injections and budget, its V, mismatch
    and iterations are K1's bit for bit."""
    _need_cuda()
    core = _fused_core(env_name)
    st, ds = core.grid.step, core.grid.tree
    assert step_cuda.tree_form(st) and st.tree is ds
    B, kw = 4096, (dict(x_tol=3e-5, max_iter=18) if env_name == "feeder141" else dict(x_tol=1e-5, max_iter=15))
    if env_name == "feeder141":
        assert (core.x_tol, core.max_iter) == (kw["x_tol"], kw["max_iter"])
    tree = step_cuda.step_fused_geometry(st)
    if env_name in TREE_GEOMETRY:
        assert tuple(tree.values()) == TREE_GEOMETRY[env_name], tree
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if env_name == "feeder141":
        # Past the dense form's 64 unknowns: no dense geometry, two waves.
        with pytest.raises(RuntimeError, match="geometry refused"):
            step_cuda.step_fused_geometry(st, pivot=True)
        assert 2 * tree["blocks_per_sm"] * tree["lanes_per_block"] * sms >= B
    else:
        # Less shared memory a lane than the dense form's, and every lane of
        # the batch resident at once.
        dense = step_cuda.step_fused_geometry(st, pivot=True)
        per_lane = lambda g: g["smem_bytes_per_block"] / g["lanes_per_block"]
        assert per_lane(tree) < per_lane(dense)
        assert tree["blocks_per_sm"] * tree["lanes_per_block"] * sms >= B
    lanes = _step_lanes(core, B, 3)
    counters = lambda: (step_cuda.KERNEL_LAUNCHES, step_cuda.TREE_LAUNCHES, tree_cuda.KERNEL_LAUNCHES,
                        tree_cuda.LANE_SOLVES, tree_cuda.iteration_counts("cuda").tolist())
    k3_counts = lambda: step_cuda.iteration_counts("cuda").tolist() + [step_cuda.LANE_SOLVES]
    c0, i0 = counters(), k3_counts()
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, **kw))
    torch.cuda.synchronize()
    assert counters() == (c0[0] + 1, c0[1] + 1) + c0[2:]
    i1 = k3_counts()
    added = [int(k.n_iter.sum()), int((~(k.diff <= kw["x_tol"])).sum()), B]
    assert [b - a for a, b in zip(i0, i1)] == added
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, **kw))
    assert counters() == (c0[0] + 1, c0[1] + 1) + c0[2:]
    assert [b - a for a, b in zip(i1, k3_counts())] == added
    for f in k._fields:
        _assert_same(getattr(k, f), getattr(p, f))
    assert float((k.diff <= kw["x_tol"]).float().mean()) > 0.9
    zero = torch.zeros((1, B), device="cuda")
    pT = torch.cat([k.bus_p.T[1:], zero])[ds.slot_sel].contiguous()
    qT = torch.cat([k.bus_q.T[1:], zero])[ds.slot_sel].contiguous()
    vr, vi, diff, it = tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, **kw)
    _assert_same(k.v_re[:, 1:], vr[ds.busm1_slot].T)
    _assert_same(k.v_im[:, 1:], vi[ds.busm1_slot].T)
    _assert_same(k.diff[:, 0], diff)
    _assert_same(k.n_iter[:, 0], it.float())


@pytest.mark.gpu
@pytest.mark.parametrize("chord, pivot", [(0, True), (16, True)], ids=["pivot", "chord-pivot"])
@pytest.mark.parametrize("env", ["anm6easy", "feeder33"])
def test_cuda_step_dense_form_matches_plain(env, chord, pivot):
    """With pivoting (and a chord prefix) K3 keeps its dense form, bit for
    bit its plain twin, counting no tree launch."""
    _need_cuda()
    core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method="fused")
    st = core.grid.step
    lanes = _step_lanes(core, 1000, 4)
    kw = dict(x_tol=1e-5, max_iter=15, chord_iters=chord, pivot=pivot)
    assert not step_cuda.tree_form(st, chord, pivot)
    before = step_cuda.KERNEL_LAUNCHES, step_cuda.TREE_LAUNCHES
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, **kw))
    torch.cuda.synchronize()
    assert (step_cuda.KERNEL_LAUNCHES, step_cuda.TREE_LAUNCHES) == (before[0] + 1, before[1])
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, **kw))
    for f in k._fields:
        _assert_same(getattr(k, f), getattr(p, f))
    assert float((k.diff <= 1e-5).float().mean()) > 0.9


@pytest.mark.gpu
def test_cuda_step_meshed_grid_runs_the_dense_form():
    """ANM6 with one more branch (a meshed grid) has no tree schedule: K3
    runs its dense form there, bit for bit its plain twin, and counts no
    tree launch.  Its lane layout is ANM6's, so ANM6Easy's lanes serve."""
    _need_cuda()
    net = dict(anm6_network)
    net["branch"] = np.concatenate([anm6_network["branch"], [[3, 4, 0.03, 0.06, 0.0, 18, 1, 0]]])
    g = GridTensors.from_spec(build_grid(net, 0.25, 100, dtype=np.float32)[0], "cuda", torch.float32)
    st = g.step
    assert g.tree is None and st.tree is None and not step_cuda.tree_form(st)
    lanes = _step_lanes(make_core(torch.float32, "cuda", pf_method="fused"), 1000, 6)
    before = step_cuda.KERNEL_LAUNCHES, step_cuda.TREE_LAUNCHES
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, x_tol=1e-5, max_iter=10))
    torch.cuda.synchronize()
    assert (step_cuda.KERNEL_LAUNCHES, step_cuda.TREE_LAUNCHES) == (before[0] + 1, before[1])
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, x_tol=1e-5, max_iter=10))
    for f in k._fields:
        _assert_same(getattr(k, f), getattr(p, f))
    assert float((k.diff <= 1e-5).float().mean()) > 0.9


@pytest.mark.gpu
def test_cuda_step_kernel_projection_tie_matches_plain():
    """The first generator's polytope becomes a roof y <= R -+ 1e-6 x over a
    box, with a NaN normal and inactive rows.  The roof's apex is a vertex
    of two nearly parallel rows, which the projection rejects, so a set-point
    (0, y > R) lies exactly as far from the feet onto the two sides, (+-x,
    ~R): the first side's foot, x > 0, must win in the kernel as in the
    plain twin's sequential scan."""
    _need_cuda()
    core = make_core(torch.float32, "cuda", pf_method="fused")
    spec = core.grid.spec
    R, inf, nan = 0.3, np.inf, np.nan
    G, h0 = np.array(spec.gen_G), np.array(spec.gen_h0)
    G[0, :9] = [[-1, 0], [-1e-6, 1], [1, 0], [1e-6, 1], [0, -1], [nan, nan], [0, 0], [1, 1], [0, 0]]
    h0[0, [0, 1, 3, 4, 5]] = [1.0, R, R, 1.0, 1.0]
    h0[0, 6:] = inf
    st = step_cuda.StepTables.from_spec(dataclasses.replace(spec, gen_G=G, gen_h0=h0), "cuda", torch.float32)
    B, roof = 100, slice(0, 40)
    lanes = _step_lanes(core, B, 5).clone()
    n_des, n_load, n_gen = st.dims["n_des"], st.dims["n_load"], st.dims["n_gen"]
    ppot = n_des + n_load
    lanes[ppot, roof] = st.f["genc"][0, 1]  # the potential at p_max: the cap row stays far
    lanes[ppot + n_gen, roof] = 0.0  # P set-point
    lanes[ppot + 2 * n_gen, roof] = torch.linspace(R + 0.1, R + 2.0, 40, device="cuda")  # Q set-point
    kw = dict(x_tol=1e-5, max_iter=10)
    k = step_cuda.unpack_outputs(st, step_cuda.fused_transition_cuda(st, lanes, **kw))
    p = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, **kw))
    for f in k._fields:
        _assert_same(getattr(k, f), getattr(p, f))
    gen_p = k.dev_p[roof, st.structure.positions["gen_pos"][0]]
    assert bool(((gen_p > 0) & (gen_p < 1e-4)).all())


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
    with pytest.raises(TypeError):
        nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, p, init=(p.double(), p.double()))
    with pytest.raises(ValueError, match="shape"):
        nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, p, init=(p[:, :8].contiguous(), p[:, :8].contiguous()))
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
    # Sizes whose lane region (dev_p, dev_q for 60k devices) exceeds a
    # block's shared memory: the geometry and the launch are refused.
    dims = list(st.c_args[2])
    dims[step_cuda.DIMS.index("d")] = 60000
    huge = dataclasses.replace(st, c_args=st.c_args[:2] + ((type(st.c_args[2]))(*dims),))
    with pytest.raises(RuntimeError, match="refused"):
        step_cuda.step_fused_geometry(huge)
    with pytest.raises(RuntimeError, match="launch failed"):
        step_cuda.fused_transition_cuda(huge, lanes)
    assert (nr_cuda.KERNEL_LAUNCHES, step_cuda.KERNEL_LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    # Two float32 solves converged to x_tol = 1e-5 p.u. may sit a few x_tol
    # apart, i.e. a few 1e-3 MW/MVAr in the state vector (baseMVA = 100).
    # The dense NR's slack power (pallas, fused) has been seen 1.6e-3 MVAr
    # apart on one lane; the fused path's kernel and CPU twin also differ in
    # the projection and flows.  Warm-started, a lane whose warm and flat
    # mismatches tie to the last bit may take the other start on the other
    # device and end elsewhere within x_tol (its slack power seen 1.9e-3
    # apart).
    "pf_method, warm_start, counter, atol",
    [("tree", False, tree_cuda, 1e-3), ("tree", True, tree_cuda, 5e-3), ("pallas", False, nr_cuda, 5e-3),
     ("fused", False, step_cuda, 5e-3), ("pallas", True, nr_cuda, 5e-3)],
    ids=["tree", "tree-warm", "pallas", "fused", "pallas-warm"],
)
def test_cuda_env_core_matches_cpu(pf_method, warm_start, counter, atol):
    _need_cuda()
    gpu = make_core(torch.float32, "cuda", pf_method=pf_method, warm_start=warm_start)
    cpu = make_core(torch.float32, "cpu", pf_method=pf_method, warm_start=warm_start)
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


@pytest.mark.gpu
def test_cuda_lockstep_matches_cpu():
    """The lockstep step on the card and on the CPU from the same draws (made
    on the CPU), every eighth lane reset at the first step; float32 rule as
    in ``test_cuda_env_core_matches_cpu``'s tree case.  The card's steps run
    through ``LockstepEnv.step``, whose hooks hand it the CPU's draws: the
    first eagerly, the others replayed from its CUDA graph."""
    from gym_anm_tpu_torch.envs import vector_core

    _need_cuda()
    gpu, cpu = make_core(torch.float32, "cuda"), make_core(torch.float32, "cpu")
    B, T = 512, 4
    gen = torch.Generator().manual_seed(0)
    s0 = cpu.init_state_fn(gen, B)
    lock = vector_core.LockstepEnv(gpu, B)
    needs_c = torch.arange(B) % 8 == 0
    lock.es, lock.needs_reset, es_c = gpu.env_state_from_s0(s0.cuda()), needs_c.cuda(), cpu.env_state_from_s0(s0)
    draws = {}
    gpu.next_vars_fn = lambda s, generator: draws["vars"]
    gpu.init_state_fn = lambda generator, batch_size: draws["s0"]
    actions = np.random.default_rng(0).uniform(cpu.action_low, cpu.action_high, (T, B, cpu.action_n))
    before, r0 = tree_cuda.KERNEL_LAUNCHES, vector_core.LOCKSTEP_GRAPH_REPLAYS
    for t in range(T):
        a = torch.tensor(actions[t], dtype=torch.float32)
        d = vector_core.draw(cpu, es_c, gen)
        es_c, vs_c = vector_core.step(cpu, es_c, needs_c, a, d.vars, d.fresh_s0)
        draws.update(vars=d.vars.cuda(), s0=d.fresh_s0.cuda())
        needs_g = lock.needs_reset
        vs_g = lock.step(a.cuda())
        if t == 0:
            assert not vs_g.terminated[needs_g].any() and bool((vs_g.reward[needs_g] == 0).all())
        agree = vs_g.terminated.cpu() == vs_c.terminated
        assert float(agree.float().mean()) >= 0.99
        live = agree & ~es_c.terminated
        torch.testing.assert_close(vs_g.obs.cpu()[live], vs_c.obs[live], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(vs_g.reward.cpu()[live], vs_c.reward[live], rtol=1e-4, atol=1e-3)
        needs_c = vs_c.terminated
    assert tree_cuda.KERNEL_LAUNCHES == before + 2 * T
    assert vector_core.LOCKSTEP_GRAPH_REPLAYS == r0 + T - 1


def _lockstep_steps(env_name, graph_device, B=4096, T=64):
    """``T`` ``LockstepEnv`` steps of the task on ``tree`` at B from NumPy
    actions, one seed, the graph runner engaged (``graph_device`` "cuda") or
    not (a device type nothing has): each step's outputs and state, the
    final state, and the increments of K1's launches and lane-solves and of
    the graph replays."""
    from gym_anm_tpu_torch.core import graph
    from gym_anm_tpu_torch.core.env_core import state_tensors
    from gym_anm_tpu_torch.envs import vector_core

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "GRAPH_DEVICE", graph_device)
        core = check.task_make_core(env_name)(dtype=torch.float32, device="cuda", pf_method="tree")
        lock = vector_core.LockstepEnv(core, B, seed=7)
        lock.reset()
        rng = np.random.default_rng(7)
        counts = lambda: (tree_cuda.KERNEL_LAUNCHES, tree_cuda.LANE_SOLVES, vector_core.LOCKSTEP_GRAPH_REPLAYS)
        c0, outs = counts(), []
        for _ in range(T):
            vs = lock.step(rng.uniform(core.action_low, core.action_high, (B, core.action_n)).astype(np.float32))
            outs.append(list(vs) + state_tensors(lock.es))
        torch.cuda.synchronize()
        return outs, [b - a for a, b in zip(c0, counts())]


@pytest.mark.gpu
@pytest.mark.parametrize("env_name", ["anm6easy", "feeder33"])
def test_cuda_lockstep_graph_matches_eager(env_name):
    """64 ``LockstepEnv`` steps at B=4096 replayed from the step's CUDA graph
    equal the eager steps bit for bit (observations, rewards, flags and every
    field of each step's state, lanes reborn included), with K1 launched twice
    a step either way."""
    _need_cuda()
    T, B = 64, 4096
    outs_g, c_g = _lockstep_steps(env_name, "cuda", B, T)
    outs_e, c_e = _lockstep_steps(env_name, "no-device", B, T)
    assert c_g == [2 * T, 2 * B * T, T - 1] and c_e == [2 * T, 2 * B * T, 0]
    assert bool(torch.stack([o[2] for o in outs_e[:-1]]).any())  # lanes terminated and were reborn
    for g, e in zip(outs_g, outs_e):
        for a, b in zip(g, e):
            _assert_same(a, b)


@pytest.mark.gpu
def test_cuda_single_lane_step_matches_cpu():
    """``ANMEnv``'s one-lane float64 ``scan`` step on the card and on the CPU
    from the same initial state, actions and vars (float64 plain solver on
    both: no kernel)."""
    from gym_anm_tpu_torch.core.env_core import EnvCore
    from gym_anm_tpu_torch.core.obs import state_values_spec
    from gym_anm_tpu_torch.envs.single_core import reset_lane, step_lane

    _need_cuda()
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float64)
    s0 = make_core(torch.float64, "cpu").init_state_fn(torch.Generator().manual_seed(1), 1)[0].numpy()
    ref = make_core(torch.float64, "cpu")
    rng = np.random.default_rng(1)
    actions = rng.uniform(ref.action_low, ref.action_high, (6, ref.action_n))
    outs = {}
    for dev in ("cuda", "cpu"):
        core = EnvCore(spec, K=1, gamma=0.995, device=dev, dtype=torch.float64, costs_clipping=(1, 100),
                       obs_values=state_values_spec(spec, 1), aux_bounds=np.array([[0, 95]]), pf_method="scan")
        es, converged, state, _ = reset_lane(core, s0)
        assert converged
        outs[dev] = []
        for a in actions:
            vars = ref.next_vars_fn(torch.tensor(state)[None], None)[0].numpy()
            es, out = step_lane(core, es, a, vars)
            state = out.state
            outs[dev].append(out)
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.terminated == c.terminated
        np.testing.assert_allclose([g.reward, g.e_loss, g.penalty], [c.reward, c.e_loss, c.penalty], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.obs, c.obs, rtol=0, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "builder, pf_method, L, counter",
    [(randomized_anm6easy_cores, "tree", 37, tree_cuda), (randomized_feeder33_cores, "fused", 64, step_cuda)],
    ids=["anm6easy-tree", "feeder33-fused"],
)
def test_cuda_fleet_matches_cpu(builder, pf_method, L, counter):
    """Each variant's lanes on the card agree with the same variant's on the
    CPU within the env-core bound (5e-3), given the same initial states,
    actions and internal variables (drawn on the CPU)."""
    _need_cuda()
    G, T = 2, 4
    kw = dict(seed=0, r_sigma=0.2, x_sigma=0.2, dtype=torch.float32, pf_method=pf_method)
    gpu = MultiBatchedEnv(builder(G, device="cuda", **kw), L)
    cpu = MultiBatchedEnv(builder(G, device="cpu", **kw), L)
    gen = torch.Generator().manual_seed(0)
    s0 = [c.init_state_fn(gen, L) for c in cpu.cores]
    rng = np.random.default_rng(0)
    actions = rng.uniform(cpu.cores[0].action_low, cpu.cores[0].action_high, (T, G, L, cpu.action_n))
    next_vars = [c.next_vars_fn for c in cpu.cores]
    before = counter.KERNEL_LAUNCHES
    es_g = tuple(c.env_state_from_s0(s.cuda()) for c, s in zip(gpu.cores, s0))
    es_c = tuple(c.env_state_from_s0(s) for c, s in zip(cpu.cores, s0))
    for t in range(T):
        for g in range(G):
            v = next_vars[g](es_c[g].state_vec, gen)
            cpu.cores[g].next_vars_fn = lambda s, generator, v=v: v
            gpu.cores[g].next_vars_fn = lambda s, generator, v=v.cuda(): v
        a = torch.tensor(actions[t], dtype=torch.float32)
        es_g, out_g = gpu.step(es_g, a.cuda())
        es_c, out_c = cpu.step(es_c, a)
        for g in range(G):
            agree = out_g.terminated[g].cpu() == out_c.terminated[g]
            assert float(agree.float().mean()) >= 0.95
            live = agree & ~out_c.terminated[g]
            torch.testing.assert_close(out_g.state_vec[g].cpu()[live], out_c.state_vec[g][live], rtol=1e-4, atol=5e-3)
            torch.testing.assert_close(out_g.reward[g].cpu()[live], out_c.reward[g][live], rtol=1e-4, atol=5e-3)
    assert counter.KERNEL_LAUNCHES == before + G * (1 + T)
    # The variants' grids differ, and so do their outputs.
    assert not torch.equal(out_g.state_vec[0], out_g.state_vec[1])


@pytest.mark.gpu
def test_cuda_step_rate_counter_waits_for_the_device():
    """A block that only queues a spinning kernel is timed to the kernel's
    end: ``measure`` synchronizes the card before it reads the clock."""
    _need_cuda()
    cycles = 200_000_000
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    kernel_s = start.elapsed_time(end) / 1e3
    counter = StepRateCounter(device="cuda")
    with counter.measure(1):
        torch.cuda._sleep(cycles)
    assert counter.total_seconds >= 0.8 * kernel_s > 0.01


def _mpc_agent(cls, device, N=3, **kw):
    from gym_anm_tpu_torch.simulator import Simulator

    core = make_core(torch.float64, "cpu")
    space = types.SimpleNamespace(low=core.action_low, high=core.action_high)
    sim = Simulator(anm6_network, 0.25, 100, device=device)
    return cls(sim, space, core.gamma, planning_steps=N, device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dense", "banded"])
def test_cuda_mpc_solve_batch_matches_cpu(solver):
    """The batched float64 ADMM on the card against the same solve on the
    CPU, at ANM6 h3 B=8.  Two chunks of 300 iterations (CUDA graphs on the
    card) from the same bounds: iterates within 1e-9 (relative for the
    duals and slacks of size ~5).  The full budget of
    ``solve_batch``: some lanes end it on a dual-residual plateau (~2e-7
    scaled), not at a fixed point, where the two devices' roundings leave
    the solutions ~1e-8 p.u. and the objectives (weights up to 100 on the
    branch slacks) ~4e-8 relative apart: held to 1e-7 p.u., 1e-6 relative
    and 1e-5 MW."""
    _need_cuda()
    from gym_anm_tpu_torch.agents import MPCAgentConstant, MPCAgentConstantBanded

    cls = MPCAgentConstantBanded if solver == "banded" else MPCAgentConstant
    core = make_core(torch.float64, "cpu")
    sv = BatchedEnv(core, 8, generator=torch.Generator().manual_seed(0)).reset()[1].state_vec
    out = {}
    for device in ("cuda", "cpu"):
        agent = _mpc_agent(cls, device, solver_x64=True)
        acts = agent.act_batch(sv.to(device))
        assert acts.device.type == device and acts.dtype == torch.float64
        sol = agent.last_batch_solution
        x2, carry = agent._admm_batch(sol["lv"], sol["uv"], max_chunks=2, chunk_len=300)
        out[device] = (acts.cpu(), sol["x"].cpu(), agent.q, [x2.cpu()] + [c.cpu() for c in carry])
    (a_g, x_g, q, it_g), (a_c, x_c, _, it_c) = out["cuda"], out["cpu"]
    for g, c in zip(it_g, it_c):
        torch.testing.assert_close(g, c, rtol=1e-9, atol=1e-9)
    obj_g, obj_c = x_g.numpy() @ q, x_c.numpy() @ q
    assert np.max(np.abs(obj_g - obj_c) / np.maximum(1.0, np.abs(obj_c))) < 1e-6
    torch.testing.assert_close(x_g, x_c, rtol=0, atol=1e-7)
    torch.testing.assert_close(a_g, a_c, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["dense", "banded"])
def test_cuda_mpc_iteration_graph_matches_eager(solver):
    """Two chunks of 300 batched ADMM iterations on the card, replayed from
    CUDA graphs of 50 iterations, against the same chunks launched eagerly
    (float64, ANM6 h3, B=8): the same iterates, rho and residuals."""
    _need_cuda()
    from gym_anm_tpu_torch.agents import MPCAgentConstant, MPCAgentConstantBanded

    cls = MPCAgentConstantBanded if solver == "banded" else MPCAgentConstant
    agent = _mpc_agent(cls, "cuda", solver_x64=True)
    core = make_core(torch.float64, "cpu")
    sv = BatchedEnv(core, 8, generator=torch.Generator().manual_seed(1)).reset()[1].state_vec
    agent.act_batch(sv.cuda())
    lv, uv = agent.last_batch_solution["lv"], agent.last_batch_solution["uv"]
    out = {}
    for iters in (50, 0):
        agent.GRAPH_ITERS = iters
        x, carry = agent._admm_batch(lv, uv, max_chunks=2, chunk_len=300)
        out[iters] = [x] + list(carry)
    for g, e in zip(out[50], out[0]):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-12)


@pytest.mark.gpu
def test_cuda_mpc_closed_loop_through_the_tree_kernel():
    """Three steps of a B=64 ANM6Easy fleet on the tree path driven by the
    dense MPC agent (h3, float32) on the card: no lane terminates, and the
    tree kernel runs every step; the agent leaves TF32 as it found it."""
    _need_cuda()
    from gym_anm_tpu_torch.agents import MPCAgentConstant

    core = make_core(torch.float32, "cuda")
    env = BatchedEnv(core, 64)
    agent = _mpc_agent(MPCAgentConstant, "cuda")
    es, first = env.reset()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        acts = agent.act_batch(first.state_vec)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    before = tree_cuda.KERNEL_LAUNCHES
    for _ in range(3):
        es, out = env.step(es, acts)
        assert not bool(out.terminated.any())
        assert float(out.reward.mean()) > -5
        acts = agent.act_batch(out.state_vec, warm_start=True)
    assert tree_cuda.KERNEL_LAUNCHES - before >= 3


def _launches():
    return tree_cuda.KERNEL_LAUNCHES, nr_cuda.KERNEL_LAUNCHES, step_cuda.KERNEL_LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("pf_method", ["hybrid", "tree_xla"])
def test_cuda_feeder141_plain_paths_launch_no_kernel(pf_method):
    """16 lanes, 4 steps of the feeder141 reference through a plain path in
    float32 on the card, under the ``check.py`` rule with no termination
    mismatch; no kernel launches."""
    _need_cuda()
    from gym_anm_tpu_torch.envs.feeder141 import make_core as feeder141_make_core

    data = check.load_reference("feeder141")
    core = feeder141_make_core(torch.float32, "cuda", pf_method=pf_method)
    before = _launches()
    sv, rw, tm = check.rollout_given(core, data["s0"][:16], data["actions"][:4, :16], data["vars"][:4, :16])
    torch.cuda.synchronize()
    assert _launches() == before
    ref = {k: data[k][:4, :16] for k in ("state_vec", "reward", "terminated")}
    res = check.compare_trajectories(ref, {"state_vec": sv.cpu().numpy(), "reward": rw.cpu().numpy(),
                                           "terminated": tm.cpu().numpy()})
    assert res["pass"] and res["term_mismatch_frac"] == 0.0


@pytest.mark.gpu
def test_cuda_chord_product_runs_without_tf32():
    """With TF32 switched on globally, the chord product and the plain
    solver's chord steps still run in full float32 (a float64 product to
    float32 rounding), and the global setting is left as it was."""
    _need_cuda()
    from gym_anm_tpu_torch.ops.power_flow import solve_pfe

    g = _dense_grid("feeder33")
    rng = np.random.default_rng(4)
    F = torch.tensor(rng.uniform(-0.05, 0.05, (g.J0inv.shape[0], 256)).astype(np.float32), device="cuda")
    exact = (g.J0inv.double() @ F.double()).float()
    p, q = F[: g.spec.n_bus - 1].T.contiguous(), F[g.spec.n_bus - 1 :].T.contiguous()
    kw = dict(method="hybrid", chord_iters=4, max_iter=0, J0inv=g.J0inv)
    off = solve_pfe(g.Y_re, g.Y_im, p, q, **kw)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        torch.testing.assert_close(nr_cuda.chord_product(g.J0inv, F), exact, rtol=1e-5, atol=1e-6)
        on = solve_pfe(g.Y_re, g.Y_im, p, q, **kw)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert bool(torch.isfinite(off[2]).all())
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_make_mesh_over_nccl_world_one(tmp_path):
    _need_cuda()
    import torch.distributed as dist

    from gym_anm_tpu_torch.parallel import sharding

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1)
        assert mesh.size() == 1 and sharding.rank_device(mesh).type == "cuda"
        x = torch.arange(8.0, device="cuda")
        c0 = sharding.COLLECTIVES
        local = sharding.shard_batch(x, mesh)
        assert torch.equal(local, x) and torch.equal(sharding.gather_batch(local, mesh), x)
        t = torch.full((3,), 2.0, device="cuda")
        assert torch.equal(sharding.all_reduce_mean_(t, mesh), torch.full((3,), 2.0, device="cuda"))
        assert sharding.COLLECTIVES - c0 == 2
        with pytest.raises(ValueError, match="backend"):
            sharding.make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_cuda_projection_forms(name, dtype):
    """On the card the stacked projection equals the running minimum bit for
    bit (NaN, infinite and empty-region lanes included) and the running
    minimum on the CPU to rounding; box-slants is within 2e-5;
    ``GridTensors.from_spec`` builds the card's chosen form."""
    _need_cuda()
    from gym_anm_tpu_torch.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR, projection_form
    from gym_anm_tpu_torch.ops.projection import LanesProjector, project_box_slants_lanes

    net = {"anm6": anm6_network, "feeder33": make_feeder_network(), "feeder141": make_multi_feeder_network()}[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
    G = np.concatenate([spec.gen_G, spec.des_G], axis=0)
    C, B = G.shape[0], 1000
    rng = np.random.default_rng(3)
    h = np.repeat(np.concatenate([spec.gen_h0, spec.des_h0], axis=0)[:, :, None], B, axis=2)
    h[:, POLY_ROW_P_CAP] = np.where(rng.uniform(size=(C, B)) < 0.25, np.inf, rng.uniform(0.0, 0.6, (C, B)))
    h[spec.n_gen :, POLY_ROW_P_FLOOR] = rng.uniform(0.0, 0.6, (spec.n_des, B))
    h[spec.n_gen :, POLY_ROW_P_CAP, 6] = h[spec.n_gen :, POLY_ROW_P_FLOOR, 6] = -0.5  # empty regions
    px, py = rng.uniform(-1.5, 1.5, (2, C, B))
    px[:, 0], py[:, 1], px[:, 2], py[:, 3] = np.nan, np.nan, np.inf, -np.inf
    args = [torch.tensor(a, dtype=dtype) for a in (px, py, h)]
    card = [a.cuda() for a in args]
    bits = lambda t: t.view(torch.int64 if dtype == torch.float64 else torch.int32)
    x1, y1 = LanesProjector(G, "cuda", dtype)(*card)
    x2, y2 = LanesProjector(G, "cuda", dtype, form="stacked")(*card)
    assert torch.equal(bits(x1), bits(x2)) and torch.equal(bits(y1), bits(y2))
    xc, yc = LanesProjector(G, "cpu", dtype)(*args)
    fin = torch.isfinite(args[0]) & torch.isfinite(args[1])
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(x2.cpu()[fin], xc[fin], rtol=0, atol=tol)
    torch.testing.assert_close(y2.cpu()[fin], yc[fin], rtol=0, atol=tol)
    xb, yb = project_box_slants_lanes(card[0], card[1], G, card[2])
    torch.testing.assert_close(xb.cpu()[fin], xc[fin], rtol=0, atol=2e-5)
    torch.testing.assert_close(yb.cpu()[fin], yc[fin], rtol=0, atol=2e-5)
    assert GridTensors.from_spec(spec, "cuda", torch.float32).projector.form == projection_form("cuda")


def _pool_rollouts(env_name, pf_method, eager, B=4096, segments=2):
    """Two 64-step pool rollouts of the task at B from one seed, through the
    graphed ``step_fn`` or the eager step: ``(final state, [(reward,
    terminated)] a segment, K1/K2/K3 launches, K3's tree launches and its
    counters' gain [iterations, unconverged lanes, lane-solves], graph
    replays)``."""
    from gym_anm_tpu_torch.envs import batched

    core = check.task_make_core(env_name)(dtype=torch.float32, device="cuda", pf_method=pf_method)
    env = BatchedEnv(core, B, generator=torch.Generator(device="cuda").manual_seed(7), auto_reset=True)
    if eager:
        env.step_fn = env._step_eager
    es, _ = env.reset()
    launches = lambda: _launches() + (step_cuda.TREE_LAUNCHES,) + tuple(
        step_cuda.iteration_counts("cuda").tolist() + [step_cuda.LANE_SOLVES])
    l0, r0 = launches(), batched.STEP_GRAPH_REPLAYS
    ys = []
    for _ in range(segments):
        es, y = env.rollout(es, 64)
        ys.append(y)
    torch.cuda.synchronize()
    return es, ys, [b - a for a, b in zip(l0, launches())], batched.STEP_GRAPH_REPLAYS - r0


@pytest.mark.gpu
@pytest.mark.parametrize("env_name, pf_method, k",
                         [("anm6easy", "tree", 0), ("feeder33", "fused", 2), ("feeder141", "fused", 2)],
                         ids=["anm6easy-tree", "feeder33-fused", "feeder141-fused"])
def test_cuda_step_graph_rollout_matches_eager(env_name, pf_method, k):
    """Two pool rollouts at B=4096 replayed from the step's CUDA graph equal
    the eager step's bit for bit (rewards, terminations, every field of the
    final state), and launch the path's kernel as often: once a step and once
    a segment's pool (and once a reset attempt); a replay counts K3's tree
    launches, iterations and lane-solves as the eager steps do, every K3
    launch on the feeders' radial grids in the tree form."""
    _need_cuda()
    from gym_anm_tpu_torch.core.env_core import state_tensors

    es_g, ys_g, launches_g, replays = _pool_rollouts(env_name, pf_method, eager=False)
    es_e, ys_e, launches_e, none = _pool_rollouts(env_name, pf_method, eager=True)
    assert replays == 2 * 64 - 1 and none == 0  # the first step warms up eagerly
    for yg, ye in zip(ys_g, ys_e):
        for a, b in zip(yg, ye):
            _assert_same(a, b)
    for a, b in zip(state_tensors(es_g), state_tensors(es_e)):
        _assert_same(a, b)
    assert launches_g == launches_e and launches_g[k] >= 2 * 64 + 2
    assert sum(launches_g[:3]) == launches_g[k]
    assert launches_g[3] == (launches_g[2] if pf_method == "fused" else 0)


@pytest.mark.gpu
def test_cuda_ppo_train_step_through_the_step_graph_matches_eager():
    """One ``PPOTrainer.train_step`` (ANM6Easy ``tree``, B=4096, a policy
    forward between steps) gives the same metrics and weights whether its
    rollout replays the step's graph or runs the eager step."""
    _need_cuda()
    from gym_anm_tpu_torch.envs import batched
    from gym_anm_tpu_torch.rl.ppo import PPOTrainer

    def run(eager):
        trainer = PPOTrainer(make_core(torch.float32, "cuda"), 4096, seed=3)
        if eager:
            trainer.env.step_fn = trainer.env._step_eager
        r0 = batched.STEP_GRAPH_REPLAYS
        _, metrics = trainer.train_step(trainer.init_envs())
        torch.cuda.synchronize()
        return metrics, trainer.model.state_dict(), batched.STEP_GRAPH_REPLAYS - r0

    m_g, w_g, replays = run(False)
    m_e, w_e, none = run(True)
    assert replays == 63 and none == 0
    for name in m_g:
        _assert_same(m_g[name], m_e[name])
    for name in w_g:
        _assert_same(w_g[name], w_e[name])


@pytest.mark.gpu
@pytest.mark.parametrize("name, amp", [("anm6", 0.3), ("feeder33", 0.05)])
def test_cuda_kernel_counts_its_iterations(name, amp):
    """K1 adds its lanes' NR iterations and budget hits (a NaN lane and a
    diverging one among 1000) to the card's counters, as the plain twin's
    count of the same solve, and counts 1000 lane-solves; the outputs of both
    agree bit for bit."""
    _need_cuda()
    ds, pT, qT = _slot_inputs(name, 1000, amp)
    pT[1, 0] = float("nan")
    pT[:, 1] *= 60.0
    counts = tree_cuda.iteration_counts("cuda")
    c0, s0 = counts.clone(), tree_cuda.LANE_SOLVES
    k = tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, x_tol=1e-5, max_iter=2)
    c1 = counts.clone()
    pl = tree_cuda.solve_pfe_tree_plain(ds, pT, qT, x_tol=1e-5, max_iter=2)
    c2 = counts.clone()
    hits = int(((k[3] == 2) & ~(k[2] <= 1e-5)).sum())
    assert (c1 - c0).tolist() == [int(k[3].sum()), hits] == (c2 - c1).tolist() and hits > 0
    assert tree_cuda.LANE_SOLVES == s0 + 2000
    for a, b in zip(k, pl):
        _assert_same(a, b)


def _counted_pool_rollouts(env_name, eager):
    """Two 64-step pool rollouts of the task's ``tree`` path at B=4096 from
    one seed: ``(final state, [(reward, terminated)] a segment, the
    counters' gain [iterations, budget hits, lane-solves], the n_iter each
    K1 launch returned summed, with the budget hits (eager only))``."""
    from gym_anm_tpu_torch.envs.baranwu33 import make_core as baranwu33_make_core

    make = {"anm6easy": make_core, "baranwu33": baranwu33_make_core}[env_name]
    core = make(torch.float32, "cuda", pf_method="tree")
    env = BatchedEnv(core, 4096, generator=torch.Generator(device="cuda").manual_seed(7), auto_reset=True)
    returned = []
    if eager:
        env.step_fn = env._step_eager
        kernel = tree_cuda.solve_pfe_tree_cuda

        def spy(ds, p, q, x_tol=1e-5, max_iter=10, init=None):
            out = kernel(ds, p, q, x_tol=x_tol, max_iter=max_iter, init=init)
            returned.append(torch.stack([out[3].sum(), ((out[3] == max_iter) & ~(out[2] <= x_tol)).sum()]))
            return out

        tree_cuda.solve_pfe_tree_cuda = spy
    try:
        es, _ = env.reset()
        c0 = tree_cuda.iteration_counts("cuda").tolist() + [tree_cuda.LANE_SOLVES]
        ys = []
        for _ in range(2):
            es, y = env.rollout(es, 64)
            ys.append(y)
        torch.cuda.synchronize()
        c1 = tree_cuda.iteration_counts("cuda").tolist() + [tree_cuda.LANE_SOLVES]
    finally:
        if eager:
            tree_cuda.solve_pfe_tree_cuda = kernel
    n_reset = len(returned) - 2 * (64 + 1) if eager else 0
    summed = torch.stack(returned[n_reset:]).sum(0).tolist() if eager else None
    return es, ys, [b - a for a, b in zip(c0, c1)], summed


@pytest.mark.gpu
@pytest.mark.parametrize("env_name", ["anm6easy", "baranwu33"])
def test_cuda_iteration_counts_through_the_step_graph(env_name):
    """Two pool rollouts replayed from the step's CUDA graph add to K1's
    counters what the eager rollouts' launches returned (the iterations
    summed, the budget hits, B lane-solves a launch), and their steps equal
    the eager steps bit for bit with the counters on."""
    _need_cuda()
    from gym_anm_tpu_torch.core.env_core import state_tensors

    es_g, ys_g, counted_g, _ = _counted_pool_rollouts(env_name, eager=False)
    es_e, ys_e, counted_e, summed = _counted_pool_rollouts(env_name, eager=True)
    assert counted_g == counted_e == summed + [4096 * 2 * (64 + 1)]
    assert 1.0 <= counted_g[0] / counted_g[2] <= 6.0
    for yg, ye in zip(ys_g, ys_e):
        for a, b in zip(yg, ye):
            _assert_same(a, b)
    for a, b in zip(state_tensors(es_g), state_tensors(es_e)):
        _assert_same(a, b)
