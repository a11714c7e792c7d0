"""The port's tree Newton-Raphson solver against the JAX package's.

* The plain PyTorch version in float64 against ``solve_pfe_tree`` (the XLA
  tree path), from the flat start and warm-started (``init``): identical
  convergence flags and iteration counts, V to 1e-9; lanes whose warm
  point is invalid flat-start.  The JAX side of both cases is the solver's
  warm form (one compile), whose flat start is an absorbing warm state.
* The plain version in float32 against the TPU kernel
  ``solve_pfe_tree_pallas`` in Pallas interpret mode, cold and warm, with
  the thresholds of ``tests/test_pallas_tree.py`` (summation orders differ,
  so criterion-marginal lanes may flip or take another iteration).
* ``warm_init_theta_vm`` against the JAX package's.
* The kernel's gather tables: a parent that gathers its children's terms
  in their listed order adds them as the plain version's pushes do, bit for
  bit.
* The dispatch: a CPU tensor runs the plain version; the kernel wrapper
  refuses what the kernel does not take.

The CUDA kernel itself is tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.envs.feeder141 import _NETWORK as JAX_F141
from gym_anm_tpu.ops.pallas_tree import build_tree_schedule as jax_build_tree_schedule, solve_pfe_tree_pallas
from gym_anm_tpu.ops.power_flow import warm_init_theta_vm as jax_warm_init_theta_vm
from gym_anm_tpu.ops.tree_nr import build_tree_info as jax_build_tree_info, solve_pfe_tree as jax_solve_pfe_tree

from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops import tree_cuda
from gym_anm_tpu_torch.ops.power_flow import warm_init_theta_vm
from gym_anm_tpu_torch.ops.tree_cuda import DeviceSchedule, gather_tables, solve_pfe_tree


GRIDS = {
    "anm6": (anm6_network, jax_anm6_network, 0.3),
    "feeder33": (make_feeder_network(), JAX_F33, 0.05),
    "feeder141": (make_multi_feeder_network(), JAX_F141, 0.02),
}


def _inputs(n_bus, B, amp, seed, dtype):
    rng = np.random.default_rng(seed)
    m = n_bus - 1
    p = rng.uniform(-amp, amp, (B, m)).astype(dtype)
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (B, m)).astype(dtype)
    return p, q


F64_KW = dict(x_tol=1e-9, max_iter=12)
N_INVALID = 5  # lanes whose warm point is zeroed: they flat-start


def _warm_init(spec, p, q, dtype):
    """Previous voltages ``(v_re, v_im) [B, n]``: the solution of a nearby
    problem, with the first lanes zeroed (an absorbing state)."""
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float64 if dtype == np.float64 else torch.float32)
    vr, vi = solve_pfe_tree(ds, torch.tensor(0.9 * p), torch.tensor(0.9 * q), x_tol=1e-9, max_iter=12)[:2]
    vr, vi = vr.numpy().copy(), vi.numpy().copy()
    vr[:N_INVALID] = 0.0
    vi[:N_INVALID] = 0.0
    return vr, vi


@functools.lru_cache(maxsize=None)
def _f64_case(name):
    """The grid's inputs and the JAX package's solves from the flat start and
    warm-started, both by one compiled program: its warm form, given an
    absorbing (all-zero) state for the flat start, starts every lane flat."""
    net, jnet, amp = GRIDS[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=np.float64)
    p, q = _inputs(spec.n_bus, 64, amp, 0, np.float64)
    init = _warm_init(spec, p, q, np.float64)
    tree = jax_build_tree_info(jspec.br_f, jspec.br_t, jspec.n_bus, jspec.Y_re, jspec.Y_im)
    run = jax.jit(lambda p, q, vr, vi: jax_solve_pfe_tree(tree, p, q, init=(vr, vi), **F64_KW))
    absorbing = np.zeros_like(init[0])
    return spec, p, q, init, {False: run(p, q, absorbing, absorbing), True: run(p, q, *init)}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_plain_f64_matches_xla_tree(name, warm):
    spec, p, q, init, jax_out = _f64_case(name)
    jv = jax_out[warm]
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float64)
    v = solve_pfe_tree(
        ds, torch.tensor(p), torch.tensor(q), init=tuple(map(torch.tensor, init)) if warm else None, **F64_KW
    )

    np.testing.assert_array_equal(v[4].numpy(), np.asarray(jv[4]))
    np.testing.assert_array_equal(v[3].numpy(), np.asarray(jv[3]))
    # V on every lane from the flat start; warm, one feeder33 lane diverges
    # and its trajectory amplifies rounding, so V on the converged lanes.
    lanes = np.asarray(jv[4]) if warm else slice(None)
    np.testing.assert_allclose(v[0].numpy()[lanes], np.asarray(jv[0])[lanes], rtol=0, atol=1e-9)
    np.testing.assert_allclose(v[1].numpy()[lanes], np.asarray(jv[1])[lanes], rtol=0, atol=1e-9)
    assert v[4].numpy().mean() > 0.9  # the comparison is over converged solves
    if warm:
        # The invalid lanes flat-start; the others start closer and take fewer steps.
        cold = np.asarray(jax_out[False][3])
        np.testing.assert_array_equal(v[3].numpy()[:N_INVALID], cold[:N_INVALID])
        assert v[3].numpy()[N_INVALID:].sum() < cold[N_INVALID:].sum()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_plain_f32_matches_pallas_kernel_interpret(warm):
    net, jnet, amp = GRIDS["anm6"]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float32)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=np.float32)
    p, q = _inputs(spec.n_bus, 128, amp, 0, np.float32)  # 128: the kernel's smallest lane tile
    x_tol, max_iter = 1e-5, 12
    init = _warm_init(spec, p, q, np.float32) if warm else None

    sched = jax_build_tree_schedule(jspec.br_f, jspec.br_t, jspec.n_bus, jspec.Y_re, jspec.Y_im, align=1)
    with pltpu.force_tpu_interpret_mode():
        vr_p, vi_p, _, it_p, c_p = solve_pfe_tree_pallas(
            sched, jnp.asarray(p), jnp.asarray(q), x_tol=x_tol, max_iter=max_iter, tile=128,
            init=None if init is None else tuple(map(jnp.asarray, init)),
        )
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    vr, vi, _, it, c = solve_pfe_tree(
        ds, torch.tensor(p), torch.tensor(q), x_tol=x_tol, max_iter=max_iter,
        init=None if init is None else tuple(map(torch.tensor, init)),
    )

    c, cp = c.numpy(), np.asarray(c_p)
    assert (c == cp).mean() >= 0.99
    both = c & cp
    np.testing.assert_allclose(vr.numpy()[both], np.asarray(vr_p)[both], atol=5e-5)
    np.testing.assert_allclose(vi.numpy()[both], np.asarray(vi_p)[both], atol=5e-5)
    dit = np.abs(it.numpy() - np.asarray(it_p))[both]
    assert (dit <= 1).mean() >= 0.97 and dit.max() <= 4


def test_warm_init_theta_vm_equals_jax():
    rng = np.random.default_rng(2)
    B, n = 32, 6
    vm = rng.uniform(0.9, 1.1, (B, n))
    th = rng.uniform(-0.3, 0.3, (B, n))
    vr, vi = vm * np.cos(th), vm * np.sin(th)
    vr[1] = 0.0  # absorbing state
    vi[2, 3] = np.nan  # diverged
    vr[3, 4] = 5.0  # outside the window
    vr[4, 2] = 0.2
    vi[4, 2] = 0.0
    ours = warm_init_theta_vm(torch.tensor(vr), torch.tensor(vi), n - 1, torch.float64)
    theirs = jax_warm_init_theta_vm(jnp.asarray(vr), jnp.asarray(vi), n - 1, jnp.float64)
    # XLA may contract vr * vr + vi * vi into a fused multiply-add: |V| to 1 ulp.
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    np.testing.assert_array_equal(ours[2].numpy()[:6], [True, False, False, False, False, True])


@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_gather_tables_add_in_the_push_order(name):
    """The kernel's gather (each slot adds its children's terms in
    ``gather_tables`` order, from 0) against the plain version's push
    (``acc[dst:dst+k] += val[src:src+k]`` in run order), bit for bit."""
    net = {"anm6": anm6_network, "feeder33": make_feeder_network(), "feeder141": make_multi_feeder_network()}[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float32)
    sched = DeviceSchedule.from_spec(spec, "cpu", torch.float32).sched
    par, children = gather_tables(sched)
    rng = np.random.default_rng(0)
    val = (rng.standard_normal((sched.S, 256)) * 10.0 ** rng.uniform(-4, 4, (sched.S, 256))).astype(np.float32)
    push = np.zeros_like(val)
    for lruns in sched.runs:
        for src, k, dst in lruns:
            push[dst : dst + k] += val[src : src + k]
            np.testing.assert_array_equal(par[src : src + k], np.arange(dst, dst + k))
    gather = np.zeros_like(val)
    for c in range(children.shape[0]):
        kids = children[c]
        has = kids >= 0
        gather[has] = gather[has] + val[kids[has]]
    np.testing.assert_array_equal(gather, push)
    assert (children >= 0).sum() == (par >= 0).sum() and children.shape[0] == sched.maxC


def test_cpu_dispatch_runs_plain_and_kernel_wrapper_refuses():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float32)
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    p, q = _inputs(spec.n_bus, 16, 0.3, 3, np.float32)
    before = tree_cuda.KERNEL_LAUNCHES
    out = solve_pfe_tree(ds, torch.tensor(p), torch.tensor(q))
    assert tree_cuda.KERNEL_LAUNCHES == before
    assert out[0].shape == (16, spec.n_bus) and out[2].dtype == torch.float32 and out[3].dtype == torch.int32

    S = ds.sched.S
    pT = torch.zeros((S, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tree_cuda.solve_pfe_tree_cuda(ds, pT, pT)
    with pytest.raises(ValueError, match="CUDA"):
        tree_cuda.solve_pfe_tree_cuda(ds, pT, pT, init=(pT, pT))
    assert tree_cuda.KERNEL_LAUNCHES == before


def test_plain_freezes_nan_lanes():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float32)
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    p, q = _inputs(spec.n_bus, 8, 0.3, 4, np.float32)
    p[3, 2] = np.nan
    _, _, diff, n_iter, conv = solve_pfe_tree(ds, torch.tensor(p), torch.tensor(q))
    assert torch.isnan(diff[3]) and not bool(conv[3]) and int(n_iter[3]) == 0
    assert bool(conv[[0, 1, 2, 4, 5, 6, 7]].all())
