"""The port's tree Newton-Raphson solver against the JAX package's.

* The plain PyTorch version in float64 against ``solve_pfe_tree`` (the XLA
  tree path): identical convergence flags and iteration counts, V to 1e-9.
* The plain version in float32 against the TPU kernel
  ``solve_pfe_tree_pallas`` in Pallas interpret mode, with the thresholds
  of ``tests/test_pallas_tree.py`` (summation orders differ, so
  criterion-marginal lanes may flip or take another iteration).
* The dispatch: a CPU tensor runs the plain version; the kernel wrapper
  refuses what the kernel does not take.

The CUDA kernel itself is tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.ops.pallas_tree import build_tree_schedule as jax_build_tree_schedule, solve_pfe_tree_pallas
from gym_anm_tpu.ops.tree_nr import build_tree_info as jax_build_tree_info, solve_pfe_tree as jax_solve_pfe_tree

from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network
from gym_anm_tpu_torch.ops import tree_cuda
from gym_anm_tpu_torch.ops.tree_cuda import DeviceSchedule, solve_pfe_tree

GRIDS = {
    "anm6": (anm6_network, jax_anm6_network, 0.3),
    "feeder33": (make_feeder_network(), JAX_F33, 0.05),
}


def _inputs(n_bus, B, amp, seed, dtype):
    rng = np.random.default_rng(seed)
    m = n_bus - 1
    p = rng.uniform(-amp, amp, (B, m)).astype(dtype)
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (B, m)).astype(dtype)
    return p, q


@pytest.mark.parametrize("name", ["anm6", "feeder33"])
def test_plain_f64_matches_xla_tree(name):
    net, jnet, amp = GRIDS[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=np.float64)
    p, q = _inputs(spec.n_bus, 64, amp, 0, np.float64)
    x_tol, max_iter = 1e-9, 12

    tree = jax_build_tree_info(jspec.br_f, jspec.br_t, jspec.n_bus, jspec.Y_re, jspec.Y_im)
    jv = jax.jit(lambda p, q: jax_solve_pfe_tree(tree, p, q, x_tol=x_tol, max_iter=max_iter))(p, q)
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float64)
    v = solve_pfe_tree(ds, torch.tensor(p), torch.tensor(q), x_tol=x_tol, max_iter=max_iter)

    np.testing.assert_array_equal(v[4].numpy(), np.asarray(jv[4]))
    np.testing.assert_array_equal(v[3].numpy(), np.asarray(jv[3]))
    np.testing.assert_allclose(v[0].numpy(), np.asarray(jv[0]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(v[1].numpy(), np.asarray(jv[1]), rtol=0, atol=1e-9)
    assert v[4].numpy().mean() > 0.9  # the comparison is over converged solves


def test_plain_f32_matches_pallas_kernel_interpret():
    net, jnet, amp = GRIDS["anm6"]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float32)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=np.float32)
    p, q = _inputs(spec.n_bus, 128, amp, 0, np.float32)
    x_tol, max_iter = 1e-5, 12

    sched = jax_build_tree_schedule(jspec.br_f, jspec.br_t, jspec.n_bus, jspec.Y_re, jspec.Y_im, align=1)
    with pltpu.force_tpu_interpret_mode():
        vr_p, vi_p, _, it_p, c_p = solve_pfe_tree_pallas(
            sched, jnp.asarray(p), jnp.asarray(q), x_tol=x_tol, max_iter=max_iter, tile=128
        )
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    vr, vi, _, it, c = solve_pfe_tree(ds, torch.tensor(p), torch.tensor(q), x_tol=x_tol, max_iter=max_iter)

    c, cp = c.numpy(), np.asarray(c_p)
    assert (c == cp).mean() >= 0.99
    both = c & cp
    np.testing.assert_allclose(vr.numpy()[both], np.asarray(vr_p)[both], atol=5e-5)
    np.testing.assert_allclose(vi.numpy()[both], np.asarray(vi_p)[both], atol=5e-5)
    dit = np.abs(it.numpy() - np.asarray(it_p))[both]
    assert (dit <= 1).mean() >= 0.97 and dit.max() <= 4


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
    assert tree_cuda.KERNEL_LAUNCHES == before


def test_plain_freezes_nan_lanes():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float32)
    ds = DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    p, q = _inputs(spec.n_bus, 8, 0.3, 4, np.float32)
    p[3, 2] = np.nan
    _, _, diff, n_iter, conv = solve_pfe_tree(ds, torch.tensor(p), torch.tensor(q))
    assert torch.isnan(diff[3]) and not bool(conv[3]) and int(n_iter[3]) == 0
    assert bool(conv[[0, 1, 2, 4, 5, 6, 7]].all())
