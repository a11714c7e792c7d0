"""Every solver path of the port at every grid size.

feeder141's ``make_core`` builds each method the JAX package builds there,
with its budgets and ``x_tol``, and refuses the dense kernels' methods (and
``fused`` with pivoting); it builds ``fused`` itself, the whole-transition
kernel's tree form, on its own network or one it is given;
``resolve_solver_path`` routes ``tree_xla`` to the tree kernel's plain twin,
refuses the dense kernels' methods on grids beyond 64 unknowns, but for
``fused`` on a radial grid without pivoting, and runs ``hybrid`` there
chord-only on the plain solver; on the CPU ``tree_xla`` and ``tree`` are the same bits.  The plain
solver's chord step (one ``J0inv @ F`` product) is held against the dense
kernel twin's column loop at feeder141; at ANM6 and feeder33 it is held
against JAX by ``tests/test_torch_power_flow.py``.  The replays of the
committed references through these paths are in
``tests/test_torch_solver_replays.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_anm_tpu.envs.feeder141 import make_core as jax_f141_make_core

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.core.transition import resolve_solver_path
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder141 import make_core
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops import nr_cuda
from gym_anm_tpu_torch.ops.power_flow import flat_start_jacobian_inv_np


F141_METHODS = ("tree", "tree_xla", "hybrid", "xla_hybrid", "scan", "while")


@pytest.mark.parametrize("method", F141_METHODS)
def test_feeder141_make_core_takes_jax_budgets(method):
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        core = make_core(dtype=dtype, device="cpu", pf_method=method)
        jcore = jax_f141_make_core(dtype=jdtype, pf_method=method)
        assert core.pf_method == method
        assert (core.max_iter, core.x_tol, core.chord_iters) == (jcore.max_iter, jcore.x_tol, jcore.chord_iters)
    assert make_core(dtype=torch.float64, device="cpu", pf_method=method, pf_max_iter=3, x_tol=1e-7).max_iter == 3


@pytest.mark.parametrize("method", ["pallas", "fused", "fused_hybrid"])
def test_feeder141_make_core_refuses_the_dense_kernels(method):
    # "fused" takes the tree form at this size, which has no pivoting: with
    # it, the transition would need the dense form.
    kw = dict(nr_pivot=True) if method == "fused" else {}
    with pytest.raises(ValueError, match="64 unknowns"):
        make_core(device="cpu", pf_method=method, **kw)


def test_feeder141_make_core_takes_a_network():
    """``network=`` (as the benchmark passes it) builds the core of the
    network given; the default network gives the default core, and
    ``fused`` takes the tree solves' budget of 18 and their ``x_tol``."""
    for dtype, x_tol in ((torch.float32, 3e-5), (torch.float64, 1e-5)):
        mine = make_core(dtype=dtype, device="cpu", pf_method="fused", network=make_multi_feeder_network())
        default = make_core(dtype=dtype, device="cpu", pf_method="fused")
        assert (mine.pf_method, mine.max_iter, mine.x_tol) == (default.pf_method, default.max_iter, default.x_tol)
        assert (mine.max_iter, mine.x_tol) == (18, x_tol)
        assert resolve_solver_path(mine.grid, "fused", False) == ("fused_kernel", "fused")
        for f in dataclasses.fields(mine.spec):
            a, b = getattr(mine.spec, f.name), getattr(default.spec, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    other = make_core(device="cpu", pf_method="fused", network=make_multi_feeder_network(seed=1))
    assert other.spec.n_bus == 141 and not np.array_equal(np.asarray(other.spec.br_rate), np.asarray(mine.spec.br_rate))


def _grid(name):
    net = {"anm6": lambda: anm6_network, "feeder33": make_feeder_network, "feeder141": make_multi_feeder_network}
    return GridTensors.from_spec(build_grid(net[name](), 0.25, 100, dtype=np.float32)[0], "cpu", torch.float32)


# (method, path, effective method) on grids within and beyond the dense
# kernels' 64 unknowns; None: refused.
ROUTES = {
    "small": {
        "tree": ("tree_kernel", "tree"), "tree_xla": ("tree_plain", "tree_xla"),
        "pallas": ("nr_kernel", "pallas"), "hybrid": ("nr_kernel", "hybrid"),
        "fused": ("fused_kernel", "fused"), "fused_hybrid": ("fused_kernel", "fused_hybrid"),
        "scan": ("torch", "scan"), "while": ("torch", "while"), "xla_hybrid": ("torch", "xla_hybrid"),
    },
    "large": {
        "tree": ("tree_kernel", "tree"), "tree_xla": ("tree_plain", "tree_xla"),
        "pallas": None, "hybrid": ("torch", "hybrid"), "fused": ("fused_kernel", "fused"), "fused_hybrid": None,
        "scan": ("torch", "scan"), "while": ("torch", "while"), "xla_hybrid": ("torch", "xla_hybrid"),
    },
}


@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_resolve_solver_path_routes(name):
    g = _grid(name)
    routes = ROUTES["large" if 2 * (g.spec.n_bus - 1) > nr_cuda.NN_MAX else "small"]
    assert (name == "feeder141") == (routes is ROUTES["large"])
    for method, want in routes.items():
        if want is None:
            with pytest.raises(ValueError, match="64 unknowns"):
                resolve_solver_path(g, method, False)
            with pytest.raises(ValueError, match="64 unknowns"):
                resolve_solver_path(dataclasses.replace(g, step=None), method, False)
        else:
            assert resolve_solver_path(g, method, False) == want, method
    for method in ("tree", "tree_xla"):
        with pytest.raises(ValueError, match="radial"):
            resolve_solver_path(dataclasses.replace(g, tree=None), method, False)
    if routes is ROUTES["large"]:
        # "fused" past 64 unknowns: the tree form only, on a radial grid
        # with step tables and without pivoting.
        meshed = dataclasses.replace(g, step=dataclasses.replace(g.step, tree=None))
        for grid, pivot in ((dataclasses.replace(g, step=None), False), (meshed, False), (g, True)):
            with pytest.raises(ValueError, match="64 unknowns"):
                resolve_solver_path(grid, "fused", pivot)


def test_chord_matmul_matches_column_loop_feeder141_f64():
    """Chord-only (the feeder141 hybrids' 28 iterations, no NR tail): the
    plain solver's one product a step against the kernel twin's column
    loop, from the same injections."""
    g = build_grid(make_multi_feeder_network(), 0.25, 100, dtype=np.float64)[0]
    Y_re, Y_im = torch.tensor(np.asarray(g.Y_re)), torch.tensor(np.asarray(g.Y_im))
    J0inv = torch.tensor(flat_start_jacobian_inv_np(g.Y_re, g.Y_im))
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.uniform(-0.02, 0.02, (g.n_bus - 1, 16)))
    q = torch.tensor(rng.uniform(-0.012, 0.012, (g.n_bus - 1, 16)))
    kw = dict(x_tol=1e-10, max_iter=0, chord_iters=28)
    loop = nr_cuda.nr_core_plain(Y_re, Y_im, J0inv, p, q, **kw)
    mm = nr_cuda.nr_core_plain(Y_re, Y_im, J0inv, p, q, **kw, chord_matmul=True)
    assert bool((loop[4] <= 1e-10).all())
    torch.testing.assert_close(mm[5], loop[5], rtol=0, atol=0)
    for a, b in zip(mm[:4], loop[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("env", ["anm6easy", "feeder33"])
def test_tree_xla_is_the_tree_kernels_plain_twin(env):
    """On the CPU both tree paths run the plain twin: the same bits."""
    data = check.load_reference(env)
    out = []
    for method in ("tree", "tree_xla"):
        core = check.task_make_core(env)(dtype=torch.float32, device="cpu", pf_method=method)
        out.append(check.rollout_given(core, data["s0"][:32], data["actions"][:4, :32], data["vars"][:4, :32]))
    for a, b in zip(*out):
        assert torch.equal(a, b)
