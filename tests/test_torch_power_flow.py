"""The port's plain dense power-flow solver against the JAX package's.

``gym_anm_tpu_torch.ops.power_flow.solve_pfe`` (scan / while / hybrid)
against ``gym_anm_tpu.ops.power_flow.solve_pfe`` in float64 on the ANM6 and
feeder33 grids, from injections made with numpy: identical iteration counts
and convergence flags, V to 1e-9; warm-started (``init=``) on ANM6 too.
The feeder33 solves are the JAX package's recorded by
``scripts/gen_torch_test_refs.py`` in ``tests/data/torch_refs_power_flow.npz``
(their program takes half a minute to compile); ANM6's run live.  Also the
host builder ``flat_start_jacobian_inv_np`` (a copy)."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.envs.feeder141 import _NETWORK as JAX_F141
from gym_anm_tpu.ops.power_flow import (
    flat_start_jacobian_inv_np as jax_flat_start_jacobian_inv_np,
    solve_pfe as jax_solve_pfe,
)

from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops.power_flow import flat_start_jacobian_inv_np, solve_pfe


GRIDS = {
    "anm6": (anm6_network, jax_anm6_network, 0.3),
    "feeder33": (make_feeder_network(), JAX_F33, 0.05),
}


def _case(name, B, seed):
    net, jnet, amp = GRIDS[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=np.float64)
    rng = np.random.default_rng(seed)
    m = spec.n_bus - 1
    p = rng.uniform(-amp, amp, (B, m))
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (B, m))
    return spec, jspec, p, q


METHODS = ("scan", "while", "hybrid")
KW = dict(x_tol=1e-9, max_iter=8, chord_iters=6)
# The methods held warm-started against the JAX package, on ANM6.
WARM_METHODS = ("scan", "hybrid")


def _case_f64(name):
    spec, jspec, p, q = _case(name, 48, 1)
    # A large injection on a few lanes leaves them unconverged (or NaN).
    p[:3] *= 40.0
    return spec, jspec, p, q


@functools.lru_cache(maxsize=None)
def _warm_voltages(name):
    """Raw warm voltages ``[B, n]`` for the float64 case: the solution of
    the problem scaled by 0.9, with lanes 3-5 zeroed and lane 6 NaN, so
    that they flat-start."""
    spec, _, p, q = _case_f64(name)
    Y = lambda a: torch.tensor(np.asarray(a))
    vr, vi = solve_pfe(Y(spec.Y_re), Y(spec.Y_im), torch.tensor(0.9 * p), torch.tensor(0.9 * q), **KW)[:2]
    vr, vi = vr.numpy().copy(), vi.numpy().copy()
    vr[3:6] = 0.0
    vi[6] = np.nan
    return vr, vi


@functools.lru_cache(maxsize=None)
def _jax_solves(name):
    """The JAX package's solves of every method on one grid (and, on ANM6,
    the warm-started ones, keyed ``method + "-warm"``), compiled as one
    program (one compile instead of one a method); feeder33's as recorded."""
    _, jspec, p, q = _case_f64(name)
    if name == "feeder33":
        with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_power_flow.npz")) as z:
            np.testing.assert_array_equal(p, z["feeder33/p"], err_msg="re-run scripts/gen_torch_test_refs.py")
            np.testing.assert_array_equal(q, z["feeder33/q"], err_msg="re-run scripts/gen_torch_test_refs.py")
            return {m: [z["feeder33/%s/%d" % (m, i)] for i in range(5)] for m in METHODS}
    warm = WARM_METHODS if name == "anm6" else ()

    def run(Yr, Yi, p, q, v0):
        out = {m: jax_solve_pfe(Yr, Yi, p, q, method=m, **KW) for m in METHODS}
        out.update({m + "-warm": jax_solve_pfe(Yr, Yi, p, q, method=m, **KW, init=v0) for m in warm})
        return out

    v0 = _warm_voltages(name) if warm else None
    return {m: [np.asarray(x) for x in v] for m, v in jax.jit(run)(jspec.Y_re, jspec.Y_im, p, q, v0).items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["anm6", "feeder33"])
def test_solve_pfe_matches_jax_f64(name, method):
    spec, _, p, q = _case_f64(name)
    kw = dict(KW, method=method)
    jv = _jax_solves(name)[method]
    Y = lambda a: torch.tensor(np.asarray(a))
    v = solve_pfe(Y(spec.Y_re), Y(spec.Y_im), torch.tensor(p), torch.tensor(q), **kw)
    conv = np.asarray(jv[4])
    assert 0.5 < conv.mean() < 1.0
    np.testing.assert_array_equal(v[4].numpy(), conv)
    np.testing.assert_array_equal(v[3].numpy(), np.asarray(jv[3]))
    np.testing.assert_allclose(v[0].numpy()[conv], np.asarray(jv[0])[conv], rtol=0, atol=1e-9)
    np.testing.assert_allclose(v[1].numpy()[conv], np.asarray(jv[1])[conv], rtol=0, atol=1e-9)


@pytest.mark.parametrize("method", WARM_METHODS)
def test_solve_pfe_warm_matches_jax_f64(method):
    """``init=``: each lane starts from the better of {warm point, flat
    start}; non-finite and out-of-window voltages flat-start."""
    spec, _, p, q = _case_f64("anm6")
    jv = _jax_solves("anm6")[method + "-warm"]
    Y = lambda a: torch.tensor(np.asarray(a))
    init = tuple(torch.tensor(a) for a in _warm_voltages("anm6"))
    v = solve_pfe(Y(spec.Y_re), Y(spec.Y_im), torch.tensor(p), torch.tensor(q), method=method, **KW, init=init)
    conv = np.asarray(jv[4])
    assert 0.5 < conv.mean() < 1.0
    np.testing.assert_array_equal(v[4].numpy(), conv)
    np.testing.assert_array_equal(v[3].numpy(), np.asarray(jv[3]))
    np.testing.assert_allclose(v[0].numpy()[conv], np.asarray(jv[0])[conv], rtol=0, atol=1e-9)
    np.testing.assert_allclose(v[1].numpy()[conv], np.asarray(jv[1])[conv], rtol=0, atol=1e-9)
    cold = np.asarray(_jax_solves("anm6")[method][3])
    assert v[3].numpy()[7:].mean() < cold[7:].mean()


def test_solve_pfe_chord_only():
    spec, jspec, p, q = _case("anm6", 4, 2)
    Y = lambda a: torch.tensor(np.asarray(a))
    # Chord only (max_iter=0): no NR step, iteration counts are the chord's.
    kw = dict(x_tol=1e-9, max_iter=0, method="hybrid", chord_iters=30)
    ours = solve_pfe(Y(spec.Y_re), Y(spec.Y_im), torch.tensor(p), torch.tensor(q), **kw)
    theirs = jax_solve_pfe(jspec.Y_re, jspec.Y_im, p, q, **kw)
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(theirs[3]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="method"):
        solve_pfe(Y(spec.Y_re), Y(spec.Y_im), torch.tensor(p), torch.tensor(q), method="chord")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "net, jnet",
    [(anm6_network, jax_anm6_network), (make_feeder_network(), JAX_F33), (make_multi_feeder_network(), JAX_F141)],
    ids=["anm6", "feeder33", "feeder141"],
)
def test_flat_start_jacobian_inv_equals_jax(net, jnet, dtype):
    spec, _ = build_grid(net, 0.25, 100, dtype=dtype)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=dtype)
    ours = flat_start_jacobian_inv_np(spec.Y_re, spec.Y_im)
    theirs = jax_flat_start_jacobian_inv_np(jspec.Y_re, jspec.Y_im)
    assert ours.dtype == theirs.dtype == dtype
    np.testing.assert_array_equal(ours, theirs)
