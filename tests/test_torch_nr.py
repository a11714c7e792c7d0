"""The port's dense Newton-Raphson solver (the plain twin of the CUDA kernel)
against the JAX package's.

* ``nr_core_plain`` in float64 against ``gym_anm_tpu.ops.pallas_nr.nr_core``
  (the TPU kernel's body, plain jnp) for pivot {False, True} x chord
  {0, 16}: identical convergence flags, the same iteration counts on
  converged lanes, V and I to 1e-9.
* The warm form: ``nr_core_plain(init=)`` against ``nr_core(init=)`` in
  float64 on ANM6 and feeder33 (the warm point the solved V of a 0.9x
  problem, a few lanes zeroed so that they flat-start): identical flags,
  the same iteration counts on converged lanes, V and I to 1e-9.
* ``nr_core_plain`` in float32 against the TPU kernel ``solve_pfe_pallas``
  in Pallas interpret mode, cold and warm, with the tree kernel's agreement
  rule (summation orders differ, so lanes on the criterion may stop a step
  or two apart).
* The dispatch: a CPU tensor runs the plain twin; the kernel wrapper refuses
  what the kernel does not take.
* The pivoted elimination, and the kernel's FLOP count against the
  operations the plain twin performs.

The CUDA kernel itself is tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import TorchDispatchMode

from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.ops.pallas_nr import nr_core, solve_pfe_pallas
from gym_anm_tpu.ops.power_flow import flat_start_jacobian_inv_np as jax_j0inv

from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network
from gym_anm_tpu_torch.ops import nr_cuda
from gym_anm_tpu_torch.ops.nr_cuda import nr_core_plain, solve_pfe_nr
from gym_anm_tpu_torch.ops.power_flow import warm_init_theta_vm


GRIDS = {
    "anm6": (anm6_network, jax_anm6_network, 0.3),
    "feeder33": (make_feeder_network(), JAX_F33, 0.05),
}


def _case(name, B, seed, dtype):
    net, jnet, amp = GRIDS[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=dtype)
    jspec, _ = jax_build_grid(jnet, 0.25, 100, dtype=dtype)
    g = GridTensors.from_spec(spec, "cpu", torch.float64 if dtype == np.float64 else torch.float32)
    rng = np.random.default_rng(seed)
    m = spec.n_bus - 1
    p = rng.uniform(-amp, amp, (m, B)).astype(dtype)
    q = rng.uniform(-0.6 * amp, 0.6 * amp, (m, B)).astype(dtype)
    return g, jspec, p, q


NR_CASES = [("anm6", 0, False), ("anm6", 0, True), ("anm6", 16, False), ("anm6", 16, True), ("feeder33", 16, False)]
# The warm form's cases: (grid, chord_iters, pivot).
NR_WARM_CASES = [("anm6", 0, False), ("anm6", 16, True), ("feeder33", 16, False)]


def _case_f64(name):
    g, jspec, p, q = _case(name, 48, 0, np.float64)
    p[:, :2] *= 30.0  # a few lanes that do not converge
    return g, jspec, p, q


def _nr_kw(chord, pivot):
    return dict(x_tol=1e-9, max_iter=8, chord_iters=chord, pivot=pivot)


def _warm_voltages(g, p, q, zeroed=slice(2, 5)):
    """Bus voltages ``[B, n]`` of the problem scaled by 0.9 (pivoted, to
    1e-9), the lanes ``zeroed`` set to 0 so that they flat-start."""
    vr, vi, *_ = nr_core_plain(g.Y_re, g.Y_im, g.J0inv, 0.9 * p, 0.9 * q, **_nr_kw(0, True))
    vr = vr.clone()
    vr[:, zeroed] = 0.0
    return vr.T, vi.T


@functools.lru_cache(maxsize=None)
def _warm_point(name):
    """The sanitised warm point ``(theta, vm) [m, B]`` of the float64 cases
    (the diverged lanes 0-1 and the zeroed lanes 2-4 flat-start)."""
    g, _, p, q = _case_f64(name)
    vr, vi = _warm_voltages(g, torch.tensor(p), torch.tensor(q))
    th, vm, _ = warm_init_theta_vm(vr, vi, g.spec.n_bus - 1, torch.float64)
    return th.numpy(), vm.numpy()


@functools.lru_cache(maxsize=None)
def _jax_nr_core(name):
    """The JAX ``nr_core`` of every case of one grid, cold and warm,
    compiled as one program."""
    _, jspec, p, q = _case_f64(name)
    J0 = jax_j0inv(jspec.Y_re, jspec.Y_im)
    settings = [(c, pv) for n, c, pv in NR_CASES if n == name]
    warm = [("warm", c, pv) for n, c, pv in NR_WARM_CASES if n == name]
    core = lambda p, q, c, pv, init=None: nr_core(jspec.Y_re, jspec.Y_im, J0, p, q, **_nr_kw(c, pv), init=init)
    run = jax.jit(
        lambda p, q, th, vm: [core(p, q, c, pv) for c, pv in settings]
        + [core(p, q, c, pv, (th, vm)) for _, c, pv in warm]
    )
    return {s: [np.asarray(x) for x in out] for s, out in zip(settings + warm, run(p, q, *_warm_point(name)))}


@pytest.mark.parametrize("name, chord, pivot", NR_CASES)
def test_plain_f64_matches_nr_core(name, chord, pivot):
    g, _, p, q = _case_f64(name)
    ours = nr_core_plain(g.Y_re, g.Y_im, g.J0inv, torch.tensor(p), torch.tensor(q), **_nr_kw(chord, pivot))
    theirs = _jax_nr_core(name)[(chord, pivot)]
    conv = np.asarray(theirs[4]) <= 1e-9
    assert 0.5 < conv.mean() < 1.0
    np.testing.assert_array_equal(ours[4].numpy() <= 1e-9, conv)
    # Iteration counts agree on converged lanes; a diverging lane's
    # trajectory amplifies rounding and may go NaN one step apart.
    np.testing.assert_array_equal(ours[5].numpy()[conv], np.asarray(theirs[5])[conv])
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_allclose(a.numpy()[:, conv], np.asarray(b)[:, conv], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name, chord, pivot", NR_WARM_CASES)
def test_plain_f64_warm_matches_nr_core(name, chord, pivot):
    """The warm form: each lane starts from the better of {warm, flat}; the
    chord prefix's worsened lanes restart flat."""
    g, _, p, q = _case_f64(name)
    th, vm = (torch.tensor(a) for a in _warm_point(name))
    args = (g.Y_re, g.Y_im, g.J0inv, torch.tensor(p), torch.tensor(q))
    ours = nr_core_plain(*args, **_nr_kw(chord, pivot), init=(th, vm))
    theirs = _jax_nr_core(name)[("warm", chord, pivot)]
    conv = np.asarray(theirs[4]) <= 1e-9
    assert 0.5 < conv.mean() < 1.0
    np.testing.assert_array_equal(ours[4].numpy() <= 1e-9, conv)
    # As cold: iteration counts agree on converged lanes (a diverging lane's
    # trajectory amplifies rounding and may go NaN one step apart).
    np.testing.assert_array_equal(ours[5].numpy()[conv], np.asarray(theirs[5])[conv])
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_allclose(a.numpy()[:, conv], np.asarray(b)[:, conv], rtol=0, atol=1e-9)
    # The warm point saves iterations on the lanes that take it.
    cold = nr_core_plain(*args, **_nr_kw(chord, pivot))
    assert ours[5][5:].float().mean() < cold[5][5:].float().mean()


def test_plain_f32_matches_pallas_kernel_interpret():
    g, jspec, p, q = _case("anm6", 128, 0, np.float32)
    x_tol, max_iter = 1e-5, 10
    with pltpu.force_tpu_interpret_mode():
        vr_p, vi_p, _, it_p, c_p = solve_pfe_pallas(
            jspec.Y_re, jspec.Y_im, jnp.asarray(p.T), jnp.asarray(q.T), x_tol=x_tol, max_iter=max_iter, tile=128
        )
    vr, vi, _, it, c = solve_pfe_nr(g.Y_re, g.Y_im, g.J0inv, torch.tensor(p.T), torch.tensor(q.T), x_tol, max_iter)
    # The tree kernel's rule (tests/test_torch_tree.py): in float32 the
    # mismatch floor of I = YV sits near x_tol, so a lane on the criterion
    # may stop a step or two apart under another summation order.
    c, cp = c.numpy(), np.asarray(c_p)
    assert (c == cp).mean() >= 0.99 and c.mean() > 0.9
    both = c & cp
    np.testing.assert_allclose(vr.numpy()[both], np.asarray(vr_p)[both], atol=5e-5)
    np.testing.assert_allclose(vi.numpy()[both], np.asarray(vi_p)[both], atol=5e-5)
    dit = np.abs(it.numpy() - np.asarray(it_p))[both]
    assert (dit <= 1).mean() >= 0.97 and dit.max() <= 4


def test_plain_f32_warm_matches_pallas_kernel_interpret():
    """The TPU kernel's warm form (``solve_pfe_pallas(init=)``) against the
    port's, from the same raw voltages, with the agreement rule above."""
    g, jspec, p, q = _case("anm6", 128, 6, np.float32)
    x_tol, max_iter = 1e-5, 10
    v_re, v_im = _warm_voltages(g, torch.tensor(p), torch.tensor(q))
    v_im = v_im.clone()
    v_im[5] = float("nan")  # a non-finite warm point flat-starts
    with pltpu.force_tpu_interpret_mode():
        vr_p, vi_p, _, it_p, c_p = solve_pfe_pallas(
            jspec.Y_re, jspec.Y_im, jnp.asarray(p.T), jnp.asarray(q.T), x_tol=x_tol, max_iter=max_iter, tile=128,
            init=(jnp.asarray(v_re.numpy()), jnp.asarray(v_im.numpy())),
        )
    vr, vi, _, it, c = solve_pfe_nr(
        g.Y_re, g.Y_im, g.J0inv, torch.tensor(p.T), torch.tensor(q.T), x_tol, max_iter, init=(v_re, v_im)
    )
    c, cp = c.numpy(), np.asarray(c_p)
    assert (c == cp).mean() >= 0.99 and c.mean() > 0.9
    both = c & cp
    np.testing.assert_allclose(vr.numpy()[both], np.asarray(vr_p)[both], atol=5e-5)
    np.testing.assert_allclose(vi.numpy()[both], np.asarray(vi_p)[both], atol=5e-5)
    dit = np.abs(it.numpy() - np.asarray(it_p))[both]
    assert (dit <= 1).mean() >= 0.97 and dit.max() <= 4
    # Warm lanes start near their solution; the zeroed and NaN lanes start flat.
    assert it.float()[6:].mean() < it.float()[2:6].mean()


def test_cpu_dispatch_runs_plain_and_kernel_wrapper_refuses():
    g, _, p, q = _case("anm6", 16, 3, np.float32)
    before = nr_cuda.KERNEL_LAUNCHES
    out = solve_pfe_nr(g.Y_re, g.Y_im, g.J0inv, torch.tensor(p.T), torch.tensor(q.T), chord_iters=16, pivot=True)
    assert nr_cuda.KERNEL_LAUNCHES == before
    assert out[0].shape == (16, 6) and out[2].dtype == torch.float32 and out[3].dtype == torch.int32
    assert bool(out[4].all())
    with pytest.raises(ValueError, match="CUDA"):
        nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, torch.tensor(p), torch.tensor(q))
    assert nr_cuda.KERNEL_LAUNCHES == before


def test_plain_freezes_nan_and_singular_lanes():
    g, _, p, q = _case("anm6", 8, 4, np.float32)
    p[0, 1] = np.nan
    p[:, 2] *= 1e6  # a collapse: diverges to inf/NaN, never "converged"
    vr, vi, ir, ii, diff, it = nr_core_plain(
        g.Y_re, g.Y_im, g.J0inv, torch.tensor(p), torch.tensor(q), x_tol=1e-5, max_iter=10, chord_iters=0
    )
    assert np.isnan(diff[1].item()) and it[1].item() == 0
    assert not diff[2].item() <= 1e-5
    assert bool((diff[3:] <= 1e-5).all())


def test_flops_per_lane_equals_jax():
    from gym_anm_tpu.ops.pallas_nr import nr_flops_per_lane as jax_flops

    for args in ((6, 10, 0, True), (33, 6, 16, False), (141, 3, 2, True)):
        assert nr_cuda.nr_flops_per_lane(*args) == jax_flops(*args[:3], pivot=args[3])


def test_pivoted_elimination_solves():
    rng = np.random.default_rng(3)
    n, B = 7, 16
    A = rng.normal(size=(n, n, B))
    A[0, 0, :4] = 0.0  # needs a row exchange
    b = rng.normal(size=(n, B))
    ref = np.linalg.solve(np.moveaxis(A, -1, 0), np.moveaxis(b, -1, 0)[..., None])[..., 0].T
    Ab = torch.tensor(np.concatenate([A, b[:, None, :]], axis=1))
    np.testing.assert_allclose(nr_cuda._solve_system(Ab, pivot=True).numpy(), ref, rtol=1e-9, atol=1e-9)
    # A singular lane gives inf/NaN, no exception.
    A[:, :, 5] = 0.0
    Ab = torch.tensor(np.concatenate([A, b[:, None, :]], axis=1))
    assert not np.isfinite(nr_cuda._solve_system(Ab, pivot=True).numpy()[:, 5]).all()


class _CountArithmetic(TorchDispatchMode):
    """Counts the floating-point adds, subtracts, multiplies, divides, square
    roots, sines and cosines the dispatched ops perform (one per output
    element)."""

    aten = torch.ops.aten
    OPS = {aten.add, aten.sub, aten.mul, aten.div, aten.sqrt, aten.sin, aten.cos}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.OPS and out.is_floating_point():
            self.n += out.numel()
        return out


@pytest.mark.parametrize(
    "name, chord, pivot", [("anm6", 0, False), ("anm6", 16, True), ("feeder33", 0, True)]
)
def test_kernel_flops_count_the_plain_twins_operations(name, chord, pivot):
    """On one lane the plain twin performs exactly the kernel's operations
    and, per evaluation, per step and per NR step, the few it adds: it forms
    S and the Jacobian's diagonal term on the slack bus too (6 each) and
    takes its step twice (2m)."""
    g, _, p, q = _case(name, 1, 5, np.float64)
    with _CountArithmetic() as counter:
        *_, diff, it = nr_core_plain(
            g.Y_re, g.Y_im, g.J0inv, torch.tensor(p), torch.tensor(q),
            x_tol=1e-9, max_iter=10, chord_iters=chord, pivot=pivot,
        )
    assert diff.item() <= 1e-9
    n_chord = min(int(it), chord)
    n_nr = int(it) - n_chord
    count = nr_cuda.nr_dense_flops_per_lane(g.spec.n_bus, n_nr, n_chord)
    m = g.spec.n_bus - 1
    assert counter.n == count + 6 * (1 + int(it)) + 2 * m * int(it) + 6 * n_nr


@pytest.mark.parametrize("name, chord", [("anm6", 0), ("anm6", 16), ("feeder33", 0)])
def test_kernel_flops_count_the_warm_twins_operations(name, chord):
    """The warm form adds the warm point's evaluation (and its 6 on the
    slack bus); a warm start that already converged takes no step."""
    g, _, p, q = _case(name, 2, 5, np.float64)
    p, q = torch.tensor(p), torch.tensor(q)
    vr, vi = _warm_voltages(g, 1.0 / 0.9 * p, 1.0 / 0.9 * q, zeroed=slice(0, 0))
    th, vm, _ = warm_init_theta_vm(vr, vi, g.spec.n_bus - 1, torch.float64)
    m = g.spec.n_bus - 1
    for lane in range(2):
        init = (th[:, lane : lane + 1] * (1.0 + lane), vm[:, lane : lane + 1])  # lane 1 from a worse point
        with _CountArithmetic() as counter:
            *_, diff, it = nr_core_plain(
                g.Y_re, g.Y_im, g.J0inv, p[:, lane : lane + 1], q[:, lane : lane + 1],
                x_tol=1e-9, max_iter=10, chord_iters=chord, pivot=True, init=init,
            )
        assert diff.item() <= 1e-9
        n_chord = min(int(it), chord)
        n_nr = int(it) - n_chord
        count = nr_cuda.nr_dense_flops_per_lane(g.spec.n_bus, n_nr, n_chord, warm=True)
        assert counter.n == count + 6 * (2 + int(it)) + 2 * m * int(it) + 6 * n_nr
