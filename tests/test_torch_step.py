"""The port's whole-transition path (the plain twin of the fused CUDA kernel)
against the JAX package's.

* ``transition(pf_method="fused")`` in float32 against the JAX package's
  ``transition(pf_method="fused")`` routed through the TPU kernel
  ``_step_tile_kernel`` in Pallas interpret mode, with the tolerances of
  ``tests/test_pallas_step.py``; the JAX side's outputs (minutes of
  interpret mode) are recorded by ``scripts/gen_torch_test_refs.py`` in
  ``tests/data/torch_refs_step.npz``.
* ``fused_transition_plain`` in float64 against the port's unfused
  ``"pallas"`` and ``"tree"`` transitions on the ANM6, feeder33 and Baran
  and Wu grids, to 1e-9: on these radial grids ``"fused"`` solves in the
  tree form, ``"fused_hybrid"`` in the dense one; on feeder141 (280
  unknowns, past the dense form) ``"fused"`` against ``"tree"`` and
  ``"tree_xla"``.
* The form of the solve follows the grid and the call: the tree form on a
  radial grid without a chord prefix or pivoting, the dense one on a meshed
  grid (ANM6 with one more branch) and with either; neither adds to the
  tree-NR kernel's counters, and each adds its iterations, its unconverged
  lanes and its lane-solves to the fused transition's own.
* The dispatch: the semantic downgrade of ``"fused"`` on grids without a
  storage unit, and the kernel wrapper's refusals on the CPU.

The CUDA kernel itself is tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.core.state import SIM_FIELDS
from gym_anm_tpu_torch.core.transition import resolve_solver_path, transition
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import (
    make_baran_wu_33_network, make_feeder_network, make_multi_feeder_network,
)
from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda


NETWORKS = {"anm6": anm6_network, "feeder33": make_feeder_network(), "baranwu33": make_baran_wu_33_network()}


def _meshed_anm6():
    """ANM6 with one more branch, from bus 3 to bus 4: a meshed grid."""
    net = dict(anm6_network)
    net["branch"] = np.concatenate([anm6_network["branch"], [[3, 4, 0.03, 0.06, 0.0, 18, 1, 0]]])
    return net


def _set_points(spec, B, seed, dtype):
    """Random set-points inside (and partly outside) the devices' ranges."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, (B,) + np.shape(lo)).astype(dtype)
    gen = np.asarray(spec.gen_pos)
    des = np.asarray(spec.des_pos)
    q_lo, q_hi = np.asarray(spec.dev_q_min), np.asarray(spec.dev_q_max)
    return dict(
        des_soc=u(np.asarray(spec.des_soc_min), np.asarray(spec.des_soc_max)),
        P_load=u(np.asarray(spec.load_p_min), np.zeros(spec.n_load)),
        P_pot=u(np.zeros(spec.n_gen), np.asarray(spec.gen_p_max)),
        P_set_gen=u(np.zeros(spec.n_gen), 1.2 * np.asarray(spec.gen_p_max)),
        Q_set_gen=u(1.2 * q_lo[gen], 1.2 * q_hi[gen]),
        P_set_des=u(np.asarray(spec.dev_p_min)[des], np.asarray(spec.dev_p_max)[des]),
        Q_set_des=u(q_lo[des], q_hi[des]),
    )


def test_fused_matches_pallas_step_kernel_interpret():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float32)
    g = GridTensors.from_spec(spec, "cpu", torch.float32)
    args = _set_points(spec, 128, 0, np.float32)
    # The JAX package's fused transition of these inputs through the TPU
    # kernel in interpret mode, as recorded.
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_step.npz")) as z:
        theirs = {k[len("fused/"):]: z[k] for k in z.files}
    for k, v in args.items():
        np.testing.assert_array_equal(v, theirs["inputs/" + k], err_msg="re-run scripts/gen_torch_test_refs.py")
    assert str(theirs["path"]) == "fused_kernel"
    ours = transition(g, **{k: torch.tensor(v) for k, v in args.items()}, pf_method="fused", max_iter=10)

    conv, jconv = ours.pfe_converged.numpy(), theirs["pfe_converged"]
    assert (conv == jconv).mean() >= 0.99 and conv.mean() > 0.9
    both = conv & jconv
    for f in SIM_FIELDS[:-1]:
        a, b = getattr(ours.state, f).numpy()[both], theirs["state/" + f][both]
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=f)
    np.testing.assert_allclose(ours.e_loss.numpy()[both], theirs["e_loss"][both], atol=5e-5)
    # The penalty amplifies voltage and flow round-off by lamb = 100.
    np.testing.assert_allclose(ours.penalty.numpy()[both], theirs["penalty"][both], atol=5e-3)


@pytest.mark.parametrize("name", ["anm6", "feeder33", "baranwu33", "feeder141"])
def test_fused_plain_matches_unfused_f64(name):
    net = make_multi_feeder_network() if name == "feeder141" else NETWORKS[name]
    spec, _ = build_grid(net, 0.25, 100, dtype=np.float64)
    g = GridTensors.from_spec(spec, "cpu", torch.float64)
    assert step_cuda.tree_form(g.step) and g.tree is g.step.tree
    args = {k: torch.tensor(v) for k, v in _set_points(spec, 64, 1, np.float64).items()}
    if name == "feeder141":
        # 280 unknowns: the dense paths are refused; the tree form against
        # the tree-NR kernel's plain twin, by both of its routes.
        cases = (("fused", "tree", {}), ("fused", "tree_xla", {}))
    else:
        cases = (("fused", "pallas", {}), ("fused", "tree", {}),
                 ("fused_hybrid", "hybrid", dict(chord_iters=8, nr_pivot=True)))
    for fused, unfused, kw in cases:
        a = transition(g, **args, pf_method=fused, x_tol=1e-9, max_iter=12, **kw)
        b = transition(g, **args, pf_method=unfused, x_tol=1e-9, max_iter=12, **kw)
        conv = b.pfe_converged.numpy()
        assert conv.mean() > 0.5
        np.testing.assert_array_equal(a.pfe_converged.numpy(), conv)
        for f in SIM_FIELDS[:-1]:
            np.testing.assert_allclose(
                getattr(a.state, f).numpy()[conv], getattr(b.state, f).numpy()[conv], rtol=1e-9, atol=1e-9, err_msg=f
            )
        for f in ("reward", "e_loss", "penalty"):
            np.testing.assert_allclose(getattr(a, f).numpy()[conv], getattr(b, f).numpy()[conv], rtol=1e-9, atol=1e-9)


def test_fused_form_follows_the_grid_and_the_call(monkeypatch):
    radial, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float64)
    meshed, _ = build_grid(_meshed_anm6(), 0.25, 100, dtype=np.float64)
    g, gm = (GridTensors.from_spec(spec, "cpu", torch.float64) for spec in (radial, meshed))
    assert gm.tree is None and gm.step.tree is None and gm.step.tree_args == ()
    calls = []
    newton = step_cuda.tree_newton_plain
    monkeypatch.setattr(step_cuda, "tree_newton_plain", lambda *a, **k: calls.append(1) or newton(*a, **k))
    args = {k: torch.tensor(v) for k, v in _set_points(radial, 64, 2, np.float64).items()}
    cases = ((g, {}, True), (g, dict(chord_iters=16), False), (g, dict(pivot=True), False), (gm, {}, False),
             (gm, dict(chord_iters=16, pivot=True), False))
    k3_counts = lambda: step_cuda.iteration_counts("cpu").tolist() + [step_cuda.LANE_SOLVES]
    for grid, kw, tree in cases:
        assert step_cuda.tree_form(grid.step, **kw) == tree
        counters = (step_cuda.TREE_LAUNCHES, tree_cuda.LANE_SOLVES, tree_cuda.iteration_counts("cpu").tolist())
        del calls[:]
        lanes = step_cuda.pack_inputs(*args.values())
        k0 = k3_counts()
        out = step_cuda.fused_transition_plain(grid.step, lanes, x_tol=1e-9, max_iter=12, **kw)
        assert len(calls) == int(tree)
        assert counters == (step_cuda.TREE_LAUNCHES, tree_cuda.LANE_SOLVES, tree_cuda.iteration_counts("cpu").tolist())
        o = step_cuda.unpack_outputs(grid.step, out)
        added = [int(o.n_iter.sum()), int((~(o.diff <= 1e-9)).sum()), 64]
        assert [b - a for a, b in zip(k0, k3_counts())] == added and added[0] > 64
        # Either form solves the grid's own power flow: the meshed grid's
        # dense form matches its unfused dense transition.
        if grid is gm and not kw:
            a = step_cuda.unpack_outputs(grid.step, out)
            b = transition(gm, **args, pf_method="pallas", x_tol=1e-9, max_iter=12)
            conv = b.pfe_converged.numpy()
            assert conv.mean() > 0.5 and np.array_equal((a.diff[:, 0] <= 1e-9).numpy(), conv)
            np.testing.assert_allclose(a.v_re.numpy()[conv], b.state.bus_v_re.numpy()[conv], rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(a.i_im.numpy()[conv], b.state.bus_i_im.numpy()[conv], rtol=1e-9, atol=1e-9)


def test_dispatch_and_wrapper_refusals():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float32)
    g = GridTensors.from_spec(spec, "cpu", torch.float32)
    assert resolve_solver_path(g, "fused", False) == ("fused_kernel", "fused")
    assert resolve_solver_path(g, "pallas", False) == ("nr_kernel", "pallas")
    assert resolve_solver_path(g, "xla_hybrid", False) == ("torch", "xla_hybrid")
    assert resolve_solver_path(g, "tree", False) == ("tree_kernel", "tree")
    # A grid without a load, a generator and a storage unit runs the fused
    # methods unfused, as the JAX package does.
    bare = dataclasses.replace(g, step=None)
    assert resolve_solver_path(bare, "fused", False) == ("nr_kernel", "pallas")
    assert resolve_solver_path(bare, "fused_hybrid", False) == ("nr_kernel", "hybrid")
    assert resolve_solver_path(g, "tree_xla", False) == ("tree_plain", "tree_xla")
    with pytest.raises(ValueError, match="pf_method"):
        resolve_solver_path(g, "chord", False)
    no_des = dataclasses.replace(spec, n_des=0)
    assert not step_cuda.fused_transition_supported(no_des)
    with pytest.raises(ValueError, match="storage"):
        step_cuda.StepTables.from_spec(no_des, "cpu", torch.float32)

    st = g.step
    lanes = torch.zeros((sum(st.in_rows), 8))
    before = step_cuda.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.fused_transition_cuda(st, lanes)
    assert step_cuda.KERNEL_LAUNCHES == before
    out = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes))
    assert [t.shape[1] for t in out] == list(st.out_rows) and out.dev_p.shape == (8, spec.n_dev)


def test_tables_and_flops_follow_jax():
    from gym_anm_tpu.ops.pallas_step import fused_step_flops_per_lane as jax_flops

    for name, net in NETWORKS.items():
        spec, _ = build_grid(net, 0.25, 100, dtype=np.float32)
        st = step_cuda.StepTables.from_spec(spec, "cpu", torch.float32)
        # The candidate table is the projector's, in the TPU kernel's order:
        # the feet, then the vertices.
        proj = GridTensors.from_spec(spec, "cpu", torch.float32).projector
        feet = [(r, -1) for r, *_ in proj.feet]
        verts = [(v[0], v[1]) for v in proj.vertices]
        assert list(st.structure.cand) == feet + verts
        inc = np.asarray(spec.inc_bus_dev)
        assert st.structure.devs_at_bus == tuple(tuple(np.nonzero(row)[0]) for row in inc)
        assert st.structure.positions["des_pos"] == tuple(np.asarray(spec.des_pos))
        assert list(st.c_args[2]) == [st.dims[k] for k in step_cuda.DIMS]
        assert step_cuda.fused_step_flops_per_lane(spec, 10, 16, True) == jax_flops(spec, 10, 16, True)
        # The kernel's own count: its solve (the dense form's, or the tree
        # form's and the slack's current) plus a part that the iterations do
        # not change, under the TPU count, which charges every candidate.
        n, S = spec.n_bus, st.tree.sched.S
        rest = [step_cuda.step_fused_flops_per_lane(st, k, c, pivot=True) - nr_cuda.nr_dense_flops_per_lane(n, k, c)
                for k, c in ((0, 0), (3, 0), (2, 16))]
        rest += [step_cuda.step_fused_flops_per_lane(st, k) - tree_cuda.tree_nr_flops_per_lane(S, k) - 8 * n
                 for k in (0, 3)]
        assert rest[0] == rest[1] == rest[2] == rest[3] == rest[4] > 0
        assert rest[0] < jax_flops(spec, 0, 0, True) - nr_cuda.nr_flops_per_lane(n, 0, 0, True)
