"""The projection forms of ``gym_anm_tpu_torch/ops/projection.py`` against
each other and against the JAX package's forms, on the three tasks'
capability polytopes (ANM6Easy C=3, feeder33 C=7, feeder141 C=21).

The inputs and the JAX package's outputs of every form are recorded by
``scripts/gen_torch_test_refs.py`` in
``tests/data/torch_refs_projection_forms.npz`` (no JAX program is compiled
here): random dynamic rows with +inf rows, points inside and outside, NaN,
+inf and -inf set-points, and a lane whose storage regions are empty.

* The stacked form equals the running minimum bit for bit, in float64 and
  float32, on every lane.
* Both lanes forms equal JAX's on finite set-points (1e-12, float64); the
  running minimum equals JAX's on every lane.
* Box-slants equals JAX's box-slants (1e-12, float64) and the running
  minimum to 2e-5 in float32 with equal squared distances.
* ``project_polytope`` (batch-first) equals JAX's, NaN included.
* A NaN set-point keeps the point in the running-min and stacked forms,
  where JAX's stacked form returns a vertex (a departure kept on purpose).
"""

import functools
import os

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.grid import GridTensors, build_grid, projection_form
from gym_anm_tpu_torch.envs.anm6.network import network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops.projection import (
    LanesProjector,
    project_box_slants_lanes,
    project_polytope,
    project_polytope_lanes,
)
from gym_anm_tpu_torch.profiling import count_aten_ops


TASKS = ("anm6", "feeder33", "feeder141")
NETWORKS = {"anm6": lambda: network, "feeder33": make_feeder_network, "feeder141": make_multi_feeder_network}
ATOL = 1e-12
BOX_SLANTS_F32_ATOL = 2e-5  # tests/test_pallas_step.py:109-120
NAN_LANES = (0, 1, 2)  # NaN px, NaN py, both (then +inf, -inf set-points; lane 6: empty storage regions)
EMPTY_LANE = 6


@functools.lru_cache(maxsize=None)
def _refs():
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                              "torch_refs_projection_forms.npz")) as z:
        return {k: z[k] for k in z.files}


def _case(task, dtype=torch.float64):
    """The task's port-built normals (equal to the recorded JAX ones), the
    recorded inputs as tensors, and the JAX outputs by form."""
    r = {k[len(task) + 1 :]: v for k, v in _refs().items() if k.startswith(task + "/")}
    spec, _ = build_grid(NETWORKS[task](), 0.25, 100, dtype=np.float64)
    G = np.concatenate([spec.gen_G, spec.des_G], axis=0)
    np.testing.assert_array_equal(G, r["G"])
    px, py, h = (torch.tensor(r[k], dtype=dtype) for k in ("px", "py", "h"))
    return spec, G, px, py, h, r


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("task", TASKS)
def test_stacked_equals_running_min_bitwise(task, dtype):
    spec, G, px, py, h, _ = _case(task, dtype)
    x1, y1 = LanesProjector(G, "cpu", dtype)(px, py, h)
    x2, y2 = LanesProjector(G, "cpu", dtype, form="stacked")(px, py, h)
    assert torch.equal(_bits(x1), _bits(x2)) and torch.equal(_bits(y1), _bits(y2))
    # The edge lanes are what they should be: non-finite set-points and the
    # empty regions (no valid candidate) return the point.
    for lane in NAN_LANES + (3, 4, 5):
        assert torch.equal(_bits(x2[:, lane]), _bits(px[:, lane])) and torch.equal(_bits(y2[:, lane]), _bits(py[:, lane]))
    des = slice(spec.n_gen, None)
    assert torch.equal(x2[des, EMPTY_LANE], px[des, EMPTY_LANE]) and torch.equal(y2[des, EMPTY_LANE], py[des, EMPTY_LANE])
    moved = (x2 != px) | (y2 != py)
    assert 0.05 < float(moved.double().mean()) < 0.95  # both feasible and projected points occur
    assert bool(torch.isinf(h).any())


@pytest.mark.parametrize("task", TASKS)
def test_lanes_forms_match_jax(task):
    _, G, px, py, h, r = _case(task)
    finite = (torch.isfinite(px) & torch.isfinite(py)).numpy()
    x, y = LanesProjector(G, "cpu", torch.float64)(px, py, h)
    _close(x, r["running_min/x"], ATOL)
    _close(y, r["running_min/y"], ATOL)
    xs, ys = LanesProjector(G, "cpu", torch.float64, form="stacked")(px, py, h)
    _close(xs.numpy()[finite], r["stacked/x"][finite], ATOL)
    _close(ys.numpy()[finite], r["stacked/y"][finite], ATOL)
    # eps= reaches the lanes form, as in JAX.
    xe, ye = project_polytope_lanes(px, py, G, h, eps=0.05)
    _close(xe, r["running_min_eps/x"], ATOL)
    _close(ye, r["running_min_eps/y"], ATOL)
    assert not np.array_equal(np.nan_to_num(xe.numpy()), np.nan_to_num(x.numpy()))


@pytest.mark.parametrize("task", TASKS)
def test_box_slants_matches_jax_and_running_min(task):
    _, G, px, py, h, r = _case(task)
    x, y = project_box_slants_lanes(px, py, G, h)
    _close(x, r["box_slants/x"], ATOL)
    _close(y, r["box_slants/y"], ATOL)
    # float32, against the running minimum, on finite set-points.
    _, _, px, py, h, _ = _case(task, torch.float32)
    fin = torch.isfinite(px) & torch.isfinite(py)
    x1, y1 = LanesProjector(G, "cpu", torch.float32)(px, py, h)
    x2, y2 = project_box_slants_lanes(px, py, G, h)
    _close(x2[fin], x1[fin], BOX_SLANTS_F32_ATOL)
    _close(y2[fin], y1[fin], BOX_SLANTS_F32_ATOL)
    d = lambda a, b: ((a - px) ** 2 + (b - py) ** 2)[fin]
    _close(d(x2, y2), d(x1, y1), BOX_SLANTS_F32_ATOL)


@pytest.mark.parametrize("task", TASKS)
def test_project_polytope_matches_jax(task):
    _, G, px, py, h, r = _case(task)
    B = px.shape[1]
    pts = torch.stack([px.T, py.T], dim=-1)  # [B, C, 2]
    out = project_polytope(pts, torch.tensor(G).expand((B,) + G.shape), h.permute(2, 0, 1))
    _close(out, r["polytope"], ATOL)  # NaN set-points included
    # The lanes forms agree with it on finite set-points.
    finite = (torch.isfinite(px) & torch.isfinite(py)).T
    x, y = LanesProjector(G, "cpu", torch.float64, form="stacked")(px, py, h)
    _close(x.T[finite], out[..., 0][finite], ATOL)
    _close(y.T[finite], out[..., 1][finite], ATOL)


def test_nan_set_point_departs_from_jax_stacked():
    """A NaN set-point: the running-min and stacked forms return the point
    (NaN); JAX's stacked form, like its batch-first form, returns a finite
    vertex, whose NaN distance ``argmin`` takes as the minimum."""
    for task in TASKS:
        _, G, px, py, h, r = _case(task)
        for form in ("running_min", "stacked"):
            x, y = LanesProjector(G, "cpu", torch.float64, form=form)(px, py, h)
            assert bool(torch.isnan(x[:, 0]).all()) and bool(torch.isnan(y[:, 1]).all())
        jx, jy = r["stacked/x"][:, NAN_LANES], r["stacked/y"][:, NAN_LANES]
        assert np.isfinite(jx).all() and np.isfinite(jy).all()
        assert np.isfinite(r["polytope"][NAN_LANES, :]).all()


def test_form_selection_and_launches():
    """``GridTensors.from_spec`` builds the form of the device type: the
    stacked form on the card, the running minimum on the CPU; the stacked
    form dispatches under 60 aten ops a call where the running minimum
    dispatches 1,725."""
    assert projection_form("cpu") == "running_min"
    assert projection_form("cuda") == projection_form("cuda:0") == "stacked"
    spec, G, px, py, h, _ = _case("anm6", torch.float32)
    assert GridTensors.from_spec(spec, "cpu", torch.float32).projector.form == "running_min"
    with pytest.raises(ValueError, match="form"):
        LanesProjector(G, "cpu", torch.float32, form="box_slants")
    for task in TASKS:
        _, G, px, py, h, _ = _case(task, torch.float32)
        _, n_min = count_aten_ops(LanesProjector(G, "cpu", torch.float32), px, py, h)
        _, n_stacked = count_aten_ops(LanesProjector(G, "cpu", torch.float32, form="stacked"), px, py, h)
        assert n_min == 1725 and n_stacked < 60, (task, n_min, n_stacked)
