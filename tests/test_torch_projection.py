"""The port's lanes-last polytope projection against the JAX package's
``project_polytope_lanes`` and ``project_polytope`` (float64).

Inputs are the ANM6 generator and storage capability polytopes with random
dynamic rows (potential cap, SoC charge/discharge caps) and random points
both inside and outside them, made from numpy seeds.  The JAX package's
projections of these inputs are recorded by ``scripts/gen_torch_test_refs.py``
in ``tests/data/torch_refs_projection.npz``."""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR, build_grid
from gym_anm_tpu_torch.envs.anm6.network import network
from gym_anm_tpu_torch.ops.projection import project_polytope_lanes


def _polytopes():
    spec, _ = build_grid(network, 0.25, 100, dtype=np.float64)
    return spec, np.concatenate([spec.gen_G, spec.des_G], axis=0)  # [C, m, 2]


@functools.lru_cache(maxsize=None)
def _refs():
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_projection.npz")) as z:
        return {k: z[k] for k in z.files}


def _digest(*arrays):
    """``scripts/gen_torch_test_refs.py::digest``."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_matches_jax(seed):
    spec, G = _polytopes()
    h0 = np.concatenate([spec.gen_h0, spec.des_h0], axis=0)  # [C, m]
    C = G.shape[0]
    rng = np.random.default_rng(seed)
    B = 512
    h = np.repeat(h0[:, :, None], B, axis=2)
    h[: spec.n_gen, POLY_ROW_P_CAP] = rng.uniform(0.0, 0.6, (spec.n_gen, B))
    h[spec.n_gen :, POLY_ROW_P_CAP] = rng.uniform(0.0, 0.6, (spec.n_des, B))
    h[spec.n_gen :, POLY_ROW_P_FLOOR] = rng.uniform(0.0, 0.6, (spec.n_des, B))
    # Half the points near the feasible sets (many inside), half far out.
    scale = np.where(np.arange(B) < B // 2, 0.3, 1.5)
    px = rng.uniform(-1.0, 1.0, (C, B)) * scale
    py = rng.uniform(-1.0, 1.0, (C, B)) * scale
    ref = {k.split("/")[-1]: v for k, v in _refs().items() if k.startswith("matches/%d/" % seed)}
    assert str(ref["inputs_sha256"]) == _digest(px, py, h), "re-run scripts/gen_torch_test_refs.py"

    x, y = project_polytope_lanes(torch.tensor(px), torch.tensor(py), G, torch.tensor(h))
    # JAX's project_polytope_lanes
    np.testing.assert_allclose(x.numpy(), ref["lanes_x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), ref["lanes_y"], rtol=0, atol=1e-12)
    # JAX's project_polytope over [B, C, 2] points, G broadcast over B
    np.testing.assert_allclose(x.numpy().T, ref["points"][..., 0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy().T, ref["points"][..., 1], rtol=0, atol=1e-12)

    inside = (x.numpy() == px) & (y.numpy() == py)
    assert 0.05 < inside.mean() < 0.95  # both cases are exercised
