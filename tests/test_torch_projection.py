"""The port's lanes-last polytope projection against the JAX package's
``project_polytope_lanes`` and ``project_polytope`` (float64).

Inputs are the ANM6 generator and storage capability polytopes with random
dynamic rows (potential cap, SoC charge/discharge caps) and random points
both inside and outside them, made from numpy seeds."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu.ops.projection import project_polytope, project_polytope_lanes as jax_project_lanes

from gym_anm_tpu_torch.core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR, build_grid
from gym_anm_tpu_torch.envs.anm6.network import network
from gym_anm_tpu_torch.ops.projection import project_polytope_lanes


def _polytopes():
    spec, _ = build_grid(network, 0.25, 100, dtype=np.float64)
    return spec, np.concatenate([spec.gen_G, spec.des_G], axis=0)  # [C, m, 2]


@functools.lru_cache(maxsize=None)
def _jax_projections():
    """Both JAX projections of the ANM6 polytopes, each compiled once for
    every seed (op by op, each of their ops compiles alone)."""
    _, G = _polytopes()
    lanes = jax.jit(lambda px, py, h: jax_project_lanes(px, py, G, h))
    points = jax.jit(lambda pts, h: project_polytope(pts, jnp.broadcast_to(G, (pts.shape[0],) + G.shape), h))
    return lanes, points


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_matches_jax(seed):
    spec, G = _polytopes()
    jax_lanes, jax_points = _jax_projections()
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

    x, y = project_polytope_lanes(torch.tensor(px), torch.tensor(py), G, torch.tensor(h))
    jx, jy = jax_lanes(jnp.asarray(px), jnp.asarray(py), jnp.asarray(h))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)

    pts = np.stack([px.T, py.T], axis=-1)  # [B, C, 2]
    ref = np.asarray(jax_points(jnp.asarray(pts), jnp.asarray(np.moveaxis(h, 2, 0))))
    np.testing.assert_allclose(x.numpy().T, ref[..., 0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy().T, ref[..., 1], rtol=0, atol=1e-12)

    inside = (x.numpy() == px) & (y.numpy() == py)
    assert 0.05 < inside.mean() < 0.95  # both cases are exercised
