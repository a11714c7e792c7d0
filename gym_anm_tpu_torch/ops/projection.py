"""Exact Euclidean projection onto 2-D halfspace-intersection polytopes.

The counterpart of ``gym_anm_tpu.ops.projection.project_polytope_lanes``.
Each generator's or storage unit's feasible (P, Q) region is a 2-D convex
polytope with at most ~10 facets, so the projection of a point onto it is
the point itself (if feasible), the foot of the perpendicular onto one
facet's supporting line, or a vertex (intersection of two supporting
lines).  Enumerating those candidates with a running minimum computes the
projection exactly, with no iteration.

Lanes-last layout: points are ``[C, B]`` (C devices, B environments) and
the offsets ``h`` are ``[C, m, B]``.  The normals ``G`` are static per grid:
:class:`LanesProjector` prunes on the host the candidates whose rows are
statically absent on every device and keeps the per-device constants on the
device, so each call only reads ``h`` and the points.
"""

from __future__ import annotations

import numpy as np
import torch


class LanesProjector:
    """Exact lanes-last projection for one static normal tensor ``G``.

    ``G``: NumPy ``[C, m, 2]`` halfspace normals (zero rows mark absent
    constraints).  The tolerance ``eps`` is 1e-9 in float64 and 1e-5 in
    float32, as in the JAX package.
    """

    def __init__(self, G, device, dtype: torch.dtype):
        G = np.asarray(G, dtype=np.float64)
        m = G.shape[1]
        self.eps = 1e-9 if dtype == torch.float64 else 1e-5
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)
        b = lambda a: torch.as_tensor(np.asarray(a, dtype=bool), device=device)

        g_finite = np.all(np.isfinite(G), axis=-1)  # [C, m]
        g_nonzero = (np.abs(G).sum(axis=-1) > 0) & g_finite
        # Feasibility reads every row with a finite normal on some device,
        # all of them in one [C, rows, B] comparison.
        self.feas_rows = [r for r in range(m) if g_finite[:, r].any()]
        self.feas_gx = t(G[:, self.feas_rows, 0])[:, :, None]  # [C, rows, 1]
        self.feas_gy = t(G[:, self.feas_rows, 1])[:, :, None]
        self.feas_finite = b(g_finite[:, self.feas_rows])[:, :, None]

        # Feet of the perpendiculars: (row, gx [C,1], gy [C,1], gg [C,1], present [C,1]).
        self.feet = []
        for r in range(m):
            if not g_nonzero[:, r].any():
                continue  # statically absent on every device
            gg = G[:, r, 0] ** 2 + G[:, r, 1] ** 2
            self.feet.append(
                (r, t(G[:, r, 0:1]), t(G[:, r, 1:2]), t(np.where(gg > 0, gg, 1.0)[:, None]), b(g_nonzero[:, r, None]))
            )

        # Vertices: (r, s, gx_r, gy_r, gx_s, gy_s, det [C,1], det_ok [C,1]).
        self.vertices = []
        for r in range(m):
            for s in range(r + 1, m):
                det = G[:, r, 0] * G[:, s, 1] - G[:, r, 1] * G[:, s, 0]  # [C]
                nrm = np.sqrt(np.maximum((G[:, r] ** 2).sum(-1) * (G[:, s] ** 2).sum(-1), 0.0))
                det_ok = np.isfinite(det) & (np.abs(det) > self.eps * np.maximum(1.0, nrm))
                if not det_ok.any():
                    continue  # statically parallel/absent on every device
                self.vertices.append(
                    (
                        r, s,
                        t(G[:, r, 0:1]), t(G[:, r, 1:2]), t(G[:, s, 0:1]), t(G[:, s, 1:2]),
                        t(np.where(det_ok, det, 1.0)[:, None]), b(det_ok[:, None]),
                    )
                )

    def __call__(self, px, py, h):
        """Project the points ``(px, py)`` ``[C, B]`` onto ``{x : G x <= h}``
        with ``h`` ``[C, m, B]`` (+inf = inactive row).  Returns
        ``(x [C, B], y [C, B])``."""
        eps = self.eps
        h_fin = torch.isfinite(h)  # [C, m, B]
        tol = eps * (1.0 + torch.where(h_fin, h.abs(), torch.zeros_like(h)))
        rows = self.feas_rows
        bound = (h + tol)[:, rows]  # [C, rows, B]
        # Rows inactive for a device (non-finite normal) or a lane (infinite
        # offset) are trivially satisfied.
        inactive = ~(self.feas_finite & h_fin[:, rows])

        def feasible(x, y):
            gx = self.feas_gx * x[:, None, :] + self.feas_gy * y[:, None, :]
            return ((gx <= bound) | inactive).all(dim=1)

        # Running minimum over candidates, starting from the point itself.
        best_x, best_y = px, py
        best_d = torch.where(feasible(px, py), torch.zeros_like(px), torch.full_like(px, float("inf")))

        def consider(x, y, valid):
            nonlocal best_x, best_y, best_d
            d = (x - px) ** 2 + (y - py) ** 2
            ok = valid & torch.isfinite(x) & torch.isfinite(y) & feasible(x, y) & (d < best_d)
            best_x = torch.where(ok, x, best_x)
            best_y = torch.where(ok, y, best_y)
            best_d = torch.where(ok, d, best_d)

        for r, gx, gy, gg, present in self.feet:
            hr = h[:, r]
            coef = (gx * px + gy * py - hr) / gg
            consider(px - coef * gx, py - coef * gy, present & h_fin[:, r])

        for r, s, gxr, gyr, gxs, gys, det, det_ok in self.vertices:
            hr, hs = h[:, r], h[:, s]
            vx = (hr * gys - hs * gyr) / det
            vy = (gxr * hs - gxs * hr) / det
            consider(vx, vy, det_ok & h_fin[:, r] & h_fin[:, s])

        return best_x, best_y


def project_polytope_lanes(px, py, G, h):
    """Exact lanes-last projection (see :class:`LanesProjector`).

    ``px, py``: ``[C, B]``; ``G``: static NumPy ``[C, m, 2]``; ``h``:
    ``[C, m, B]``.  Returns ``(x [C, B], y [C, B])``.
    """
    return LanesProjector(G, px.device, px.dtype)(px, py, h)
