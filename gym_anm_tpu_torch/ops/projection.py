"""Exact Euclidean projection onto 2-D halfspace-intersection polytopes.

The counterpart of ``gym_anm_tpu.ops.projection``.  Each generator's or
storage unit's feasible (P, Q) region is a 2-D convex polytope with at most
~10 facets, so the projection of a point onto it is the point itself (if
feasible), the foot of the perpendicular onto one facet's supporting line,
or a vertex (intersection of two supporting lines).  Enumerating those
candidates and keeping the nearest valid one computes the projection
exactly, with no iteration.

Lanes-last layout: points are ``[C, B]`` (C devices, B environments) and
the offsets ``h`` are ``[C, m, B]``.  The normals ``G`` are static per grid:
the projectors prune on the host the candidates whose rows are statically
absent on every device and keep the per-device constants on the device, so
each call only reads ``h`` and the points.

Forms:

* :class:`LanesProjector` ``form="running_min"`` -- the candidates one at a
  time with a running minimum over ``[C, B]`` (the JAX package's
  ``project_polytope_lanes``): ~1,700 small ops a call.
* :class:`LanesProjector` ``form="stacked"`` -- every candidate in one
  ``[K, C, B]`` tensor, built from static ``[K, C, 1]`` tables and one
  gather of ``h``'s rows, checked against every row in one ``[K, C, rows,
  B]`` comparison and scored at once; ``argmin`` picks the first of equal
  minima, the running minimum's strict-improvement rule, so the two forms
  agree bit for bit (``project_polytope_lanes_stacked``).  It departs from
  the JAX stacked form on a NaN set-point: it returns the point, as the
  running minimum does, where the JAX form returns a vertex.
* :func:`project_box_slants_lanes` -- box bounds plus slanted cuts (the
  clip replaces every box foot and corner); exact to rounding, not bit for
  bit.
* :func:`project_polytope` -- the general batch-first form with ``G`` per
  batch element, JAX's semantics (NaN included); nothing on the main path
  calls it.
"""

from __future__ import annotations

import numpy as np
import torch

FORMS = ("running_min", "stacked")


def _default_eps(dtype) -> float:
    return 1e-9 if dtype == torch.float64 else 1e-5


class LanesProjector:
    """Exact lanes-last projection for one static normal tensor ``G``.

    ``G``: NumPy ``[C, m, 2]`` halfspace normals (zero rows mark absent
    constraints).  ``form``: ``"running_min"`` or ``"stacked"`` (the same
    result bit for bit; see the module docstring).  The tolerance ``eps``
    defaults to 1e-9 in float64 and 1e-5 in float32, as in the JAX package.
    """

    def __init__(self, G, device, dtype: torch.dtype, form: str = "running_min", eps=None):
        if form not in FORMS:
            raise ValueError("form must be one of %s, got %r" % (FORMS, form))
        self.form = form
        G = np.asarray(G, dtype=np.float64)
        m = G.shape[1]
        self.eps = _default_eps(dtype) if eps is None else float(eps)
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
        self.feas_idx = torch.as_tensor(self.feas_rows, dtype=torch.int64, device=device)  # gathers them
        self._all_rows = self.feas_rows == list(range(m))  # no gather of rows needed

        # Feet of the perpendiculars: (row, gx [C,1], gy [C,1], gg [C,1], present [C,1]).
        feet = []
        for r in range(m):
            if not g_nonzero[:, r].any():
                continue  # statically absent on every device
            gg = G[:, r, 0] ** 2 + G[:, r, 1] ** 2
            feet.append((r, G[:, r, 0:1], G[:, r, 1:2], np.where(gg > 0, gg, 1.0)[:, None], g_nonzero[:, r, None]))

        # Vertices: (r, s, gx_r, gy_r, gx_s, gy_s, det [C,1], det_ok [C,1]).
        vertices = []
        for r in range(m):
            for s in range(r + 1, m):
                det = G[:, r, 0] * G[:, s, 1] - G[:, r, 1] * G[:, s, 0]  # [C]
                nrm = np.sqrt(np.maximum((G[:, r] ** 2).sum(-1) * (G[:, s] ** 2).sum(-1), 0.0))
                det_ok = np.isfinite(det) & (np.abs(det) > self.eps * np.maximum(1.0, nrm))
                if not det_ok.any():
                    continue  # statically parallel/absent on every device
                vertices.append(
                    (r, s, G[:, r, 0:1], G[:, r, 1:2], G[:, s, 0:1], G[:, s, 1:2],
                     np.where(det_ok, det, 1.0)[:, None], det_ok[:, None])
                )

        self.feet = [(r, t(gx), t(gy), t(gg), b(ok)) for r, gx, gy, gg, ok in feet]
        self.vertices = [(v[0], v[1], *(t(a) for a in v[2:7]), b(v[7])) for v in vertices]
        if form == "stacked":
            # [K-1, C, 1] tables, feet then vertices (the running minimum's
            # order), and the h rows each candidate reads.
            C = G.shape[0]
            stack = lambda rows, i, conv: conv(np.stack([row[i] for row in rows]) if rows else np.zeros((0, C, 1)))
            idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
            self.foot_gx, self.foot_gy, self.foot_gg = (stack(feet, i, t) for i in (1, 2, 3))
            self.vert_gxr, self.vert_gyr, self.vert_gxs, self.vert_gys, self.vert_det = (
                stack(vertices, i, t) for i in (2, 3, 4, 5, 6)
            )
            self.n_feet, self.n_vert = len(feet), len(vertices)
            self.cand_rows = idx([f[0] for f in feet] + [v[0] for v in vertices] + [v[1] for v in vertices])
            self.cand_ok = torch.cat([stack(feet, 4, b), stack(vertices, 7, b)])  # [K-1, C, 1]

    def __call__(self, px, py, h):
        """Project the points ``(px, py)`` ``[C, B]`` onto ``{x : G x <= h}``
        with ``h`` ``[C, m, B]`` (+inf = inactive row).  Returns
        ``(x [C, B], y [C, B])``."""
        if self.form == "stacked":
            return self._stacked(px, py, h)
        eps = self.eps
        h_fin = torch.isfinite(h)  # [C, m, B]
        tol = eps * (1.0 + torch.where(h_fin, h.abs(), torch.zeros_like(h)))
        rows = self.feas_idx
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

    def _stacked(self, px, py, h):
        h_abs = h.abs()
        h_fin = h_abs < float("inf")  # isfinite in two ops
        # The running minimum's tolerance where the offset is finite; an
        # infinite row is inactive, whatever its bound.
        bound = h + self.eps * (1.0 + h_abs)
        fin_rows = h_fin
        if not self._all_rows:
            bound, fin_rows = bound[:, self.feas_idx], h_fin[:, self.feas_idx]
        inactive = ~(self.feas_finite & fin_rows)  # [C, rows, B]

        # One gather of h's rows: the feet's, then each vertex's r and s.
        nf, nv = self.n_feet, self.n_vert
        hg = h.transpose(0, 1)[self.cand_rows]  # [nf + 2 nv, C, B]
        hf, hr, hs = hg[:nf], hg[nf : nf + nv], hg[nf + nv :]
        # Feet, every row in one pass (the running minimum's arithmetic).
        coef = (self.foot_gx * px + self.foot_gy * py - hf) / self.foot_gg
        fx = px - coef * self.foot_gx
        fy = py - coef * self.foot_gy
        # Vertices, every pair in one pass.
        vx = (hr * self.vert_gys - hs * self.vert_gyr) / self.vert_det
        vy = (self.vert_gxr * hs - self.vert_gxs * hr) / self.vert_det
        cx = torch.cat([px[None], fx, vx])  # [K, C, B]; candidate 0 is the point
        cy = torch.cat([py[None], fy, vy])

        # Every row of every candidate in one [K, C, rows, B] comparison.
        # In place, so that two [K, C, rows, B] temporaries are live at most.
        g = self.feas_gx * cx[:, :, None, :]
        g += self.feas_gy * cy[:, :, None, :]
        ok = g <= bound
        ok |= inactive
        valid = ok.all(dim=2)
        # A foot needs its row's offset finite, a vertex both of its rows'.
        fg = h_fin.transpose(0, 1)[self.cand_rows]
        valid[1:] &= self.cand_ok & torch.cat([fg[:nf], fg[nf : nf + nv] & fg[nf + nv :]])
        d = (cx - px) ** 2 + (cy - py) ** 2
        # A non-finite distance scores +inf: a candidate off the finite plane
        # is invalid, and a NaN set-point (NaN at every candidate) keeps the
        # point, as the running minimum does.
        valid &= d < float("inf")
        score = torch.where(valid, d, float("inf"))
        best = torch.argmin(score, dim=0, keepdim=True)  # the first of equal minima
        return cx.gather(0, best)[0], cy.gather(0, best)[0]


def project_polytope_lanes(px, py, G, h, eps=None):
    """Exact lanes-last projection (see :class:`LanesProjector`).

    ``px, py``: ``[C, B]``; ``G``: static NumPy ``[C, m, 2]``; ``h``:
    ``[C, m, B]``; ``eps``: the feasibility tolerance (default 1e-9 in
    float64, 1e-5 in float32).  Returns ``(x [C, B], y [C, B])``.
    """
    return LanesProjector(G, px.device, px.dtype, eps=eps)(px, py, h)


class BoxSlantsProjector:
    """Exact lanes-last projection specialized to box bounds plus slanted
    cuts (``gym_anm_tpu.ops.projection.project_box_slants_lanes``).

    Rows are classified on the host per device: zero-normal rows are
    absent, rows with one non-zero normal entry fold into the dynamic box
    bounds, rows with two are slants.  The candidates are the point, the
    box clip (which stands for every box foot and corner), the slant feet,
    the slant-slant vertices and the slant x box-edge vertices, kept as a
    running minimum.  Exact to rounding (same ``eps`` tolerances), not bit
    for bit with :class:`LanesProjector`.

    Precondition (as in JAX): zero-normal rows carry ``+inf`` offsets, as
    the transition builds ``h``; the general form treats a zero-normal row
    with a finite negative offset as an empty set, this form ignores it.
    """

    def __init__(self, G, device, dtype: torch.dtype, eps=None):
        G = np.asarray(G, dtype=np.float64)
        C, m, _ = G.shape
        self.eps = eps = _default_eps(dtype) if eps is None else float(eps)
        self.dtype = dtype
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)
        b = lambda a: torch.as_tensor(np.asarray(a, dtype=bool), device=device)

        g_finite = np.all(np.isfinite(G), axis=-1)  # [C, m]
        nz_x = (G[:, :, 0] != 0) & g_finite
        nz_y = (G[:, :, 1] != 0) & g_finite
        axis_x = nz_x & ~nz_y  # p-bound rows
        axis_y = nz_y & ~nz_x  # q-bound rows
        slant = nz_x & nz_y

        # Box bounds: (bound, row, mask [C,1], g [C,1]) for each row that
        # bounds it on some device, in row order.
        self.box = {k: [] for k in ("hi_x", "lo_x", "hi_y", "lo_y")}
        for r in range(m):
            for axis_rows, col, hi, lo in ((axis_x, 0, "hi_x", "lo_x"), (axis_y, 1, "hi_y", "lo_y")):
                if not axis_rows[:, r].any():
                    continue
                g = G[:, r, col]
                for key, sign in ((hi, g > 0), (lo, g < 0)):
                    if sign.any():
                        self.box[key].append((r, b((axis_rows[:, r] & sign)[:, None]), t(g[:, None])))

        self.slant_rows = [r for r in range(m) if slant[:, r].any()]
        self.slant_mask = {r: b(slant[:, r][:, None]) for r in self.slant_rows}
        self.gx = {r: t(G[:, r, 0][:, None]) for r in self.slant_rows}
        self.gy = {r: t(G[:, r, 1][:, None]) for r in self.slant_rows}
        gg = G[:, :, 0] ** 2 + G[:, :, 1] ** 2  # [C, m]
        self.gg = {r: t(np.where(gg[:, r] > 0, gg[:, r], 1.0)[:, None]) for r in self.slant_rows}
        self.pairs = []
        for i, r in enumerate(self.slant_rows):
            for s in self.slant_rows[i + 1 :]:
                det = G[:, r, 0] * G[:, s, 1] - G[:, r, 1] * G[:, s, 0]
                nrm = np.sqrt(np.maximum((G[:, r] ** 2).sum(-1) * (G[:, s] ** 2).sum(-1), 0.0))
                det_ok = np.isfinite(det) & (np.abs(det) > eps * np.maximum(1.0, nrm)) & slant[:, r] & slant[:, s]
                if det_ok.any():
                    self.pairs.append((r, s, t(np.where(det_ok, det, 1.0)[:, None]), b(det_ok[:, None])))
        # Slant x box-edge vertices: rows whose slant devices have a non-zero
        # x (meet the y bounds) or y (meet the x bounds) normal entry.
        self.meets_y = {r: t(np.where(G[:, r, 0] == 0, 1.0, G[:, r, 0])[:, None]) for r in self.slant_rows
                        if np.any(G[:, r, 0][slant[:, r]] != 0)}
        self.meets_x = {r: t(np.where(G[:, r, 1] == 0, 1.0, G[:, r, 1])[:, None]) for r in self.slant_rows
                        if np.any(G[:, r, 1][slant[:, r]] != 0)}

    def __call__(self, px, py, h):
        eps, inf = self.eps, float("inf")
        h_rows = h.unbind(1)  # m views [C, B]
        h_fin = torch.isfinite(h).unbind(1)

        bounds = {}
        for key, reduce, fill in (("hi_x", torch.minimum, inf), ("lo_x", torch.maximum, -inf),
                                  ("hi_y", torch.minimum, inf), ("lo_y", torch.maximum, -inf)):
            cur = None
            for r, mask, g in self.box[key]:
                val = torch.where(mask & h_fin[r], h_rows[r] / g, fill)
                cur = val if cur is None else reduce(cur, val)
            bounds[key] = torch.full_like(px, fill) if cur is None else cur
        lo_x, hi_x, lo_y, hi_y = bounds["lo_x"], bounds["hi_x"], bounds["lo_y"], bounds["hi_y"]

        fin_abs = lambda a: torch.where(torch.isfinite(a), a.abs(), torch.zeros_like(a))
        tol_x = eps * (1.0 + fin_abs(hi_x) + fin_abs(lo_x))
        tol_y = eps * (1.0 + fin_abs(hi_y) + fin_abs(lo_y))
        tol_s = {r: eps * (1.0 + torch.where(h_fin[r], h_rows[r].abs(), torch.zeros_like(h_rows[r])))
                 for r in self.slant_rows}
        act_s = {r: self.slant_mask[r] & h_fin[r] for r in self.slant_rows}

        def feasible(x, y):
            ok = (x >= lo_x - tol_x) & (x <= hi_x + tol_x) & (y >= lo_y - tol_y) & (y <= hi_y + tol_y)
            for r in self.slant_rows:
                gxv = self.gx[r] * x + self.gy[r] * y
                ok = ok & ((gxv <= h_rows[r] + tol_s[r]) | ~act_s[r])
            return ok

        best_x, best_y = px, py
        best_d = torch.where(feasible(px, py), torch.zeros_like(px), torch.full_like(px, inf))

        def consider(x, y, valid):
            nonlocal best_x, best_y, best_d
            d = (x - px) ** 2 + (y - py) ** 2
            ok = valid & torch.isfinite(x) & torch.isfinite(y) & feasible(x, y) & (d < best_d)
            best_x = torch.where(ok, x, best_x)
            best_y = torch.where(ok, y, best_y)
            best_d = torch.where(ok, d, best_d)

        # Candidate 0 is the point (returned when nothing is feasible);
        # candidate 1 the box clip, every box foot and corner in one.
        consider(torch.clamp(px, lo_x, hi_x), torch.clamp(py, lo_y, hi_y), torch.ones_like(px, dtype=torch.bool))
        for r in self.slant_rows:
            coef = (self.gx[r] * px + self.gy[r] * py - h_rows[r]) / self.gg[r]
            consider(px - coef * self.gx[r], py - coef * self.gy[r], act_s[r])
        for r, s, det, det_ok in self.pairs:
            hr, hs = h_rows[r], h_rows[s]
            vx = (hr * self.gy[s] - hs * self.gy[r]) / det
            vy = (self.gx[r] * hs - self.gx[s] * hr) / det
            consider(vx, vy, det_ok & h_fin[r] & h_fin[s])
        for r in self.slant_rows:
            if r in self.meets_y:
                for ybound in (lo_y, hi_y):
                    consider((h_rows[r] - self.gy[r] * ybound) / self.meets_y[r], ybound, act_s[r])
            if r in self.meets_x:
                for xbound in (lo_x, hi_x):
                    consider(xbound, (h_rows[r] - self.gx[r] * xbound) / self.meets_x[r], act_s[r])
        return best_x, best_y


def project_box_slants_lanes(px, py, G, h, eps=None):
    """Exact lanes-last projection onto box bounds plus slanted cuts (see
    :class:`BoxSlantsProjector`).  Inputs and outputs as
    :func:`project_polytope_lanes`."""
    return BoxSlantsProjector(G, px.device, px.dtype, eps=eps)(px, py, h)


def _pair_indices(m: int):
    iu = np.triu_indices(m, k=1)
    return torch.as_tensor(iu[0]), torch.as_tensor(iu[1])


def project_polytope(point, G, h, eps=None):
    """Project ``point`` onto ``{x : G x <= h}`` exactly (batch-first).

    ``point``: ``[..., 2]``; ``G``: ``[..., m, 2]`` (per batch element);
    ``h``: ``[..., m]``.  ``+inf`` offsets and non-finite normals mark
    inactive rows.  JAX's semantics: a candidate must be finite and
    feasible, and ``argmin`` takes the first of equal minima, so a NaN point
    (NaN distance to every valid candidate) returns its first valid
    candidate.
    """
    if eps is None:
        eps = _default_eps(point.dtype)
    m = G.shape[-2]
    ii, jj = (a.to(G.device) for a in _pair_indices(m))
    inf = float("inf")

    row_finite = torch.isfinite(G).all(dim=-1)  # [..., m]
    h_fin = torch.isfinite(h)
    active = row_finite & h_fin
    tol = eps * (1.0 + torch.where(h_fin, h.abs(), torch.zeros_like(h)))

    def feasible(x):  # x [..., k, 2] -> [..., k]
        gx = (G[..., None, :, :] * x[..., :, None, :]).sum(-1)  # [..., k, m]
        viol = gx - (h + tol)[..., None, :]
        return torch.where(active[..., None, :], viol <= 0, True).all(dim=-1)

    gg = (G * G).sum(-1)
    gp = (G * point[..., None, :]).sum(-1)
    feet_valid = active & (gg > 0)
    coef = torch.where(feet_valid, (gp - h) / torch.where(gg > 0, gg, torch.ones_like(gg)), torch.nan)
    c_feet = point[..., None, :] - coef[..., None] * G

    g_i, g_j = G[..., ii, :], G[..., jj, :]
    h_i, h_j = h[..., ii], h[..., jj]
    det = g_i[..., 0] * g_j[..., 1] - g_i[..., 1] * g_j[..., 0]
    nrm = torch.sqrt(torch.clamp(gg[..., ii] * gg[..., jj], min=0.0))
    det_ok = det.abs() > eps * torch.clamp(nrm, min=1.0)
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    vx = (h_i * g_j[..., 1] - h_j * g_i[..., 1]) / safe_det
    vy = (g_i[..., 0] * h_j - g_j[..., 0] * h_i) / safe_det
    c_vert = torch.stack([vx, vy], dim=-1)
    vert_valid = det_ok & active[..., ii] & active[..., jj]

    cands = torch.cat([point[..., None, :], c_feet, c_vert], dim=-2)
    valid = torch.cat([torch.ones_like(feet_valid[..., :1]), feet_valid, vert_valid], dim=-1)
    valid = valid & torch.isfinite(cands).all(dim=-1) & feasible(cands)
    d2 = ((cands - point[..., None, :]) ** 2).sum(-1)
    score = torch.where(valid, d2, inf)
    # NaN is the minimum, as jnp.argmin takes it: the first NaN, else the
    # first of the equal minima.
    nan = torch.isnan(score)
    best = torch.where(nan.any(-1), nan.to(torch.int8).argmax(-1), torch.argmin(torch.where(nan, inf, score), dim=-1))
    return torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
