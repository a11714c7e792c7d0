"""Observation & state-vector machinery.

The counterpart of ``gym_anm_tpu.core.obs``: every electrical quantity is
packed into one flat "packed observables" vector (p.u./rad, ID-sorted
report order, :func:`pack_observables`), and an observation specification
-- a list of ``(quantity, ids, unit)`` -- is compiled once on the host into
static ``(index, scale, low, high)`` arrays (:func:`compile_gather`).  At
run time an observation is one gather:

    obs = clip(packed[idx] * scale, low, high)

All supported units are linear scalings of the p.u./rad values (MW/MVAr/MVA/
MWh: x baseMVA; kV: x baseKV; kA: x baseMVA/baseKV; degree: x 180/pi).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import ObsNotSupportedError
from .grid import GridSpec
from .state import SimState

# Packed-vector segment order. Bus quantities are in ascending-bus-ID
# (report) order, devices in ascending device ID, branches in input order.
PACKED_KEYS = (
    "bus_p",
    "bus_q",
    "bus_v_magn",
    "bus_v_ang",
    "bus_i_magn",
    "bus_i_ang",
    "dev_p",
    "dev_q",
    "des_soc",
    "gen_p_max",
    "branch_p",
    "branch_q",
    "branch_s",
    "branch_i_magn",
    "branch_i_ang",
    "aux",
)


def packed_ids(spec: GridSpec, K: int) -> dict:
    """The ordered ID list of each packed segment."""
    return {
        "bus_p": spec.bus_ids,
        "bus_q": spec.bus_ids,
        "bus_v_magn": spec.bus_ids,
        "bus_v_ang": spec.bus_ids,
        "bus_i_magn": spec.bus_ids,
        "bus_i_ang": spec.bus_ids,
        "dev_p": spec.dev_ids,
        "dev_q": spec.dev_ids,
        "des_soc": spec.des_ids,
        "gen_p_max": spec.gen_ids,
        "branch_p": spec.branch_ids,
        "branch_q": spec.branch_ids,
        "branch_s": spec.branch_ids,
        "branch_i_magn": spec.branch_ids,
        "branch_i_ang": spec.branch_ids,
        "aux": tuple(range(K)),
    }


def packed_offsets(spec: GridSpec, K: int) -> dict:
    """Map quantity -> start offset in the packed vector."""
    ids = packed_ids(spec, K)
    offsets, off = {}, 0
    for k in PACKED_KEYS:
        offsets[k] = off
        off += len(ids[k])
    offsets["_total"] = off
    return offsets


def pack_observables(spec: GridSpec, sim: SimState, aux, bus_sorted: torch.Tensor) -> torch.Tensor:
    """Flatten a SimState (+ aux vars) into the packed observable vector
    ``[..., total]``, in the dtype and on the device of ``sim``.
    ``bus_sorted``: ``spec.bus_sorted`` as an int64 tensor on that device.

    p.u./rad everywhere.  ``branch_i_magn`` is Re(i_from): the reference
    computes ``np.sign(i).real * np.abs(i)`` (simulator.py:613), which under
    NumPy>=2 complex-sign semantics (sign(z) = z/|z|) equals the real part.
    """
    dtype, device = sim.dev_p.dtype, sim.dev_p.device
    vr, vi = sim.bus_v_re[..., bus_sorted], sim.bus_v_im[..., bus_sorted]
    ir, ii = sim.bus_i_re[..., bus_sorted], sim.bus_i_im[..., bus_sorted]
    segs = [
        sim.bus_p[..., bus_sorted],
        sim.bus_q[..., bus_sorted],
        torch.sqrt(vr * vr + vi * vi),
        torch.atan2(vi, vr),
        torch.sqrt(ir * ir + ii * ii),
        torch.atan2(ii, ir),
        sim.dev_p,
        sim.dev_q,
        sim.des_soc,
        sim.gen_p_pot,
        sim.br_p_from,
        sim.br_q_from,
        sim.br_s,
        sim.br_if_re,
        torch.atan2(sim.br_if_im, sim.br_if_re),
        torch.as_tensor(aux, device=device),
    ]
    return torch.cat([s.to(dtype) for s in segs], dim=-1)


def _unit_scale(spec: GridSpec, key: str, unit, ext_id) -> float:
    """Linear factor converting a packed (p.u./rad) entry to ``unit``."""
    base = spec.baseMVA
    if key == "aux" or unit in ("pu", "rad", None):
        return 1.0
    if unit in ("MW", "MVAr", "MVA", "MWh"):
        return base
    by_id = {b: i for i, b in enumerate(spec.bus_ids)}
    if unit == "kV":
        return float(np.asarray(spec.bus_baseKV)[np.asarray(spec.bus_sorted)][by_id[ext_id]])
    if unit == "kA":
        return base / float(np.asarray(spec.bus_baseKV)[np.asarray(spec.bus_sorted)][by_id[ext_id]])
    if unit == "degree":
        return 180.0 / np.pi
    raise ObsNotSupportedError(unit, ("pu", "rad", "MW", "MVAr", "MVA", "MWh", "kV", "kA", "degree"))


def state_bounds(spec: GridSpec) -> dict:
    """The ``{quantity: {id: {unit: (lo, hi)}}}`` state-space bounds dict,
    replicating ``Simulator.get_state_space`` exactly (simulator.py:382-462)
    -- including the reference's ``gen_p_max`` MW upper bound being
    ``q_max * baseMVA`` (simulator.py:430, a reproduced quirk)."""
    base = spec.baseMVA
    inf = np.inf
    srt = np.asarray(spec.bus_sorted)
    kv = np.asarray(spec.bus_baseKV)[srt]
    vmin = np.asarray(spec.bus_v_min)[srt]
    vmax = np.asarray(spec.bus_v_max)[srt]
    bpmin = np.asarray(spec.bus_p_min)[srt]
    bpmax = np.asarray(spec.bus_p_max)[srt]
    bqmin = np.asarray(spec.bus_q_min)[srt]
    bqmax = np.asarray(spec.bus_q_max)[srt]
    slack_sorted = int(np.where(srt == 0)[0][0])

    bus_p, bus_q, bus_v_magn, bus_v_ang, bus_i_magn, bus_i_ang = {}, {}, {}, {}, {}, {}
    for k, bid in enumerate(spec.bus_ids):
        bus_p[bid] = {"MW": (bpmin[k] * base, bpmax[k] * base), "pu": (bpmin[k], bpmax[k])}
        bus_q[bid] = {"MVAr": (bqmin[k] * base, bqmax[k] * base), "pu": (bqmin[k], bqmax[k])}
        if k == slack_sorted:
            vs = vmax[k]  # v_slack := v_max (bus.py:51)
            bus_v_magn[bid] = {"pu": (vs, vs), "kV": (vs * kv[k], vs * kv[k])}
            bus_v_ang[bid] = {"degree": (0, 0), "rad": (0, 0)}
        else:
            bus_v_magn[bid] = {"pu": (-inf, inf), "kV": (-inf, inf)}
            bus_v_ang[bid] = {"degree": (-180, 180), "rad": (-np.pi, np.pi)}
        bus_i_magn[bid] = {"pu": (-inf, inf), "kA": (-inf, inf)}
        bus_i_ang[bid] = {"degree": (-180, 180), "rad": (-np.pi, np.pi)}

    dpmin = np.asarray(spec.dev_p_min)
    dpmax = np.asarray(spec.dev_p_max)
    dqmin = np.asarray(spec.dev_q_min)
    dqmax = np.asarray(spec.dev_q_max)
    dev_p, dev_q, des_soc, gen_p_max = {}, {}, {}, {}
    for k, did in enumerate(spec.dev_ids):
        dev_p[did] = {"MW": (dpmin[k] * base, dpmax[k] * base), "pu": (dpmin[k], dpmax[k])}
        dev_q[did] = {"MVAr": (dqmin[k] * base, dqmax[k] * base), "pu": (dqmin[k], dqmax[k])}
    for k, did in enumerate(spec.des_ids):
        smin = float(np.asarray(spec.des_soc_min)[k])
        smax = float(np.asarray(spec.des_soc_max)[k])
        des_soc[did] = {"MWh": (smin * base, smax * base), "pu": (smin, smax)}
    for k, did in enumerate(spec.gen_ids):
        pmin = float(np.asarray(spec.gen_p_min)[k])
        pmax = float(np.asarray(spec.gen_p_max)[k])
        qmax = dqmax[list(spec.dev_ids).index(did)]
        gen_p_max[did] = {"MW": (pmin * base, qmax * base), "pu": (pmin, pmax)}

    branch_p, branch_q, branch_s, branch_i_magn, branch_i_ang = {}, {}, {}, {}, {}
    for br in spec.branch_ids:
        branch_p[br] = {"MW": (-inf, inf), "pu": (-inf, inf)}
        branch_q[br] = {"MVAr": (-inf, inf), "pu": (-inf, inf)}
        branch_s[br] = {"MVA": (-inf, inf), "pu": (-inf, inf)}
        branch_i_magn[br] = {"pu": (-inf, inf), "kA": (-inf, inf)}
        branch_i_ang[br] = {"rad": (-np.pi, np.pi), "degree": (-180, 180)}

    return {
        "bus_p": bus_p,
        "bus_q": bus_q,
        "bus_v_magn": bus_v_magn,
        "bus_v_ang": bus_v_ang,
        "bus_i_magn": bus_i_magn,
        "bus_i_ang": bus_i_ang,
        "dev_p": dev_p,
        "dev_q": dev_q,
        "des_soc": des_soc,
        "gen_p_max": gen_p_max,
        "branch_p": branch_p,
        "branch_q": branch_q,
        "branch_s": branch_s,
        "branch_i_magn": branch_i_magn,
        "branch_i_ang": branch_i_ang,
    }


@dataclasses.dataclass(frozen=True)
class GatherSpec:
    """Compiled extraction of a state/observation vector from the packed
    observables: ``vec = clip(packed[idx] * scale, low, high)``.

    :func:`compile_gather` makes one with NumPy fields; a copy with tensor
    fields on the packed vector's device saves the copies per call."""

    idx: np.ndarray  # [m] int32
    scale: np.ndarray  # [m]
    low: np.ndarray  # [m]
    high: np.ndarray  # [m]

    def __call__(self, packed: torch.Tensor, clip: bool = False) -> torch.Tensor:
        t = lambda a: torch.as_tensor(a, device=packed.device)
        vec = packed[..., t(self.idx).long()] * t(self.scale).to(packed.dtype)
        if clip:
            vec = torch.clamp(vec, t(self.low).to(packed.dtype), t(self.high).to(packed.dtype))
        return vec

    @property
    def n(self) -> int:
        return self.idx.shape[0]


def compile_gather(spec: GridSpec, values, K: int, aux_bounds=None, dtype=None) -> GatherSpec:
    """Compile a list of ``(quantity, [ids], unit)`` tuples (already
    'all'-expanded and validated) into a GatherSpec."""
    dtype = dtype or spec.dtype
    offsets = packed_offsets(spec, K)
    ids = packed_ids(spec, K)
    bounds = state_bounds(spec)

    idx, scale, low, high = [], [], [], []
    for key, nodes, unit in values:
        if key not in PACKED_KEYS:
            raise ObsNotSupportedError(key, PACKED_KEYS)
        pos = {e: i for i, e in enumerate(ids[key])}
        for n in nodes:
            n_key = tuple(n) if isinstance(n, (list, tuple)) else n
            idx.append(offsets[key] + pos[n_key])
            if key == "aux":
                scale.append(1.0)
                if aux_bounds is not None:
                    low.append(aux_bounds[n_key][0])
                    high.append(aux_bounds[n_key][1])
                else:
                    low.append(-np.inf)
                    high.append(np.inf)
            else:
                scale.append(_unit_scale(spec, key, unit, n_key))
                lo, hi = bounds[key][n_key][unit]
                low.append(lo)
                high.append(hi)

    return GatherSpec(
        idx=np.asarray(idx, dtype=np.int32),
        scale=np.asarray(scale, dtype=np.float64).astype(dtype),
        low=np.asarray(low, dtype=np.float64).astype(dtype),
        high=np.asarray(high, dtype=np.float64).astype(dtype),
    )


def state_values_spec(spec: GridSpec, K: int):
    """The canonical state-vector layout (anm_env.py:139-147):
    [dev_p (MW), dev_q (MVAr), des_soc (MWh), gen_p_max (MW), aux]."""
    return [
        ("dev_p", list(spec.dev_ids), "MW"),
        ("dev_q", list(spec.dev_ids), "MVAr"),
        ("des_soc", list(spec.des_ids), "MWh"),
        ("gen_p_max", list(spec.gen_ids), "MW"),
        ("aux", list(range(K)), None),
    ]
