"""The comparison that decides ``correct``.

A driver records, during the measured window, the inputs and the outputs of
a sample of the steps the window drove (the sample is drawn from the seed),
as references to the program's own tensors.  Once the window has closed, the
plain reference (:mod:`gridbench.reference`, float64) works every recorded
step out again from its inputs: the storage charge and termination flags of
the state the step started from, the actions, the task's drawn variables
and, for a fresh state, its initial vector ``s0``.  The reference follows the
program step by step from the program's state: a trajectory of thousands of
steps cannot be replayed in float64 to float32's rounding.

The numbers compared, each against its limit in ``limits/<cell>.json``:

``pf_residual``
    The widest float64 power-flow mismatch (p.u.) of the program's bus
    voltages at the injections the reference computed, over the lanes both
    keep alive: the task's own criterion of a solved power flow, which a
    solve meets within ``x_tol`` at whichever iterate it stops.
``state_gap``
    The widest gap, in p.u. (MW / MVAr / MWh over baseMVA), between the
    program's and the reference's state vector and observation, the
    reference deriving the slack's injection, the flows and the reward from
    the program's voltages; a termination flag that differs reads 1 (a lane
    terminated on one side only also compares a zero state with a live one);
    for a reborn lane, the gap to the nearest fresh state the reference
    computed from the segment's pool; and how far the task's drawn variables
    lie from what the task allows.
``reward_gap``
    The widest gap between the rewards, over every lane.

``control=True`` puts the reference computed in bfloat16 in the program's
place: its outputs from the same recorded inputs are judged the same way.
"""

from __future__ import annotations

import math

import torch

from . import reference as R

NUMBERS = ("pf_residual", "state_gap", "reward_gap")


def _max(x) -> float:
    if x.numel() == 0:
        return 0.0
    x = torch.nan_to_num(x.to(torch.float64), nan=math.inf)
    return float(x.max())


def _cplx(v):
    return torch.complex(v[0].to(torch.float64), v[1].to(torch.float64)) if isinstance(v, tuple) else v


class Judge:
    def __init__(self, cfg: dict, traffic: dict, device, control: bool = False):
        self.g = R.Grid(cfg, device)
        self.cfg = cfg
        self.max_iter = int(cfg["pf_max_iter"][traffic["pf_method"]])
        self.ref = R.Prec("float64")
        self.ctl = R.Prec("bfloat16") if control else None
        self.device = torch.device(device)
        self.resid = 0.0
        self.gap = 0.0
        self.rgap = 0.0
        self.iters = {"step": [], "reset": []}

    def _d(self, x):
        return torch.as_tensor(x).to(self.device)

    # ------------------------------------------------------------------
    def _flags(self, term, ref_term, reward=None, ref_reward=None):
        """Termination flags are outputs of 0 or 1: a lane whose flag
        differs reads a state gap of 1.  Rewards are compared on every lane
        (a terminal reward is -c2 / (1 - gamma))."""
        term = self._d(term).bool()
        self.gap = max(self.gap, float((term != ref_term).any()))
        if reward is not None:
            self.rgap = max(self.rgap, _max((self._d(reward).double() - ref_reward.double()).abs()))

    def _gap(self, sv, obs, term, ref: R.EnvOut):
        """The state gap (p.u.) over every lane (a lane terminated on one side
        only compares a zero state with a live one); the power flow's
        residual over the lanes both sides keep alive."""
        base = self.g.base
        d = torch.cat([(self._d(sv).double() - ref.state_vec.double()) / base,
                       (self._d(obs).double() - ref.obs.double()) / base], 1)
        self.gap = max(self.gap, _max(d.abs()))
        live = ~self._d(term).bool() & ~ref.terminated
        self.resid = max(self.resid, _max(ref.residual[live]))

    def _reborn(self, sv, obs, lanes, es_term, pool_ref: R.EnvOut):
        """Reborn lanes: each must be one of the segment's fresh states; the
        gap is to the nearest one the reference computed, and its
        termination is that one's."""
        if not bool(lanes.any()):
            return
        base = self.g.base
        mine = torch.cat([self._d(sv).double(), self._d(obs).double()], 1)[lanes] / base
        ref = torch.cat([pool_ref.state_vec.double(), pool_ref.obs.double()], 1) / base
        best = torch.full((mine.shape[0],), math.inf, dtype=torch.float64, device=self.device)
        arg = torch.zeros((mine.shape[0],), dtype=torch.int64, device=self.device)
        for j0 in range(0, ref.shape[0], 1024):
            v, i = torch.cdist(mine, ref[j0:j0 + 1024], p=math.inf).min(1)
            better = v < best
            best, arg = torch.where(better, v, best), torch.where(better, i + j0, arg)
        self.gap = max(self.gap, _max(best))
        self._flags(self._d(es_term).bool()[lanes], pool_ref.terminated[arg])

    # ------------------------------------------------------------------
    def pool(self, rec: dict) -> tuple[R.EnvOut, R.EnvOut]:
        """A segment's fresh states: ``(reference, judged)``, judged being the
        program's (or the control's)."""
        s0 = self._d(rec["s0"])
        if self.ctl is None:
            V = _cplx(rec["v"])
            ref = R.reset_from_s0(self.g, s0, self.max_iter, self.ref, self._d(V))
            out = R.EnvOut(self._d(rec["sv"]), ref.obs, ref.reward, self._d(rec["term"]).bool(), ref.V, ref.iters,
                           ref.residual)
        else:
            out = R.reset_from_s0(self.g, s0, self.max_iter, self.ctl)
            ref = R.reset_from_s0(self.g, s0, self.max_iter, self.ref, out.V)
        self.iters["reset"].append(float(ref.iters.double().mean()))
        self._flags(out.terminated, ref.terminated)
        # The pool's observations are judged where lanes are reborn.
        self._gap(out.state_vec, ref.obs if self.ctl is None else out.obs, out.terminated, ref)
        return ref, out

    def _inputs(self, rec: dict):
        args = (self._d(rec["soc"]), self._d(rec["term_in"]).bool(), self._d(rec["actions"]), self._d(rec["vars"]))
        self.gap = max(self.gap, _max(R.task_vars_gap(self.cfg, self.g, self._d(rec["sv_in"]), args[3])))
        return args

    def rollout_step(self, rec: dict, pool_ref: R.EnvOut, pool_out: R.EnvOut, pool_sv) -> None:
        """A pool-mode step: lanes that terminate are reborn from the pool."""
        args = self._inputs(rec)
        if self.ctl is None:
            sv, obs, V, term, rew = rec["sv"], rec["obs"], self._d(_cplx(rec["v"])), rec["term"], rec["reward"]
            es_term = rec["es_term"]
        else:
            # The control's reborn lanes take the pool entries the program's
            # took (the draw is the program's generator's), from its own pool.
            ctl = R.env_step(self.g, *args, self.max_iter, self.ctl)
            term = ctl.terminated
            pick = torch.arange(term.shape[0], device=self.device)
            reborn = self._d(rec["term"]).bool()
            if bool(reborn.any()):
                prog_sv = self._d(rec["sv"]).double()
                pick[reborn] = torch.cdist(prog_sv[reborn], self._d(pool_sv).double(), p=math.inf).argmin(1)
            lanes = term[:, None]
            sv = torch.where(lanes, pool_out.state_vec[pick], ctl.state_vec)
            obs = torch.where(lanes, pool_out.obs[pick], ctl.obs)
            V = ctl.V
            es_term = torch.where(term, pool_out.terminated[pick], ctl.terminated)
            rew = ctl.reward
        ref = R.env_step(self.g, *args, self.max_iter, self.ref, V)
        self.iters["step"].append(float(ref.iters.double().mean()))
        term = self._d(term).bool()
        self._flags(term, ref.terminated, rew, ref.reward)
        # Reborn lanes are judged against the pool, the others here.
        keep = ~term[:, None]
        self._gap(torch.where(keep, self._d(sv), ref.state_vec), torch.where(keep, self._d(obs), ref.obs), term, ref)
        self._reborn(sv, obs, term, es_term, pool_ref)

    def vec_step(self, rec: dict) -> None:
        """A next-step-autoreset step: lanes flagged to reset take the fresh
        state of their own ``s0``, reward 0 and ``terminated`` False."""
        args = self._inputs(rec)
        s0 = self._d(rec["fresh_s0"])
        reset = self._d(rec["needs_reset"]).bool()
        sel = lambda a, b: torch.where(reset[:, None] if a.dim() == 2 else reset, a, b)
        if self.ctl is None:
            sv, V, es_term = rec["es_sv"], self._d(_cplx(rec["es_v"])), rec["es_term"]
            obs, reward, flag = rec["obs"], rec["reward"], rec["terminated"]
        else:
            ctl = R.env_step(self.g, *args, self.max_iter, self.ctl)
            fresh = R.reset_from_s0(self.g, s0, self.max_iter, self.ctl)
            sv, obs, V = sel(fresh.state_vec, ctl.state_vec), sel(fresh.obs, ctl.obs), sel(fresh.V, ctl.V)
            es_term = sel(fresh.terminated, ctl.terminated)
            reward = sel(torch.zeros_like(ctl.reward), ctl.reward)
            flag = ctl.terminated & ~reset
        ref = R.env_step(self.g, *args, self.max_iter, self.ref, V)
        fresh_ref = R.reset_from_s0(self.g, s0, self.max_iter, self.ref, V)
        self.iters["step"].append(float(ref.iters.double().mean()))
        self.iters["reset"].append(float(fresh_ref.iters.double().mean()))
        expected = R.EnvOut(sel(fresh_ref.state_vec, ref.state_vec), sel(fresh_ref.obs, ref.obs),
                            sel(torch.zeros_like(ref.reward), ref.reward),
                            sel(fresh_ref.terminated, ref.terminated), sel(fresh_ref.V, ref.V), ref.iters,
                            sel(fresh_ref.residual, ref.residual))
        self._flags(es_term, expected.terminated)
        self._flags(flag, ref.terminated & ~reset, reward, expected.reward)
        self._gap(sv, obs, es_term, expected)

    # ------------------------------------------------------------------
    def numbers(self) -> dict:
        return {"pf_residual": self.resid, "state_gap": self.gap, "reward_gap": self.rgap}

    def work(self) -> dict:
        """The NR iterations the reference needed, a lane, on the recorded
        steps and fresh-state solves."""
        mean = lambda xs: sum(xs) / len(xs) if xs else None
        return {"step_iters": mean(self.iters["step"]), "reset_iters": mean(self.iters["reset"])}


def judge_records(cfg, traffic, records, device, control=False) -> Judge:
    """Run the reference over a driver's records (see the drivers)."""
    j = Judge(cfg, traffic, device, control)
    pools = {}
    for rec in records:
        if rec["kind"] == "pool":
            pools[rec["id"]] = j.pool(rec) + (rec["sv"],)
        elif rec["kind"] == "rollout_step":
            j.rollout_step(rec, *pools[rec["pool"]])
        elif rec["kind"] == "vec_step":
            j.vec_step(rec)
        else:
            raise ValueError("unknown record kind %r" % rec["kind"])
    return j


def decide(numbers: dict, limits: dict, judged: int) -> tuple[bool, dict]:
    """``correct`` and, for each number, its value beside its limit; a run
    that recorded no step to judge is not correct."""
    checks = {k: {"value": numbers[k], "limit": float(limits[k])} for k in NUMBERS}
    ok = judged > 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
