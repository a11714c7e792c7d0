"""Time the port's kernels in several checkouts with one yardstick.

    python3 scripts/time_kernels_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository: ``.`` for this one,
another commit unpacked with ``git archive`` under ``build/checkout/``
(git-ignored).  On one GPU, for each ROOT in the order given, a fresh
process imports that checkout's ``gym_anm_tpu_torch``, builds its kernels
and times them at B=4096 on the cases of this checkout's ``chip_smoke.py``
(K1 on its three grids and K2 on its four settings, each cold and, where
the checkout's kernel has a warm form, warm; K3 on its tasks and methods,
``chip_smoke.STEP_CASES``: a case the checkout refuses prints its row with
``refused``), through the public wrappers, with
``chip_smoke.event_ms``: the replay of a CUDA graph of 20 launches (``ms``,
as ``chip_smoke.py`` reports) and 20 eager calls (``eager_ms``, the host's
issue time included), each per launch.  Give the roots as A B B A to see
the drift between turns.  Prints the card's name and power limit, then one
JSON line per (root, case); ``out_sha`` hashes the case's outputs, so two
roots whose kernels agree bit for bit show the same value; ``k1_counts``
and ``k3_counts`` (where the checkout has K1's or K3's iteration counters)
are what the case's first launch added to them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    """This checkout's ``chip_smoke.py``; its helpers import
    ``gym_anm_tpu_torch`` lazily, so they use the package first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(cs):
    """``(row, run)`` for each case: ``run()`` launches the kernel once."""
    from gym_anm_tpu_torch import check
    from gym_anm_tpu_torch.ops import nr_cuda, step_cuda, tree_cuda

    # A checkout whose tree kernel has no warm form times its cold cases.
    for name, x_tol, ds, pT, qT, warm in cs.tree_cases(warm=hasattr(tree_cuda, "warm_point")):
        kw = dict(x_tol=x_tol, max_iter=cs.TREE_MAX_ITER, **({} if warm is None else {"init": warm}))
        yield {"kernel": "tree_nr", "grid": name, "warm": warm is not None}, (
            lambda ds=ds, pT=pT, qT=qT, kw=kw: tree_cuda.solve_pfe_tree_cuda(ds, pT, qT, **kw))
    nr_warm = "init" in inspect.signature(nr_cuda.solve_pfe_nr_cuda).parameters
    for name, _, chord, pivot, max_iter, g, p, q, warm in cs.nr_cases(warm=nr_warm):
        kw = dict(x_tol=1e-5, max_iter=max_iter, chord_iters=chord, pivot=pivot)
        kw.update({} if warm is None else {"init": warm})
        yield {"kernel": "nr_dense", "grid": name, "chord_iters": chord, "pivot": pivot, "warm": warm is not None}, (
            lambda g=g, p=p, q=q, kw=kw: nr_cuda.solve_pfe_nr_cuda(g.Y_re, g.Y_im, g.J0inv, p, q, **kw))
    for env, method in cs.STEP_CASES:
        row = {"kernel": "step_fused", "env": env, "pf_method": method}
        try:
            core = check.task_make_core(env)(dtype=torch.float32, device="cuda", pf_method=method)
        except ValueError as e:
            yield dict(row, refused=str(e)), None
            continue
        chord = core.chord_iters if method == "fused_hybrid" else 0
        kw = dict(x_tol=core.x_tol, max_iter=core.max_iter, chord_iters=chord, pivot=core.nr_pivot)
        yield row, (
            lambda st=core.grid.step, lanes=cs.step_lanes(core), kw=kw: (
                step_cuda.fused_transition_cuda(st, lanes, **kw),))


def child(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    cs = _load_smoke()
    import gym_anm_tpu_torch
    from gym_anm_tpu_torch.ops import _build, step_cuda, tree_cuda

    if not os.path.abspath(gym_anm_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError("imported %s, not the package under %s" % (gym_anm_tpu_torch.__file__, root))
    t0 = time.perf_counter()
    _build.load_library()
    print(json.dumps({"root": os.path.relpath(root, REPO), "build_s": time.perf_counter() - t0}), flush=True)
    counters = {name: getattr(m, "iteration_counts", None) for name, m in (("k1", tree_cuda), ("k3", step_cuda))}
    counters = {name: c for name, c in counters.items() if c is not None}
    for row, run in cases(cs):
        if run is None:
            print(json.dumps(dict(row, root=os.path.relpath(root, REPO))), flush=True)
            continue
        h = hashlib.sha256()
        c0 = {name: c("cuda").tolist() for name, c in counters.items()}
        for t in run():
            h.update(t.cpu().numpy().tobytes())
        for name, c in counters.items():  # what one launch added to the iteration counters
            row[name + "_counts"] = [b - a for a, b in zip(c0[name], c("cuda").tolist())]
        row.update({
            "root": os.path.relpath(root, REPO), "out_sha": h.hexdigest()[:16],
            "ms": cs.event_ms(run, 20, 5, graph=True), "eager_ms": cs.event_ms(run, 20, 5),
        })
        print(json.dumps(row), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        return child(argv[1])
    if not argv:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rc = 0
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root]).returncode
        rc = rc or r
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
