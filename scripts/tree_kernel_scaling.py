"""Where the tree-NR kernel's time goes: its time against the batch and the
NR budget, on one GPU.

    python3 scripts/tree_kernel_scaling.py

On the inputs of ``chip_smoke.py``'s K1 rows (cold), times the kernel by
``chip_smoke.event_ms`` (a CUDA graph of 20 launches, per launch) at
several batch sizes and NR budgets, and prints the card's name and power
limit, then one JSON line per case with the launch geometry and the
batch's resident lanes: the lanes that fit on the card at once
(lanes a block x blocks an SM x SMs).  A time that steps up when the batch
passes that count is the cost of a second wave; a time that follows the
budget with the batch fixed is the cost of the lanes that run every step.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (grid, batch sizes, NR budgets)
CASES = (
    ("anm6", (1024, 2048, 4096), (12,)),
    ("feeder33", (2048, 4096), (4, 6, 12)),
    ("feeder141", (1056, 2112, 3168, 4096), (4, 12)),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("tree_kernel_scaling: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gym_anm_tpu_torch.ops import tree_cuda

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    amps = {name: (amp, x_tol) for name, amp, x_tol in cs.TREE_GRIDS}
    for name, batches, budgets in CASES:
        amp, x_tol = amps[name]
        g = cs.make_grid(name)
        ds = g.tree
        p, q = cs.make_injections(g.spec.n_bus - 1, amp)
        zero = torch.zeros((1, p.shape[1]), device="cuda")
        pT = torch.cat([p, zero])[ds.slot_sel].contiguous()
        qT = torch.cat([q, zero])[ds.slot_sel].contiguous()
        geo = tree_cuda.tree_nr_geometry(ds)
        resident = geo["lanes_per_block"] * geo["blocks_per_sm"] * sms
        for B in batches:
            pB, qB = pT[:, :B].contiguous(), qT[:, :B].contiguous()
            for max_iter in budgets:
                run = lambda: tree_cuda.solve_pfe_tree_cuda(ds, pB, qB, x_tol=x_tol, max_iter=max_iter)
                it = run()[3]
                print(json.dumps({
                    "grid": name, "B": B, "max_iter": max_iter, "resident_lanes": resident,
                    "waves": -(-B // resident), "ms": cs.event_ms(run, 20, 5, graph=True),
                    "mean_iters": float(it.float().mean()), "lanes_at_budget": int((it == max_iter).sum()),
                    "geometry": geo,
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
