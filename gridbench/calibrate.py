"""Readings for the limits of the correctness check, and the control.

For each cell and seed, one run at the cell's own size and load (a window of
``--seconds``) is judged twice from the same records: as the program's
outputs (the lower reading: the largest a sound run gives) and, on the first
``--control-seeds`` seeds, with the reference computed in bfloat16 in the
program's place (the control: the upper reading is the smallest it gives).
One JSON line a run::

    python3 -m gridbench.calibrate --cells <cell> [...] --seeds 12 --control-seeds 3 --seconds 12

Run from the root of a checkout on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

FIRST_SEED = 3_000_000_000  # the seeds are FIRST_SEED + 7919 k


def main(argv=None) -> int:
    from . import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=12.0)
    a = p.parse_args(argv)
    harness.prepare_process()
    import torch

    from . import judge

    torch.set_num_threads(1)
    for cell_name in a.cells:
        for k in range(a.seeds):
            seed = FIRST_SEED + 7919 * k
            _, cell, out, peak = harness.execute(cell_name, seed, a.seconds, False)
            row = {"cell": cell_name, "seed": seed, "attempted": out.attempted, "failed": out.failed,
                   "records": len(out.records), "metrics": out.metrics, "memory_peak_bytes": peak}
            row["program"] = judge.judge_records(cell.config, cell.traffic, out.records, "cuda").numbers()
            if k < a.control_seeds:
                row["control"] = judge.judge_records(cell.config, cell.traffic, out.records, "cuda",
                                                     control=True).numbers()
            print(json.dumps(row), flush=True)
            del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
