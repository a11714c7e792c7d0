"""Run one benchmark cell once and print its result as the last line of stdout.

    python3 gridbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, on a machine with the
cards the cell asks for; see ``gridbench/README.md``.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gridbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
