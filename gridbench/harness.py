"""Run one cell of ``BENCHMARK.json`` once and report it.

Everything that belongs to one item is a file of its own, found by name:

* the cell's configuration: the ``file`` its ``configs`` entry names;
* the cell's traffic mix: ``gridbench/traffic/<traffic>.json``, whose
  ``driver`` names the entry driver ``gridbench/drivers/<driver>.py``;
* the limits of the cell's correctness check: ``gridbench/limits/<cell>.json``;
* each per-layer metric's reader: ``gridbench/metrics/<metric>.py``, or,
  where that file is absent, the reader of the metric's name without its
  family suffix (``device_idle_pct.vec`` -> ``device_idle_pct.py``).

A run: set-up (build, load, warm up the cell's own shapes), the measured
window, with ``--trace 1`` a profiled stretch after it, the check of what the
window produced against the plain reference, and one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that may not be loaded in a measured process: JAX and
# the JAX package (compared whole: the port's own name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_anm_tpu")


def prepare_process(root: Path = ROOT) -> None:
    """Before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths (the port's library goes to ``build/kernels/``
    by itself), and one host thread for the math libraries, so that a run
    loads the host from one process with few threads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def process_age() -> Optional[float]:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


@dataclasses.dataclass
class Cell:
    """One cell, resolved: what a driver is handed."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    patch: Optional[Callable] = None  # fault planting, for the harness's own tests
    t0: float = dataclasses.field(default_factory=time.perf_counter)
    setup_s: Optional[float] = None
    build: Optional[dict] = None  # the kernel library's part of set-up (on the card)

    def open_window(self):
        """Close set-up (its length is ``setup_s``) and open the window.
        The objects set-up made are moved out of the collector's reach
        (``gc.freeze``), so a full collection in the window walks only what
        the window allocates."""
        from .yardstick import WindowRate

        gc.collect()
        gc.freeze()
        age = process_age()
        self.setup_s = age if age is not None else time.perf_counter() - self.t0
        return WindowRate()


@dataclasses.dataclass
class DriverOut:
    """What a driver hands back once its window has closed."""

    metrics: dict  # end-to-end metric name -> value (setup_s excluded)
    attempted: int
    failed: int
    records: list  # the sample the check judges (see judge.py)
    counters: dict  # program counters and the benchmark's spans
    trace: object = None  # trace.Trace of the profiled stretch, with --trace 1


def resolve(manifest: dict, workload: str, root: Path = ROOT, overrides: Optional[dict] = None) -> tuple:
    """The cell's entry, its configuration entry, and its files, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit("no cell %r in BENCHMARK.json (cells: %s)" % (workload, ", ".join(cells)))
    w = cells[workload]
    c = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(root / c["file"])
    traffic = load_json(root / "gridbench" / "traffic" / ("%s.json" % w["traffic"]))
    traffic.update(overrides or {})
    limits = load_json(root / "gridbench" / "limits" / ("%s.json" % workload))
    return w, c, config, traffic, limits


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: Path = ROOT):
    """``gridbench/drivers/<name>.py``: ``run(cell) -> DriverOut`` (it may
    import the harness's modules)."""
    return _load(root / "gridbench" / "drivers" / ("%s.py" % name), "gridbench.drivers.%s" % name)


def load_reader(name: str, root: Path = ROOT):
    """``gridbench/metrics/<name>.py``, or the reader of ``name`` without its
    family suffix (one reader serves every family): ``read(ctx)`` gives the
    metric or None."""
    metrics = root / "gridbench" / "metrics"
    path = metrics / ("%s.py" % name)
    if not path.is_file() and "." in name:
        path = metrics / ("%s.py" % name.rsplit(".", 1)[0])
    return _load(path, "gridbench_metric_" + name.replace(".", "_"))


def load_kernels() -> dict:
    """Load the port's kernel library, which ``nvcc`` builds into
    ``build/kernels/`` on a checkout's first run: whether it was built, and
    the seconds this part of set-up took."""
    from gym_anm_tpu_torch.ops import _build

    built = not _build.library_path().exists()
    t = time.perf_counter()
    _build.load_library()
    return {"nvcc": built, "library_s": time.perf_counter() - t}


def device_info(torch, chips: int, peak: int, device: str) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def cards(torch) -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Context:
    """What a per-layer reader is handed: the cell, its driver's counters and
    trace, the reference's work counts, and the grid's shapes."""

    def __init__(self, cell: Cell, out: DriverOut, work: dict):
        from . import reference, yardstick

        self.cell = cell
        self.counters = out.counters
        self.trace = out.trace
        self.work = work
        self.grid = reference.Grid(cell.config, "cpu")
        self.yardstick = yardstick
        self.batch = int(cell.traffic["batch"])


def execute(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device: str = "cuda",
            overrides: Optional[dict] = None, patch: Optional[Callable] = None,
            t0: Optional[float] = None) -> tuple:
    """Set up, measure and (with ``trace``) profile one run of ``workload``:
    ``(manifest, cell, driver output, memory peak)``.  The program's state is
    freed before this returns; the records the check judges stay."""
    import torch

    manifest = load_json(root / "BENCHMARK.json")
    w, _, config, traffic, limits = resolve(manifest, workload, root, overrides)
    cell = Cell(name=workload, config=config, traffic=traffic, limits=limits, chips=int(w["chips"]),
                seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device, patch=patch, t0=time.perf_counter() if t0 is None else t0)
    driver = load_driver(traffic["driver"], root)
    if device == "cuda":
        cell.build = load_kernels()
    out = driver.run(cell)
    found = loaded_forbidden()
    if found:
        raise SystemExit("modules of JAX or the JAX package are loaded: %s" % ", ".join(found))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return manifest, cell, out, peak


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device: str = "cuda",
             overrides: Optional[dict] = None, patch: Optional[Callable] = None, control: bool = False,
             t0: Optional[float] = None) -> dict:
    """One run of ``workload``: the result line as a dict (the check's
    numbers last, under ``checks``).  ``device``, ``overrides``, ``patch``
    and ``control`` serve the harness's own tests and the control's runs;
    a measured run leaves them at their defaults."""
    import torch

    from . import judge

    manifest, cell, out, peak = execute(workload, seed, seconds, trace, root=root, device=device,
                                        overrides=overrides, patch=patch, t0=t0)
    t = time.perf_counter()
    j = judge.judge_records(cell.config, cell.traffic, out.records, device, control=control)
    check_s = time.perf_counter() - t
    correct, checks = judge.decide(j.numbers(), cell.limits, len(out.records))
    correct = correct and out.attempted > 0 and out.failed == 0

    metrics = {}
    if not trace:
        for m in manifest["end_to_end"]:
            if not applies(m, workload):
                continue
            v = cell.setup_s if m["name"] == "setup_s" else out.metrics.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = Context(cell, out, j.work())
        for m in manifest["per_layer"]:
            if applies(m, workload):
                v = load_reader(m["name"], root).read(ctx)
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device_info(torch, cell.chips, peak, device)}
    if trace and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_s
        line["device"]["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_device_ops(10), "idle_gaps": out.trace.idle_gaps(10)}
    if device == "cuda":
        line["device"]["card"] = card_line()
    line["setup"] = dict(cell.build or {}, setup_s=cell.setup_s)
    line["check_seconds"] = check_s
    line["checks"] = checks
    return line


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once; print one JSON result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    prepare_process()
    import torch

    torch.set_num_threads(1)

    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: int(w["chips"]) for w in manifest["workloads"]}.get(a.workload, 1)
    if cards(torch) < chips:
        print("no CUDA card (or fewer than %d): this benchmark measures the card only" % chips, file=sys.stderr)
        return 2
    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
    # Last, after the check and every reader: nothing of JAX may be loaded.
    found = loaded_forbidden()
    if found:
        print("modules of JAX or the JAX package are loaded: %s; no result" % ", ".join(found), file=sys.stderr)
        return 3
    print("setup %s" % json.dumps(line["setup"]), file=sys.stderr)
    print("check_seconds %.3f (the reference's time, after the window)" % line["check_seconds"], file=sys.stderr)
    for k, c in line["checks"].items():
        print("check %s %.6g limit %.6g" % (k, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
