"""Whole runs of every cell, here on the CPU at a small size through the
port's plain paths, and on the card at the cells' own size (``gpu``):

* a sound run is judged correct by the plain reference;
* the control (the reference computed in bfloat16 in the program's place)
  and each fault a cell can have (a step that returns its state unchanged,
  half of the batch left out, an answer altered where it is produced) are
  judged not correct;
* the result line has exactly the contract's keys, the check's numbers last;
* nothing the harness loads is JAX or the JAX package.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gridbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"batch": 48, "segment_steps": 6, "judge_segments": 3, "trace_segments": 1,
         "record_every": 2, "judge_steps": 3, "trace_steps": 2, "warmup_steps": 1}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "setup", "check_seconds", "checks"}


def _run(cell, trace=False, **kw):
    return harness.run_cell(cell, 2**31 + 11, 0.3, trace, device="cpu", overrides=SMALL, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"setup_s"} < set(line["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    line = _run(cell, trace=True)
    assert line["correct"]
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in manifest["per_layer"] if harness.applies(m, cell)}
    assert set(line["metrics"]) <= names  # device readings are left out off the card
    assert {"window_s", "busy_s"} <= set(line["device"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = _run(cell, control=True)
    assert not line["correct"]
    assert line["checks"]["pf_residual"]["value"] > line["checks"]["pf_residual"]["limit"]


def _unchanged(core, env):
    from gym_anm_tpu_torch.core.env_core import StepOut

    def step(es, action, vars):
        zero = torch.zeros_like(es.state_vec[:, 0])
        return es, StepOut(obs=core.observation(es), reward=zero, terminated=es.terminated,
                           state_vec=es.state_vec, e_loss=zero, penalty=zero)

    core.step = step


def _half_batch(core, env):
    from gym_anm_tpu_torch.core.env_core import select_env

    real = core.step

    def step(es, action, vars):
        es_new, out = real(es, action, vars)
        first = torch.arange(es.terminated.shape[0]) < es.terminated.shape[0] // 2
        keep = lambda a, b: torch.where(first.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        return select_env(first, es_new, es), out._replace(
            obs=keep(out.obs, core.observation(es)), state_vec=keep(out.state_vec, es.state_vec),
            terminated=keep(out.terminated, es.terminated))

    core.step = step


def _altered(core, env):
    real = core.step

    def step(es, action, vars):
        es_new, out = real(es, action, vars)
        reward = out.reward.clone()
        reward[0] += 1.0
        return es_new, out._replace(reward=reward)

    core.step = step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered], ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(cell, fault):
    assert not _run(cell, patch=fault)["correct"]


# ``harness.main`` as a measured run calls it, with the card's presence faked
# and the run itself kept on the CPU at the small size; argv[1] is the root.
MAIN = (
    "import sys; from pathlib import Path; sys.path.insert(0, %r)\n"
    "from gridbench import harness\n"
    "harness.cards = lambda torch: 1\n"
    "real = harness.run_cell\n"
    "harness.run_cell = lambda *a, **k: real(*a, **dict(k, root=Path(sys.argv[1]), device='cpu', overrides=%r))\n"
    "sys.exit(harness.main(['--workload', %r, '--seed', '5', '--seconds', '0.2', '--trace', '1'], 0.0))\n"
    % (str(ROOT), SMALL, CELLS[0])
)


def test_harness_loads_no_jax(tmp_path):
    """A whole traced run, the check and every reader included, leaves no
    module of JAX or the JAX package loaded; and where a reader loads one,
    the run prints no result and names it."""
    res = subprocess.run([sys.executable, "-c", MAIN, str(ROOT)], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "gym_anm_tpu")
    # Names are compared whole: the port's own name begins with the JAX package's.
    assert "gym_anm_tpu_torch".split(".")[0] not in harness.FORBIDDEN

    shutil.copytree(ROOT / "gridbench", tmp_path / "gridbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    reader = tmp_path / "gridbench" / "metrics" / "device_ops_per_step.py"
    reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    res = subprocess.run([sys.executable, "-c", MAIN, str(tmp_path)], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "jax" in res.stderr.splitlines()[-1]


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_sound_and_control(card, cell):
    """At the cell's own size: a short run is correct; the control, judged
    from the same run's records, is not."""
    from gridbench import judge

    _, c, out, _ = harness.execute(cell, 3_300_000_001, 3.0, False)
    n = len(out.records)
    ok, _ = judge.decide(judge.judge_records(c.config, c.traffic, out.records, "cuda").numbers(), c.limits, n)
    bad, _ = judge.decide(judge.judge_records(c.config, c.traffic, out.records, "cuda", control=True).numbers(),
                          c.limits, n)
    assert ok and not bad
