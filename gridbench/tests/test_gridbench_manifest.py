"""The benchmark's manifest (``BENCHMARK.json``) against its contract, and the
harness's resolution of cells, configurations, traffic mixes, limits and
per-layer metrics by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from gridbench import harness, judge

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_sizes(manifest):
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) and not w.startswith("/") and ".." not in w for w in cmd)
    assert all((ROOT / p).is_dir() for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16 and 1 <= len(manifest["per_layer"]) <= 128


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in manifest["paths"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
    assert len({c["name"] for c in manifest["configs"]}) == len(manifest["configs"])
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_cells_report_what_the_contract_asks(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    assert {w["config"] for w in manifest["workloads"]} == configs  # every configuration is used
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(cells) // 4)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], w)
    for w in cells:
        reported = [m for m in manifest["end_to_end"] if harness.applies(m, w)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(harness.applies(m, w) for m in manifest["per_layer"])
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer


def test_every_cell_resolves_to_its_files(manifest):
    for w in manifest["workloads"]:
        entry, c, config, traffic, limits = harness.resolve(manifest, w["name"])
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert set(limits) == set(judge.NUMBERS)
        assert (ROOT / "gridbench" / "drivers" / ("%s.py" % traffic["driver"])).is_file()
        assert traffic["batch"] == 4096 and config["dtype"] == "float32"
    for m in manifest["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def test_config_files_hold_the_network_the_program_runs():
    import numpy as np

    from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series
    from gym_anm_tpu_torch.envs.anm6.network import network as anm6
    from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network

    for name, net in (("anm6easy", anm6), ("feeder33", make_feeder_network())):
        cfg = json.loads((ROOT / "gridbench" / "configs" / ("%s.json" % name)).read_text())
        for key in ("bus", "device", "branch"):
            a = np.asarray(net[key], dtype=object)
            b = np.asarray(cfg["network"][key], dtype=object)
            assert a.shape == b.shape
            assert all((x is None and y is None) or float(x) == float(y) for x, y in zip(a.ravel(), b.ravel()))
    cfg = json.loads((ROOT / "gridbench" / "configs" / "anm6easy.json").read_text())
    assert np.array_equal(np.asarray(cfg["next_vars"]["P_loads"]), _get_load_time_series())
    assert np.array_equal(np.asarray(cfg["next_vars"]["P_maxs"]), _get_gen_time_series())


NEW_DRIVER = '''"""A driver added as a file of its own."""
from gridbench.drivers.rollout import run  # noqa: F401
'''
NEW_READER = '''"""A per-layer metric added as a file of its own."""


def read(ctx):
    return float(ctx.counters["steps"])
'''


def test_a_cell_made_of_new_files_only_is_found(tmp_path, manifest):
    """A later change adds a configuration, a traffic mix with its driver,
    a cell's limits and a per-layer metric as new files and manifest entries,
    and edits no file that is there."""
    shutil.copytree(ROOT / "gridbench", tmp_path / "gridbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    g = tmp_path / "gridbench"
    cfg = json.loads((g / "configs" / "anm6easy.json").read_text())
    cfg["name"] = "anm6easy_copy"
    (g / "configs" / "anm6easy_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((g / "traffic" / "rollout.tree-pool.json").read_text())
    tr["driver"] = "rollout_added"
    (g / "traffic" / "rollout.tree-pool-added.json").write_text(json.dumps(tr))
    (g / "drivers" / "rollout_added.py").write_text(NEW_DRIVER)
    (g / "limits" / "anm6easy_copy.rollout.added.json").write_text(
        (g / "limits" / "anm6easy.rollout.tree-pool.json").read_text())
    (g / "metrics" / "steps_counted.rollout.py").write_text(NEW_READER)
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "anm6easy_copy", "source": "https://arxiv.org/abs/2103.07932",
                         "file": "gridbench/configs/anm6easy_copy.json", "reduced": [], "why": "a copy"})
    m["workloads"].append({"name": "anm6easy_copy.rollout.added", "config": "anm6easy_copy",
                           "traffic": "rollout.tree-pool-added", "chips": 1, "why": "a cell of new files"})
    for e in m["end_to_end"]:
        if e["name"] == "rollout_env_steps_per_s":
            e["workloads"].append("anm6easy_copy.rollout.added")
    m["per_layer"].append({"name": "steps_counted.rollout", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "Rollout loop and env core",
                           "moves": "rollout_env_steps_per_s", "workloads": ["anm6easy_copy.rollout.added"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    small = {"batch": 32, "segment_steps": 4, "judge_segments": 2, "trace_segments": 1}
    line = harness.run_cell("anm6easy_copy.rollout.added", 11, 0.2, True, root=tmp_path, device="cpu",
                            overrides=small)
    assert line["correct"] and line["metrics"]["steps_counted.rollout"]["value"] > 0
    assert harness.load_driver("rollout_added", tmp_path).run is not None
