"""The benchmark's files: every cell, configuration and metric found by
name, a new cell and metric added as files, the contract's shapes, the
imports, and the Viterbi bound."""

import ast
import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import roofline, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return spec.benchmark(ROOT)


def test_every_cell_config_and_metric_loads_from_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell["name"], cell["config"], cell["traffic_name"],
                cell["chips"], cell["why"]) == (
            w["name"], w["config"], w["traffic"], w["chips"], w["why"])
        cfg = spec.config(w["config"])
        assert hasattr(spec.driver(cfg["driver"]), "Driver")
        assert set(cell["check"]["limits"]) >= {"au_errors", "db_errors",
                                                "lost_sync"}
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for m in b["per_layer"]:
        assert callable(spec.metric(m["name"]).probe)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A later change adds a cell and a per-layer metric as new files and
    entries; no file of the harness changes."""
    root = str(tmp_path)
    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(os.path.join(bench, p), "rb").read()
              for p in _files(bench)}
    new = "dabplus18-fleet16.new_mix"
    cell = spec.cell("dabplus18-fleet16.clean15db")
    cell.update(name=new, traffic_name="new_mix")
    cell["traffic"]["snr_db"] = 12.0
    json.dump(cell, open(os.path.join(bench, "workloads", new + ".json"), "w"))
    with open(os.path.join(bench, "metrics", "rounds.count.py"), "w") as f:
        f.write("from harness.probes import Probe\n\n\n"
                "class _Count(Probe):\n"
                "    def value(self, run):\n"
                "        return float(run.units)\n\n\n"
                "def probe(run):\n    return _Count()\n")
    b = _bench()
    b["workloads"].append({"name": new, "config": "dabplus18-fleet16",
                           "traffic": "new_mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "rounds.count", "unit": "rounds",
                           "better": "higher", "source": "host_clock",
                           "layer": "fleet byte layer", "moves": "air_rate",
                           "workloads": [new]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    assert spec.cell(new, bench)["traffic"]["snr_db"] == 12.0
    names = [m["name"] for m in spec.metrics_of(spec.benchmark(root), new,
                                                "per_layer")]
    assert names == ["rounds.count"]

    class FakeRun:
        units = 7
    assert spec.metric("rounds.count", bench).probe(FakeRun()).value(
        FakeRun()) == 7.0
    for p, data in before.items():
        assert open(os.path.join(bench, p), "rb").read() == data, p


def _files(bench):
    out = []
    for d, _, files in os.walk(bench):
        if "__pycache__" in d:
            continue
        out += [os.path.relpath(os.path.join(d, f), bench) for f in files]
    return out


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: dab_radio_tpu_torch is allowed."""
    for rel in _files(BENCH):
        if not rel.endswith(".py"):
            continue
        tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, rel))}
        assert not tops & {"jax", "jaxlib", "flax", "dab_radio_tpu"}, rel
        if rel.startswith("reference") or rel.startswith("traffic"):
            assert "dab_radio_tpu_torch" not in tops, rel


def test_viterbi_bound_equals_chip_smoke():
    import importlib.util
    s = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(s)
    s.loader.exec_module(smoke)
    want_ms, _ = smoke.bound("viterbi_decode_fused", 9728, 1542)
    got_ms = roofline.viterbi_bound_s([(9728, 1542)]) * 1e3
    assert got_ms == pytest.approx(want_ms, rel=1e-12)
    assert round(got_ms, 4) == 0.2556


def test_viterbi_roofline_counts_each_trellis_at_its_own_length():
    from traffic import transmit
    roof = spec.metric("viterbi_roofline")
    ens = transmit.ensemble_of(spec.config("dabplus18-fleet16")["multiplex"])
    work = roof.frame_work(ens)
    # a round of 16 streams x 8 frames: 9,216 MSC and 512 FIC messages
    assert sum(b for b, t in work[1:]) * 128 == 9216
    assert work[0][0] * 128 == 512 and work[0][1] == 774
    assert {t for _, t in work[1:]} == {1542}


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert len(json.dumps(b)) < 64 * 1024
