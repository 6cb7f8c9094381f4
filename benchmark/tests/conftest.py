"""The benchmark's own tests (not tier-1): run from the root of the
checkout with `python -m pytest benchmark/tests`. Tests that need a CUDA
card carry the repository's `cuda` marker and skip without one; whether a
card is there is decided inside a fixture."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

FLEET = "dabplus18-fleet16.clean15db"
TUNER = "dabplus18-tuner1.clean15db"
# a cell that only the tests add: one DAB+ service (48 CU, EEP 3-A) and one
# classic DAB service (MP2, 96 CU at UEP level 3: UEP_ROWS[35]) through
# the fleet driver
MIXED = "mixed2-fleet2.clean15db"
MIXED_SERVICES = [
    {"count": 1, "kind": "dab+", "size_cu": 48, "eep": "3-A",
     "first_service_id": "F123", "first_subchannel_id": 3,
     "label": "Radio TPU {n}",
     "superframe": {"sampling_rate": 48000, "stereo": True, "sbr": True,
                    "ps": False}},
    {"count": 1, "kind": "dab", "size_cu": 96, "uep_level": 3,
     "first_service_id": "F200", "first_subchannel_id": 10,
     "label": "Classic {n}"}]


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark's cells run on one)")
    return torch.device("cuda")


def tiny_copy(dst: str, services: int = 2, streams: int = 2,
              period: int = 10, reference_frames: int = 40) -> str:
    """A copy of BENCHMARK.json and benchmark/ under dst whose cells serve
    a small multiplex (a CPU run takes seconds); returns dst/benchmark."""
    bench = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for name in os.listdir(os.path.join(bench, "configs")):
        p = os.path.join(bench, "configs", name)
        c = json.load(open(p))
        c["multiplex"]["services"][0]["count"] = services
        if "streams" in c["serving"]:
            c["serving"]["streams"] = streams
            c["serving"]["frames_per_round"] = 2
        json.dump(c, open(p, "w"))
    for name in os.listdir(os.path.join(bench, "workloads")):
        p = os.path.join(bench, "workloads", name)
        c = json.load(open(p))
        c["traffic"]["period_frames"] = period
        c["traffic"]["captures"] = c["traffic"]["captures"][:streams]
        c["check"]["reference_frames"] = reference_frames
        c["warmup"] = {"rounds": 6} if "rounds" in c["warmup"] \
            else {"frames": 12}
        json.dump(c, open(p, "w"))
    return bench


def add_mixed(dst: str, bench: str):
    """Add MIXED to a tiny copy: its configuration (the tiny fleet's, with
    MIXED_SERVICES as its multiplex), its cell (the tiny fleet cell's
    traffic, warm-up and check) and their entries in BENCHMARK.json."""
    fleet = json.load(open(os.path.join(bench, "workloads", FLEET + ".json")))
    config = json.load(open(os.path.join(bench, "configs",
                                         fleet["config"] + ".json")))
    name = MIXED.split(".")[0]
    config.update(name=name, reduced=[])
    config["multiplex"]["services"] = MIXED_SERVICES
    json.dump(config, open(os.path.join(bench, "configs", name + ".json"),
                           "w"))
    fleet.update(name=MIXED, config=name)
    json.dump(fleet, open(os.path.join(bench, "workloads", MIXED + ".json"),
                          "w"))
    p = os.path.join(dst, "BENCHMARK.json")
    b = json.load(open(p))
    b["configs"].append({"name": name, "source": config["source"],
                         "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "tests"})
    b["workloads"].append({"name": MIXED, "config": name,
                           "traffic": fleet["traffic_name"], "chips": 1,
                           "why": "tests"})
    json.dump(b, open(p, "w"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("tiny"))
    bench = tiny_copy(dst)
    add_mixed(dst, bench)
    return dst, bench


def run_tiny(tiny, cell, seconds=2.0, seed=123456789012, trace=False,
             keep=None):
    import run as bench_run
    root, bench = tiny
    return bench_run.run_cell(cell, seed, seconds, trace, "cpu",
                              bench_dir=bench, root=root, keep=keep)
