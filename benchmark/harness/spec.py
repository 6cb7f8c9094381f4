"""Where the benchmark finds what it runs, by name: BENCHMARK.json at the
root of the checkout, a cell in workloads/<cell>.json, its configuration
in configs/<config>.json, the loop that drives the configuration's serving
path in drivers/<driver>.py, and each per-layer metric's reader in
metrics/<metric>.py. Nothing here names a cell, a configuration or a
metric: a later change adds one as files and entries."""

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = REPO_DIR) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "workloads", f"{name}.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs", f"{name}.json"))


def load_module(path: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "drivers", f"{name}.py"))


def metric(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"))


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` ("end_to_end" or
    "per_layer") that the cell reports: an end-to-end metric unless it
    lists other cells, a per-layer metric where it lists the cell (every
    per-layer entry lists its cells)."""
    if kind == "end_to_end":
        return [m for m in bench[kind]
                if cell_name in m.get("workloads", [cell_name])]
    return [m for m in bench[kind] if cell_name in m["workloads"]]
