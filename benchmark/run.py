#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the GPUs of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell (workloads/<cell>.json) names its
configuration (configs/<config>.json), whose "driver" names the loop that
serves it (drivers/<driver>.py). Set-up makes the cell's traffic from the
seed, builds the program and warms every shape the traffic uses; then the
window runs the loop for --seconds, closed loop. After the window the
outputs are compared with what was sent and with the plain reference
(reference/), and the last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, whose readers are metrics/<metric>.py),
device, with --trace 1 a breakdown of the window's device timeline, and
last "checks": each number compared with its limit, which also end
standard error. Exits non-zero, printing no result, without enough CUDA
devices, and when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc, 10 ms ticks): the
    interpreter's own start-up, before T0, belongs to set-up too."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_AGE_AT_T0 = _process_age_s()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import env, spec  # noqa: E402

AIR_S_PER_FRAME = 0.096          # a mode-I transmission frame


class Run:
    """What the per-layer readers see of a run."""

    def __init__(self, cell, config, traffic, driver):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.driver = driver
        self.air_s = self.window_s = 0.0
        self.units = 0                 # rounds or frames in the window
        self.spans = None              # the program's span table
        self.trace = None              # harness.trace.DeviceTrace


def _percentile(samples, q):
    import numpy as np
    return float(np.percentile(np.asarray(samples, np.float64), q)) \
        if len(samples) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float = T0 - PROCESS_AGE_AT_T0,
             bench_dir: str = spec.BENCH_DIR,
             root: str = spec.REPO_DIR, keep: dict = None) -> dict:
    """One run of the cell; `keep`, when given, receives the traffic, the
    program's outputs and the window, for the control."""
    import numpy as np
    import torch
    from harness.trace import WINDOW_RANGE, DeviceTrace
    from reference import check
    from traffic import generate
    bench = spec.benchmark(root)
    cell = spec.cell(name, bench_dir)
    config = spec.config(cell["config"], bench_dir)
    cuda = torch.device(device).type == "cuda"
    dtrace = DeviceTrace() if trace and cuda else None
    if dtrace is not None:
        dtrace.start()                 # before any graph is captured

    serving = spec.driver(config["driver"], bench_dir)
    unread = set(cell["traffic"]) - generate.KEYS \
        - set(getattr(serving, "TRAFFIC_KEYS", ()))
    if unread:
        raise ValueError(f"{name}: traffic keys that nothing reads: "
                         f"{sorted(unread)}")
    traffic = generate.make(config["multiplex"], cell["traffic"], seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng([seed, 7])
    driver = serving.Driver(config, cell, traffic, device, rng)
    driver.warm_up(**cell["warmup"])
    run = Run(cell, config, traffic, driver)
    run.trace = dtrace
    probes = []
    if trace:
        for m in spec.metrics_of(bench, name, "per_layer"):
            probes.append((m, spec.metric(m["name"], bench_dir).probe(run)))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the window ----
    from dab_radio_tpu_torch.utils.profiler import get_profiler
    from harness.records import SpanTotals
    spans = get_profiler()
    totals = SpanTotals(spans) if trace else None
    if trace:
        driver.trace_on()
        for _, p in probes:
            p.start(run)
        spans.reset()
        spans.enabled = True
    ranged = torch.profiler.record_function(WINDOW_RANGE) if dtrace \
        else contextlib.nullcontext()
    air0, unit0 = driver.air_frames, driver.last_unit
    driver.in_window = True
    cpu0 = os.times()
    with ranged:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            driver.step()
            if totals is not None:
                totals.fold()
        end = time.perf_counter()
    cpu1 = os.times()
    driver.in_window = False
    window = (unit0 + 1, driver.last_unit)
    run.air_s = (driver.air_frames - air0) * AIR_S_PER_FRAME
    run.window_s = end - start
    run.units = window[1] - window[0] + 1
    if trace:
        spans.enabled = False
        run.spans = totals.rows
        for _, p in reversed(probes):
            p.stop(run)
        driver.trace_off()
        if dtrace is not None:
            dtrace.stop()

    # ---- after the window: late outputs, the peak, the program freed ----
    driver.finish()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    latency = [(t_cb - t_in) * 1e3 for t_cb, t_in, n in driver.latency
               if start <= t_cb <= end for _ in range(n)]
    per_layer = {}
    if dtrace is not None:
        dtrace.reduce()
    for m, p in probes:
        v = p.value(run)
        if v is not None:
            per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
    out = driver.outputs()
    driver.close()
    del driver, run.driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    result = check.compare(traffic, out, window, cell["check"], device)
    if keep is not None:
        keep.update(traffic=traffic, out=out, window=window, cell=cell,
                    check_s=time.perf_counter() - t_check, result=result)
    limits = cell["check"]["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in result["numbers"].items()}
    correct = check.verdict(result["numbers"], limits)

    cpu_s = sum(cpu1[:2]) - sum(cpu0[:2])
    e2e = {"air_rate": run.air_s / run.window_s,
           "latency_p90_ms": _percentile(latency, 90),
           "host_cpu_ms_per_air_s": cpu_s * 1e3 / run.air_s
           if run.air_s else None,
           "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if trace:
        metrics = per_layer
    else:
        metrics = {}
        for m in spec.metrics_of(bench, name, "end_to_end"):
            if m["name"] not in e2e:
                raise KeyError(f"no reading for end-to-end metric {m['name']}")
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.summary["busy_s"]
        dev["window_s"] = dtrace.summary["window_s"]
        line["breakdown"] = dtrace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.pin_caches(spec.REPO_DIR)
    import torch
    chips = next(w["chips"] for w in spec.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    keep = {}
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    "cuda", keep=keep)
    print(f"run.py: the check took {keep['check_s']:.2f} s", file=sys.stderr)
    bad = env.forbidden_modules(sys.modules)
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
