#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, one run
of the cell (a short window at the cell's own load) with the program's
numbers (the lower readings), and the control's numbers (the upper ones):
the plain reference put in the program's place and computed with every
stored value in bfloat16, the precision below the program's float32,
against the same reference in float64, over the same frames that the run
compares; and the verdict of reference/check.py on the control's numbers,
which has to come out false.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--out control.jsonl]

One JSON line a seed. The benchmark's own runs do not run the control.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

from harness import env, spec  # noqa: E402

def control_numbers(traffic, out: dict, cell: dict, device,
                    program: dict) -> dict:
    """The numbers of the control put in the program's place, the same
    numbers that decide the program's `correct`: the carry and the sampled
    soft bits of the bfloat16 reference against the float64 one, on the
    tracks and sampled frames of the run; lost_sync adds the control's
    frames out of sync to the run's; the bytes' numbers are the run's own
    (the control stands in for the demodulation alone)."""
    import numpy as np
    from reference import check
    ref = check.reference_numbers(traffic, out, cell["check"], device, "f64")
    low = check.reference_numbers(traffic, out, cell["check"], device, "bf16")
    prog = {f: np.array([c[f] for c in low["carry"]])
            for f in ("freq_coarse", "freq_fine", "signal_l1_avg")}
    numbers = dict(program)
    numbers.update(check.carry_gaps(traffic, prog, ref["carry"]))
    if "softbit_gap" in program:
        numbers["softbit_gap"] = max(
            int(np.abs(low["bits"][k].astype(np.int32)
                       - ref["bits"][k].astype(np.int32)).max())
            for k in ref["bits"])
    numbers["lost_sync"] = program["lost_sync"] + sum(low["lost"])
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    env.pin_caches(spec.REPO_DIR)
    import time
    import run as bench_run
    from reference import check
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            keep = {}
            line = bench_run.run_cell(args.workload, seed, args.seconds, False,
                                      "cuda", t0=time.perf_counter(),
                                      keep=keep)
            t = time.perf_counter()
            program = keep["result"]["numbers"]
            control = control_numbers(keep["traffic"], keep["out"],
                                      keep["cell"], "cuda", program)
            limits = keep["cell"]["check"]["limits"]
            rec = {"workload": args.workload, "seed": seed,
                   "correct": line["correct"], "check_s": keep["check_s"],
                   "control_s": time.perf_counter() - t,
                   "setup_s": line["metrics"]["setup_s"]["value"],
                   "program": program, "control": control,
                   "control_correct": check.verdict(control, limits),
                   "align_gaps": keep["result"]["align_gaps"]}
            print(json.dumps(rec), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
