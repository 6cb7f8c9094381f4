"""Serving soak: run the fused fleet over a looped capture for N seconds and
verify the long-running contract (models/fused_fleet.py): constant memory,
constant decode rate, no state drift. Port of ``tools/soak.py``, same flags,
gates and JSON keys.

Samples every --sample-s seconds: rounds, access units, RSS (VmRSS) and, on
a CUDA device, the caching allocator's allocated and reserved bytes. Exit 0
requires (a) AUs still arriving in the final sample window, (b) RSS growth
after the warm-up sample at most --max-rss-growth (fraction) and, on a CUDA
device, (c) the same bound on the growth of reserved device memory, where a
pinned-buffer or event leak of the double-buffered fetch would show. Prints
one JSON line with the samples.

Usage:
  python -m dab_radio_tpu_torch.tools.soak --seconds 120 [--streams 4] \\
      [--services 2] [--frames-per-step 8] [--backend cuda|cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ..utils.backend import add_backend_flag, apply_backend

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _growth(samples, key):
    """Growth of samples[key] from the first sample to the last, as a
    fraction of the first (at least 1 MB)."""
    base = samples[0][key]
    return (samples[-1][key] - base) / max(base, 1.0)


def _capture(services: int, frames: int, backend: str) -> str:
    """Path of a u8 ensemble capture from the port's simulate_transmitter,
    made once and kept in the temp directory (its own name: the port's
    transmitter is not byte-identical to the JAX package's)."""
    path = os.path.join(tempfile.gettempdir(),
                        f"torch_soak_iq_s{services}_f{frames}.u8")
    if not os.path.exists(path):
        r = subprocess.run(
            [sys.executable, "-m",
             "dab_radio_tpu_torch.apps.simulate_transmitter",
             "--backend", backend, "--payload", "ensemble",
             "--services", str(services), "-n", str(frames), "-F", "u8"],
            capture_output=True, cwd=ROOT)
        assert r.returncode == 0, r.stderr.decode()[-400:]
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(r.stdout)
        os.replace(tmp, path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=int, default=120)
    ap.add_argument("--sample-s", type=int, default=15)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--frames-per-step", type=int, default=8)
    ap.add_argument("--capture-frames", type=int, default=40)
    ap.add_argument("--max-rss-growth", type=float, default=0.15)
    ap.add_argument("--audio", action="store_true",
                    help="also decode subchannel 0 to PCM on every stream")
    ap.add_argument("--viterbi", default="exact",
                    choices=["exact", "tiled"])
    ap.add_argument("--chainback", default="sequential",
                    choices=["sequential", "parallel"])
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    import numpy as np
    import torch
    from ..models.fused_fleet import FusedFleet
    from ..params import SubchannelConfig, get_ofdm_params

    iq = np.fromfile(_capture(args.services, args.capture_frames,
                             args.backend), dtype=np.uint8)
    on_card = device.type == "cuda"

    N, K = args.streams, args.frames_per_step
    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(args.services)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K,
                       device=device, viterbi=args.viterbi,
                       chainback=args.chainback)
    if args.audio:
        for k in range(N):
            fleet.enable_audio(k, 0)
    fs = get_ofdm_params(1).nb_frame_samples
    chunk = 2 * K * fs
    tb = fleet.tail_bytes
    # whole-frame loop point keeps the stream frame-aligned across wraps
    usable = (iq.shape[0] // chunk) * chunk
    pos = 0

    def next_block():
        nonlocal pos
        if pos + chunk + tb > usable:
            pos = 0
        blk = np.broadcast_to(iq[pos:pos + chunk], (N, chunk))
        tail = np.broadcast_to(iq[pos + chunk:pos + chunk + tb], (N, tb))
        pos += chunk
        return blk, tail

    t_end = time.time() + args.seconds
    samples = []
    last = {"t": time.time(), "aus": 0, "rounds": 0}
    next_sample = time.time() + args.sample_s
    while time.time() < t_end:
        blk, tail = next_block()
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        if time.time() >= next_sample:
            now = time.time()
            aus, rounds = int(fleet.total_aus), int(fleet.total_rounds)
            samples.append({
                "t_s": round(now - (t_end - args.seconds), 1),
                "rounds": rounds, "aus": aus,
                "au_rate": round((aus - last["aus"]) / (now - last["t"]), 1),
                "rss_mb": round(_rss_mb(), 1)})
            if on_card:
                samples[-1].update(
                    cuda_allocated_mb=round(
                        torch.cuda.memory_allocated(device) / 2**20, 1),
                    cuda_reserved_mb=round(
                        torch.cuda.memory_reserved(device) / 2**20, 1))
            last = {"t": now, "aus": aus, "rounds": rounds}
            next_sample = now + args.sample_s
            print(f"# {samples[-1]}", file=sys.stderr, flush=True)
    fleet.flush()

    # baseline: the first sample taken AFTER decode actually started (the
    # kernel build and the first rounds can leave sample 0 before warm-up,
    # which would overstate growth); the same sample for device memory
    warm = [x for x in samples if x["rounds"] >= 2] or samples
    ok = len(samples) >= 2 and len(warm) >= 2
    growth = reserved = None
    if ok:
        ok &= samples[-1]["au_rate"] > 0
        growth = _growth(warm, "rss_mb")
        ok &= growth <= args.max_rss_growth
        if on_card:
            reserved = _growth(warm, "cuda_reserved_mb")
            ok &= reserved <= args.max_rss_growth
    result = {
        "metric": "serving_soak",
        "seconds": args.seconds, "streams": N, "frames_per_step": K,
        "viterbi": args.viterbi, "chainback": args.chainback,
        "total_rounds": int(fleet.total_rounds),
        "total_aus": int(fleet.total_aus),
        "rss_growth": round(growth, 4) if growth is not None else None,
        "samples": samples,
        "ok": bool(ok),
    }
    if on_card:
        result["cuda_reserved_growth"] = \
            round(reserved, 4) if reserved is not None else None
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
