#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX.
It exits non-zero, printing no result, when there is no card. Phases:

1. the card's name and power limit;
2. build every kernel from dab_radio_tpu_torch/csrc (one nvcc per source);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the receive chain gives it, with CUDA-event times of both;
4. the main path: an 18-service, 864-CU mode-I ensemble from the port's
   transmitter, with a carrier offset and AWGN, quantised to u8, decoded by
   the port's radio_cli on the card; every access unit must come back
   byte-exact with desync=0, no RS or AU-CRC error and no firecode error
   past superframe sync, and the Viterbi kernels must have run for both
   the FIC and the MSC;
5. a JSON line of the kernels, then the last line
   {"ok": true, "device": {...}}.

Scratch files go to build/chip_smoke/ in the checkout.
"""

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# ensemble of the main path: apps/simulate_transmitter.py --services 18
NB_SERVICES = 18
NB_FRAMES = 25
CFO_BINS = 3.37          # carrier offset, in carrier spacings (1 kHz each)
SNR_DB = 15.0            # AWGN against the signal power
SEED = 2024

# K1 shapes (B messages, T trellis steps): the FIC decode of a frame, the
# 18-subchannel MSC group, a batch past the Pallas kernel's 128-lane cap,
# and the trellis of a 384 kbit/s subchannel
K1_SHAPES = [("fic", 4, 774), ("msc_group", 72, 1542), ("wide", 1024, 1542),
             ("long", 8, 9222)]
# the Pallas kernel body, and the lax.scan chainback of viterbi_decode_pallas
REPLACES = {"viterbi_acs": "dab_radio_tpu/ops/viterbi_pallas.py:46",
            "viterbi_chainback": "dab_radio_tpu/ops/viterbi_pallas.py:151"}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"card: {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {smi}")


def build_kernels():
    from dab_radio_tpu_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rec in logs.items():
        log(f"  {name}: nvcc done after {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def _encoded_soft(rng, B, T):
    """(B, T, 4) int8: random messages closed by the 6-bit tail, encoded
    with the mother code, plus noise, with a third of the last two code
    bits of each step punctured to 0."""
    from dab_radio_tpu_torch.ops.viterbi import _expected_outputs
    exp = _expected_outputs()                      # (64, 2, 4) +/-1
    bits = rng.integers(0, 2, (B, T)).astype(np.int64)
    bits[:, T - 6:] = 0
    state = np.zeros(B, np.int64)
    sym = np.empty((B, T, 4), np.float64)
    for t in range(T):
        sym[:, t] = 127.0 * exp[state, bits[:, t]]
        state = (bits[:, t] << 5) | (state >> 1)
    sym += rng.normal(0.0, 80.0, sym.shape)
    sym[:, :, 2:][rng.random((B, T, 2)) < 0.33] = 0.0
    return np.clip(np.round(sym), -127, 127).astype(np.int8)


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(dev):
    """K1 (forward ACS + chainback) against the plain versions; returns
    per-kernel {ms, plain_ms, max_abs_err} at the MSC group shape."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    rng = np.random.default_rng(SEED)
    cases = [(name, _encoded_soft(rng, B, T)) for name, B, T in K1_SHAPES]
    cases.append(("all_zero_ties", np.zeros((4, 774, 4), np.int8)))
    out = {}
    for name, d_np in cases:
        d = torch.as_tensor(d_np, device=dev)
        B, T = d_np.shape[:2]
        dec, err = K.viterbi_acs(d)
        bits = K.chainback(dec)
        torch.cuda.synchronize()
        pdec, perr = K.viterbi_acs_plain(d)
        pbits = K.chainback_plain(pdec)
        torch.cuda.synchronize()
        same = (torch.equal(dec, pdec) and torch.equal(err, perr)
                and torch.equal(bits, pbits))
        err_acs = int((err.long() - perr.long()).abs().max())
        err_cb = int((bits.long() - pbits.long()).abs().max())
        reps = 20 if T * B < 2_000_000 else 5
        ms_acs = _cuda_ms(lambda: K.viterbi_acs(d), reps)
        ms_cb = _cuda_ms(lambda: K.chainback(dec), reps)
        pms_acs = _cuda_ms(lambda: K.viterbi_acs_plain(d), 1)
        pms_cb = _cuda_ms(lambda: K.chainback_plain(dec), 1)
        log(f"K1 {name:14s} B={B:5d} T={T:5d} bit-identical={same} "
            f"acs {ms_acs:.4f} ms (plain {pms_acs:.1f} ms) "
            f"chainback {ms_cb:.4f} ms (plain {pms_cb:.1f} ms) "
            f"Mbit/s {B * T / (ms_acs + ms_cb) / 1e3:.2f}")
        if not same:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{name} (B={B}, T={T})")
        if name == "msc_group":
            out["viterbi_acs"] = {"ms": ms_acs, "plain_ms": pms_acs,
                                  "max_abs_err": err_acs}
            out["viterbi_chainback"] = {"ms": ms_cb, "plain_ms": pms_cb,
                                        "max_abs_err": err_cb}
    return out


class _AUSource:
    """Seeded random access units that remember what was sent."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.sent = []

    def __call__(self, cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        aus = [self.rng.integers(0, 256, n).astype(np.uint8).tobytes()
               for n in sizes]
        self.sent.extend(aus)
        return aus


def make_capture(dev, path):
    """The 18-service ensemble through the port's transmitter, with CFO and
    AWGN, written as u8 IQ. Returns {service_id: sent AU list}."""
    from dab_radio_tpu_torch.models.transmitter import (
        EnsembleTransmitter, ServiceSpec, SubchannelConfig)
    services = [ServiceSpec(0xF123 + i, 3 + i, f"Radio TPU {i + 1}",
                            SubchannelConfig(48 * i, 48, False, eep_type="A",
                                             eep_prot_level=2))
                for i in range(NB_SERVICES)]
    tx = EnsembleTransmitter(1, services=services, device=dev)
    sources = {}
    for i, s in enumerate(services):
        sources[s.service_id] = _AUSource(SEED + i)
        tx.set_au_source(s.subchannel_id, sources[s.service_id])
    t0 = time.perf_counter()
    iq = tx.generate(NB_FRAMES)
    t_tx = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    lead = np.zeros(20000, np.complex64)
    iq = np.concatenate([lead, iq, lead])
    n = np.arange(iq.shape[0])
    iq = iq * np.exp(2j * np.pi * CFO_BINS / 2048 * n)
    p_sig = float(np.mean(np.abs(iq[lead.shape[0]:-lead.shape[0]]) ** 2))
    std = np.sqrt(p_sig / 10 ** (SNR_DB / 10) / 2)
    iq = iq + std * (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape))
    iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
    # u8 IQ as rtl_sdr writes it: 127.5 + 127.5 x, interleaved I/Q
    u8 = np.clip(iq.view(np.float32) * 127.5 + 127.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(u8.tobytes())
    log(f"capture: {NB_FRAMES} frames, {NB_SERVICES} services x 48 CU "
        f"EEP-3A, CFO {CFO_BINS} carriers, SNR {SNR_DB} dB, "
        f"{os.path.getsize(path)} bytes u8 (transmitter {t_tx:.2f} s)")
    return {sid: src.sent for sid, src in sources.items()}


def _read_adts(path):
    data = open(path, "rb").read()
    aus, i = [], 0
    while i + 7 <= len(data):
        h = data[i:i + 7]
        n = ((h[3] & 3) << 11) | (h[4] << 3) | (h[5] >> 5)
        aus.append(data[i + 7:i + n])
        i += n
    return aus


def _run_capturing_stderr(fn):
    """Run fn() with file descriptor 2 sent to a file; echo and return it."""
    path = os.path.join(WORK, "stderr.txt")
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w+b") as f:
        os.dup2(f.fileno(), 2)
        try:
            rc = fn()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        text = f.read().decode(errors="replace")
    sys.stderr.write(text)
    return rc, text


def main_path(dev, sent):
    """radio_cli on the capture; checks the decode and the kernel counts."""
    import torch
    from dab_radio_tpu_torch.apps import radio_cli
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    scrape = os.path.join(WORK, "scrape")
    shutil.rmtree(scrape, ignore_errors=True)
    argv = ["-i", os.path.join(WORK, "capture.u8"), "-F", "u8", "--benchmark",
            "--backend", "cuda", "--scraper-enable", "--scraper-output",
            scrape]
    K.reset_launches()
    t0 = time.perf_counter()
    rc, err_text = _run_capturing_stderr(lambda: radio_cli.main(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    by_t = dict(K.ACS_LAUNCHES_BY_T)
    check(rc == 0, f"radio_cli returned {rc}")

    # the last summary block is the final one
    final = err_text[err_text.rindex("ensemble: id="):]
    m = re.search(r"ensemble: id=(\w+) .* services=(\d+) subchannels=(\d+)",
                  final)
    check(m and m.group(1) == "C0FE" and int(m.group(2)) == NB_SERVICES,
          f"ensemble not decoded: {final[:200]!r}")
    m = re.search(r"demod: frames_read=(\d+) desync=(\d+)", final)
    check(m and int(m.group(2)) == 0, "demodulator lost sync")
    frames = int(m.group(1))
    subs = re.findall(r"subchannel \d+: .* sf=(\d+) fc_err=(\d+) "
                      r"rs_err=(\d+) au_err=(\d+)", final)
    check(len(subs) == NB_SERVICES, f"{len(subs)} DAB+ channels decoded")
    # a channel is created when the FIC carousel has carried its entries,
    # in the first or second frame; its deinterleaver then fills for 15
    # CIFs and it searches for superframe sync. fc_err counts only that
    # search (the frames before sync whose firecode fails), so it is < 5;
    # after sync no superframe may be lost or fail RS or AU CRC.
    min_sf = (4 * (frames - 1) - 15 - 4) // 5
    for sf, fc, rs, au in subs:
        check(int(sf) >= min_sf and int(fc) < 5 and (rs, au) == ("0", "0"),
              f"decode errors: sf={sf} fc_err={fc} rs_err={rs} au_err={au}")

    nb_aus = 0
    for sid, aus_sent in sent.items():
        dirs = glob.glob(os.path.join(scrape, f"service_{sid:X}_*"))
        check(len(dirs) == 1, f"no scraper output for service {sid:X}")
        got = _read_adts(os.path.join(dirs[0], "stream.aac"))
        check(got, f"service {sid:X}: no access units")
        check(got[0] in aus_sent, f"service {sid:X}: unknown access unit")
        k = aus_sent.index(got[0])
        check(got == aus_sent[k:k + len(got)],
              f"service {sid:X}: access units differ from those sent")
        nb_aus += len(got)

    check(by_t.get(774, 0) > 0, "the FIC decode did not run the ACS kernel")
    check(by_t.get(1542, 0) > 0, "the MSC decode did not run the ACS kernel")
    check(launches["viterbi_chainback"] > 0, "the chainback kernel never ran")
    air = frames * 0.096
    log(f"main path: frames={frames} wall={wall:.3f} s air={air:.3f} s "
        f"real-time factor={air / wall:.3f} access_units={nb_aus} "
        f"(all byte-exact) acs launches by T={by_t} "
        f"chainback launches={launches['viterbi_chainback']}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    card_line()
    build_kernels()
    timings = check_kernels(dev)
    sent = make_capture(dev, os.path.join(WORK, "capture.u8"))
    launches = main_path(dev, sent)
    check("jax" not in sys.modules, "the port loaded jax")
    kernels = []
    for name in ("viterbi_acs", "viterbi_chainback"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dab_radio_tpu_torch/csrc/viterbi_acs.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "matches_plain": True,
            "ms": t["ms"], "plain_ms": t["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
