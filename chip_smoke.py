#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX.
It exits non-zero, printing no result, when there is no card. Phases:

1. the card's name and power limit;
2. build every kernel from dab_radio_tpu_torch/csrc (one nvcc per source);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the receive chain gives it, with CUDA-event times of both and the
   roofline bound of the work; K1's windowed mode at the window shapes of
   the tiled decode (28, 936, 1,300 and 126,464 windows of 320 steps), with
   the time of the whole tiled decode, window gather included; K1's decode
   between start and end states other than 0, through the fused kernel and
   through the kernel pair;
4. the main path: an 18-service, 864-CU mode-I ensemble from the port's
   transmitter, with a carrier offset and AWGN, quantised to u8, decoded by
   the port's radio_cli on the card; every access unit must come back
   byte-exact with desync=0, no RS or AU-CRC error and no firecode error
   past superframe sync, and the fused Viterbi kernel must have run for
   both the FIC and the MSC, once per decode, and the kernel pair not at
   all;
5. the long-trellis path: one 864-CU EEP 4-A subchannel (1728 kbit/s, a
   trellis of 41,478 steps) from the port's MSCEncoder, with noise, through
   the port's MSCDecoder on the card; every payload byte-exact, decoded by
   the forward and chainback kernel pair; then the same subchannel after
   set_decode_mode("tiled"): byte-exact again, one windowed launch a decode
   and the pair not at all, and the time of both decodes;
6. the fleet path, at full width: 16 streams of that ensemble (4 distinct
   captures, each with its own access units, carrier offset and noise)
   served by the port's fleet_serve on the card, 8 frames a round; 16
   stream lines with ensemble C0FE and 18 services, every stream's every
   subchannel's access units byte-exact, valid FIBs on every stream, and
   exactly one fused Viterbi launch a round, of 9,728 messages of 1,542
   steps; the time of each round, the device time of the round's step, the
   host's byte-layer time and the real-time ensembles they amount to;
7. the fleet path tiled, at full width: the same 16 streams through
   fleet_serve --viterbi tiled: every access unit byte-exact, exactly one
   windowed launch a round, of 126,464 windows, with the round's times
   beside the exact round's;
8. a discovery run: 2 distinct captures through fleet_serve --discover, 4
   frames a round (per-stream layouts from the dynamic receiver);
9. the exact decode variants on the card, at a smaller depth (2 streams, 4
   frames a round): receiver_step with chainback="parallel",
   chainback="fused", viterbi_branch="lut" and viterbi="radix8" on the
   input of the default step: every output equal, each step's time;
10. the older batched path: 4 distinct captures through
   MultiStreamDemodulator (u8 ingest, 4 frames a step, soft bits kept on the
   card) into ReceiverFleet (pipeline depth 2): every access unit
   byte-exact, no desync, and a round one fused launch for the stacked FIC
   and one for each protection shape of the MSC;
11. the multi-GPU receiver on the one card: multichip_receiver_step over a
   process group of one rank (NCCL) on the 16 streams of the fleet path,
   every output and the state equal to receiver_step's, one fused launch a
   round, and FusedFleet on that mesh with every access unit byte-exact;
   then 4 rank processes on a (1, 2, 2) mesh over gloo, all on the card
   (this script with --mesh-rank): the dry run of parallel/dryrun.py,
   bit-exact against the one-device decoders with two fused launches a rank
   (FIC and MSC), then FusedFleet on that mesh over the 16 streams of the
   fleet path, every rank fed the whole round: every access unit
   byte-exact, one fused launch a round on every rank, every rank's health
   signals equal; the step's time between CUDA events, the round walls, the
   collectives' wall time and host copies;
12. which host native libraries run as shared libraries, a JSON line of the
   kernels, then the last line {"ok": true, "device": {...}}.

Scratch files go to build/chip_smoke/ in the checkout.

    python3 chip_smoke.py --measure [--frames 50]

measures instead: it builds the kernels, makes the same ensemble over more
frames and decodes it with radio_cli on the card once cold and five times
warm (wall time and real-time factor), once with the stage spans on, and
once under torch.profiler (device busy share, device time by kernel). Then
the fleet path: 16 streams through FusedFleet, 5 warm rounds under
torch.profiler (round wall, device busy share, device time by kernel), and
the round's stop_after ladder in ms a round. The numbers are printed and
written to build/chip_smoke/measure.json.

    python3 chip_smoke.py --mesh-only --mesh-backend nccl

runs the captures and the 4 rank processes of phase 11 alone, over NCCL
with a card a rank (4 cards).
"""

import argparse
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
NB_FRAMES = 26
CFO_BINS = 3.37          # carrier offset, in carrier spacings (1 kHz each)
SNR_DB = 15.0            # AWGN against the signal power
SEED = 2024

# the fleet path: 16 streams (FLEET_DISTINCT distinct captures, repeated),
# 8 frames a round, 26 frames each: 3 rounds and the tail
FLEET_STREAMS = 16
FLEET_DISTINCT = 4
FLEET_K = 8
# its one decode a round: 16 x (18 subchannels x 32 CIFs + 8 frames x 4 FIC
# groups) messages
FLEET_LANES = FLEET_STREAMS * (NB_SERVICES * 4 * FLEET_K + 4 * FLEET_K)
DISCOVER_STREAMS = 2
DISCOVER_K = 4

# K1 shapes (B messages, T trellis steps): the FIC decode of a frame, the
# 18-subchannel MSC group, a batch past the Pallas kernel's 128-lane cap,
# 16 streams of one frame each, the trellis of a 384 kbit/s subchannel, and
# the fleet path's round of 16 streams x 8 frames
K1_SHAPES = [("fic", 4, 774), ("msc_group", 72, 1542), ("wide", 1024, 1542),
             ("round16", 1152, 1542), ("long", 8, 9222),
             ("round16x8", FLEET_LANES, 1542)]
# the windows of the tiled decode of four of those (and of the long path's
# 4 x 41478): ceil(T / 128) windows of 128 + 2 * 96 steps a message
WINDOWS_OF = {"fic": "fic_tiled", "msc_group": "msc_group_tiled",
              "eep4a_864cu": "long_tiled", "round16x8": "round16x8_tiled"}
WINDOW_L = 320
# the plain windowed version holds (B, 320, 128) branch metrics in float32
# and in int32: it is run on this many windows at a time (an eighth of the
# fleet round's 126,464)
WINDOW_PLAIN_CHUNK = 15808
VARIANT_STREAMS = 2
VARIANT_K = 4
BATCHED_STREAMS = 4
BATCHED_K = 4
# the mesh dry run: 4 rank processes on the one card, one stream in 2 time
# blocks of 10 frames, 2 subchannels on 2 sub ranks; each may take this long
MESH_RANKS = 4
MESH_AXES = (1, 2, 2)
MESH_TIMEOUT_S = 300
PLAIN_TIMED = ("fic", "msc_group")      # the plain loops take 0.1 to 0.9 s
# the plain forward pass holds (B, T, 128) branch metrics in float32 and in
# int32 and a (T, B, 64) int64 product: it is run on this many messages at
# a time (messages are independent)
PLAIN_CHUNK = 1216
# the long-trellis path: 864 CU at EEP 4-A, 4 CIFs a frame
LONG_CU = 864
LONG_T = 41478
LONG_FRAMES = 5                          # 20 CIFs: 16 fill the deinterleaver
LONG_NOISE_STD = 30.0
# the Pallas kernel body, and the lax.scan chainback of viterbi_decode_pallas
REPLACES = {"viterbi_decode_fused": "dab_radio_tpu/ops/viterbi_pallas.py:46",
            "viterbi_acs": "dab_radio_tpu/ops/viterbi_pallas.py:46",
            "viterbi_chainback": "dab_radio_tpu/ops/viterbi_pallas.py:151",
            "viterbi_decode_windows": "dab_radio_tpu/ops/viterbi_pallas.py:46"}
# the shape each kernel's entry in the JSON line is taken at: the one its
# path gives it most of the work at
REPORT_SHAPE = {"viterbi_decode_fused": "round16x8",
                "viterbi_acs": "eep4a_864cu",
                "viterbi_chainback": "eep4a_864cu",
                "viterbi_decode_windows": "round16x8_tiled"}
# the path of this script that launches each kernel: the other launches it
# no time, which that path checks
KERNEL_PATH = {"viterbi_decode_fused": "fleet", "viterbi_acs": "long",
               "viterbi_chainback": "long",
               "viterbi_decode_windows": "fleet_tiled"}

# Roofline of one H100 SXM. Device memory: 3.35 TB/s. int32 outside the
# tensor cores: 64 lanes on each of 132 SMs at 1.98 GHz, one operation a
# lane and cycle (a quarter of the published 67 TFLOP/s of float32, which
# counts 128 lanes and two operations per multiply-add).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per message and trellis step: 64 new states x (2 adds, compare, select),
# and 8 branch metrics of 3 adds each. The 16 sign patterns of a step's 4
# symbols come in 8 pairs of opposite sign, since every generator taps the
# oldest and the newest register bit: a butterfly's four metrics are +m, -m,
# -m, +m for one m, and a negation folds into the add that uses it.
ACS_OPS_PER_STEP = 64 * 4 + 8 * 3
# chainback per step: select the word, shift, mask, shift-or into the state
CHAINBACK_OPS_PER_STEP = 5


def bound(name, B, T):
    """(bound_ms, bound_by) of one kernel's work on B messages of T steps:
    every input byte read once, every output byte written once, against
    the int32 operations."""
    steps = B * T
    nb_bytes, ops = {
        "viterbi_decode_fused": (4 * steps + steps + 4 * B,
                                 (ACS_OPS_PER_STEP + CHAINBACK_OPS_PER_STEP)
                                 * steps),
        "viterbi_acs": (4 * steps + 8 * steps + 4 * B,
                        ACS_OPS_PER_STEP * steps),
        "viterbi_chainback": (8 * steps + steps,
                              CHAINBACK_OPS_PER_STEP * steps),
        # the fused kernel's work on B windows of T steps; a mask byte in
        # and no path error out
        "viterbi_decode_windows": (4 * steps + steps + B,
                                   (ACS_OPS_PER_STEP + CHAINBACK_OPS_PER_STEP)
                                   * steps),
    }[name]
    t_bytes = nb_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def launched(**counts):
    """The wrappers' launch counts with every kernel at 0 but those named."""
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    return K.launched(**counts)


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
    """Device time of one fn() in ms, from CUDA events around reps calls.
    The calls are queued behind a matrix product of a few milliseconds, so
    that the card runs them back to back and the time of the host's
    launches (longer than a short kernel) stays out of the reading."""
    import torch
    fn()
    blocker = torch.empty((4096, 4096), device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(max(1, reps // 10)):
        torch.mm(blocker, blocker)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_windows(name, d, out):
    """K1's windowed mode on the windows of the tiled decode of d (B, T, 4),
    against its plain version, bit for bit, on every window
    (WINDOW_PLAIN_CHUNK at a time). Times the kernel, and the whole tiled
    decode of d with the window gather and the slice around it."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.ops import viterbi as vit
    windows, first = vit.tile_windows(d)
    B, L = windows.shape[:2]
    check(L == WINDOW_L, f"windows of {L} steps")
    before = dict(K.LAUNCHES)
    bits = K.decode_windows(windows, first)
    torch.cuda.synchronize()
    took = {k: K.LAUNCHES[k] - before[k] for k in before}
    check(took == launched(viterbi_decode_windows=1),
          f"decode_windows launched {took} at {name}")
    plain_ms, err = 0.0, 0
    for lo in range(0, B, WINDOW_PLAIN_CHUNK):
        sl = slice(lo, lo + WINDOW_PLAIN_CHUNK)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = K.decode_windows_plain(windows[sl], first[sl])
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        err = max(err, int((bits[sl].to(torch.int16) - want).abs().max()))
        del want
    check(first.any() and not first.all(),
          f"the windows of {name} hold one kind of tile only")
    if err:
        raise AssertionError(f"viterbi_decode_windows disagrees with its "
                             f"plain version at {name} (B={B}, L={L})")
    reps = 20 if B * L < 2_000_000 else 5
    ms = _cuda_ms(lambda: K.decode_windows(windows, first), reps)
    tiled_ms = _cuda_ms(lambda: vit.viterbi_decode_soft_tiled(d), reps)
    b_ms, b_by = bound("viterbi_decode_windows", B, L)
    out["viterbi_decode_windows"][name] = {
        "B": B, "T": L, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": b_ms, "bound_by": b_by}
    log(f"K1 {name:16s} windows B={B:6d} L={L} route={K.plan(B, L)} "
        f"bit-identical=True | kernel {ms:.4f} ms, "
        f"bound {b_ms:.6f} ms by {b_by}, share {100 * b_ms / ms:.3f}% | "
        f"tiled decode with its window gather {tiled_ms:.4f} ms for "
        f"{tuple(d.shape[:2])} | plain {plain_ms:.1f} ms")


def check_kernels(dev):
    """The kernels of K1 against the plain versions, bit for bit, at every
    shape, the windowed mode at the window shapes of WINDOWS_OF; returns {kernel: {shape name: {B, T, ms, plain_ms,
    max_abs_err, bound_ms, bound_by}}}."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    rng = np.random.default_rng(SEED)
    cases = [(name, _encoded_soft(rng, B, T)) for name, B, T in K1_SHAPES]
    cases.append(("all_zero_ties", np.zeros((4, 774, 4), np.int8)))
    cases.append(("eep4a_864cu", _encoded_soft(rng, 4, LONG_T)))
    out = {name: {} for name in REPLACES}
    for name, d_np in cases:
        d = torch.as_tensor(d_np, device=dev)
        B, T = d_np.shape[:2]
        fused = K.plan(B, T)[0] == "fused"
        dec, err = K.viterbi_acs(d)
        bits = K.chainback(dec)
        before = dict(K.LAUNCHES)
        dbits, derr = K.decode(d)
        took = {k: K.LAUNCHES[k] - before[k] for k in before}
        torch.cuda.synchronize()
        check(took == launched(viterbi_decode_fused=int(fused),
                               viterbi_acs=int(not fused),
                               viterbi_chainback=int(not fused)),
              f"decode took the wrong route at {name}: {took}")
        # the plain versions, PLAIN_CHUNK messages at a time, timed by the
        # one run that the comparison needs
        exact = [k for k in REPLACES if k != "viterbi_decode_windows"]
        same = dict.fromkeys(exact, True)
        errs = dict.fromkeys(exact, 0)
        pms_acs = pms_cb = 0.0
        for lo in range(0, B, PLAIN_CHUNK):
            sl = slice(lo, lo + PLAIN_CHUNK)
            start, mid, end = (torch.cuda.Event(enable_timing=True)
                               for _ in range(3))
            start.record()
            pdec, perr = K.viterbi_acs_plain(d[sl])
            mid.record()
            pbits = K.chainback_plain(pdec)
            end.record()
            torch.cuda.synchronize()
            pms_acs += start.elapsed_time(mid)
            pms_cb += mid.elapsed_time(end)
            same["viterbi_acs"] &= (torch.equal(dec[:, sl], pdec)
                                    and torch.equal(err[sl], perr))
            same["viterbi_chainback"] &= torch.equal(bits[sl], pbits)
            same["viterbi_decode_fused"] &= (torch.equal(dbits[sl], pbits)
                                             and torch.equal(derr[sl], perr))
            for kernel, got, want in (
                    ("viterbi_acs", err[sl], perr),
                    ("viterbi_chainback", bits[sl], pbits),
                    ("viterbi_decode_fused", dbits[sl], pbits),
                    ("viterbi_decode_fused", derr[sl], perr)):
                errs[kernel] = max(errs[kernel], int(
                    (got.long() - want.long()).abs().max()))
            del pdec, perr, pbits
        reps = 20 if T * B < 2_000_000 else 5
        ms = {"viterbi_acs": _cuda_ms(lambda: K.viterbi_acs(d), reps),
              "viterbi_chainback": _cuda_ms(lambda: K.chainback(dec), reps)}
        # decode() is the fused kernel, or for a long trellis the pair
        ms["viterbi_decode_fused" if fused else "decode_pair"] = _cuda_ms(
            lambda: K.decode(d), reps)
        if name in PLAIN_TIMED:                  # a second, warm plain run
            pms_acs = _cuda_ms(lambda: K.viterbi_acs_plain(d), 1)
            pms_cb = _cuda_ms(lambda: K.chainback_plain(dec), 1)
        plain_ms = {"viterbi_acs": pms_acs, "viterbi_chainback": pms_cb,
                    "viterbi_decode_fused": pms_acs + pms_cb}
        whole = ms.get("viterbi_decode_fused", ms.get("decode_pair"))
        log(f"K1 {name:14s} B={B:5d} T={T:5d} route={K.plan(B, T)} "
            f"bit-identical={all(same.values())} "
            f"decode {whole:.4f} ms | acs {ms['viterbi_acs']:.4f} ms "
            f"chainback {ms['viterbi_chainback']:.4f} ms | plain acs "
            f"{pms_acs:.1f} ms chainback {pms_cb:.1f} ms | "
            f"Mbit/s {B * T / whole / 1e3:.2f}")
        for kernel in exact:
            if not same[kernel]:
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     f"version at {name} (B={B}, T={T})")
            if kernel in ms:
                b_ms, b_by = bound(kernel, B, T)
                out[kernel][name] = {
                    "B": B, "T": T, "ms": ms[kernel],
                    "plain_ms": plain_ms[kernel], "max_abs_err": errs[kernel],
                    "bound_ms": b_ms, "bound_by": b_by}
                log(f"   {kernel:22s} {ms[kernel]:.4f} ms, bound "
                    f"{b_ms:.6f} ms by {b_by}, share "
                    f"{100 * b_ms / ms[kernel]:.3f}%")
        if name in WINDOWS_OF:
            check_windows(WINDOWS_OF[name], d, out)
    return out


# start and end states other than 0, and the shapes they are checked at: the
# fused kernel alone in a block, 16 messages a block, and the kernel pair
STATE_PAIRS = [(37, 22), (0, 63), (1, 0)]
STATE_SHAPES = [(4, 774), (2200, 320), (2, 25374)]


def check_states(dev):
    """K1's decode between states other than 0 against the plain versions,
    bit for bit: bits and path error of the best path from start_state to
    end_state, through the fused kernel and through the kernel pair."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    rng = np.random.default_rng(SEED + 7)
    for B, T in STATE_SHAPES:
        d = torch.as_tensor(_encoded_soft(rng, B, T), device=dev)
        fused = K.plan(B, T)[0] == "fused"
        zero_bits, zero_err = K.decode(d)
        for start, end in STATE_PAIRS[:3 if fused else 1]:
            before = dict(K.LAUNCHES)
            bits, err = K.decode(d, start, end)
            torch.cuda.synchronize()
            took = {k: K.LAUNCHES[k] - before[k] for k in before}
            check(took == launched(viterbi_decode_fused=int(fused),
                                   viterbi_acs=int(not fused),
                                   viterbi_chainback=int(not fused)),
                  f"decode between states {start} and {end} took {took}")
            pdec, perr = K.viterbi_acs_plain(d, start, end)
            pbits = K.chainback_plain(pdec, end)
            if not (torch.equal(bits, pbits) and torch.equal(err, perr)):
                raise AssertionError(
                    f"K1 disagrees with its plain version between states "
                    f"{start} and {end} (B={B}, T={T})")
            check(not (torch.equal(bits, zero_bits)
                       and torch.equal(err, zero_err)),
                  f"states {start}, {end} gave the result of states 0, 0")
        log(f"K1 states B={B:5d} T={T:5d} route={K.plan(B, T)[0]} "
            f"{STATE_PAIRS[:3 if fused else 1]} bit-identical=True")


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


def make_capture(dev, path, nb_frames=NB_FRAMES, variant=0):
    """The 18-service ensemble through the port's transmitter, with CFO and
    AWGN, written as u8 IQ. Each variant has its own access units, carrier
    offset and noise. Returns {service_id: sent AU list}."""
    from dab_radio_tpu_torch.models.transmitter import (
        EnsembleTransmitter, ServiceSpec, SubchannelConfig)
    services = [ServiceSpec(0xF123 + i, 3 + i, f"Radio TPU {i + 1}",
                            SubchannelConfig(48 * i, 48, False, eep_type="A",
                                             eep_prot_level=2))
                for i in range(NB_SERVICES)]
    tx = EnsembleTransmitter(1, services=services, device=dev)
    sources = {}
    for i, s in enumerate(services):
        sources[s.service_id] = _AUSource(SEED + 1000 * variant + i)
        tx.set_au_source(s.subchannel_id, sources[s.service_id])
    t0 = time.perf_counter()
    iq = tx.generate(nb_frames)
    t_tx = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + variant)
    cfo_bins = CFO_BINS * (-1) ** variant - 0.83 * variant
    lead = np.zeros(20000, np.complex64)
    iq = np.concatenate([lead, iq, lead])
    n = np.arange(iq.shape[0])
    iq = iq * np.exp(2j * np.pi * cfo_bins / 2048 * n)
    p_sig = float(np.mean(np.abs(iq[lead.shape[0]:-lead.shape[0]]) ** 2))
    std = np.sqrt(p_sig / 10 ** (SNR_DB / 10) / 2)
    iq = iq + std * (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape))
    iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
    # u8 IQ as rtl_sdr writes it: 127.5 + 127.5 x, interleaved I/Q
    u8 = np.clip(iq.view(np.float32) * 127.5 + 127.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(u8.tobytes())
    log(f"capture {variant}: {nb_frames} frames, {NB_SERVICES} services x 48 "
        f"CU EEP-3A, CFO {cfo_bins:.2f} carriers, SNR {SNR_DB} dB, "
        f"{os.path.getsize(path)} bytes u8 (transmitter {t_tx:.2f} s)")
    return {sid: src.sent for sid, src in sources.items()}


def make_captures(dev, nb_frames=NB_FRAMES, count=FLEET_DISTINCT):
    """`count` distinct captures -> ([path], [{service_id: sent AU list}])."""
    paths = [os.path.join(WORK, f"capture{k}_{nb_frames}.u8")
             for k in range(count)]
    return paths, [make_capture(dev, path, nb_frames, k)
                   for k, path in enumerate(paths)]


def _read_adts(path):
    data = open(path, "rb").read()
    aus, i = [], 0
    while i + 7 <= len(data):
        h = data[i:i + 7]
        n = ((h[3] & 3) << 11) | (h[4] << 3) | (h[5] >> 5)
        aus.append(data[i + 7:i + n])
        i += n
    return aus


def _check_aus(adts_path, aus_sent, what):
    """The access units of an ADTS file are a run of those sent, byte for
    byte; returns their count."""
    check(os.path.exists(adts_path), f"{what}: no scraper output")
    got = _read_adts(adts_path)
    check(got, f"{what}: no access units")
    check(got[0] in aus_sent, f"{what}: unknown access unit")
    k = aus_sent.index(got[0])
    check(got == aus_sent[k:k + len(got)],
          f"{what}: access units differ from those sent")
    return len(got)


def _run_capturing_stderr(fn, echo=True):
    """Run fn() with file descriptor 2 sent to a file; return its text, and
    echo it unless told not to."""
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
    if echo:
        sys.stderr.write(text)
    return rc, text


def main_path(dev, capture, sent):
    """radio_cli on the capture; checks the decode and the kernel counts."""
    import torch
    from dab_radio_tpu_torch.apps import radio_cli
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    scrape = os.path.join(WORK, "scrape")
    shutil.rmtree(scrape, ignore_errors=True)
    argv = ["-i", capture, "-F", "u8", "--benchmark", "--backend", "cuda",
            "--scraper-enable", "--scraper-output", scrape]
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
        nb_aus += _check_aus(os.path.join(dirs[0], "stream.aac"), aus_sent,
                             f"service {sid:X}")

    check(by_t.get(774, 0) > 0, "the FIC decode did not run a Viterbi kernel")
    check(by_t.get(1542, 0) > 0, "the MSC decode did not run a Viterbi kernel")
    check(launches == launched(viterbi_decode_fused=sum(by_t.values())),
          f"a decode took more than one launch, or another kernel than the "
          f"fused one ran on the main path: {launches} for {by_t}")
    air = frames * 0.096
    log(f"main path: frames={frames} wall={wall:.3f} s air={air:.3f} s "
        f"real-time factor={air / wall:.3f} access_units={nb_aus} "
        f"(all byte-exact) launches={launches} by T={by_t}")
    return launches


def long_path(dev, mode="exact"):
    """One 864-CU EEP 4-A subchannel, MSCEncoder -> noise -> MSCDecoder on
    the card: the trellis of 41,478 steps takes the forward and chainback
    kernel pair, or with mode "tiled" (dab/msc.py:set_decode_mode) one
    windowed launch a decode of 4 CIFs, 1,300 windows. Returns the launch
    counts of this path."""
    import torch
    from dab_radio_tpu_torch.dab import msc
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.ops import viterbi as vit
    from dab_radio_tpu_torch.params import SubchannelConfig
    cfg = SubchannelConfig(0, LONG_CU, False, eep_type="A", eep_prot_level=3)
    enc, dec = msc.MSCEncoder(cfg), msc.MSCDecoder(cfg, dev)
    check(dec.spec.nb_steps == LONG_T, f"trellis of {dec.spec.nb_steps} steps")
    rng = np.random.default_rng(SEED + 1)
    sent, got = [], []
    msc.set_decode_mode(mode)
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(LONG_FRAMES):
            cifs = np.empty((4, cfg.nb_cif_bits), np.int8)
            for k in range(4):
                sent.append(rng.integers(0, 256, enc.nb_data_bytes)
                            .astype(np.uint8).tobytes())
                cifs[k] = enc.encode_cif(sent[-1])
            noisy = cifs + rng.normal(0.0, LONG_NOISE_STD, cifs.shape)
            got += dec.decode_frame(np.clip(np.round(noisy), -127, 127)
                                    .astype(np.int8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        by_t = dict(K.ACS_LAUNCHES_BY_T)
    finally:
        msc.set_decode_mode("exact")
    nb_fill = 15                      # CIFs before the deinterleaver is full
    check(got[:nb_fill] == [None] * nb_fill, "output before the fill")
    decoded = got[nb_fill:]
    check(len(decoded) == 4 * LONG_FRAMES - nb_fill and
          decoded == sent[:len(decoded)],
          f"long-trellis payloads ({mode}) differ from those sent")
    if mode == "tiled":
        check(by_t == {WINDOW_L: LONG_FRAMES}
              and launches == launched(viterbi_decode_windows=LONG_FRAMES),
              f"the tiled long trellis did not take one windowed launch a "
              f"decode: {launches} by T {by_t}")
        # both decodes of 4 codewords at the path's own noise, depuncture
        # included, on one input (launches made to time them are not the
        # path's). On symbols that are no codeword the survivor paths merge
        # late, and the pair's chainback, which walks its segments from
        # guessed entry states, has more to repair: that is not this path.
        coded = np.stack([vit.puncture(vit.conv_encode(
            rng.integers(0, 2, dec.spec.nb_data_bits)), dec.spec.mask)
            for _ in range(4)])
        noisy = vit.bits_to_soft(coded) + rng.normal(0.0, LONG_NOISE_STD,
                                                     coded.shape)
        soft = torch.as_tensor(np.clip(np.round(noisy), -127, 127)
                               .astype(np.int8), device=dev)
        check(torch.equal(vit.viterbi_decode(soft, dec.spec)[0],
                          vit.viterbi_decode_tiled(soft, dec.spec)[0]),
              "the tiled and the exact decode differ at the long path's noise")
        pair_ms = _cuda_ms(lambda: vit.viterbi_decode(soft, dec.spec), 5)
        tiled_ms = _cuda_ms(lambda: vit.viterbi_decode_tiled(soft, dec.spec),
                            5)
        log(f"long path: a decode of 4 noisy codewords, depuncture to bits: "
            f"exact (kernel pair) {pair_ms:.4f} ms, tiled (1300 windows, one "
            f"launch) {tiled_ms:.4f} ms")
    else:
        check(by_t == {LONG_T: LONG_FRAMES}, f"forward passes by T: {by_t}")
        check(launches == launched(viterbi_acs=LONG_FRAMES,
                                   viterbi_chainback=LONG_FRAMES),
              f"the long trellis did not take the kernel pair: {launches}")
    log(f"long path ({mode}): {LONG_CU} CU EEP 4-A, T={LONG_T}, "
        f"{len(decoded)} CIFs of {enc.nb_data_bytes} bytes byte-exact, noise "
        f"std {LONG_NOISE_STD}, wall={wall:.3f} s (encoder included) "
        f"launches={launches}")
    return launches


class _FleetTimers:
    """While active, times every FusedFleet round of this process: the host
    wall of process_round, CUDA events around the round's device step, and
    the host's byte-layer time (_consume); and counts the kernel launches
    of each round's step."""

    def __init__(self):
        self.round_wall_s, self.consume_s, self.step_events = [], [], []
        self.step_launches = []     # per round: (kernel counts, counts by T)

    def __enter__(self):
        import torch
        from dab_radio_tpu_torch.kernels import viterbi_acs as K
        from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
        self._cls = FusedFleet
        self._saved = (FusedFleet.process_round, FusedFleet._consume)
        process_round, consume = self._saved
        timers = self

        def timed_step(inner):
            def step(*args):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                before = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
                start.record()
                out = inner(*args)
                end.record()
                timers.step_events.append((start, end))
                timers.step_launches.append(tuple(
                    {k: v - was.get(k, 0) for k, v in now.items()
                     if v != was.get(k, 0)}
                    for now, was in zip((K.LAUNCHES, K.ACS_LAUNCHES_BY_T),
                                        before)))
                return out
            step.__dict__.update(inner.__dict__)
            step.timed = True
            return step

        def timed_round(fleet, *args, **kw):
            if not getattr(fleet.step, "timed", False):
                fleet.step = timed_step(fleet.step)
            t0 = time.perf_counter()
            process_round(fleet, *args, **kw)
            timers.round_wall_s.append(time.perf_counter() - t0)

        def timed_consume(fleet, *args):
            t0 = time.perf_counter()
            consume(fleet, *args)
            timers.consume_s.append(time.perf_counter() - t0)

        FusedFleet.process_round = timed_round
        FusedFleet._consume = timed_consume
        return self

    def __exit__(self, *exc):
        self._cls.process_round, self._cls._consume = self._saved

    def step_ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.step_events]


def _serve(argv):
    """fleet_serve.main(argv) with its stdout captured -> (JSON lines,
    stderr text, timers, launch counts, forward passes by T, wall s)."""
    import contextlib
    import io
    import torch
    from dab_radio_tpu_torch.apps import fleet_serve
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    out = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with _FleetTimers() as timers, contextlib.redirect_stdout(out):
        rc, err_text = _run_capturing_stderr(lambda: fleet_serve.main(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_t = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
    check(rc == 0, f"fleet_serve returned {rc}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    return lines, err_text, timers, launches, by_t, wall


def _check_streams(lines, scrape, sent_of_stream):
    """The stream lines and the scraper tree of a fleet_serve run against
    what was sent; returns the access units checked."""
    nb_streams = len(sent_of_stream)
    check(len(lines) == nb_streams + 1,
          f"{len(lines)} stdout lines for {nb_streams} streams")
    nb_aus = 0
    for b, (row, sent) in enumerate(zip(lines, sent_of_stream)):
        check(row["stream"] == b and row["ensemble"] == "C0FE"
              and len(row["services"]) == NB_SERVICES,
              f"stream {b} not decoded: {row}")
        check(row["fib_ok"] > 0, f"stream {b}: no valid FIB in the last round")
        for s in range(NB_SERVICES):
            nb_aus += _check_aus(
                os.path.join(scrape, f"stream_{b}", f"subchannel_{s}",
                             "stream.aac"),
                sent[0xF123 + s], f"stream {b} subchannel {s}")
    total = lines[-1]
    check(total["streams"] == nb_streams and total["access_units"] == nb_aus,
          f"totals {total} against {nb_aus} access units on disk")
    return nb_aus


def fleet_path(dev, paths, sents, viterbi="exact"):
    """fleet_serve on 16 streams of the 18-service ensemble, 8 frames a
    round: every access unit byte-exact, one Viterbi launch a round: the
    fused kernel on 9,728 messages of 1,542 steps, or with viterbi "tiled"
    the windowed one on their 126,464 windows of 320."""
    tag = "fleet path" if viterbi == "exact" else f"fleet path ({viterbi})"
    scrape = os.path.join(WORK, f"fleet_scrape_{viterbi}")
    shutil.rmtree(scrape, ignore_errors=True)
    order = [k % len(paths) for k in range(FLEET_STREAMS)]
    layout = ",".join(f"{48 * i}:48:EEP3A" for i in range(NB_SERVICES))
    argv = ["-i", *[paths[k] for k in order], "--subchannels", layout,
            "--frames-per-step", str(FLEET_K), "--scraper-output", scrape,
            "--viterbi", viterbi, "--backend", "cuda"]
    lines, _, timers, launches, by_t, wall = _serve(argv)
    rounds = lines[-1]["rounds"]
    check(rounds == (NB_FRAMES - 1) // FLEET_K, f"{rounds} rounds")
    nb_aus = _check_streams(lines, scrape, [sents[k] for k in order])
    kernel, T = {"exact": ("viterbi_decode_fused", 1542),
                 "tiled": ("viterbi_decode_windows", WINDOW_L)}[viterbi]
    check(launches == launched(**{kernel: rounds}) and by_t == {T: rounds}
          and timers.step_launches == [({kernel: 1}, {T: 1})] * rounds,
          f"not one {kernel} launch a round at T={T}: {launches} by T "
          f"{by_t}, by round {timers.step_launches}")
    step_ms = timers.step_ms()
    air = FLEET_STREAMS * FLEET_K * 0.096
    warm = timers.round_wall_s[-1]
    log(f"{tag}: streams={FLEET_STREAMS} ({len(paths)} distinct) "
        f"rounds={rounds} frames/round={FLEET_K} lanes/round={FLEET_LANES} "
        f"access_units={nb_aus} (all byte-exact) wall={wall:.3f} s "
        f"launches={launches} by T={by_t}")
    log(f"{tag}: round wall s = "
        + json.dumps([round(x, 4) for x in timers.round_wall_s])
        + " (a round's wall holds the byte layer of the round before)")
    log(f"{tag}: device step ms = "
        + json.dumps([round(x, 3) for x in step_ms])
        + ", host consume s = "
        + json.dumps([round(x, 4) for x in timers.consume_s]))
    log(f"{tag}: warm round wall {warm:.4f} s for {air:.3f} s of air: "
        f"real-time ensembles = {air / warm:.3f}")
    return launches


def discovery_path(dev, paths, sents):
    """fleet_serve --discover on 2 distinct captures, 4 frames a round: the
    layouts come from the dynamic receiver, one row a stream."""
    scrape = os.path.join(WORK, "discover_scrape")
    shutil.rmtree(scrape, ignore_errors=True)
    argv = ["-i", *paths[:DISCOVER_STREAMS], "--discover",
            "--frames-per-step", str(DISCOVER_K), "--scraper-output", scrape,
            "--backend", "cuda"]
    lines, _, timers, launches, by_t, wall = _serve(argv)
    rounds = lines[-1]["rounds"]
    check(rounds == (NB_FRAMES - 1) // DISCOVER_K, f"{rounds} rounds")
    nb_aus = _check_streams(lines, scrape, sents[:DISCOVER_STREAMS])
    # the dynamic pass before the rounds decodes frame by frame (T=774 and
    # T=1542), so the rounds are counted step by step
    check(timers.step_launches
          == [({"viterbi_decode_fused": 1}, {1542: 1})] * rounds
          and launches
          == launched(viterbi_decode_fused=launches["viterbi_decode_fused"]),
          f"not one fused launch a round at T=1542: {timers.step_launches}, "
          f"in all {launches} by T {by_t}")
    log(f"discovery path: streams={DISCOVER_STREAMS} rounds={rounds} "
        f"frames/round={DISCOVER_K} access_units={nb_aus} (all byte-exact) "
        f"wall={wall:.3f} s launches={launches} by T={by_t} round wall s = "
        + json.dumps([round(x, 4) for x in timers.round_wall_s]))
    return launches


def _aligned_streams(fleet, paths):
    """Each capture's u8 samples from its first whole frame on."""
    streams = []
    for path in paths:
        u8 = np.fromfile(path, np.uint8)
        off = fleet.find_alignment(u8[:2 * 4 * fleet.fs])
        check(off is not None, f"no frame sync in {path}")
        streams.append(u8[off:])
    return streams


def variants_path(dev, paths):
    """The exact decode variants on the card: receiver_step with each flag
    on 2 streams x 4 frames of the 18-service ensemble, two rounds from the
    default step's input and state: every output equal to the default
    step's. They are torch loops over the trellis: their times are printed,
    and the default step's K1 launches are the only ones."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel.mesh import receiver_step
    from dab_radio_tpu_torch.params import SubchannelConfig
    cfgs = [SubchannelConfig(48 * i, 48, False, eep_type="A", eep_prot_level=2)
            for i in range(NB_SERVICES)]
    fleet = FusedFleet(VARIANT_STREAMS, cfgs, 1, VARIANT_K, device=dev)
    streams = _aligned_streams(fleet, paths[:VARIANT_STREAMS])
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    rounds = [(torch.as_tensor(np.stack([s[r * chunk:(r + 1) * chunk]
                                         for s in streams]), device=dev),
               torch.as_tensor(np.stack(
                   [s[(r + 1) * chunk:(r + 1) * chunk + tb] for s in streams]),
                   device=dev)) for r in range(2)]
    lanes = VARIANT_STREAMS * (NB_SERVICES * 4 * VARIANT_K + 4 * VARIANT_K)

    def run(**kw):
        step, (carry, hist, _) = receiver_step(
            dev, 1, VARIANT_K, subchannels_per_shard=NB_SERVICES,
            ensembles_per_shard=VARIANT_STREAMS, ingest="u8",
            subchannel_cfgs=cfgs, fuse_fic=True, **kw)
        outs, times = [], []
        for blk, tail in rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, hist, out = step(carry, hist, blk, tail)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append(out)
        return outs, times

    K.reset_launches()
    want, base_s = run()
    launches = dict(K.LAUNCHES)
    check(launches == launched(viterbi_decode_fused=2),
          f"the default step launched {launches}")
    log(f"variants path: {VARIANT_STREAMS} streams x {VARIANT_K} frames, "
        f"{lanes} lanes of 1542 steps; default step (K1) "
        + json.dumps([round(x, 4) for x in base_s]) + " s")
    for kw in (dict(chainback="parallel"), dict(chainback="fused"),
               dict(viterbi_branch="lut"), dict(viterbi="radix8")):
        got, took_s = run(**kw)
        for r, (a, b) in enumerate(zip(got, want)):
            for k in ("fib_bits", "msc_bits", "fic_err", "msc_err",
                      "offsets"):
                check(torch.equal(a[k], b[k]),
                      f"{kw}: {k} of round {r} differs from the default "
                      f"step's")
        log(f"variants path: {kw} equal to the default step in all outputs; "
            "step " + json.dumps([round(x, 4) for x in took_s]) + " s (torch "
            "loops over the trellis, no kernel)")
    check(dict(K.LAUNCHES) == launches,
          f"a variant launched a kernel: {dict(K.LAUNCHES)}")
    return launches


def batched_path(dev, paths, sents):
    """The older batched path: 4 distinct captures through
    MultiStreamDemodulator (u8 ingest, 4 frames a step, soft bits kept on
    the card) into ReceiverFleet (pipeline depth 2). Every access unit
    byte-exact, no desync, and each round one fused launch for the stacked
    FIC (16 x 774) and one for each protection shape of the MSC (here one:
    288 x 1542). Returns the launch counts of this path."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    N = BATCHED_STREAMS
    ms = MultiStreamDemodulator(OFDMDemodulator(1, device=dev), N,
                                frames_per_step=BATCHED_K, ingest="u8",
                                fetch_bits=False, device=dev)
    fleet = ReceiverFleet(N, 1, pipeline_depth=2, device=dev)
    got = {}
    for k, rx in enumerate(fleet.receivers):
        def on_channel(sub_id, ch, _k=k):
            aus = got.setdefault((_k, sub_id), [])
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: aus.append(bytes(au)))
        rx.on_audio_channel.append(on_channel)
    for k, path in enumerate(paths[:N]):
        ms.push(k, np.fromfile(path, np.uint8))
    K.reset_launches()
    step_s, round_s, per_round = [], [], []
    t_all = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        res = ms.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not res:
            break
        check(all(torch.is_tensor(b) and b.device.type == "cuda"
                  for _, b in res), "the soft bits left the card")
        while res:         # a step gives up to 4 frames a stream, in order
            seen, now, later = set(), [], []
            for i, b in res:
                (later if i in seen else now).append((i, b))
                seen.add(i)
            before = dict(K.ACS_LAUNCHES_BY_T)
            t0 = time.perf_counter()
            fleet.process_frames(now)
            round_s.append(time.perf_counter() - t0)
            per_round.append({T: n - before.get(T, 0)
                              for T, n in K.ACS_LAUNCHES_BY_T.items()
                              if n != before.get(T, 0)})
            res = later
    fleet.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = dict(K.LAUNCHES)
    check(int(ms.carry.total_desync.sum()) == 0, "a stream lost sync")
    frames = fleet.total_frames
    check(frames >= N * (NB_FRAMES - 3), f"{frames} frames decoded")
    # a round: one fused launch for the stacked FIC, and once the channels
    # are known one for the one protection shape of the MSC
    check(all(r in ({774: 1}, {774: 1, 1542: 1}) for r in per_round)
          and per_round[-1] == {774: 1, 1542: 1}
          and launches == launched(
              viterbi_decode_fused=sum(sum(r.values()) for r in per_round)),
          f"launches by round {per_round}, in all {launches}")
    nb_aus = 0
    for k in range(N):
        check(len(fleet.receivers[k].channels) == NB_SERVICES,
              f"stream {k}: {len(fleet.receivers[k].channels)} channels")
        for s in range(NB_SERVICES):
            aus = got.get((k, 3 + s))
            sent = sents[k][0xF123 + s]
            check(aus and aus[0] in sent, f"stream {k} subchannel {3 + s}: "
                  "no access unit, or an unknown one")
            at = sent.index(aus[0])
            check(aus == sent[at:at + len(aus)],
                  f"stream {k} subchannel {3 + s}: access units differ from "
                  "those sent")
            nb_aus += len(aus)
    air = frames * 0.096
    log(f"batched path: streams={N} frames={frames} rounds={len(round_s)} "
        f"access_units={nb_aus} (all byte-exact) desync=0 wall={wall:.3f} s "
        f"for {air:.3f} s of air: real-time ensembles = {air / wall:.3f}; "
        f"launches={launches} by T={dict(K.ACS_LAUNCHES_BY_T)}")
    log("batched path: demodulator step s = "
        + json.dumps([round(x, 4) for x in step_s])
        + ", process_frames round s = "
        + json.dumps([round(x, 4) for x in round_s]))
    return launches


def _events_ms(fn):
    """(fn(), the time between CUDA events around it in ms)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def mesh_world1(dev, paths, sents, backend="nccl"):
    """multichip_receiver_step on a process group of one rank against
    receiver_step, on the 16 streams of the fleet path, 3 rounds of 8
    frames: every output, the carry and the history equal; one fused launch
    a round of the mesh step. The same rounds through FusedFleet on that
    mesh: every access unit byte-exact."""
    from datetime import timedelta
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel import distributed
    from dab_radio_tpu_torch.parallel import mesh as M
    from dab_radio_tpu_torch.params import SubchannelConfig
    rdzv = os.path.join(WORK, "rdzv_world1")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    check(distributed.initialize(f"file://{rdzv}", 1, 0, backend,
                                 timedelta(seconds=60)),
          "the process group of one rank did not come up")
    try:
        mesh = distributed.global_receiver_mesh()
        check(mesh.groups is not None and mesh.axis_sizes == (1, 1, 1)
              and torch.distributed.get_backend() == backend,
              f"mesh {mesh} over {torch.distributed.get_backend()}")
        cfgs = [SubchannelConfig(48 * i, 48, False, eep_type="A",
                                 eep_prot_level=2) for i in range(NB_SERVICES)]
        kw = dict(subchannels_per_shard=NB_SERVICES,
                  ensembles_per_shard=FLEET_STREAMS, ingest="u8",
                  subchannel_cfgs=cfgs, fuse_fic=True)
        fleet = FusedFleet(FLEET_STREAMS, cfgs, 1, FLEET_K, device=dev,
                           mesh=mesh)
        streams = _aligned_streams(fleet, paths)
        streams = [streams[k % len(paths)] for k in range(FLEET_STREAMS)]
        chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
        one, (c1, h1, _) = M.receiver_step(dev, 1, FLEET_K, **kw)
        many, (c2, h2, _) = M.multichip_receiver_step(mesh, 1, FLEET_K,
                                                      device=dev, **kw)
        step_ms, one_ms, launches = [], [], []
        aus = {}
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, h: aus.setdefault((b, s), []).append(
                bytes(au)))
        M.reset_collectives()
        for r in range((NB_FRAMES - 1) // FLEET_K):
            blk, tail = (torch.as_tensor(np.stack([x[a:b] for x in streams]),
                                         device=dev)
                         for a, b in ((r * chunk, (r + 1) * chunk),
                                      ((r + 1) * chunk, (r + 1) * chunk + tb)))
            K.reset_launches()
            (c2, h2, o2), ms = _events_ms(lambda: many(c2, h2, blk, tail))
            launches.append(dict(K.LAUNCHES))
            step_ms.append(ms)
            (c1, h1, o1), ms = _events_ms(lambda: one(c1, h1, blk, tail))
            one_ms.append(ms)
            for k in o1:
                check(torch.equal(o1[k], o2[k]),
                      f"mesh step's {k} of round {r} differs from "
                      "receiver_step's")
            check(all(torch.equal(a, b) for a, b in zip(c1, c2))
                  and torch.equal(h1, h2),
                  f"mesh step's state after round {r} differs")
            fleet.process_round(blk, tail_u8=tail)
        check(all(n == launched(viterbi_decode_fused=1) for n in launches),
              f"the mesh step did not launch K1 once a round: {launches}")
        coll = dict(M.COLLECTIVES)
        nb_aus = _check_fleet_aus(aus, sents, "mesh fleet")
    finally:
        distributed.shutdown()
    log(f"mesh world 1 ({backend}): {FLEET_STREAMS} streams x "
        f"{FLEET_K} frames, {len(step_ms)} rounds equal to receiver_step in "
        f"every output and the state; FusedFleet on the mesh: {nb_aus} "
        f"access units byte-exact; K1 a round {launches[-1]}; mesh step "
        f"ms = {json.dumps([round(x, 3) for x in step_ms])}, receiver_step "
        f"ms = {json.dumps([round(x, 3) for x in one_ms])}; collectives "
        f"{json.dumps(coll)}")
    return launches[-1]


def _check_fleet_aus(aus, sents, what):
    """Each (stream, subchannel)'s access units of {(b, s): [bytes]} are a
    run of those sent, byte for byte; returns their count."""
    nb = 0
    for b in range(FLEET_STREAMS):
        for s in range(NB_SERVICES):
            got, sent = aus.get((b, s)), sents[b % len(sents)][0xF123 + s]
            check(got and got[0] in sent, f"{what} stream {b} subchannel "
                  f"{s}: no access unit, or an unknown one")
            at = sent.index(got[0])
            check(got == sent[at:at + len(got)], f"{what} stream {b} "
                  f"subchannel {s}: access units differ from those sent")
            nb += len(got)
    return nb


def mesh_rank(rank, init, backend):
    """One of the MESH_RANKS processes of the mesh phase (chip_smoke.py
    --mesh-rank R --mesh-init URL --mesh-backend B): the dry run of
    parallel/dryrun.py on a MESH_AXES mesh, then FusedFleet on that mesh
    over the fleet path's captures (16 streams, FLEET_K frames a round,
    FLEET_K / n_time a time rank), every rank fed the whole round. Rank 0
    writes the ranks' reports and the leader's access units to
    WORK/mesh_ranks.pkl."""
    import pickle
    from datetime import timedelta
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel import distributed, dryrun
    from dab_radio_tpu_torch.parallel import mesh as M
    from dab_radio_tpu_torch.params import SubchannelConfig
    torch.set_num_threads(1)
    check(distributed.initialize(init, MESH_RANKS, rank, backend,
                                 timedelta(seconds=120)),
          "the process group did not come up")
    try:
        mesh = distributed.global_receiver_mesh(MESH_AXES)
        dev = distributed.local_device()
        dry = dryrun.dryrun_multichip(mesh, dev)
        cfgs = [SubchannelConfig(48 * i, 48, False, eep_type="A",
                                 eep_prot_level=2) for i in range(NB_SERVICES)]
        fleet = FusedFleet(FLEET_STREAMS, cfgs, 1, FLEET_K // MESH_AXES[1],
                           device=dev, mesh=mesh)
        paths = [os.path.join(WORK, f"capture{k}_{NB_FRAMES}.u8")
                 for k in range(FLEET_DISTINCT)]
        streams = _aligned_streams(fleet, paths)
        streams = [streams[k % len(paths)] for k in range(FLEET_STREAMS)]
        chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
        aus = {}
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, h: aus.setdefault((b, s), []).append(
                bytes(au)))
        torch.cuda.synchronize(dev)
        K.reset_launches()
        M.reset_collectives()
        walls = []
        for r in range((NB_FRAMES - 1) // FLEET_K):
            blk, tail = (np.stack([x[a:b] for x in streams])
                         for a, b in ((r * chunk, (r + 1) * chunk),
                                      ((r + 1) * chunk, (r + 1) * chunk + tb)))
            t0 = time.perf_counter()
            fleet.process_round(blk, tail_u8=tail)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        report = {"rank": rank, "coords": mesh.coords, "device": str(dev),
                  "rows": fleet.rows, "launches": dict(K.LAUNCHES),
                  "collectives": dict(M.COLLECTIVES), "round_wall_s": walls,
                  "health": (fleet.drift_correction.tolist(),
                             fleet.last_fib_ok.tolist(),
                             fleet.materialized_rounds),
                  "aus": aus if mesh.is_leader else None,
                  "summary": fleet.summary() if mesh.is_leader else None}
        reports = M._gather_objects(mesh, report, 0)
        if rank == 0:
            with open(os.path.join(WORK, "mesh_ranks.pkl"), "wb") as f:
                pickle.dump({"dryrun": dry, "fleet": reports,
                             "backend": torch.distributed.get_backend()}, f)
    finally:
        distributed.shutdown()
    return 0


def mesh_ranks(sents, backend="gloo"):
    """MESH_RANKS processes of mesh_rank over `backend` (gloo: all on one
    card; nccl: a card each). The dry run bit-exact, two fused launches a
    rank; the fleet's access units byte-exact, one fused launch a round on
    every rank, every rank's health signals equal. A rank that fails or a
    collective that times out fails this."""
    import pickle
    from dab_radio_tpu_torch.parallel import dryrun
    rdzv, out = (os.path.join(WORK, f) for f in ("rdzv_ranks",
                                                  "mesh_ranks.pkl"))
    for f in (rdzv, out):
        if os.path.exists(f):
            os.remove(f)
    cmds = [[sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
             "--mesh-init", f"file://{rdzv}", "--mesh-backend", backend]
            for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    outs = dryrun.launch(cmds, MESH_TIMEOUT_S, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    for r, (rc, text) in enumerate(outs):
        if rc != 0:
            sys.stderr.write(f"mesh rank {r} exited with {rc}:\n"
                             f"{text[-3000:]}\n")
    check(all(rc == 0 for rc, _ in outs),
          f"mesh ranks exited with {[rc for rc, _ in outs]}")
    check(os.path.exists(out), "rank 0 wrote no report")
    with open(out, "rb") as f:
        res = pickle.load(f)
    report, fleet = res["dryrun"], res["fleet"]
    ranks = report["ranks"]
    check(report["bit_exact"] and res["backend"] == backend
          and len(ranks) == MESH_RANKS == len(fleet)
          and report["fibs"] > 0 and report["payloads"] > 0,
          f"dry run report {report}")
    for r in ranks:
        check(r["launches"] == launched(viterbi_decode_fused=2),
              f"rank {r['rank']} launched {r['launches']} in the dry run")
        check(not r["loaded_jax"], f"rank {r['rank']} loaded {r['loaded_jax']}")
    nb_rounds = (NB_FRAMES - 1) // FLEET_K
    leaders = [p for p in fleet if p["aus"] is not None]
    check([p["rank"] for p in leaders] == [0], f"leaders {leaders}")
    nb_aus = _check_fleet_aus(leaders[0]["aus"], sents, "mesh ranks' fleet")
    for p in fleet:
        check(p["launches"] == launched(viterbi_decode_fused=nb_rounds),
              f"rank {p['rank']} launched {p['launches']} in the fleet")
        check(p["health"] == fleet[0]["health"] and p["health"][2] == nb_rounds
              and min(p["health"][1]) > 0,
              f"rank {p['rank']}'s health {p['health']} is not rank 0's "
              f"{fleet[0]['health']}")
    log(f"mesh {MESH_RANKS} ranks ({backend}, devices "
        f"{sorted({p['device'] for p in fleet})}), wall of the launch "
        f"{wall:.2f} s. Dry run: mesh {report['mesh']} subchannels "
        f"{report['subchannels']} frames {report['frames']}: "
        f"{report['fibs']} FIBs and {report['payloads']} payloads bit-exact "
        f"against FICDecoder / MSCDecoder. FusedFleet on the mesh: "
        f"{FLEET_STREAMS} streams x {FLEET_K} frames a round, {nb_rounds} "
        f"rounds, {nb_aus} access units byte-exact, every rank's health "
        f"equal (fib_ok {fleet[0]['health'][1]})")
    for r, p in zip(ranks, fleet):
        log(f"  rank {r['rank']} {r['coords']}: dry run K1 {r['launches']}, "
            f"step {r['step_ms']} ms between events, wall {r['wall_s']:.4f} "
            f"s, collectives {json.dumps(r['collectives'])}; fleet K1 "
            f"{p['launches']}, round walls "
            f"{json.dumps([round(x, 4) for x in p['round_wall_s']])} s, "
            f"collectives {json.dumps(p['collectives'])}")
    return fleet[0]["launches"]


def mesh_path(dev, paths, sents):
    """The multi-GPU receiver on the one card: see the module docstring.
    Returns the launch counts of rank 0's fleet."""
    mesh_world1(dev, paths, sents)
    return mesh_ranks(sents)


def _device_profile(tp, wall_s):
    """(device time ms, busy share of wall_s, top 12 kernels) of a finished
    torch.profiler run."""
    import torch
    rows = [e for e in tp.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    total_us = sum(dev_us(e) for e in rows)
    rows.sort(key=dev_us, reverse=True)
    return (total_us / 1e3, total_us / 1e6 / wall_s,
            [{"name": e.key[:80], "calls": e.count, "ms": dev_us(e) / 1e3}
             for e in rows[:12]])


def measure(dev, nb_frames):
    """Times of the main path on nb_frames frames: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dab_radio_tpu_torch.apps import radio_cli
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.utils.profiler import get_profiler
    paths, _ = make_captures(dev, nb_frames)
    argv = ["-i", paths[0], "-F", "u8", "--benchmark", "--backend", "cuda"]
    air = nb_frames * 0.096

    def run():
        t0 = time.perf_counter()
        rc, text = _run_capturing_stderr(lambda: radio_cli.main(argv), echo=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0 and f"frames_read={nb_frames} desync=0" in text
              and "rs_err=0 au_err=0" in text, "the decode failed")
        return wall

    out = {"frames": nb_frames, "air_s": air, "device": torch.cuda.get_device_name(0)}
    K.reset_launches()
    out["first_wall_s"] = run()
    out["launches_per_run"] = dict(K.LAUNCHES)
    out["steady_wall_s"] = [run() for _ in range(5)]
    out["steady_rtf"] = [air / w for w in out["steady_wall_s"]]
    prof = get_profiler()
    prof.reset()
    prof.enabled = True
    out["spans_wall_s"] = run()
    prof.enabled = False
    out["spans"] = prof.table()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        out["profiled_wall_s"] = run()
    (out["device_time_ms"], out["device_busy_share"],
     out["kernels"]) = _device_profile(tp, out["profiled_wall_s"])
    out["fleet"] = measure_fleet(dev, paths)
    for k, v in out.items():
        log(f"measure: {k} = {json.dumps(v)}")
    with open(os.path.join(WORK, "measure.json"), "w") as f:
        json.dump(out, f, indent=1)


def measure_fleet(dev, paths):
    """The fleet path through FusedFleet: 16 streams x 8 frames a round, one
    cold round, then 5 warm rounds under torch.profiler, then the round's
    stop_after ladder (each prefix 3 times, fenced by a fetch of its
    digest). Needs captures of at least 6 * 8 + 1 frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel.mesh import STOP_AFTER, receiver_step
    from dab_radio_tpu_torch.params import SubchannelConfig
    cfgs = [SubchannelConfig(48 * i, 48, False, eep_type="A", eep_prot_level=2)
            for i in range(NB_SERVICES)]
    fleet = FusedFleet(FLEET_STREAMS, cfgs, 1, FLEET_K, device=dev)
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    streams = _aligned_streams(fleet, paths)
    streams = [streams[k % len(paths)] for k in range(FLEET_STREAMS)]
    nb_rounds = min(s.shape[0] - tb for s in streams) // chunk
    check(nb_rounds >= 6, f"captures hold {nb_rounds} rounds, 6 are needed")

    def round_at(r):
        return (np.stack([s[r * chunk:(r + 1) * chunk] for s in streams]),
                np.stack([s[(r + 1) * chunk:(r + 1) * chunk + tb]
                          for s in streams]))

    out = {"streams": FLEET_STREAMS, "frames_per_round": FLEET_K,
           "lanes": FLEET_LANES, "air_s_per_round": FLEET_STREAMS * FLEET_K
           * 0.096}
    K.reset_launches()
    with _FleetTimers() as timers:
        blk, tail = round_at(0)
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            for r in range(1, 6):
                blk, tail = round_at(r)
                fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fleet.flush()
        out["round_wall_s"] = timers.round_wall_s
        out["consume_s"] = timers.consume_s
        out["step_ms"] = timers.step_ms()
    out["launches"] = dict(K.LAUNCHES)
    out["warm_wall_s_per_round"] = wall / 5
    out["realtime_ensembles"] = out["air_s_per_round"] / (wall / 5)
    out["access_units"] = fleet.total_aus
    check(fleet.total_aus > 0 and min(fleet.last_fib_ok) > 0,
          "the measured fleet did not decode")
    (out["device_time_ms_per_round"], out["device_busy_share"],
     out["kernels_5_rounds"]) = _device_profile(tp, wall)
    out["device_time_ms_per_round"] /= 5

    blk, tail = (torch.as_tensor(x, device=dev) for x in round_at(1))
    ladder = {}
    for stop in STOP_AFTER[1:] + (None,):
        step, (carry, hist, _) = receiver_step(
            dev, 1, FLEET_K, subchannels_per_shard=NB_SERVICES,
            ensembles_per_shard=FLEET_STREAMS, ingest="u8",
            subchannel_cfgs=cfgs, fuse_fic=True, stop_after=stop)

        def run():
            res = step(carry, hist, blk, tail)[2]
            # the fetch of one scalar waits for the whole prefix
            float(res["digest"] if stop else res["msc_err"].sum())
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        ladder[stop or "full"] = times
    out["stop_after_ms"] = ladder
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--measure", action="store_true",
                    help="time the main path instead of checking it")
    ap.add_argument("--frames", type=int, default=50,
                    help="frames of the --measure capture")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the captures and the mesh ranks alone (with "
                         "--mesh-backend nccl: one card a rank)")
    ap.add_argument("--mesh-backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_init, args.mesh_backend)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    card_line()
    build_kernels()
    if args.measure:
        measure(dev, args.frames)
        return 0
    if args.mesh_only:
        _, sents = make_captures(dev)
        mesh_ranks(sents, args.mesh_backend)
        return 0
    phases = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        phases.append((name, time.perf_counter() - t0))
        log(f"phase {name}: {phases[-1][1]:.2f} s")
        return res

    timings = phase("kernels", check_kernels, dev)
    phase("states", check_states, dev)
    paths, sents = phase("captures", make_captures, dev)
    # each path's counts were set to 0 just before it and read just after
    launches = {"main": phase("main", main_path, dev, paths[0], sents[0]),
                "long": phase("long", long_path, dev),
                "long_tiled": phase("long_tiled", long_path, dev, "tiled"),
                "fleet": phase("fleet", fleet_path, dev, paths, sents),
                "fleet_tiled": phase("fleet_tiled", fleet_path, dev, paths,
                                     sents, "tiled"),
                "discovery": phase("discovery", discovery_path, dev, paths,
                                   sents),
                "variants": phase("variants", variants_path, dev, paths),
                "batched": phase("batched", batched_path, dev, paths, sents),
                "mesh": phase("mesh", mesh_path, dev, paths, sents)}
    log("phases: " + ", ".join(f"{n} {t:.2f} s" for n, t in phases))
    from dab_radio_tpu_torch.host.native import native_status
    log("host native libraries: " + ", ".join(
        f"{k}={v}" for k, v in native_status().items()))
    check("jax" not in sys.modules, "the port loaded jax")
    check(not any(m == "dab_radio_tpu" or m.startswith("dab_radio_tpu.")
                  for m in sys.modules), "the port loaded the JAX package")
    kernels = []
    for name in REPLACES:
        t = timings[name][REPORT_SHAPE[name]]
        path = KERNEL_PATH[name]
        check(launches[path][name] > 0,
              f"{name} was never launched on the {path} path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dab_radio_tpu_torch/csrc/viterbi_acs.cu",
            "replaces": REPLACES[name], "path": path,
            "launches": launches[path][name],
            "max_abs_err": t["max_abs_err"], "matches_plain": True,
            "shape": [t["B"], t["T"]], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
