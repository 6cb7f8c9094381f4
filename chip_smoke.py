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
   all; the decodes run as captured programs (the FIC decode, a persistent
   decode group a protection shape), and the demodulated frames go through
   a second receiver with cuda_graph=False: every FIB and MSC payload equal,
   with each way's wall, graphs and reserved memory;
5. the long-trellis path: one 864-CU EEP 4-A subchannel (1728 kbit/s, a
   trellis of 41,478 steps) from the port's MSCEncoder, with noise, through
   the port's MSCDecoder on the card; every payload byte-exact, decoded by
   the forward and chainback kernel pair; then the same subchannel after
   set_decode_mode("tiled"): byte-exact again, one windowed launch a decode
   and the pair not at all, and the time of both decodes;
5a. the round as one program (phase graph): receiver_step captured as CUDA
   graphs (utils/graphs.py, the default on the card) beside the same step
   with cuda_graph=False, on the fleet path's 16 streams x 8 frames x 18
   services, 4 rounds (the last two without a tail, so that their program
   is captured and replayed), exact, tiled and with block_tracking: every
   output, the carry and the history bit-identical after every round; the
   demodulator's frame_step, frame_step_batch and frame_scan likewise at
   one stream and at 16; then 5 rounds of each of eager, captured,
   block_tracking eager and block_tracking captured: the step's time
   between CUDA events and the host's time to issue it, the reserved device
   memory before and after the capture; and in a child process (this script
   with --graph-profile) 5 more of each under torch.profiler: K1's launches
   from LAUNCHES beside the profiler's kernel rows (one a round either way).
   Every later phase runs captured where the port captures by default (the
   fused round of FusedFleet and fleet_serve, the frame step and scan) and
   keeps its checks: a replay adds to the launch counts what its capture
   recorded;
6. the fleet path, at full width: 16 streams of that ensemble (4 distinct
   captures, each with its own access units, carrier offset and noise)
   served by the port's fleet_serve on the card, 8 frames a round; 16
   stream lines with ensemble C0FE and 18 services, every stream's every
   subchannel's access units byte-exact, valid FIBs on every stream, and
   exactly one fused Viterbi launch a round, of 9,728 messages of 1,542
   steps; the time of each round, the device time of the round's step, the
   host's byte-layer time and the real-time ensembles they amount to; then
   the same run with the rounds staged 2 ahead (--prefetch 2): every access
   unit byte-exact, every stream line and the totals equal to the default
   run's, one fused launch a round;
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
   and one for each protection shape of the MSC; then the round program of
   MultiStreamDemodulator (dequantise, scan, masked merge) against
   cuda_graph=False on the same captures: every frame and the carry
   bit-identical, each way's step times;
11. the multi-GPU receiver on the one card: multichip_receiver_step over a
   process group of one rank (NCCL), captured with its collectives, on the
   16 streams of the fleet path, every output and the state equal to
   receiver_step's and to the same mesh step with cuda_graph=False, one
   fused launch a round, the collectives counted alike on replays, and
   FusedFleet on that mesh (captured) with every access unit byte-exact;
   then 4 rank processes on a (1, 2, 2) mesh over gloo, all on the card
   (this script with --mesh-rank): the dry run of parallel/dryrun.py,
   bit-exact against the one-device decoders with two fused launches a rank
   (FIC and MSC), then FusedFleet on that mesh over the 16 streams of the
   fleet path, every rank fed the whole round: every access unit
   byte-exact, one fused launch a round on every rank, every rank's health
   signals equal; the step's time between CUDA events, the round walls, the
   collectives' wall time and host copies; then on a (4, 1, 1) mesh of the
   same ranks MultiStreamDemodulator(mesh=) into a ReceiverFleet of the
   rank's stream, over the batched path's 4 captures: the ranks' rows are
   the 4 streams, every access unit byte-exact, K1 on every rank;
12. the closed loop through the port's own apps (phase tx): the 18-service
   ensemble with a dynamic label and a slideshow on each service's X-PAD
   from simulate_transmitter on the card, apply_frequency_shift, the port's
   ChannelModel (an echo and AWGN), then radio_app on the card (18 labels,
   no RS or AU-CRC error, non-silent audio where libavcodec is present) and
   radio_cli --scraper-enable (18 slideshows byte-equal to those sent,
   desync 0), every decode one fused K1 launch; then the modulator's two
   programs and acquisition's (null-dip search, L1) captured against
   cuda_graph=False, bit for bit;
13. ber_sweep on the card (phase ber): no lock at 2 dB, clean FIC decodes
   at 14 dB with AWGN, a guard-edge echo and clock drift, each FIC decode
   one fused K1 launch of 4 x 774;
14. the monitors (phase monitor), at the main path's width: the RS syndromes
   of rs_syndromes_device on the card for 4096 random codewords of each
   code, equal to rs_syndromes_numpy, the gate firing on the corrupted rows
   only; collect_diagnostics on the card against the CPU on the frame
   window after 6 frames of the ensemble; tui --plain on the ensemble (18
   services, state=TRACK, the five sparklines, K1 fused only, one FIC and
   at most one MSC launch a frame); webmon as a subprocess on the card
   (--device file --loop -c 9C: the ensemble in /state.json, the four
   panels of /plot.json, /device.json, /tune answering 403 and 400 and then
   retuning to 12B, /dashboard.png where matplotlib is present);
   fleet_serve --port on the fleet path's 16 streams, a client polling
   /plot.json?stream=1 from before the first round (503, then the plots of
   stream 1 with no "error"), every access unit byte-exact, one fused
   launch a round; monitor.main --frames 4 (a PNG where matplotlib is
   present);
15. the serving deployment (phase pod): the port's serve_pod with 2
   fleet_serve workers, each pinned by CUDA_VISIBLE_DEVICES (both to the
   one card), 16 streams of the ensemble each, 8 frames a round, 3 rounds,
   --port and --snapshot-dir: rc 0, both workers reporting, each worker's
   totals equal to one in-process fleet_serve on the same arguments (one
   fused launch a round), /pod.json never above the final totals, both
   snapshots loaded on the card with the summaries' counters and valid FIBs
   on all 32 streams; each worker's round walls;
16. the serving soak (phase soak): the port's soak on the card, 16 streams
   of the 18-service ensemble, 8 frames a round, 45 s, a sample every 10 s:
   ok, host RSS and the card's reserved memory within 0.15 of the first
   warm sample, access units still arriving at the end, one fused launch a
   round; the AU rate of each sample;
17. which host native libraries run as shared libraries, a JSON line of the
   kernels, then the last line {"ok": true, "device": {...}}.

Scratch files go to build/chip_smoke/ in the checkout. The times printed
here are the smoke's own; the benchmark (python3 benchmark/run.py, declared
by BENCHMARK.json) measures the port's speed.

    python3 chip_smoke.py --mesh-only --mesh-backend nccl

runs the captures and the 4 rank processes of phase 11 alone, over NCCL
with a card a rank (4 cards): there the dry run's step and the fleet's
round are captured with their collectives (the halo's send/recv, the
gathers), and the dry run replays its step once against its first call.
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
# the graph phase: the fleet path's rounds, captured and eager side by side,
# this many rounds (the last two without a tail), then this many timed
# rounds of each way
GRAPH_ROUNDS = 4
GRAPH_TIMED_ROUNDS = 5
GRAPH_PROFILE_TIMEOUT_S = 300
VARIANT_STREAMS = 2
VARIANT_K = 4
BATCHED_STREAMS = 4
BATCHED_K = 4
# the tx phase: the main path's ensemble from simulate_transmitter with
# X-PAD repeated as a carousel (the FIC announces services 12 to 18 in the
# second frame, after the first round of their X-PAD), shifted, with an
# echo (delay us, gain dB) and AWGN at SNR_DB; depth cut to 16 frames (the
# host-side channel model takes about a second a frame)
TX_FRAMES = 16
TX_SHIFT_HZ = 1200
TX_ECHO = (100.0, -6.0)
# the ber phase: ber_sweep's arguments after -M 1 --cfo 1200 -n 4
BER_RUNS = [["--snr", "2,14"], ["--snr", "14", "--echo", "240:-3"],
            ["--snr", "14", "--drift-ppm", "1"]]
# the monitor phase: RS syndromes on this many random codewords of each
# code; the diagnostics of the window after this many frames; tui --plain
# over this many frames; every wait on a served page has this deadline
MONITOR_RS_ROWS = 4096
MONITOR_DIAG_FRAMES = 6
MONITOR_TUI_FRAMES = 12
MONITOR_DEADLINE_S = 90
# the serving deployment (phase pod): serve_pod with this many fleet_serve
# workers (all on the one card), the fleet path's streams and layout a
# worker, this many rounds; the whole pod may take this long
POD_WORKERS = 2
POD_ROUNDS = 3
POD_TIMEOUT_S = 300
# while the pod serves: each worker's /state.json every POD_POLL_S (round
# walls to that resolution), /pod.json every POD_VIEW_S
POD_POLL_S = 0.1
POD_VIEW_S = 0.5
# the serving soak (phase soak): FusedFleet over a looped capture of the
# 18-service ensemble, the fleet path's streams and frames a round, sampled
# every SOAK_SAMPLE_S; memory may grow by this fraction after warm-up
SOAK_SECONDS = 45
SOAK_SAMPLE_S = 10
SOAK_MAX_GROWTH = 0.15
# the mesh dry run: 4 rank processes on the one card, one stream in 2 time
# blocks of 10 frames, 2 subchannels on 2 sub ranks; each may take this long
MESH_RANKS = 4
MESH_AXES = (1, 2, 2)
MESH_TIMEOUT_S = 300
# the older batched path on the same 4 ranks: a stream of the batched path a
# rank, over the 'ens' axis
BATCHED_MESH_AXES = (4, 1, 1)
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
    decodes_equal(dev, capture)
    return launches


def _graphs_of(programs) -> int:
    """The CUDA graphs that the programs hold (CapturedProgram.graphs)."""
    return sum(p.graphs for p in programs)


def _receiver_programs(rx):
    """A DabReceiver's programs: its FIC decode, its decode groups' and its
    channels' decoders'."""
    return ([rx.fic._program] + [g.program for g in rx._groups.values()]
            + [ch.msc._program for ch in rx.channels.values()])


def _tapped_receiver(dev, cuda_graph, record):
    """A DabReceiver on dev whose FIBs and MSC payloads go to `record`."""
    from dab_radio_tpu_torch.models.receiver import DabReceiver
    rx = DabReceiver(1, device=dev, cuda_graph=cuda_graph)
    inner = rx.fic.decode_fic

    def decode_fic(bits):
        fibs, err = inner(bits)
        record.append(("fic", fibs))
        return fibs, err
    rx.fic.decode_fic = decode_fic
    rx.on_audio_channel.append(
        lambda sid, ch: ch.events.on_frame_data.append(
            lambda p: record.append((sid, bytes(p)))))
    return rx


def _capture_frames(dev, capture):
    """The soft-bit frames of a u8 capture, from StreamingDemodulator on
    the card."""
    from dab_radio_tpu_torch.host.native import iq_convert
    from dab_radio_tpu_torch.models.demodulator import (OFDMDemodulator,
                                                        StreamingDemodulator)
    sd = StreamingDemodulator(OFDMDemodulator(1, device=dev))
    with open(capture, "rb") as f:
        return sd.process(iq_convert(f.read(), "u8"))


def decodes_equal(dev, capture):
    """The main path's FIC and MSC decodes as programs (captured, the
    default) against cuda_graph=False: the capture's frames through two
    DabReceivers, every FIB and MSC payload equal and in the same order.
    Returns, for each way, the receiver loop's wall, the graphs its
    programs hold, its decode groups and the reserved device memory before
    and after it."""
    import torch
    frames = _capture_frames(dev, capture)
    records, info = [], {}
    for way, graph in [("captured", None), ("eager", False)]:
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved(dev)
        records.append([])
        rx = _tapped_receiver(dev, graph, records[-1])
        t0 = time.perf_counter()
        for f in frames:
            rx.process_frame(f)
        torch.cuda.synchronize()
        info.setdefault(way, []).append({
            "wall_s": time.perf_counter() - t0,
            "graphs": _graphs_of(_receiver_programs(rx)),
            "groups": [len(g.decoders) for g in rx._groups.values()],
            "reserved_mb": [before / 2**20,
                            torch.cuda.memory_reserved(dev) / 2**20]})
        check(len(rx.channels) == NB_SERVICES
              and all(p.captured == (graph is None)
                      for p in _receiver_programs(rx)),
              f"{way} receiver: {len(rx.channels)} channels")
    check(all(r == records[0] for r in records),
          "the captured decodes' FIBs or payloads differ from the eager "
          "receiver's")
    nb_fib = sum(len(x) for k, x in records[0] if k == "fic")
    log(f"main path decodes: {len(frames)} frames, {nb_fib} FIBs and "
        f"{len(records[0]) - len(frames)} MSC payloads equal captured "
        f"and eager; " + json.dumps(info))
    return info


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


class _TimedProgram:
    """A fleet's program (its round, captured or eager) with CUDA events
    around each call and the kernel launches each call counted; everything
    else is the program's."""

    def __init__(self, program, timers):
        self._program, self._timers = program, timers

    def __getattr__(self, name):
        return getattr(self._program, name)

    def __call__(self, *args):
        import torch
        from dab_radio_tpu_torch.kernels import viterbi_acs as K
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
        start.record()
        out = self._program(*args)
        end.record()
        self._timers.step_events.append((start, end))
        self._timers.step_launches.append(tuple(
            {k: v - was.get(k, 0) for k, v in now.items()
             if v != was.get(k, 0)}
            for now, was in zip((K.LAUNCHES, K.ACS_LAUNCHES_BY_T), before)))
        return out


class _FleetTimers:
    """While active, times every FusedFleet round of this process: the host
    wall of process_round, CUDA events around the round's device step (the
    fleet's program: the round and the bit packing), and the host's
    byte-layer time (_consume); and counts the kernel launches of each
    round's step, replays of a captured round included."""

    def __init__(self):
        self.round_wall_s, self.consume_s, self.step_events = [], [], []
        self.step_launches = []     # per round: (kernel counts, counts by T)

    def __enter__(self):
        from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
        self._cls = FusedFleet
        self._saved = (FusedFleet.process_round, FusedFleet._consume)
        process_round, consume = self._saved
        timers = self

        def timed_round(fleet, *args, **kw):
            if not isinstance(fleet.program, _TimedProgram):
                fleet.program = _TimedProgram(fleet.program, timers)
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


def _fleet_cfgs():
    from dab_radio_tpu_torch.params import SubchannelConfig
    return [SubchannelConfig(48 * i, 48, False, eep_type="A",
                             eep_prot_level=2) for i in range(NB_SERVICES)]


def _fleet_rounds(fleet, paths):
    """The fleet path's 16 streams, aligned, as GRAPH_ROUNDS u8 rounds of
    (blk, tail) numpy: three rounds of the captures, the last two without a
    tail (the fourth repeats the third's samples on the state the third
    left), so that the tail=None program is captured and then replayed."""
    streams = _aligned_streams(fleet, paths)
    streams = [streams[k % len(paths)] for k in range(FLEET_STREAMS)]
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes

    def part(a, b):
        return np.stack([x[a:b] for x in streams])
    rounds = [(part(r * chunk, (r + 1) * chunk),
               part((r + 1) * chunk, (r + 1) * chunk + tb)) for r in range(2)]
    last = part(2 * chunk, 3 * chunk)
    return rounds + [(last, None)] * (GRAPH_ROUNDS - 2)


def _leaves(x):
    import torch
    return [t for t in torch.utils._pytree.tree_leaves(x) if t is not None]


def _same(a, b):
    import torch
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _graph_rounds_equal(dev, rounds, cfgs, **kw):
    """receiver_step eager (cuda_graph=False) and captured side by side on
    the rounds: every output (fib_bits, msc_bits, fic_err, msc_err,
    offsets), the carry and the history bit-identical after every round.
    Returns the reserved device bytes before and after the first capture."""
    import torch
    from dab_radio_tpu_torch.parallel.mesh import receiver_step
    args = dict(subchannels_per_shard=NB_SERVICES,
                ensembles_per_shard=FLEET_STREAMS, ingest="u8",
                subchannel_cfgs=cfgs, fuse_fic=True, **kw)
    eager, (c, h, _) = receiver_step(dev, 1, FLEET_K, cuda_graph=False,
                                     **args)
    graph, _ = receiver_step(dev, 1, FLEET_K, cuda_graph=True, **args)
    check(graph.captured, "receiver_step did not capture on the card")
    estate = gstate = (c, h)
    reserved = []
    for r, (blk, tail) in enumerate(rounds):
        *estate, eout = eager(*estate, blk, tail)
        if r == 0:
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev))
        *gstate, gout = graph(*gstate, blk, tail)
        if r == 0:
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(dev))
        for k in ("fib_bits", "msc_bits", "fic_err", "msc_err", "offsets"):
            check(torch.equal(eout[k], gout[k]),
                  f"graph {kw}: {k} of round {r} (tail "
                  f"{'None' if tail is None else 'given'}) differs from eager")
        check(_same(estate, gstate),
              f"graph {kw}: the state after round {r} differs from eager")
    check(graph.graphs == 2, f"{graph.graphs} programs captured, 2 expected")
    return reserved


def _graph_timed(fn, state, rounds_dev):
    """GRAPH_TIMED_ROUNDS rounds of fn (eager or captured, already warm) on
    device inputs: each round's time between CUDA events and the host's
    time to issue it (wall of the call, no synchronise)."""
    import torch
    state = list(state)
    torch.cuda.synchronize()
    events, issue = [], []
    for r in range(GRAPH_TIMED_ROUNDS):
        blk, tail = rounds_dev[r % len(rounds_dev)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        state[:] = fn(*state, blk, tail)[:2]
        issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return {"event_ms": [a.elapsed_time(b) for a, b in events],
            "issue_ms": issue}


def _graph_setups(dev, paths):
    """The steps that phase graph times: (name, way, fn, state) for exact
    and block_tracking, eager and captured, and the rounds on the card."""
    import torch
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.parallel.mesh import receiver_step
    cfgs = _fleet_cfgs()
    align = FusedFleet(1, cfgs, 1, FLEET_K, device=dev, cuda_graph=False)
    rounds = _fleet_rounds(align, paths)
    rounds_dev = [tuple(torch.as_tensor(x, device=dev) for x in r)
                  for r in rounds[:2]]
    setups = []
    for name, kw in (("exact", {}),
                     ("block_tracking", dict(block_tracking=True))):
        for way in ("eager", "captured"):
            fn, (c, h, _) = receiver_step(
                dev, 1, FLEET_K, subchannels_per_shard=NB_SERVICES,
                ensembles_per_shard=FLEET_STREAMS, ingest="u8",
                subchannel_cfgs=cfgs, fuse_fic=True,
                cuda_graph=way == "captured", **kw)
            setups.append((name, way, fn, (c, h)))
    return setups, rounds, rounds_dev


def graph_profile(dev):
    """chip_smoke.py --graph-profile: phase graph's profiled rounds, in a
    process of their own (a torch.profiler session leaves the CUDA
    profiling interface attached to the process, which the phases after it
    must not run under). For exact and block_tracking, eager and captured:
    two warm rounds (a capture), then GRAPH_TIMED_ROUNDS rounds under
    torch.profiler: K1's launches from LAUNCHES and the profiler's
    viterbi_forward rows; then the same rounds timed after the session.
    Prints one line "graph profile: {json}"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    paths = [os.path.join(WORK, f"capture{k}_{NB_FRAMES}.u8")
             for k in range(FLEET_DISTINCT)]
    setups, _, rounds_dev = _graph_setups(dev, paths)
    out = {}
    for name, way, fn, state in setups:
        state = list(state)
        for blk, tail in rounds_dev:
            state[:] = fn(*state, blk, tail)[:2]
        torch.cuda.synchronize()
        K.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            for r in range(GRAPH_TIMED_ROUNDS):
                state[:] = fn(*state, *rounds_dev[r % 2])[:2]
            torch.cuda.synchronize()
        rows = [e for e in tp.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "viterbi_forward" in e.key]
        out[f"{name} {way}"] = {
            "launches": dict(K.LAUNCHES),
            "profiler_k1_calls": sum(e.count for e in rows),
            "profiler_k1_rows": sorted(e.key[:40] for e in rows),
            "after_profiler": _graph_timed(fn, state, rounds_dev)}
    print("graph profile: " + json.dumps(out), flush=True)
    return 0


def _demod_graph_equal(dev, paths):
    """frame_step, frame_step_batch and frame_scan captured against
    cuda_graph=False at the one-stream shape (one window, FLEET_K frames a
    scan) and the batched one (the 16 streams): three chained calls each,
    every output bit-identical. Returns the one-stream frame step's host
    times, each way."""
    from dab_radio_tpu_torch.models.demodulator import (DemodCarry,
                                                        OFDMDemodulator)
    graph = OFDMDemodulator(1, device=dev)
    eager = OFDMDemodulator(1, device=dev, cuda_graph=False)
    W, A = graph.window_len, graph.frame_advance
    rows = []
    for k in range(FLEET_STREAMS):
        u8 = np.fromfile(paths[k % len(paths)], np.uint8)[
            :2 * (FLEET_K * A + W)]
        rows.append(((u8.astype(np.float32) - 127.5) / np.float32(127.5))
                    .view(np.complex64))
    rows = np.stack(rows)
    for batch, iq in (((), rows[0]), ((FLEET_STREAMS,), rows)):
        def step(d, c, f, iq=iq, batch=batch):
            fn = d.frame_step_batch if batch else d.frame_step
            return fn(c, iq[..., f * A:f * A + W])

        def scan(d, c, f, iq=iq):
            return d.frame_scan(FLEET_K, c, iq[..., :FLEET_K * A + W])
        for name, call in (("frame_step_batch" if batch else "frame_step",
                            step), ("frame_scan", scan)):
            cg = ce = DemodCarry.init(batch, device=dev)
            for f in range(3):
                og, oe = call(graph, cg, f), call(eager, ce, f)
                check(_same(og, oe), f"{name} at "
                      f"{batch or 'one stream'}, call {f}: captured differs "
                      "from eager")
                cg, ce = og[0], oe[0]
    check(graph._step_program.graphs == 2
          and graph._scan_program.graphs == 2,
          "the demodulator's programs were not captured once a shape")
    # the one-stream frame step, 20 calls each way: host wall of a call that
    # ends in the read of sync_ok, as StreamingDemodulator reads it
    times = {}
    for name, d in (("eager", eager), ("captured", graph)):
        c = DemodCarry.init(device=dev)
        took = []
        for f in range(20):
            t0 = time.perf_counter()
            c, out = d.frame_step(c, rows[0][(f % 3) * A:(f % 3) * A + W])
            bool(out["sync_ok"])
            took.append((time.perf_counter() - t0) * 1e3)
        times[name] = took[5:]
    return times


def graph_path(dev, paths):
    """Phase graph: the round as one captured program. receiver_step eager
    and captured side by side on the fleet path's 16 streams x 8 frames x
    18 services, GRAPH_ROUNDS rounds (the last two without a tail), exact,
    tiled and with block_tracking: every output and the state bit-identical
    after every round. The demodulator's frame step, batch and scan
    likewise. Then GRAPH_TIMED_ROUNDS rounds of each of eager, captured,
    block_tracking eager and block_tracking captured: the step's time
    between CUDA events and the host's time to issue it; the reserved
    device memory before and after the capture; and, in a process of its
    own (graph_profile), K1's launches from LAUNCHES beside the profiler's
    kernel rows (one a round either way)."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    setups, rounds, rounds_dev = _graph_setups(dev, paths)
    cfgs = _fleet_cfgs()
    K.reset_launches()
    for name, kw in (("exact", {}), ("tiled", dict(viterbi="tiled")),
                     ("block_tracking", dict(block_tracking=True))):
        reserved = _graph_rounds_equal(dev, rounds, cfgs, **kw)
        log(f"graph {name}: {GRAPH_ROUNDS} rounds of {FLEET_STREAMS} streams "
            f"x {FLEET_K} frames (the last two without a tail), captured "
            "bit-identical to eager in every output and the state; reserved "
            f"MB before / after the first capture = "
            f"{reserved[0] / 2**20:.1f} / {reserved[1] / 2**20:.1f}")
    launches = dict(K.LAUNCHES)
    for name, way, fn, state in setups:
        for blk, tail in rounds_dev:            # warm: the capture
            state = fn(*state, blk, tail)[:2]
        t = _graph_timed(fn, state, rounds_dev)
        log(f"graph {name} {way}: step between CUDA events ms = "
            + json.dumps([round(x, 3) for x in t["event_ms"]])
            + ", host issue ms = "
            + json.dumps([round(x, 3) for x in t["issue_ms"]]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--graph-profile"], capture_output=True, text=True,
                         timeout=GRAPH_PROFILE_TIMEOUT_S, cwd=ROOT)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("graph profile: ")]
    check(res.returncode == 0 and len(lines) == 1,
          f"graph --graph-profile: rc {res.returncode}, "
          f"{res.stderr[-3000:]}")
    kernel = "viterbi_decode_fused"
    def ms(xs):
        return json.dumps([round(x, 3) for x in xs])
    for key, p in json.loads(lines[0][len("graph profile: "):]).items():
        check(p["launches"] == launched(**{kernel: GRAPH_TIMED_ROUNDS})
              and p["profiler_k1_calls"] == GRAPH_TIMED_ROUNDS,
              f"graph {key}: K1 launches {p['launches']}, profiler rows "
              f"{p['profiler_k1_calls']} {p['profiler_k1_rows']} over "
              f"{GRAPH_TIMED_ROUNDS} rounds")
        log(f"graph {key}: K1 launches {p['launches'][kernel]} (LAUNCHES) / "
            f"{p['profiler_k1_calls']} (profiler rows "
            f"{p['profiler_k1_rows']}) over {GRAPH_TIMED_ROUNDS} rounds; "
            "after the profiler session: between CUDA events ms = "
            + ms(p["after_profiler"]["event_ms"]) + ", host issue ms = "
            + ms(p["after_profiler"]["issue_ms"]))
    step_ms = _demod_graph_equal(dev, paths)
    log("graph demod: frame_step, frame_step_batch and frame_scan captured "
        f"bit-identical to eager at one stream and {FLEET_STREAMS}; "
        "one-stream frame step host wall ms (to the read of sync_ok) eager = "
        + json.dumps([round(x, 3) for x in step_ms["eager"]])
        + ", captured = "
        + json.dumps([round(x, 3) for x in step_ms["captured"]]))
    return launches


def fleet_path(dev, paths, sents, viterbi="exact", port=0, options=()):
    """fleet_serve on 16 streams of the 18-service ensemble, 8 frames a
    round: every access unit byte-exact, one Viterbi launch a round: the
    fused kernel on 9,728 messages of 1,542 steps, or with viterbi "tiled"
    the windowed one on their 126,464 windows of 320. A port other than 0
    serves the status pages there (--port); `options` are more flags of
    fleet_serve. Returns (launch counts, stdout lines, timers)."""
    tag = "fleet path" if viterbi == "exact" else f"fleet path ({viterbi})"
    if options:
        tag += " " + " ".join(options)
    scrape = os.path.join(WORK, f"fleet_scrape_{viterbi}")
    shutil.rmtree(scrape, ignore_errors=True)
    order = [k % len(paths) for k in range(FLEET_STREAMS)]
    layout = ",".join(f"{48 * i}:48:EEP3A" for i in range(NB_SERVICES))
    argv = ["-i", *[paths[k] for k in order], "--subchannels", layout,
            "--frames-per-step", str(FLEET_K), "--scraper-output", scrape,
            "--viterbi", viterbi, "--backend", "cuda", *options]
    if port:
        argv += ["--port", str(port)]
        tag += " --port"
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
    return launches, lines, timers


FLEET_OPTIONS = ("--prefetch", "2")


def fleet_phase(dev, paths, sents):
    """Phase fleet: the fleet path as fleet_serve runs it by default, then
    once more with the rounds staged 2 ahead by the feeder (FLEET_OPTIONS):
    every access unit byte-exact again, every stream line and the totals
    equal to the default run's, one fused launch a round. Returns both
    runs' launches."""
    launches, lines, _ = fleet_path(dev, paths, sents)
    more, lines_opt, _ = fleet_path(dev, paths, sents, options=FLEET_OPTIONS)
    check(lines_opt == lines,
          f"fleet_serve {' '.join(FLEET_OPTIONS)}: stream lines or totals "
          f"differ from the default run's: {lines_opt[-1]} against "
          f"{lines[-1]}")
    return {k: launches[k] + more[k] for k in launches}


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
            # a captured step's outputs are its buffers: keep copies
            outs.append({k: v.clone() for k, v in out.items()})
        return outs, times

    K.reset_launches()
    want, base_s = run()
    launches = dict(K.LAUNCHES)
    check(launches == launched(viterbi_decode_fused=2),
          f"the default step launched {launches}")
    log(f"variants path: {VARIANT_STREAMS} streams x {VARIANT_K} frames, "
        f"{lanes} lanes of 1542 steps, captured (the first round is the "
        "eager warm-up and the capture, the second a replay); default step "
        "(K1) " + json.dumps([round(x, 4) for x in base_s]) + " s")
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
            "loops over the trellis, no kernel, captured as one graph)")
    check(dict(K.LAUNCHES) == launches,
          f"a variant launched a kernel: {dict(K.LAUNCHES)}")
    return launches


def _drive_batched(ms, fleet, paths):
    """Push each capture of `paths` into the stream of its index that `ms`
    (MultiStreamDemodulator, fetch_bits off) holds, and step until nothing
    comes, feeding the frames to `fleet` (ReceiverFleet of ms's rows) a
    frame a receiver a round. Returns ({(global stream, subchannel): [AU
    bytes]}, demodulator step seconds, process_frames seconds, {T: K1
    launches} of each round)."""
    import torch
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    lo, hi = ms.rows
    got = {}
    for k, rx in enumerate(fleet.receivers):
        def on_channel(sub_id, ch, _b=lo + k):
            aus = got.setdefault((_b, sub_id), [])
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: aus.append(bytes(au)))
        rx.on_audio_channel.append(on_channel)
    for b in range(lo, hi):
        ms.push(b, np.fromfile(paths[b], np.uint8))
    step_s, round_s, per_round = [], [], []
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
                (later if i in seen else now).append((i - lo, b))
                seen.add(i)
            before = dict(K.ACS_LAUNCHES_BY_T)
            t0 = time.perf_counter()
            fleet.process_frames(now)
            round_s.append(time.perf_counter() - t0)
            per_round.append({T: n - before.get(T, 0)
                              for T, n in K.ACS_LAUNCHES_BY_T.items()
                              if n != before.get(T, 0)})
            res = [(i + lo, b) for i, b in later]
    fleet.flush()
    torch.cuda.synchronize()
    return got, step_s, round_s, per_round


def _check_batched_aus(got, sents, streams):
    """Every subchannel of each of `streams` has access units, a run of
    those sent, byte for byte; returns their count."""
    nb_aus = 0
    for k in streams:
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
    return nb_aus


def batched_path(dev, paths, sents):
    """The older batched path: 4 distinct captures through
    MultiStreamDemodulator (u8 ingest, 4 frames a step, soft bits kept on
    the card) into ReceiverFleet (pipeline depth 2). Every access unit
    byte-exact, no desync, and each round one fused launch for the stacked
    FIC (16 x 774) and one for each protection shape of the MSC (here one:
    288 x 1542). Returns the launch counts of this path."""
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    N = BATCHED_STREAMS
    ms = MultiStreamDemodulator(OFDMDemodulator(1, device=dev), N,
                                frames_per_step=BATCHED_K, ingest="u8",
                                fetch_bits=False, device=dev)
    fleet = ReceiverFleet(N, 1, pipeline_depth=2, device=dev)
    K.reset_launches()
    t_all = time.perf_counter()
    got, step_s, round_s, per_round = _drive_batched(ms, fleet, paths[:N])
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
    for k in range(N):
        check(len(fleet.receivers[k].channels) == NB_SERVICES,
              f"stream {k}: {len(fleet.receivers[k].channels)} channels")
    nb_aus = _check_batched_aus(got, sents, range(N))
    air = frames * 0.096
    log(f"batched path: streams={N} frames={frames} rounds={len(round_s)} "
        f"access_units={nb_aus} (all byte-exact) desync=0 wall={wall:.3f} s "
        f"for {air:.3f} s of air: real-time ensembles = {air / wall:.3f}; "
        f"launches={launches} by T={dict(K.ACS_LAUNCHES_BY_T)}")
    log("batched path: demodulator step s = "
        + json.dumps([round(x, 4) for x in step_s])
        + ", process_frames round s = "
        + json.dumps([round(x, 4) for x in round_s])
        + f"; graphs: demodulator {ms.program.graphs}, fleet FIC "
        f"{fleet._fic_decode.graphs}, decode groups "
        f"{_graphs_of(g.program for g in fleet._groups.values())}")
    multistream_equal(dev, paths)
    return launches


def multistream_equal(dev, paths):
    """MultiStreamDemodulator's round captured (the default) against
    cuda_graph=False on the batched path's captures: the same frames (bits
    kept on the card) bit for bit and the same carry; each way's step
    times and the reserved memory."""
    import torch
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    runs, info = {}, {}
    for way, graph in (("captured", None), ("eager", False)):
        ms = MultiStreamDemodulator(
            OFDMDemodulator(1, device=dev), BATCHED_STREAMS,
            frames_per_step=BATCHED_K, ingest="u8", fetch_bits=False,
            device=dev, cuda_graph=graph)
        for b in range(BATCHED_STREAMS):
            ms.push(b, np.fromfile(paths[b], np.uint8))
        frames, steps = [], []
        while True:
            t0 = time.perf_counter()
            res = ms.step()
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if not res:
                break
            frames += res
        runs[way] = frames, ms.carry
        info[way] = {"step_s": steps, "graphs": ms.program.graphs,
                     "reserved_mb": torch.cuda.memory_reserved(dev) / 2**20}
        check(ms.program.captured == (graph is None), f"{way} round program")
    (a, ca), (b, cb) = runs["captured"], runs["eager"]
    check([i for i, _ in a] == [i for i, _ in b] and len(a) >= BATCHED_STREAMS
          * (NB_FRAMES - 3)
          and all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
          and all(torch.equal(x, y) for x, y in zip(ca, cb)),
          "the captured batched round's frames or carry differ from eager")
    log(f"batched round program: {len(a)} frames bit-identical captured and "
        f"eager, carry equal; " + json.dumps(info))


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
        eager, (c3, h3, _) = M.multichip_receiver_step(
            mesh, 1, FLEET_K, device=dev, cuda_graph=False, **kw)
        check(backend != "nccl" or (many.captured and fleet.program.captured),
              "the mesh step over NCCL is not captured")
        step_ms, one_ms, eager_ms, launches = [], [], [], []
        calls = {"captured": [], "eager": []}
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
            n0 = M.COLLECTIVES["calls"]
            (c2, h2, o2), ms = _events_ms(lambda: many(c2, h2, blk, tail))
            launches.append(dict(K.LAUNCHES))
            step_ms.append(ms)
            calls["captured"].append(M.COLLECTIVES["calls"] - n0)
            n0 = M.COLLECTIVES["calls"]
            (c3, h3, o3), ms = _events_ms(lambda: eager(c3, h3, blk, tail))
            eager_ms.append(ms)
            calls["eager"].append(M.COLLECTIVES["calls"] - n0)
            (c1, h1, o1), ms = _events_ms(lambda: one(c1, h1, blk, tail))
            one_ms.append(ms)
            for k in o1:
                check(torch.equal(o1[k], o2[k]) and torch.equal(o3[k], o2[k]),
                      f"mesh step's {k} of round {r} differs from "
                      "receiver_step's or the eager mesh step's")
            check(all(torch.equal(a, b) and torch.equal(a, e)
                      for a, b, e in zip(c1, c2, c3))
                  and torch.equal(h1, h2) and torch.equal(h3, h2),
                  f"mesh step's state after round {r} differs")
            fleet.process_round(blk, tail_u8=tail)
        check(all(n == launched(viterbi_decode_fused=1) for n in launches),
              f"the mesh step did not launch K1 once a round: {launches}")
        check(calls["captured"] == calls["eager"] and min(calls["eager"]) > 0,
              f"collectives counted a round, captured and eager: {calls}")
        coll = dict(M.COLLECTIVES)
        graphs = {"step": many.graphs, "fleet": fleet.program.graphs}
        nb_aus = _check_fleet_aus(aus, sents, "mesh fleet")
    finally:
        distributed.shutdown()
    log(f"mesh world 1 ({backend}): {FLEET_STREAMS} streams x "
        f"{FLEET_K} frames, {len(step_ms)} rounds equal to receiver_step in "
        f"every output and the state; FusedFleet on the mesh: {nb_aus} "
        f"access units byte-exact; K1 a round {launches[-1]}; mesh step "
        f"captured ms = {json.dumps([round(x, 3) for x in step_ms])}, eager "
        f"ms = {json.dumps([round(x, 3) for x in eager_ms])}, receiver_step "
        f"ms = {json.dumps([round(x, 3) for x in one_ms])}; collectives "
        f"{json.dumps(coll)}, calls a round {json.dumps(calls)}; graphs "
        f"{json.dumps(graphs)}")
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
        fleet_launches = dict(K.LAUNCHES)
        ms_report = _batched_on_mesh(dev, paths)
        report = {"rank": rank, "coords": mesh.coords, "device": str(dev),
                  "rows": fleet.rows, "launches": fleet_launches,
                  "captured": fleet.program.captured,
                  "graphs": fleet.program.graphs,
                  "batched": ms_report,
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


def _batched_on_mesh(dev, paths):
    """On a mesh rank: MultiStreamDemodulator(mesh=) over a
    BATCHED_MESH_AXES mesh of the same ranks, this rank's stream of the
    batched path's captures, into a ReceiverFleet of it (as batched_path,
    4 frames a step, pipeline depth 2). Returns this rank's rows, K1
    launches, access units, desync count and wall time."""
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.fleet import ReceiverFleet
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    from dab_radio_tpu_torch.parallel import mesh as M
    t0 = time.perf_counter()
    ms = MultiStreamDemodulator(
        OFDMDemodulator(1, device=dev), BATCHED_STREAMS,
        frames_per_step=BATCHED_K, ingest="u8", fetch_bits=False, device=dev,
        mesh=M.make_receiver_mesh(axis_sizes=BATCHED_MESH_AXES))
    fleet = ReceiverFleet(ms.B, 1, pipeline_depth=2, device=dev)
    K.reset_launches()
    got, _, round_s, _ = _drive_batched(ms, fleet, paths)
    return {"rows": ms.rows, "launches": dict(K.LAUNCHES),
            "by_t": dict(K.ACS_LAUNCHES_BY_T), "aus": got,
            "desync": int(ms.carry.total_desync.sum()),
            "frames": fleet.total_frames, "rounds": len(round_s),
            "wall_s": time.perf_counter() - t0}


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
    nccl = backend == "nccl"
    for r in ranks:
        check(r["launches"] == launched(viterbi_decode_fused=2),
              f"rank {r['rank']} launched {r['launches']} in the dry run")
        # over NCCL the dry run's step is captured and replayed once
        check(r["captured"] == nccl and r["replay_equal"] in (None, True),
              f"rank {r['rank']}'s dry-run step: captured {r['captured']}, "
              f"replay equal {r['replay_equal']}")
        check(not r["loaded_jax"], f"rank {r['rank']} loaded {r['loaded_jax']}")
    nb_rounds = (NB_FRAMES - 1) // FLEET_K
    leaders = [p for p in fleet if p["aus"] is not None]
    check([p["rank"] for p in leaders] == [0], f"leaders {leaders}")
    nb_aus = _check_fleet_aus(leaders[0]["aus"], sents, "mesh ranks' fleet")
    for p in fleet:
        check(p["launches"] == launched(viterbi_decode_fused=nb_rounds),
              f"rank {p['rank']} launched {p['launches']} in the fleet")
        check(p["captured"] == nccl and p["graphs"] == (1 if nccl else 0),
              f"rank {p['rank']}'s fleet: captured {p['captured']}, "
              f"{p['graphs']} graphs")
        check(p["health"] == fleet[0]["health"] and p["health"][2] == nb_rounds
              and min(p["health"][1]) > 0,
              f"rank {p['rank']}'s health {p['health']} is not rank 0's "
              f"{fleet[0]['health']}")
    # the batched path on the (4, 1, 1) mesh: a stream a rank
    rows = sorted(p["batched"]["rows"] for p in fleet)
    check(rows == [(b, b + 1) for b in range(BATCHED_STREAMS)],
          f"the ranks' rows {rows} are not the {BATCHED_STREAMS} streams")
    nb_batched = 0
    for p in fleet:
        q = p["batched"]
        check(q["launches"] == launched(
            viterbi_decode_fused=sum(q["by_t"].values()))
            and set(q["by_t"]) == {774, 1542},
              f"rank {p['rank']}'s batched path launched {q['launches']} "
              f"by T {q['by_t']}")
        check(q["desync"] == 0 and q["frames"] >= NB_FRAMES - 3,
              f"rank {p['rank']}'s batched path: desync {q['desync']}, "
              f"{q['frames']} frames")
        nb_batched += _check_batched_aus(q["aus"], sents, range(*q["rows"]))
    log(f"mesh {MESH_RANKS} ranks ({backend}, devices "
        f"{sorted({p['device'] for p in fleet})}), wall of the launch "
        f"{wall:.2f} s. Dry run: mesh {report['mesh']} subchannels "
        f"{report['subchannels']} frames {report['frames']}: "
        f"{report['fibs']} FIBs and {report['payloads']} payloads bit-exact "
        f"against FICDecoder / MSCDecoder. FusedFleet on the mesh: "
        f"{FLEET_STREAMS} streams x {FLEET_K} frames a round, {nb_rounds} "
        f"rounds, {nb_aus} access units byte-exact, every rank's health "
        f"equal (fib_ok {fleet[0]['health'][1]})")
    log(f"mesh batched path: MultiStreamDemodulator(mesh={BATCHED_MESH_AXES})"
        f" into ReceiverFleet, a stream a rank: {nb_batched} access units "
        "byte-exact, desync 0; rank: rows, K1 by T, frames, wall s = "
        + json.dumps([(p["batched"]["rows"], p["batched"]["by_t"],
                       p["batched"]["frames"],
                       round(p["batched"]["wall_s"], 3)) for p in fleet]))
    for r, p in zip(ranks, fleet):
        log(f"  rank {r['rank']} {r['coords']}: dry run K1 {r['launches']}, "
            f"captured {r['captured']} (replay equal {r['replay_equal']}), "
            f"step {r['step_ms']} ms between events, wall {r['wall_s']:.4f} "
            f"s, collectives {json.dumps(r['collectives'])}; fleet K1 "
            f"{p['launches']}, captured {p['captured']} ({p['graphs']} "
            f"graphs), round walls "
            f"{json.dumps([round(x, 4) for x in p['round_wall_s']])} s, "
            f"collectives {json.dumps(p['collectives'])}")
    return fleet[0]["launches"]


def mesh_path(dev, paths, sents):
    """The multi-GPU receiver on the one card: see the module docstring.
    Returns the launch counts of rank 0's fleet."""
    mesh_world1(dev, paths, sents)
    return mesh_ranks(sents)


def _run_app(main, argv, stdin_path=None, stdout_path=None):
    """main(argv) in this process with sys.stdin and sys.stdout on files (a
    file's bytes go to and come from their .buffer, as in a pipe)."""
    import io
    saved = sys.stdin, sys.stdout
    files = []
    try:
        if stdin_path:
            files.append(open(stdin_path, "rb"))
            sys.stdin = io.TextIOWrapper(files[-1])
        if stdout_path:
            files.append(open(stdout_path, "wb"))
            sys.stdout = io.TextIOWrapper(files[-1], write_through=True)
        return main(argv)
    finally:
        sys.stdout.flush()
        sys.stdin, sys.stdout = saved
        for f in files:
            f.close()


def tx_path(dev):
    """The closed loop through the port's own apps, at full width: the
    18-service ensemble with a dynamic label and a slideshow on every
    service's X-PAD from simulate_transmitter on the card, then
    apply_frequency_shift, then the port's ChannelModel (an echo and AWGN),
    then radio_app on the card (18 labels; non-silent audio where
    libavcodec is present, silence where it is not) and radio_cli
    --scraper-enable (18 slideshows byte-equal to those sent, desync 0).
    K1 runs every decode, one fused launch each. Returns the launch counts
    of the phase."""
    import wave
    from dab_radio_tpu_torch.apps import (apply_frequency_shift, radio_app,
                                          radio_cli)
    from dab_radio_tpu_torch.apps import simulate_transmitter as st
    from dab_radio_tpu_torch.host.native import (iq_convert, iq_quantize_u8,
                                                 native_status)
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.models.channel import ChannelModel, EchoTap
    clean, shifted, cap = (os.path.join(WORK, f"tx_{n}.u8")
                           for n in ("clean", "shifted", "channel"))
    wav = os.path.join(WORK, "radio.wav")
    scrape = os.path.join(WORK, "scrape_tx")
    shutil.rmtree(scrape, ignore_errors=True)
    K.reset_launches()
    walls = {}
    t0 = time.perf_counter()
    check(_run_app(st.main, ["--payload", "ensemble", "--services",
                             str(NB_SERVICES), "--slideshow",
                             "--pad-carousel", "-n", str(TX_FRAMES), "-F",
                             "u8", "--backend", "cuda"],
                   stdout_path=clean) == 0,
          "simulate_transmitter failed")
    check(os.path.getsize(clean) == TX_FRAMES * 2 * 196608,
          f"simulate_transmitter wrote {os.path.getsize(clean)} bytes")
    walls["simulate_transmitter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(_run_app(apply_frequency_shift.main,
                   ["-f", str(TX_SHIFT_HZ), "--backend", "cuda"],
                   clean, shifted) == 0, "apply_frequency_shift failed")
    walls["apply_frequency_shift"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    iq = ChannelModel(taps=[EchoTap(delay_us=TX_ECHO[0], gain_db=TX_ECHO[1])],
                      snr_db=SNR_DB, seed=SEED).apply(
        iq_convert(open(shifted, "rb").read(), "u8"))
    with open(cap, "wb") as f:
        f.write(iq_quantize_u8((iq / np.abs(iq).max() * 0.5
                                ).astype(np.complex64)))
    walls["channel"] = time.perf_counter() - t0
    launches_tx = dict(K.LAUNCHES)

    t0 = time.perf_counter()
    rc, err = _run_capturing_stderr(lambda: radio_app.main(
        ["--device", "file", "-i", cap, "--backend", "cuda", "--audio-out",
         wav]), echo=False)
    walls["radio_app"] = time.perf_counter() - t0
    check(rc == 0, f"radio_app returned {rc}")
    labels = {ln.strip() for ln in err.splitlines() if "label: " in ln}
    want = {f"label: Now: Radio TPU {i + 1}" for i in range(NB_SERVICES)}
    check(labels == want, f"radio_app's labels {sorted(labels)}")
    final = err[err.rindex("ensemble: id="):]
    subs = re.findall(r"subchannel \d+: .* rs_err=(\d+) au_err=(\d+)", final)
    check(len(subs) == NB_SERVICES and all(x == ("0", "0") for x in subs),
          f"radio_app's channels: {final[:600]!r}")
    with wave.open(wav, "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) \
        if pcm.size else 0.0
    codecs = native_status()["dabcodecs"]
    if codecs == "unavailable":
        # the AAC core decodes through libavcodec (host/codecs.py); without
        # it no channel decodes PCM, and the mixer writes silence
        check(rms == 0.0, f"sound without an AAC decoder (RMS {rms:.1f})")
    else:
        check(rms > 100, f"radio_app's WAV is silent (RMS {rms:.1f})")
    by_t_app = dict(K.ACS_LAUNCHES_BY_T)

    t0 = time.perf_counter()
    rc, err = _run_capturing_stderr(lambda: radio_cli.main(
        ["-i", cap, "-F", "u8", "--backend", "cuda", "--scraper-enable",
         "--scraper-output", scrape]), echo=False)
    walls["radio_cli"] = time.perf_counter() - t0
    check(rc == 0, f"radio_cli returned {rc}")
    m = re.search(r"demod: frames_read=(\d+) desync=(\d+)", err)
    check(m and int(m.group(2)) == 0, "radio_cli lost sync on the capture")
    for i in range(NB_SERVICES):
        d = os.path.join(scrape, f"service_{0xF123 + i:X}_component_0")
        path = os.path.join(d, f"card_{i}.png")
        check(os.path.exists(path)
              and open(path, "rb").read() == st._test_card_png(i),
              f"service {i + 1}: slideshow card_{i}.png missing or altered")
        check(f"Now: Radio TPU {i + 1}" in open(
            os.path.join(d, "labels.txt")).read().splitlines(),
              f"service {i + 1}: no label in the scraper's labels.txt")
    launches = dict(K.LAUNCHES)
    by_t = dict(K.ACS_LAUNCHES_BY_T)
    check(launches_tx == launched(), f"the transmitter ran K1: {launches_tx}")
    check(set(by_t) == {774, 1542} and set(by_t_app) == {774, 1542}
          and launches == launched(viterbi_decode_fused=sum(by_t.values())),
          f"tx phase launches {launches} by T {by_t} (radio_app {by_t_app})")
    frames = int(m.group(1))
    log(f"tx path: {NB_SERVICES} services x {TX_FRAMES} frames with X-PAD, "
        f"shift {TX_SHIFT_HZ} Hz, echo {TX_ECHO[0]} us {TX_ECHO[1]} dB, "
        f"SNR {SNR_DB} dB; radio_app: {len(labels)} labels, 0 RS/AU "
        f"errors, WAV {pcm.size} samples RMS {rms:.1f} (dabcodecs {codecs}), "
        f"real-time factor {frames * 0.096 / walls['radio_app']:.3f}; "
        f"radio_cli: {NB_SERVICES} slideshows byte-equal, desync 0, "
        f"{frames} frames; K1 {launches} by T {by_t} (radio_app "
        f"{by_t_app}); walls s = "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    modulator_equal(dev)
    return launches


def modulator_equal(dev):
    """The modulator's programs and acquisition's (captured, the default)
    against cuda_graph=False: modulate_frame on one frame and on a batch of
    two, modulate_reference_bytes, and the null-dip search and L1 level
    over the frames' IQ, 3 calls each (2 replays), bit for bit."""
    import torch
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.modulator import OFDMModulator
    mods = {g: OFDMModulator(1, dev, cuda_graph=g) for g in (None, False)}
    demods = {g: OFDMDemodulator(1, device=dev, cuda_graph=g)
              for g in (None, False)}
    p = mods[None].params
    rng = np.random.default_rng(SEED)
    ms = {g: [] for g in mods}
    for shape in ((), (2,), (), (2,), (), (2,)):
        bits = rng.integers(0, 2, shape + (p.nb_data_symbols,
                                           2 * p.nb_data_carriers)
                            ).astype(np.uint8)
        data = rng.integers(0, 256, p.nb_data_symbols * p.nb_data_carriers
                            // 4).astype(np.uint8)
        out = {}
        for g, mod in mods.items():
            out[g], t = _events_ms(lambda: mod.modulate_frame(bits))
            ms[g].append(t)
        check(torch.equal(out[None], out[False]),
              "captured modulate_frame differs from eager")
        check(np.array_equal(mods[None].modulate_reference_bytes(data),
                             mods[False].modulate_reference_bytes(data)),
              "captured modulate_reference_bytes differs from eager")
        iq = out[None].reshape(-1)
        W = demods[None].window_len
        for lo in ((0, p.nb_null_period, W // 2) if shape else ()):
            win = iq[lo:lo + W]
            l1 = [demods[g].l1(win) for g in demods]
            acq = [demods[g].acquire(win, x) for g, x in zip(demods, l1)]
            check(torch.equal(*l1) and all(torch.equal(a, b)
                                           for a, b in zip(*acq)),
                  "captured acquisition differs from eager")
    graphs = {"modulate_frame": mods[None]._bits_program.graphs,
              "modulate_reference_bytes": mods[None]._bytes_program.graphs,
              "acquire": demods[None]._acquire_program.graphs,
              "l1": demods[None]._l1_program.graphs}
    check(graphs == {"modulate_frame": 2, "modulate_reference_bytes": 1,
                     "acquire": 1, "l1": 1}, f"graphs {graphs}")
    log(f"modulator and acquisition programs: equal captured and eager; "
        f"modulate_frame ms between events captured "
        f"{json.dumps([round(x, 3) for x in ms[None]])}, eager "
        f"{json.dumps([round(x, 3) for x in ms[False]])}; graphs "
        + json.dumps(graphs))


def ber_path(dev):
    """ber_sweep on the card, mode I, 4 frames, CFO 1200 Hz: SNR 2 and
    14 dB, then 14 dB with a guard-edge echo and with 1 ppm of clock
    drift. No lock at 2 dB; at 14 dB at least 3 locked frames, every FIC
    group decoded without a byte error and every FIB's CRC good, and a raw
    BER under 1e-2 where the channel is flat (the guard-edge echo's
    frequency-selective fading leaves about 2e-2 for the Viterbi decoder to
    correct). Each FIC decode is one fused K1 launch of 4 x 774. Returns the
    launch counts of the phase."""
    import io
    from dab_radio_tpu_torch.apps import ber_sweep
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    K.reset_launches()
    rows = []
    for extra in BER_RUNS:
        out, saved = io.StringIO(), sys.stdout
        sys.stdout = out
        try:
            rc = ber_sweep.main(["-M", "1", "--cfo", "1200", "-n", "4",
                                 "--backend", "cuda"] + extra)
        finally:
            sys.stdout = saved
        check(rc == 0, f"ber_sweep {extra} returned {rc}")
        lines = out.getvalue().splitlines()
        cols = lines[0].split(",")
        for ln in lines[1:]:
            log(f"ber_sweep {' '.join(extra)}: {ln}")
            rows.append((" ".join(extra), dict(zip(cols, ln.split(",")))))
    check(len(rows) == 4, f"ber_sweep printed {len(rows)} rows")
    for name, r in rows:
        if float(r["snr_db"]) == 2.0:
            check(int(r["locked_frames"]) == 0, f"{name}: locked at 2 dB")
            continue
        check(int(r["locked_frames"]) >= 3
              and float(r["vit_byte_err"]) == 0.0
              and float(r["fib_crc_rate"]) == 1.0,
              f"{name}: the 14 dB row is not clean: {r}")
        if "--echo" not in name:
            check(float(r["raw_ber"]) < 1e-2, f"{name}: raw BER {r}")
    launches, by_t = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
    check(set(by_t) == {774} and launches == launched(
        viterbi_decode_fused=by_t[774]),
          f"ber phase launches {launches} by T {by_t}")
    log(f"ber path: K1 {launches} by T {by_t}")
    return launches


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _free_ports(n):
    """A port p with p, ..., p + n - 1 all free on 127.0.0.1."""
    import socket
    while True:
        base = _free_port()
        socks = [socket.socket() for _ in range(n)]
        try:
            for k, sock in enumerate(socks):
                sock.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()


def _http(base, path, data=None, headers=None, timeout=30):
    """(status, body bytes) of a GET (or a POST of data) to base + path."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _wait_json(base, path, cond, proc=None, what=""):
    """The JSON at base + path once cond(it) holds; fails after
    MONITOR_DEADLINE_S, or as soon as proc has ended."""
    import urllib.error
    deadline = time.time() + MONITOR_DEADLINE_S
    got = None
    while time.time() < deadline:
        check(proc is None or proc.poll() is None,
              f"{what}: the process ended with {proc and proc.poll()}")
        try:
            status, body = _http(base, path, timeout=5)
            if status == 200:
                got = json.loads(body)
                if cond(got):
                    return got
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.1)
    raise RuntimeError(f"chip_smoke: {what}: no answer by the deadline; "
                       f"last {str(got)[:300]}")


def _check_plot(plot, what):
    """The four panels of a /plot.json payload: at least 128 finite points
    each, a constellation of mean radius above 0.3, no "error"."""
    check("error" not in plot, f"{what}: {plot.get('error')}")
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        check(len(plot.get(k, ())) >= 128 and np.isfinite(plot[k]).all(),
              f"{what}: panel {k}")
    con = np.asarray(plot.get("constellation", []), np.float64)
    check(con.ndim == 2 and con.shape[0] >= 128 and np.isfinite(con).all(),
          f"{what}: constellation of shape {con.shape}")
    radius = float(np.hypot(con[:, 0], con[:, 1]).mean())
    check(radius > 0.3, f"{what}: constellation mean radius {radius}")
    return radius


def _monitor_rs(dev):
    """rs_syndromes_device on the card for MONITOR_RS_ROWS random codewords
    of each code against rs_syndromes_numpy, exact; the gate fires on the
    encoded rows with a corrupted byte and on no other."""
    import torch
    from dab_radio_tpu_torch.ops import rs
    rng = np.random.default_rng(SEED)
    for nroots, pad in ((10, 135), (16, 51)):
        n = 255 - pad
        cw = rng.integers(0, 256, (MONITOR_RS_ROWS, n)).astype(np.uint8)
        x = torch.from_numpy(cw).to(dev)
        got = rs.rs_syndromes_device(x, nroots, pad)
        check(got.device == x.device and got.dtype == torch.uint8
              and tuple(got.shape) == (MONITOR_RS_ROWS, nroots),
              f"RS({n}): syndromes {got.dtype} {tuple(got.shape)} on "
              f"{got.device}")
        check(np.array_equal(got.cpu().numpy(),
                             rs.rs_syndromes_numpy(cw, nroots, pad)),
              f"RS({n}): the card's syndromes differ from numpy's")
        enc = rs.rs_encode(cw[:, :n - nroots], nroots, pad)
        bad = enc.copy()
        rows = [3, 1000, MONITOR_RS_ROWS - 1]
        bad[3, 7] ^= 0x55
        bad[1000, 0] ^= 0x80
        bad[MONITOR_RS_ROWS - 1, n - 1] ^= 0x01
        clean = rs.rs_syndromes_device(torch.from_numpy(enc).to(dev), nroots,
                                       pad).any(-1)
        fired = rs.rs_syndromes_device(torch.from_numpy(bad).to(dev), nroots,
                                       pad).any(-1)
        check(not bool(clean.any()) and torch.nonzero(fired).flatten()
              .tolist() == rows, f"RS({n}): the gate fired on "
              f"{torch.nonzero(fired).flatten().tolist()}, not {rows}")
        ms = _cuda_ms(lambda: rs.rs_syndromes_device(x, nroots, pad), 20)
        log(f"monitor: rs_syndromes_device RS({n},{n - nroots}) on "
            f"{MONITOR_RS_ROWS} codewords equal to rs_syndromes_numpy "
            f"(exact), gate on rows {rows} only; {ms:.4f} ms between CUDA "
            f"events")


def _monitor_diagnostics(dev, capture):
    """collect_diagnostics on the card against its run on the CPU, on the
    last_window of a StreamingDemodulator that ran MONITOR_DIAG_FRAMES
    frames of the capture on the card."""
    from types import SimpleNamespace
    from dab_radio_tpu_torch.apps import monitor
    from dab_radio_tpu_torch.host.native import iq_convert
    from dab_radio_tpu_torch.models.demodulator import (OFDMDemodulator,
                                                        StreamingDemodulator)
    demod = OFDMDemodulator(1, device=dev)
    sd = StreamingDemodulator(demod)
    nb = 0
    with open(capture, "rb") as f:
        while nb < MONITOR_DIAG_FRAMES:
            raw = f.read(1 << 19)
            check(raw, f"fewer than {MONITOR_DIAG_FRAMES} frames locked")
            nb += len(sd.process(iq_convert(raw, "u8")))
    c = sd.carry
    carry = SimpleNamespace(freq_coarse=float(c.freq_coarse),
                            freq_fine=float(c.freq_fine))
    window = sd.last_window
    gpu, ms = _events_ms(lambda: monitor.collect_diagnostics(demod, window,
                                                             carry))
    cpu = monitor.collect_diagnostics(OFDMDemodulator(1, device="cpu"), window,
                                      carry)
    errs = {}
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        a, b = (10.0 ** (np.asarray(d[k], np.float64) / 20.0)
                for d in (cpu, gpu))
        errs[k] = float(np.abs(a - b).max() / a.max())
        check(gpu[k].dtype == np.float32 and errs[k] <= 1e-4,
              f"diagnostics {k}: {errs[k]} of the max")
    con = cpu["constellation"]
    errs["constellation"] = float(np.abs(gpu["constellation"] - con).max()
                                  / np.abs(con).mean())
    check(errs["constellation"] <= 1e-4,
          f"diagnostics constellation: {errs['constellation']} of the mean")
    d = np.abs(gpu["bits"].astype(np.int32) - cpu["bits"].astype(np.int32))
    errs["bits_max"], errs["bits_off"] = int(d.max()), float((d > 0).mean())
    check(d.max() <= 1 and (d > 0).mean() <= 1e-4,
          f"diagnostics bits: {errs['bits_off']} off, by up to {d.max()}")
    errs["mer_db"] = abs(gpu["mer_db"] - cpu["mer_db"])
    check(errs["mer_db"] <= 0.05 and gpu["mer_db"] > 10.0,
          f"diagnostics MER {gpu['mer_db']} dB on the card, "
          f"{cpu['mer_db']} dB on the CPU")
    est = monitor.estimate_mer_db(demod, window)
    log(f"monitor: collect_diagnostics on the card against the CPU after "
        f"{nb} frames: " + json.dumps({k: float(f"{v:.3g}") for k, v in
                                       errs.items()})
        + f" (limits 1e-4, 1e-4, 1 LSB on 1e-4, 0.05 dB); mer_db "
        f"{gpu['mer_db']:.2f} dB, estimate_mer_db {est:.2f} dB; "
        f"{ms:.3f} ms between CUDA events (fetches included)")
    return gpu, sd.carry


def _monitor_tui(capture):
    """tui --plain in this process on the capture: the dashboard's markers,
    and K1's launches (fused only: one FIC and one MSC decode a frame)."""
    import contextlib
    import io
    from dab_radio_tpu_torch.apps import tui
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    out = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tui.main(["-i", capture, "-F", "u8", "--plain", "--max-frames",
                       str(MONITOR_TUI_FRAMES), "--backend", "cuda"])
    wall = time.perf_counter() - t0
    launches, by_t = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
    check(rc == 0, f"tui returned {rc}")
    text = out.getvalue()
    last = text[text.rindex("DAB-Radio TPU"):]
    frames = int(re.search(r"mode I\s+(\d+) frames", last).group(1))
    missing = [m for m in ["state=TRACK", "aus=", "constellation",
                           "fine-time impulse", "coarse-freq corr",
                           "null symbol PSD", "data symbol PSD",
                           "sampling buffer"]
               + [f"'Radio TPU {i + 1} " for i in range(NB_SERVICES)]
               if m not in last]
    check(not missing and frames == MONITOR_TUI_FRAMES,
          f"tui: {frames} frames, missing {missing}")
    check(set(by_t) == {774, 1542} and by_t[774] == frames
          and 0 < by_t[1542] <= frames
          and launches == launched(viterbi_decode_fused=sum(by_t.values())),
          f"tui launches {launches} by T {by_t} over {frames} frames")
    log(f"monitor: tui --plain: {frames} frames, {NB_SERVICES} services, "
        f"state=TRACK, 5 sparklines; K1 {launches} by T {by_t}; "
        f"wall {wall:.3f} s")
    return launches


def _start_webmon(capture):
    """webmon on the card as a subprocess on a free port: (process, base
    URL, stderr path)."""
    port = _free_port()
    err = os.path.join(WORK, "webmon.err")
    with open(err, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dab_radio_tpu_torch.apps.webmon", "-i",
             capture, "-F", "u8", "--port", str(port), "--device", "file",
             "--loop", "-c", "9C", "--backend", "cuda"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.DEVNULL, stderr=f)
    return proc, f"http://127.0.0.1:{port}", err


def _monitor_webmon(proc, base, has_mpl):
    """The served pages of webmon: the ensemble, the plots, the tuner and
    a retune, the dashboard PNG where matplotlib is present."""
    def ensemble(frames):
        return lambda s: s.get("ensemble", {}).get("id") == "C0FE" \
            and len(s.get("services", [])) == NB_SERVICES \
            and s.get("frames", 0) >= frames
    t0 = time.perf_counter()
    state = _wait_json(base, "/state.json", ensemble(6), proc, "webmon")
    t_found = time.perf_counter() - t0
    status, body = _http(base, "/plot.json", timeout=60)
    check(status == 200, f"webmon /plot.json answered {status}")
    radius = _check_plot(json.loads(body), "webmon /plot.json")
    status, body = _http(base, "/device.json")
    dev = json.loads(body)
    check((dev["device"], dev["channel"], dev["freq_hz"])
          == ("FileDevice", "9C", 206352000), f"webmon /device.json {dev}")
    tune = b'{"channel": "12B"}'
    foreign = _http(base, "/tune", tune, {"Origin": "http://evil.example"})[0]
    unknown = _http(base, "/tune", b'{"channel": "99Z"}')[0]
    check((foreign, unknown) == (403, 400),
          f"webmon /tune: {foreign} for a foreign Origin, {unknown} for 99Z")
    status, body = _http(base, "/tune", tune)
    tuned = json.loads(body) if status == 200 else {}
    check(status == 200 and (tuned["channel"], tuned["freq_hz"])
          == ("12B", 225648000), f"webmon /tune 12B: {status} {tuned}")
    t0 = time.perf_counter()
    _wait_json(base, "/state.json", ensemble(4), proc, "webmon after 12B")
    t_refound = time.perf_counter() - t0
    if has_mpl:
        status, png = _http(base, "/dashboard.png", timeout=60)
        check(status == 200 and png[:4] == b"\x89PNG" and len(png) > 10_000,
              f"webmon /dashboard.png: {status}, {len(png)} bytes")
        dash = f"/dashboard.png {len(png)} bytes"
    else:
        dash = ("/dashboard.png not asked: matplotlib is absent (it draws "
                "the PNG)")
    log(f"monitor: webmon on the card: ensemble C0FE, {NB_SERVICES} services, "
        f"{state['frames']} frames after {t_found:.2f} s; /plot.json four "
        f"panels, constellation mean radius {radius:.3f}; /device.json "
        f"FileDevice 9C 206352000; /tune 403 (foreign Origin), 400 (99Z), "
        f"12B re-found after {t_refound:.2f} s; {dash}")


def _monitor_fleet(dev, paths, sents):
    """fleet_path with --port: a client polls /plot.json?stream=1 from
    before the first round until it gets a 200 (503 before, then the plots
    of stream 1 with no "error")."""
    import threading
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    answered, done, polled = threading.Event(), threading.Event(), {}

    def poll():
        deadline = time.time() + MONITOR_DEADLINE_S
        while not done.is_set() and time.time() < deadline:
            try:
                status, body = _http(base, "/plot.json?stream=1", timeout=5)
                polled.setdefault("first", status)
                answered.set()
                if status == 200:
                    polled["plot"] = json.loads(body)
                    return
            except OSError:
                pass
            time.sleep(0.02)

    process_round = FusedFleet.process_round

    def gated(fleet, *a, **kw):
        # the plot is built after a round that follows a request: hold the
        # first round until the poll has been answered once
        if fleet.total_rounds == 0:
            check(answered.wait(MONITOR_DEADLINE_S),
                  "fleet_serve --port: /plot.json never answered")
        return process_round(fleet, *a, **kw)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    FusedFleet.process_round = gated
    try:
        launches = fleet_path(dev, paths, sents, port=port)[0]
    finally:
        FusedFleet.process_round = process_round
        done.set()
        th.join(timeout=10)
    check(not th.is_alive(), "the /plot.json poll did not end")
    plot = polled.get("plot")
    check(polled.get("first") == 503 and plot is not None,
          f"fleet_serve /plot.json: first answer {polled.get('first')}, "
          f"then {'a payload' if plot else 'none'}")
    check(plot.get("stream") == 1 and plot.get("rounds", 0) >= 1,
          f"fleet_serve /plot.json: stream {plot.get('stream')}, rounds "
          f"{plot.get('rounds')}")
    radius = _check_plot(plot, "fleet_serve /plot.json")
    log(f"monitor: fleet_serve --port: /plot.json?stream=1 answered 503 "
        f"first, then stream 1 after round {plot['rounds']}: four panels, "
        f"mer_db {plot.get('mer_db')}, constellation mean radius "
        f"{radius:.3f}, no error")
    return launches


def _monitor_main(capture, has_mpl):
    """monitor.main --frames 4 on the capture: rc 0, and a PNG where
    matplotlib is present (without it the diagnostics are checked and no
    PNG is drawn)."""
    from dab_radio_tpu_torch.apps import monitor
    png = os.path.join(WORK, "monitor.png")
    if os.path.exists(png):
        os.remove(png)
    drawn = []
    render = monitor.render_dashboard
    if not has_mpl:
        monitor.render_dashboard = lambda diag, carry, out: drawn.append(diag)
    try:
        rc, _ = _run_capturing_stderr(lambda: monitor.main(
            ["-i", capture, "--frames", "4", "-o", png, "--backend", "cuda"]),
            echo=False)
    finally:
        monitor.render_dashboard = render
    check(rc == 0, f"monitor returned {rc}")
    if has_mpl:
        size = os.path.getsize(png) if os.path.exists(png) else 0
        check(size > 10_000, f"monitor's PNG has {size} bytes")
        log(f"monitor: monitor.main --frames 4: rc 0, PNG {size} bytes")
    else:
        check(len(drawn) == 1 and not os.path.exists(png)
              and all(np.isfinite(drawn[0][k]).all() for k in
                      ("impulse_db", "freq_response_db", "spectrum_db")),
              "monitor: the diagnostics it would draw")
        log("monitor: monitor.main --frames 4: rc 0; no PNG: matplotlib is "
            "absent (the diagnostics it would draw are finite)")


def monitor_path(dev, paths, sents):
    """Phase monitor, at the main path's width (the 18-service capture
    paths[0], the fleet's 16 streams): rs_syndromes_device on the card;
    collect_diagnostics on the card against the CPU; tui --plain in
    process (K1 counted); webmon as a subprocess on the card (started
    first, so that its start overlaps the in-process checks); fleet_serve
    --port with a /plot.json poll; monitor.main. Returns the K1 launches of
    tui and of fleet_serve."""
    import importlib.util
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"monitor: matplotlib {'present' if has_mpl else 'absent'}")
    split = {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        split[name] = round(time.perf_counter() - t0, 3)
        return out

    proc, base, err = _start_webmon(paths[0])
    try:
        part("rs", _monitor_rs, dev)
        part("diagnostics", _monitor_diagnostics, dev, paths[0])
        tui_launches = part("tui", _monitor_tui, paths[0])
        part("webmon", _monitor_webmon, proc, base, has_mpl)
    except Exception:
        with open(err, "rb") as f:
            sys.stderr.write(f.read()[-3000:].decode(errors="replace"))
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    fleet_launches = part("fleet_serve", _monitor_fleet, dev, paths, sents)
    part("monitor", _monitor_main, paths[0], has_mpl)
    log("monitor: split s = " + json.dumps(split))
    return {k: tui_launches[k] + fleet_launches[k] for k in tui_launches}


def _poll_pod(proc, port, base):
    """While the pod runs: /pod.json's pod counters (every POD_VIEW_S), and
    the times at which each worker's /state.json first showed each round
    count (its rounds counter goes up when a round is dispatched; every
    POD_POLL_S). Each request takes a worker's interpreter lock from its
    serving loop for a moment, hence the modest rates."""
    import urllib.error
    views, seen = [], [{} for _ in range(POD_WORKERS)]
    deadline = time.time() + POD_TIMEOUT_S
    next_view = 0.0
    while proc.poll() is None and time.time() < deadline:
        for k in range(POD_WORKERS):
            try:
                status, body = _http(f"http://127.0.0.1:{base + k}",
                                     "/state.json", timeout=2)
                rounds = json.loads(body).get("totals", {}).get("rounds", 0)
                seen[k].setdefault(rounds, time.perf_counter())
            except (urllib.error.URLError, ConnectionError, OSError,
                    ValueError):
                pass
        if time.time() >= next_view:
            next_view = time.time() + POD_VIEW_S
            try:
                status, body = _http(f"http://127.0.0.1:{port}", "/pod.json",
                                     timeout=5)
                views.append(json.loads(body)["pod"])
            except (urllib.error.URLError, ConnectionError, OSError,
                    ValueError):
                pass
        time.sleep(POD_POLL_S)
    return views, seen


def pod_path(dev, paths, sents):
    """Phase pod: the port's serve_pod with 2 fleet_serve workers, each
    pinned by CUDA_VISIBLE_DEVICES (both to card 0 here), each serving the
    fleet path's 16 streams of paths[0] (--shared-input) with the 18-entry
    layout, 8 frames a round, 3 rounds, --port and --snapshot-dir. Checks
    rc 0 and both workers reporting, each worker's totals against one
    in-process fleet_serve on the same arguments, /pod.json (polled while
    serving) never above the workers' final totals, and both snapshots
    loaded on the card against the summaries. Returns the K1 launches of
    the in-process run (the workers are other processes: their launches
    are not counted here)."""
    import pickle
    import signal
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    layout = ",".join(f"{48 * i}:48:EEP3A" for i in range(NB_SERVICES))
    args = ["-i", paths[0], "--subchannels", layout, "--frames-per-step",
            str(FLEET_K), "--max-rounds", str(POD_ROUNDS), "--backend",
            "cuda"]
    snaps = os.path.join(WORK, "pod_snapshots")
    shutil.rmtree(snaps, ignore_errors=True)
    base, port = _free_ports(POD_WORKERS), _free_port()
    err = os.path.join(WORK, "pod.err")
    t0 = time.perf_counter()
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dab_radio_tpu_torch.tools.serve_pod",
             "--workers", str(POD_WORKERS), "--streams-per-worker",
             str(FLEET_STREAMS), "--base-port", str(base), "--port",
             str(port), "--snapshot-dir", snaps, *args],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=f, text=True)
    try:
        views, seen = _poll_pod(proc, port, base)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)   # the pod passes it on
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
    wall = time.perf_counter() - t0
    with open(err) as f:
        err_text = f.read()
    if proc.returncode != 0:
        sys.stderr.write(err_text[-3000:])
    check(proc.returncode == 0, f"serve_pod returned {proc.returncode}")
    pod = json.loads(out.strip().splitlines()[-1])
    check(pod["metric"] == "pod_serving"
          and pod["workers_reporting"] == POD_WORKERS,
          f"pod: {pod}")
    import torch
    name = torch.cuda.get_device_name(0)
    for k in range(POD_WORKERS):
        check(f"# worker {k}: pid=" in err_text
              and re.search(rf"^# worker {k}: .*card 0 \({re.escape(name)},"
                            r" CUDA_VISIBLE_DEVICES=[^)]+\)$", err_text,
                            re.M),
              f"worker {k} not pinned to card 0: {err_text[:600]}")
    totals = {}
    for m in re.finditer(r"^# worker (\d+): (\{.*\})$", err_text, re.M):
        row = json.loads(m.group(2))
        if "access_units" in row:
            totals[int(m.group(1))] = row
    check(sorted(totals) == list(range(POD_WORKERS)),
          f"worker totals {totals}")
    # one fleet_serve in this process on the same arguments
    lines, _, timers, launches, by_t, ref_wall = _serve(
        args + ["--shared-input", "--streams", str(FLEET_STREAMS)])
    ref = lines[-1]
    check(ref["access_units"] > 0 and ref["rounds"] == POD_ROUNDS
          and all(row["fib_ok"] > 0 for row in lines[:-1]),
          f"in-process fleet_serve: {ref}, fib_ok "
          f"{[row['fib_ok'] for row in lines[:-1]]}")
    check(launches == launched(viterbi_decode_fused=POD_ROUNDS)
          and by_t == {1542: POD_ROUNDS},
          f"in-process fleet_serve launches {launches} by T {by_t}")
    for k, row in totals.items():
        check(row == ref, f"worker {k} totals {row} against {ref}")
    for key in ("rounds", "access_units", "streams"):
        check(pod[key] == POD_WORKERS * ref[key], f"pod {key}: {pod}")
    check(views, "/pod.json never answered")
    over = [v for v in views if any(v[key] > pod[key] for key in
                                    ("rounds", "access_units", "streams"))]
    check(not over, f"/pod.json above the final totals: {over[:3]}")
    fib_ok = 0
    for k in range(POD_WORKERS):
        with open(os.path.join(snaps, f"worker{k}.snap"), "rb") as f:
            fleet = FusedFleet.from_snapshot(pickle.load(f)["fleet"], dev)
        check(fleet.device.type == "cuda" and fleet.N == FLEET_STREAMS
              and (fleet.total_rounds, fleet.total_aus)
              == (ref["rounds"], ref["access_units"]),
              f"worker {k} snapshot: N {fleet.N}, rounds "
              f"{fleet.total_rounds}, AUs {fleet.total_aus}, against {ref}")
        check(fleet.summary() == {key: ref[key] for key in fleet.summary()},
              f"worker {k} snapshot summary {fleet.summary()}")
        fib_ok += int((np.asarray(fleet.last_fib_ok) > 0).sum())
    check(fib_ok == POD_WORKERS * FLEET_STREAMS,
          f"valid FIBs on {fib_ok} of {POD_WORKERS * FLEET_STREAMS} "
          "streams")
    air = FLEET_STREAMS * FLEET_K * 0.096
    walls = []
    for k in range(POD_WORKERS):
        t = [seen[k][r] for r in sorted(seen[k]) if r >= 1]
        walls.append([round(b - a, 4) for a, b in zip(t, t[1:])])
    log(f"pod: {POD_WORKERS} workers on card 0 ({name}), "
        f"{FLEET_STREAMS} streams each, {POD_ROUNDS} rounds of {FLEET_K} "
        f"frames: {pod}; each worker's totals equal the in-process "
        f"fleet_serve's ({ref['access_units']} AUs, {ref_wall:.3f} s); "
        f"snapshots loaded on the card, valid FIBs on {fib_ok} streams; "
        f"/pod.json answered {len(views)} times, at most "
        f"{max(v['rounds'] for v in views)} rounds, "
        f"{max(v['access_units'] for v in views)} AUs; pod wall "
        f"{wall:.3f} s")
    log(f"pod: per-worker round walls s (between the first sightings of "
        f"rounds 1, 2, 3 in /state.json, polled every {POD_POLL_S} s) = "
        + json.dumps(walls) + "; the in-process run's (alone on the card) "
        "= "
        + json.dumps([round(x, 4) for x in timers.round_wall_s]))
    warm = [w[-1] for w in walls if w]
    if len(warm) == POD_WORKERS:
        log(f"pod: real-time ensembles a worker (last wall) = "
            f"{json.dumps([round(air / w, 3) for w in warm])}, the pod "
            f"{sum(air / w for w in warm):.3f}")
    return launches


def soak_path(dev):
    """Phase soak: the port's soak on the card, in this process: 16 streams
    of the 18-service ensemble, 8 frames a round, 45 s, a sample every 10 s;
    ok, RSS and reserved device memory within 0.15 of the first warm sample,
    access units still arriving in the last window, and one fused K1
    launch a round."""
    import contextlib
    import io
    import tempfile
    from dab_radio_tpu_torch.kernels import viterbi_acs as K
    from dab_radio_tpu_torch.tools import soak
    out = io.StringIO()
    saved = tempfile.tempdir
    tempfile.tempdir = WORK               # the soak's capture is kept there
    K.reset_launches()
    try:
        with contextlib.redirect_stdout(out):
            rc = soak.main(["--seconds", str(SOAK_SECONDS), "--sample-s",
                            str(SOAK_SAMPLE_S), "--streams",
                            str(FLEET_STREAMS), "--services",
                            str(NB_SERVICES),
                            "--frames-per-step", str(FLEET_K),
                            "--max-rss-growth", str(SOAK_MAX_GROWTH),
                            "--backend", "cuda"])
    finally:
        tempfile.tempdir = saved
    launches, by_t = dict(K.LAUNCHES), dict(K.ACS_LAUNCHES_BY_T)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rc == 0 and res["ok"], f"soak: rc {rc}, {res}")
    rounds = res["total_rounds"]
    reserved = res.get("cuda_reserved_growth")
    check(res["rss_growth"] <= SOAK_MAX_GROWTH and reserved is not None
          and reserved <= SOAK_MAX_GROWTH
          and res["samples"][-1]["au_rate"] > 0,
          f"soak: RSS growth {res['rss_growth']}, reserved growth "
          f"{reserved}, last AU rate {res['samples'][-1]['au_rate']}")
    check(launches == launched(viterbi_decode_fused=rounds)
          and by_t == {1542: rounds},
          f"soak: {rounds} rounds, launches {launches} by T {by_t}")
    log(f"soak: {res['seconds']} s, {FLEET_STREAMS} streams x {FLEET_K} "
        f"frames a round: rounds={rounds} access_units={res['total_aus']} "
        f"rss_growth={res['rss_growth']} "
        f"cuda_reserved_growth={reserved} "
        f"launches={launches}")
    for x in res["samples"]:
        log("soak: sample " + json.dumps(x))
    log("soak: AU rate a sample = "
        + json.dumps([x["au_rate"] for x in res["samples"]]))
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the captures and the mesh ranks alone (with "
                         "--mesh-backend nccl: one card a rank)")
    ap.add_argument("--mesh-backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--graph-profile", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_init, args.mesh_backend)
    import torch
    if args.graph_profile:
        return graph_profile(torch.device("cuda", 0))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    card_line()
    build_kernels()
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
                "graph": phase("graph", graph_path, dev, paths),
                "fleet": phase("fleet", fleet_phase, dev, paths, sents),
                "fleet_tiled": phase("fleet_tiled", lambda: fleet_path(
                    dev, paths, sents, "tiled")[0]),
                "discovery": phase("discovery", discovery_path, dev, paths,
                                   sents),
                "variants": phase("variants", variants_path, dev, paths),
                "batched": phase("batched", batched_path, dev, paths, sents),
                "mesh": phase("mesh", mesh_path, dev, paths, sents),
                "tx": phase("tx", tx_path, dev),
                "ber": phase("ber", ber_path, dev),
                "monitor": phase("monitor", monitor_path, dev, paths, sents),
                "pod": phase("pod", pod_path, dev, paths, sents),
                "soak": phase("soak", soak_path, dev)}
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
