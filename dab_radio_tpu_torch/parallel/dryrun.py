"""Dry run of the whole receiver over a mesh of ranks, held bit for bit
against the one-device decoders (port of ``__graft_entry__.py``'s
``dryrun_multichip``).

Each rank runs, with the same arguments:

    python -m dab_radio_tpu_torch.parallel.dryrun --rank R --world W \\
        --init file:///tmp/rdzv [--axis-sizes 1,2,2] [--device cpu]

or starts N such ranks on this machine (one card each when there are N
cards, else gloo on one) and waits for them:

    python -m dab_radio_tpu_torch.parallel.dryrun --spawn 4 --axis-sizes 1,2,2

A mode-II ensemble of mixed EEP-A / UEP / EEP-B subchannels (one a sub
rank), one stream an ens rank, ceil(20 / n_time) frames a time rank, goes
through ``multichip_receiver_step`` on the mesh: each rank feeds its own
rows and frame block, and decodes its own subchannels. Rank 0 gathers the
round and asserts that the FIBs that pass the CRC and the MSC payloads
after the 16-CIF deinterleaver fill equal those of the port's FICDecoder
and MSCDecoder fed the transmitted frames; it prints one line
``dryrun: {json}`` with each rank's K1 launches, step time and collectives.
A failed check raises, so the rank exits non-zero. ``Ranks`` and
``launch`` start ranks as processes and stop all of them when one fails or
time runs out.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

from . import distributed
from .mesh import (COLLECTIVES, _gather_objects, gather_round,
                   multichip_receiver_step, reset_collectives)

MODE = 2
SHAPES = [dict(length=12, is_uep=False, eep_type="A", eep_prot_level=2),
          dict(length=16, is_uep=True, uep_table_index=0),
          dict(length=21, is_uep=False, eep_type="B", eep_prot_level=1)]
WARM = 16                       # CIFs before the deinterleaver is full


def ensemble(nb_streams: int, cfgs, nb_frames: int):
    """(frame soft bits (B, F, nb_frame_bits) int8, IQ (B, F * fs)
    complex64) of nb_streams ensembles, each with one service a
    subchannel of cfgs; the same on every rank."""
    from ..models.transmitter import EnsembleTransmitter, ServiceSpec
    bits, iq = [], []
    for b in range(nb_streams):
        tx = EnsembleTransmitter(
            MODE, ensemble_id=0xC000 + b, ensemble_label=f"Mesh {b}",
            services=[ServiceSpec(0xF000 + 16 * b + s, s, f"Svc {b}.{s}", c)
                      for s, c in enumerate(cfgs)])
        fb = [tx.next_frame_bits() for _ in range(nb_frames)]
        bits.append(np.stack(fb))
        iq.append(np.concatenate([tx.modulate_frame_bits(x) for x in fb]))
    return np.stack(bits), np.stack(iq)


def check_against_decoders(frame_bits, out, cfgs, nb_data_bits, device):
    """The gathered round against FICDecoder and MSCDecoder on `device`;
    returns (FIBs compared, payloads compared)."""
    from ..dab.fic import FICDecoder
    from ..dab.msc import MSCDecoder
    from ..ops.crc import crc16_check
    from ..params import get_dab_params
    dab = get_dab_params(MODE)
    B, F = frame_bits.shape[:2]
    fic = FICDecoder(MODE, device)
    nb_fibs = 0
    for b in range(B):
        for f in range(F):
            want, _ = fic.decode_fic(frame_bits[b, f, :dab.nb_fic_bits])
            got = []
            for g in range(dab.nb_cifs):
                data = np.packbits(out["fib_bits"][b, f, g].astype(np.uint8))
                for k in range(dab.nb_fibs_per_cif):
                    fib = data[32 * k:32 * (k + 1)]
                    if crc16_check(fib):
                        got.append(bytes(fib[:30]))
            if not want or got != want:
                raise AssertionError(f"FIC of stream {b} frame {f} differs "
                                     "from FICDecoder's")
            nb_fibs += len(got)
    nb_payloads = 0
    for b in range(B):
        cifs = frame_bits[b, :, dab.nb_fic_bits:].reshape(
            F * dab.nb_cifs, dab.nb_cif_bits)
        for s, cfg in enumerate(cfgs):
            dec = MSCDecoder(cfg, device)
            for c in range(F * dab.nb_cifs):
                want = dec.decode_cif(cifs[c])
                if c < WARM:
                    continue
                got = np.packbits(out["msc_bits"][b, s, c][:nb_data_bits[s]]
                                  .astype(np.uint8)).tobytes()
                if want is None or got != want:
                    raise AssertionError(f"MSC payload of stream {b} "
                                         f"subchannel {s} CIF {c} differs "
                                         "from MSCDecoder's")
                nb_payloads += 1
    return nb_fibs, nb_payloads


def dryrun_multichip(mesh, device, frames: int = 20):
    """Run and check the dry run on this rank (see the module docstring);
    returns rank 0's report, None on the other ranks."""
    from ..kernels import viterbi_acs as K
    from ..params import SubchannelConfig
    n_ens, n_time, n_sub = mesh.axis_sizes
    f_loc = -(-frames // n_time)
    F = n_time * f_loc
    cfgs, start = [], 0
    for s in range(n_sub):
        shape = SHAPES[s % len(SHAPES)]
        cfgs.append(SubchannelConfig(start, **shape))
        start += shape["length"]
    step, (carry, hist, _) = multichip_receiver_step(
        mesh, MODE, f_loc, subchannels_per_shard=1, ensembles_per_shard=1,
        subchannel_cfgs=cfgs, device=device)
    frame_bits, iq = ensemble(n_ens, cfgs, F)
    e, t = mesh.coords["ens"], mesh.coords["time"]
    T_loc = iq.shape[1] // n_time
    pairs = iq[e:e + 1, t * T_loc:(t + 1) * T_loc].view(np.float32)
    local, row0 = distributed.host_local_iq_to_global(
        mesh, pairs.reshape(1, T_loc, 2), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    K.reset_launches()
    reset_collectives()
    t0 = time.perf_counter()
    if device.type == "cuda":
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
        start_ev.record()
    carry, hist, out = step(carry, hist, local)
    if device.type == "cuda":
        end_ev.record()
    sync()
    report = {"rank": mesh.rank, "coords": mesh.coords, "row0": row0,
              "device": str(device), "wall_s": time.perf_counter() - t0,
              "step_ms": (start_ev.elapsed_time(end_ev)
                          if device.type == "cuda" else None),
              "launches": dict(K.LAUNCHES),
              "collectives": dict(COLLECTIVES),
              "loaded_jax": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax",
                                                          "dab_radio_tpu"))}
    got = gather_round(mesh, carry, hist, out)
    reports = _gather_objects(mesh, report, 0)
    if got is None:
        return None
    nb_fibs, nb_payloads = check_against_decoders(
        frame_bits, got[2], cfgs, step.msc_nb_data_bits, device)
    kinds = [f"UEP#{c.uep_table_index}" if c.is_uep
             else f"EEP{c.eep_prot_level + 1}-{c.eep_type}" for c in cfgs]
    return {"mesh": mesh.shape, "streams": n_ens, "subchannels": kinds,
            "frames": F, "fibs": nb_fibs, "payloads": nb_payloads,
            "bit_exact": True, "ranks": reports}


def rank_command(rank: int, world: int, init: str, axis_sizes=None,
                 device: str = "cuda", backend: str = None,
                 frames: int = 20) -> list:
    """The command line of one rank of the dry run."""
    cmd = [sys.executable, "-m", "dab_radio_tpu_torch.parallel.dryrun",
           "--rank", str(rank), "--world", str(world), "--init", init,
           "--device", device, "--frames", str(frames)]
    if axis_sizes is not None:
        cmd += ["--axis-sizes", ",".join(str(a) for a in axis_sizes)]
    if backend is not None:
        cmd += ["--backend", backend]
    return cmd


class Ranks:
    """One process per command, all started at once. ``wait`` waits for
    them for up to `timeout` seconds; when one exits with an error or time
    runs out, the others are killed. It returns [(exit code, output text)]
    in command order; a killed process reads -9."""

    def __init__(self, commands, cwd: str = None, env=None):
        self.procs, self.logs = [], []
        for cmd in commands:
            log = tempfile.TemporaryFile("w+")
            self.procs.append(subprocess.Popen(
                cmd, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                text=True))
            self.logs.append(log)

    def wait(self, timeout: float):
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                if None not in codes or time.monotonic() > deadline or any(
                        c not in (None, 0) for c in codes):
                    break
                time.sleep(0.05)
        finally:
            self.kill()
        outs = []
        for p, log in zip(self.procs, self.logs):
            log.seek(0)
            outs.append((p.returncode, log.read()))
            log.close()
        return outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launch(commands, timeout: float, cwd: str = None, env=None):
    """Ranks(commands, cwd, env).wait(timeout)."""
    return Ranks(commands, cwd, env).wait(timeout)


def spawn(args, axis_sizes) -> int:
    """Run args.spawn ranks of the dry run as processes of this machine;
    print rank 0's output, and every failed rank's."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as work:
        cmds = [rank_command(r, args.spawn, f"file://{work}/rdzv",
                             axis_sizes, args.device, args.backend,
                             args.frames) for r in range(args.spawn)]
        outs = launch(cmds, 5 * args.timeout, cwd=root,
                      env=dict(os.environ, PYTHONPATH=root))
    for r, (rc, text) in enumerate(outs):
        if r == 0 or rc != 0:
            print(f"# rank {r} exited with {rc}", flush=True)
            print(text, end="", flush=True)
    return 0 if all(rc == 0 for rc, _ in outs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init", default=None,
                    help="init method of the process group, e.g. "
                         "file:///path/rdzv (default: env://)")
    ap.add_argument("--axis-sizes", default=None,
                    help="ens,time,sub (default: the factoring policy)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective may wait")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks here and wait for them")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    axis_sizes = None if args.axis_sizes is None else tuple(
        int(a) for a in args.axis_sizes.split(","))
    if args.spawn:
        return spawn(args, axis_sizes)
    distributed.initialize(args.init, args.world, args.rank, args.backend,
                           timedelta(seconds=args.timeout))
    try:
        mesh = distributed.global_receiver_mesh(axis_sizes)
        device = distributed.local_device() if args.device == "cuda" \
            else torch.device("cpu")
        report = dryrun_multichip(mesh, device, args.frames)
        if report is not None:
            report["backend"] = (torch.distributed.get_backend()
                                 if torch.distributed.is_initialized()
                                 else None)
            print("dryrun: " + json.dumps(report), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
