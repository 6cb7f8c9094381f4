"""Serve N ensembles through the fused one-round-per-call receiver, on a
CUDA GPU or the CPU (port of ``dab_radio_tpu/apps/fleet_serve.py``, same
flags, stdout JSON lines and stderr notes).

The multi-ensemble analog of radio_cli: each input stream (its own raw-IQ
file, or one file shared by every stream with --shared-input) is decoded
by the FusedFleet: demod + FIC + deinterleave + MSC Viterbi as one device
round, the host doing only the byte layer. Subchannel layouts come from
--subchannels or from a dynamic-discovery pass over the first frames of
each stream (the deployment flow). Cold-start alignment is automatic per
stream. --backend picks the device (default cuda; raises without a GPU).

Usage:
  python -m dab_radio_tpu_torch.apps.fleet_serve -i a.u8 b.u8 c.u8 --discover
  python -m dab_radio_tpu_torch.apps.fleet_serve -i cap.u8 --streams 16 \
      --shared-input --subchannels 0:48:EEP3A,48:48:EEP3A
  rtl_sdr ... | python -m dab_radio_tpu_torch.apps.fleet_serve -i - --discover

`-i -` decodes a LIVE stream from stdin (the reference's pipe topology)
with constant memory: one round + tail buffered.

Prints one JSON summary line per stream plus a fleet total. With --port,
/state.json serves the live status and /plot.json one stream's OFDM plots.
--profile-trace PATH turns the stage profiler on (``utils/profiler.py``):
at the end its table goes to stderr and its spans to PATH as a Chrome
trace, and /state.json adds the table, the programs' capture and replay
counts (``utils/graphs.py:GRAPH_STATS``) and the MP2 frames the byte layer
produced (``models/fused_fleet.py:MP2_STATS``).
SIGINT stops serving at the next round boundary and ends as at the end of
the input (stream lines, totals, --snapshot-out; exit code 0); a second
SIGINT ends the process at once.
"""

import argparse
import json
import pickle
import signal
import sys
import threading
import time

import numpy as np

from ..host.native import IQ_FORMATS
from ..params import SubchannelConfig
from ..utils.backend import add_backend_flag, apply_backend


def parse_subchannels(spec: str):
    """"start:lenCU:PROT[:KIND],..." where PROT is EEP<n>A, EEP<n>B or
    UEP<idx>, and the optional KIND is audio (default), mp2, or
    packet@<address>[+fec]. Returns (cfgs, kinds) for FusedFleet."""
    cfgs, kinds = [], []
    for part in spec.split(","):
        fields = part.strip().split(":")
        start, length, prot = fields[:3]
        prot = prot.upper()
        if prot.startswith("UEP"):
            cfgs.append(SubchannelConfig(int(start), int(length), True,
                                         uep_table_index=int(prot[3:])))
        elif prot.startswith("EEP") and prot[-1] in "AB":
            cfgs.append(SubchannelConfig(
                int(start), int(length), False, eep_type=prot[-1],
                eep_prot_level=int(prot[3:-1]) - 1))
        else:
            raise ValueError(f"--subchannels: unknown protection {prot!r}")
        kind = fields[3].lower() if len(fields) > 3 else "audio"
        if kind.startswith("packet@"):
            addr = kind[len("packet@"):]
            fec = addr.endswith("+fec")
            kinds.append(("packet", int(addr[:-4] if fec else addr),
                          1 if fec else 0))
        elif kind in ("audio", "mp2"):
            kinds.append(kind)
        else:
            raise ValueError(f"--subchannels: unknown kind {kind!r}")
    return cfgs, kinds


def _load_u8(path: str, fmt: str) -> np.ndarray:
    """Load an IQ capture as the fused round's u8 ingest format. u8
    files map straight in; other formats (incl. WAV) read through the
    shared IQReader in bounded blocks and requantize (the exact
    read-path inverse, so a u8 round trip is lossless). WAV reads honor
    the data chunk's declared size (trailing metadata chunks are not
    decoded as IQ)."""
    if fmt == "u8":
        return np.fromfile(path, dtype=np.uint8)
    from ..host.io import IQReader
    from ..host.native import iq_quantize_u8
    BLOCK = 1 << 24        # bound the transient raw+complex64 working set
    out = []
    with open(path, "rb") as f:
        reader = IQReader(f, fmt)
        f.seek(reader.data_offset)
        remaining = reader.data_size or None
        while True:
            want = BLOCK if remaining is None else min(BLOCK, remaining)
            if want == 0:
                break
            raw = f.read(want)
            if not raw:
                break
            if remaining is not None:
                remaining -= len(raw)
            out.append(np.frombuffer(
                iq_quantize_u8(reader.convert(raw)), dtype=np.uint8))
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def _warn_if_clipped(u8: np.ndarray, name: str):
    """Mis-scaled captures hard-clip 8-bit IQ: FIC still decodes (phase
    survives) but MSC silently dies, so warn up front (host/io.py's
    IQReader tracks the same signal for the streaming apps)."""
    from ..host.io import u8_saturation
    sat = u8_saturation(u8)
    if sat > 0.02:
        print(f"# WARNING: {name}: {sat:.0%} of IQ samples at full scale "
              "— capture is clipping (MSC decode will fail)",
              file=sys.stderr)


def _discover(iq: np.ndarray, mode: int, device, max_frames: int = 8):
    """Dynamic pass over the first frames -> DabReceiver."""
    from ..host.native import iq_convert
    from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
    from ..models.receiver import DabReceiver
    demod = OFDMDemodulator(mode, device=device)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(mode, device=device)
    need = (max_frames + 2) * demod.params.nb_frame_samples * 2
    for bits in sd.process(iq_convert(iq[:need].tobytes(), "u8")):
        rx.process_frame(bits)
    return rx


def _start_status_server(port: int):
    """Serving observability: a daemon-thread HTTP server exposing
    /state.json (per-stream ensembles/services + fleet totals), rebuilt
    by the serving loop after every round, and /plot.json?stream=K (one
    stream's OFDM plots, built by _maybe_build_plot after a round that
    follows a request; 503 with Retry-After until the first build). The
    handler only ever reads prebuilt bytes blobs, so there is no
    cross-thread fleet access."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    box = {"json": b"{}", "plot": None, "plot_wanted": 0.0,
           "plot_built": 0.0, "plot_stream": 0}
    page = (b"<!doctype html><title>fleet_serve</title>"
            b"<body style='background:#111;color:#ddd;font-family:monospace'>"
            b"<h3>fleet_serve live status</h3>"
            b"stream <input id=k value=0 size=3>"
            b"<div><canvas id=p_imp width=440 height=140></canvas>"
            b"<canvas id=p_spec width=440 height=140></canvas>"
            b"<canvas id=p_con width=280 height=140></canvas></div>"
            b"<pre id=s>loading...</pre>"
            b"<script>"
            b"function line(id,d){const cv=document.getElementById(id),"
            b"ctx=cv.getContext('2d');ctx.fillStyle='#181818';"
            b"ctx.fillRect(0,0,cv.width,cv.height);if(!d||!d.length)return;"
            b"let lo=Math.min(...d),hi=Math.max(...d);if(hi-lo<1e-6)hi=lo+1;"
            b"ctx.strokeStyle='#6cf';ctx.beginPath();"
            b"for(let i=0;i<d.length;i++){const x=i/(d.length-1)*cv.width;"
            b"const y=cv.height-2-(d[i]-lo)/(hi-lo)*(cv.height-4);"
            b"i?ctx.lineTo(x,y):ctx.moveTo(x,y)}ctx.stroke()}"
            b"function sc(id,p){const cv=document.getElementById(id),"
            b"ctx=cv.getContext('2d');ctx.fillStyle='#181818';"
            b"ctx.fillRect(0,0,cv.width,cv.height);ctx.fillStyle='#fc6';"
            b"for(const[re,im]of(p||[])){const x=cv.width/2+re*cv.width/5;"
            b"const y=cv.height/2-im*cv.height/5;"
            b"if(x>=0&&x<cv.width&&y>=0&&y<cv.height)ctx.fillRect(x,y,2,2)}}"
            b"async function t(){const r=await fetch('/state.json');"
            b"document.getElementById('s').textContent="
            b"JSON.stringify(await r.json(),null,2)}"
            b"async function pl(){try{const k=document.getElementById('k')"
            b".value|0;const r=await fetch('/plot.json?stream='+k);"
            b"if(r.ok){const j=await r.json();line('p_imp',j.impulse_db);"
            b"line('p_spec',j.spectrum_db);sc('p_con',j.constellation)}}"
            b"catch(e){}setTimeout(pl,1000)}"
            b"t();setInterval(t,2000);pl()</script>")

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                body, ctype = page, "text/html"
            elif path == "/state.json":
                body, ctype = box["json"], "application/json"
            elif path == "/plot.json":
                # lazy: the serving loop only computes plot payloads
                # while someone is actually watching (it costs one
                # frame's diagnostics on the device a round)
                try:
                    q = self.path.split("?", 1)[1] if "?" in self.path \
                        else ""
                    for kv in q.split("&"):
                        if kv.startswith("stream="):
                            box["plot_stream"] = max(int(kv[7:]), 0)
                except ValueError:
                    pass
                box["plot_wanted"] = time.time()
                blob = box["plot"]
                if blob is None:
                    self.send_response(503)
                    self.send_header("Retry-After", "1")
                    self.end_headers()
                    return
                body, ctype = blob, "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                   # quiet
            pass

    try:
        srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    except OSError as e:
        # Observability must not kill the decode worker: a taken port
        # (port collision in a pod, stale listener after a restart) loses
        # the live view, not the serving. Final totals still land on
        # stdout, which is the authoritative record.
        print(f"# status port {port} unavailable ({e}); serving without "
              f"live /state.json", file=sys.stderr)
        return None, None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, box


def _maybe_build_plot(fleet, box, blk_u8):
    """Serve-side live plots (webmon /plot.json parity for the fused
    path): when a browser asked for /plot.json since the last build,
    recompute one frame's OFDM diagnostics for the requested stream from
    the round block just fed to the device, on the fleet's device.
    blk_u8: (N, round_bytes) or (round_bytes,) uint8, host or a tensor the
    feeder staged. Lazy by design: zero cost while nobody is watching."""
    if box is None or box["plot_wanted"] <= box["plot_built"]:
        return
    try:
        import torch
        from .monitor import collect_diagnostics, plot_payload
        from ..host.native import iq_convert
        from ..models.demodulator import OFDMDemodulator
        from types import SimpleNamespace
        k = min(box["plot_stream"], fleet.N - 1)
        row = blk_u8 if blk_u8.ndim == 1 else blk_u8[k]
        if not hasattr(fleet, "_plot_demod"):
            fleet._plot_demod = OFDMDemodulator(fleet._mode,
                                                device=fleet.device)
        d = fleet._plot_demod
        need = 2 * d.window_len
        if row.shape[0] < need:
            return
        row = row[:need]
        if torch.is_tensor(row):          # a round staged by the feeder
            row = row.cpu().numpy()
        window = iq_convert(np.ascontiguousarray(row).tobytes(),
                            "u8")[:d.window_len]
        # the carry lives on the fleet's device: fetch it through the host
        fleet_carry = fleet.carry
        fc = fleet_carry.freq_coarse.cpu().numpy().reshape(fleet.N, -1)
        ff = fleet_carry.freq_fine.cpu().numpy().reshape(fleet.N, -1)
        carry = SimpleNamespace(freq_coarse=float(fc[k, 0]),
                                freq_fine=float(ff[k, 0]))
        out = plot_payload(collect_diagnostics(d, window, carry))
        out["stream"] = int(k)
        out["rounds"] = int(fleet.total_rounds)
        box["plot"] = json.dumps(out).encode()
    except Exception as e:                    # plots must never kill serving
        box["plot"] = json.dumps({"error": str(e)}).encode()
    box["plot_built"] = time.time()


def _stream_rows(fleet):
    return [{
        "stream": k,
        "ensemble": f"{rx.db.ensemble.id:04X}",
        "label": rx.db.ensemble.label,
        "services": {f"{sid:04X}": svc.label
                     for sid, svc in sorted(rx.db.services.items())},
        # signal health from the last materialized round: valid FIB count
        # (zero = desynced) and the measured fine-time drift in samples
        "fib_ok": int(fleet.last_fib_ok[k]),
        "drift": int(fleet.drift_correction[k]),
    } for k, rx in enumerate(fleet.receivers)]


def _totals(fleet, args, pcm_out):
    summ = fleet.summary()
    if args.audio:
        summ["pcm_samples"] = pcm_out[0]
    return summ


def _status_blob(fleet, args, pcm_out) -> bytes:
    state = {"streams": _stream_rows(fleet),
             "totals": _totals(fleet, args, pcm_out)}
    if args.profile_trace:
        from ..models.fused_fleet import MP2_STATS
        from ..utils.graphs import GRAPH_STATS
        from ..utils.profiler import get_profiler
        # per-stage totals in microseconds, as webmon's /state.json has them
        state["profiler"] = {
            k: {m: round(v, 1) for m, v in row.items()}
            for k, row in sorted(get_profiler().table().items())}
        state["graphs"] = dict(GRAPH_STATS)
        state["mp2"] = dict(MP2_STATS)
    return json.dumps(state).encode()


def _build_fleet(args, device, N, discover):
    """The fleet that the flags ask for. `discover` runs the dynamic pass
    and returns its receiver, or the list of them, one a stream. Returns
    (fleet, snapshot dict or None), or (None, None) after printing why."""
    from ..models.fused_fleet import FusedFleet
    if args.resume:
        with open(args.resume, "rb") as f:
            snap = pickle.load(f)
        fleet = FusedFleet.from_snapshot(
            snap["fleet"], device, consume_workers=args.consume_workers)
        if fleet.N != N:
            raise ValueError(f"snapshot has {fleet.N} streams, the inputs "
                             f"give {N}")
        return fleet, snap
    common = dict(transmission_mode=args.transmission_mode,
                  frames_per_step=args.frames_per_step, device=device,
                  viterbi=args.viterbi, chainback=args.chainback,
                  consume_workers=args.consume_workers)
    if args.discover:
        found = discover()
        rxs = found if isinstance(found, list) else [found]
        for k, rx in enumerate(rxs):
            if not rx.db.subchannels:
                print("no subchannels discovered" if len(rxs) == 1 else
                      f"stream {k}: no subchannels discovered",
                      file=sys.stderr)
                return None, None
        if isinstance(found, list):
            return FusedFleet.from_receiver(found, **common), None
        return FusedFleet.from_receiver(found, nb_streams=N, **common), None
    if not args.subchannels:
        raise ValueError("--subchannels or --discover required")
    cfgs, kinds = parse_subchannels(args.subchannels)
    return FusedFleet(N, cfgs, subchannel_kinds=kinds, **common), None


def _attach_common(fleet, args):
    """Audio decode + serving scraper + status-server hookup shared by
    the file and stdin paths. Returns (pcm_out counter, scraper or None,
    status HTTPServer or None, its state box or None); with --port this
    starts a network listener on 127.0.0.1 as a side effect."""
    pcm_out = [0]
    if args.audio:
        for pair in args.audio.split(","):
            b, s = (int(x) for x in pair.split(":"))
            fleet.enable_audio(b, s)
        fleet.on_audio_data.append(
            lambda *a: pcm_out.__setitem__(0, pcm_out[0] + len(a[2])))
    scraper = None
    if args.scraper_output:
        from ..host.scraper import FleetScraper
        scraper = FleetScraper(args.scraper_output)
        scraper.attach(fleet)
    srv = box = None
    if args.port:
        srv, box = _start_status_server(args.port)
        if srv is not None:
            print(f"# status: http://127.0.0.1:{args.port}/state.json",
                  file=sys.stderr)
    return pcm_out, scraper, srv, box


class _DriftAnchor:
    """Applies FusedFleet.drift_correction to the host read grid: when a
    stream's final-frame fine-time offset exceeds the noise floor, the
    next round starts that many samples later (or earlier), exactly as
    the dynamic path's per-frame pointer advance; then a 2-round
    cooldown lets post-correction offsets flow through the deferred
    fetch before correcting again."""

    THRESHOLD = 16          # samples; clean-signal estimates jitter ~1-2

    def __init__(self, n):
        self.cool = [0] * n
        self.total = [0] * n

    def state(self):
        return {"cool": list(self.cool), "total": list(self.total)}

    def restore(self, st):
        self.cool = list(st["cool"])
        self.total = list(st["total"])

    def corrections(self, offsets):
        """-> per-stream byte deltas to add to each read position."""
        out = []
        for k, off in enumerate(offsets):
            if self.cool[k] > 0:
                self.cool[k] -= 1
                out.append(0)
            elif abs(int(off)) >= self.THRESHOLD:
                self.cool[k] = 2
                self.total[k] += int(off)
                out.append(2 * int(off))
            else:
                out.append(0)
        return out


class _DesyncWatch:
    """Failure detection for the serving loop: a locked stream passes
    nearly every FIB CRC; ROUNDS consecutive rounds with ZERO valid FIBs
    mean the signal is gone (retune, deep fade, hard misalignment) and
    trigger hard re-acquisition: FusedFleet.resync() + a fresh
    find_alignment.

    A stream whose re-acquisition fails MAX_FAILED times in a row is
    DISARMED (resync() resets the device state fleet-wide, so a
    permanently dead input must not keep punishing the healthy streams);
    one successful re-acquisition re-arms it. Callers must gate update()
    on fleet.materialized_rounds > 0: under deferred fetch the first
    round (and the first after every resync) reads the zero-initialized
    fib_ok, which is staleness, not desync."""

    ROUNDS = 3
    MAX_FAILED = 2

    def __init__(self, n):
        self.dead = [0] * n
        self.failed = [0] * n
        self.events = 0

    def state(self):
        return {"dead": list(self.dead), "failed": list(self.failed),
                "events": self.events}

    def restore(self, st):
        self.dead = list(st["dead"])
        self.failed = list(st["failed"])
        self.events = st["events"]

    def update(self, fib_ok):
        trig = []
        for k, nok in enumerate(fib_ok):
            self.dead[k] = 0 if nok > 0 else self.dead[k] + 1
            trig.append(self.dead[k] >= self.ROUNDS
                        and self.failed[k] < self.MAX_FAILED)
        return trig

    def reacquired(self, k, ok: bool):
        self.dead[k] = 0
        self.failed[k] = 0 if ok else self.failed[k] + 1
        if self.failed[k] == self.MAX_FAILED:
            print(f"# stream {k}: re-acquisition failed {self.failed[k]}x"
                  " in a row — desync watch disarmed for this stream",
                  file=sys.stderr)


class _StopOnSigint:
    """SIGINT ends serving between rounds. The handler runs in the main
    thread and only sets a flag, which the serving loop reads at its head
    (`now`): the round already dispatched is then materialized and consumed
    by _finish, as at the end of the input. The first SIGINT puts back the
    default action, so that a second one ends the process at once. The
    handler that was there before comes back on exit. Outside the main
    thread, where no handler can be set, SIGINT keeps its handler."""

    def __init__(self):
        self.requested = False
        self._saved = None

    def _handle(self, signum, frame):
        self.requested = True
        signal.signal(signal.SIGINT, signal.SIG_DFL)

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._saved = signal.signal(signal.SIGINT, self._handle)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            signal.signal(signal.SIGINT, self._saved)

    def now(self, rounds_done: int) -> bool:
        """True once SIGINT came (the loop then stops); says so on stderr."""
        if self.requested:
            print(f"# SIGINT: stopping after round {rounds_done} (a second "
                  "SIGINT ends the process at once)", file=sys.stderr)
        return self.requested


def _finish(fleet, args, pcm_out, scraper, srv, box, offsets,
            anchor=None, pos=None, watch=None) -> int:
    """Common serving epilogue: consume the deferred round, close the
    sinks/status server, print the summary, write the checkpoint."""
    fleet.flush()
    if scraper is not None:
        scraper.close()
    if srv is not None:
        box["json"] = _status_blob(fleet, args, pcm_out)
        srv.shutdown()
        srv.server_close()
    # the checkpoint first: once the totals line is out (the last line, the
    # one serve_pod reads), the snapshot is on disk
    if args.snapshot_out:
        with open(args.snapshot_out, "wb") as f:
            pickle.dump({"fleet": fleet.snapshot(), "offsets": offsets,
                         "pos": pos,
                         "anchor": None if anchor is None
                         else anchor.state(),
                         "watch": None if watch is None
                         else watch.state()}, f)
        print(f"# snapshot written to {args.snapshot_out}", file=sys.stderr)
    for row in _stream_rows(fleet):
        print(json.dumps(row))
    summ = _totals(fleet, args, pcm_out)
    if anchor is not None and any(anchor.total):
        summ["drift_corrected_samples"] = anchor.total
    if watch is not None and watch.events:
        summ["resync_events"] = watch.events
    print(json.dumps(summ))
    return 0


def _serve_stream(args, device, stop):
    """`-i -`: decode a LIVE byte stream from stdin, the reference's
    pipe topology (rtl_sdr | ...) at the fused serving surface. All
    --streams streams decode the one stdin stream. Memory stays at one
    round + tail regardless of stream length. --resume carries the
    databases/byte layer over but RE-ALIGNS on the live stream head (a
    pipe has no seekable round grid; the deinterleaver re-syncs within
    16 CIFs)."""
    from ..params import get_ofdm_params

    mode = args.transmission_mode
    N = max(args.streams, 1)
    fs = get_ofdm_params(mode).nb_frame_samples
    fin = sys.stdin.buffer
    # head: enough for FIC discovery (10 frames) AND cold-start alignment
    head = fin.read(2 * 12 * fs)
    head_u8 = np.frombuffer(head, dtype=np.uint8)
    _warn_if_clipped(head_u8, "stdin head")

    fleet, snap = _build_fleet(args, device, N,
                               lambda: _discover(head_u8, mode, device))
    if fleet is None:
        return 1
    if snap is not None:
        print(f"# resumed from {args.resume} at round "
              f"{fleet.total_rounds} (live stream: re-aligning)",
              file=sys.stderr)

    pcm_out, scraper, srv, box = _attach_common(fleet, args)

    off = fleet.find_alignment(head_u8)
    if off is None:
        print("no frame sync in the stream head", file=sys.stderr)
        return 1

    chunk = 2 * fleet.round_samples
    tb = fleet.tail_bytes
    buf = bytearray(head[off:])
    anchor = _DriftAnchor(1)       # one stdin stream feeds all N copies
    watch = _DesyncWatch(1)
    if snap is not None:
        if snap.get("anchor") and len(snap["anchor"]["cool"]) == 1:
            anchor.restore(snap["anchor"])
        if snap.get("watch") and len(snap["watch"]["dead"]) == 1:
            watch.restore(snap["watch"])
    realign = False
    rounds_done = 0
    eof = False
    while True:
        if stop.now(rounds_done):
            break
        while len(buf) < chunk + tb and not eof:
            data = fin.read(chunk + tb - len(buf))
            if not data:
                eof = True
                break
            buf += data
        if len(buf) < chunk:
            break
        if realign:
            # hard re-acquisition after a detected desync: null-dip
            # search over the buffered data for the new frame grid
            # (a live stream keeps hunting until the signal returns)
            off2 = fleet.find_alignment(
                np.frombuffer(bytes(buf[:2 * 12 * fleet.fs]), np.uint8))
            if off2 is None:
                del buf[:max(min(len(buf), 2 * 12 * fleet.fs) - tb, 1)]
                continue                          # slide the window on
            del buf[:off2]
            realign = False
            watch.reacquired(0, True)
            print(f"# re-acquired frame sync (round {rounds_done})",
                  file=sys.stderr)
            continue                              # refill from new grid
        blk = np.frombuffer(bytes(buf[:chunk]), np.uint8)
        tail = np.frombuffer(bytes(buf[chunk:chunk + tb]), np.uint8) \
            if len(buf) >= chunk + tb else None
        fleet.process_round(
            np.broadcast_to(blk, (N, chunk)), defer_fetch=True,
            tail_u8=None if tail is None
            else np.broadcast_to(tail, (N, tb)))
        # drift re-anchor: positive offset skips bytes, negative re-reads
        # from the still-buffered tail (|correction| << chunk)
        corr = anchor.corrections(fleet.drift_correction[:1])[0]
        del buf[:max(chunk + corr, 0)]
        rounds_done += 1
        if fleet.materialized_rounds > 0 \
                and watch.update(fleet.last_fib_ok[:1])[0]:
            print(f"# stream desync at round {rounds_done}: re-acquiring",
                  file=sys.stderr)
            fleet.resync()
            watch.dead[0] = 0
            watch.events += 1
            realign = True
        if box is not None:
            box["json"] = _status_blob(fleet, args, pcm_out)
            _maybe_build_plot(fleet, box, blk)
        if args.max_rounds and rounds_done >= args.max_rounds:
            break
    return _finish(fleet, args, pcm_out, scraper, srv, box, [off] * N,
                   anchor=anchor, watch=watch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--inputs", nargs="+", required=True,
                    help="one IQ file per stream, one file with "
                         "--shared-input, or '-' for live stdin (u8)")
    ap.add_argument("-F", "--format", default="u8",
                    choices=sorted(IQ_FORMATS) + ["wav"],
                    help="IQ sample format of file inputs (non-u8 "
                         "requantizes to the device's u8 ingest contract "
                         "at load; stdin (-i -) supports u8 only)")
    ap.add_argument("--streams", type=int, default=0,
                    help="stream count for --shared-input / stdin "
                         "(stdin default 1)")
    ap.add_argument("--shared-input", action="store_true")
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--subchannels", default=None,
                    help="static layout start:lenCU:PROT[:KIND],... "
                         "(KIND: audio|mp2|packet@<addr>[+fec]; shared "
                         "by all streams); omit with --discover")
    ap.add_argument("--discover", action="store_true",
                    help="dynamic FIC discovery per stream, then fused "
                         "handoff")
    ap.add_argument("--frames-per-step", type=int, default=8)
    ap.add_argument("--viterbi", default="exact",
                    choices=["exact", "tiled"],
                    help="Viterbi of the round: exact full-trellis, or "
                         "overlap-save tiled (2.7 times the trellis steps in "
                         "windows of 320; with the default chainback every "
                         "window of the round in one kernel launch)")
    ap.add_argument("--chainback", default="sequential",
                    choices=["sequential", "parallel", "fused"],
                    help="Viterbi traceback: sequential runs the CUDA "
                         "kernel; parallel (log-depth map composition) and "
                         "fused (register exchange) are torch loops over the "
                         "trellis, bit-identical and much slower")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="double-buffered host-to-device staging depth for "
                         "file inputs (host.feeder): rounds upload on a "
                         "background thread while the current round "
                         "computes; 0 = synchronous feeding. Staged "
                         "rounds are dropped and restaged whenever a "
                         "drift correction or desync re-acquisition "
                         "moves the read grid.")
    ap.add_argument("--consume-workers", type=int, default=0,
                    help=">1 shards the host byte layer across worker "
                         "threads (one job per stream; observers still "
                         "fire in stream order)")
    ap.add_argument("--max-rounds", type=int, default=0,
                    help="stop after this many (additional, when resuming) "
                         "rounds")
    ap.add_argument("--audio", default=None,
                    help="decode audio for 'stream:sub[,stream:sub...]' "
                         "(e.g. 0:0 or 0:0,1:1)")
    ap.add_argument("--scraper-output", default=None,
                    help="write per-(stream,sub) bitstreams / MOT files / "
                         "WAVs (for --audio channels) under this directory")
    ap.add_argument("--port", type=int, default=0,
                    help="serve live /state.json on 127.0.0.1:PORT while "
                         "decoding (serving observability; 0 = off)")
    ap.add_argument("--snapshot-out", default=None,
                    help="write the fleet decode state (device carry, "
                         "databases, byte-layer sync) here at exit")
    ap.add_argument("--resume", default=None,
                    help="resume from a --snapshot-out checkpoint "
                         "(overrides --subchannels/--discover; resumed "
                         "decode continues byte-identically)")
    ap.add_argument("--profile-trace", default=None,
                    help="enable the stage profiler, write a Chrome/"
                         "Perfetto trace JSON here and its table to stderr "
                         "on exit; with --port, /state.json adds the table")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    if args.inputs == ["-"] and args.format != "u8":
        print("-i - (live stdin) supports u8 only; pipe through "
              "an IQ converter for other formats", file=sys.stderr)
        return 2
    if not args.profile_trace:
        return _serve(ap, args, device)
    from ..utils.profiler import get_profiler
    prof = get_profiler()
    was = prof.enabled
    prof.enabled = True
    try:
        rc = _serve(ap, args, device)
        prof.dump_chrome_trace(args.profile_trace)
        print(prof.report(), file=sys.stderr)
        print(f"# profiler: {len(prof.table())} stages -> "
              f"{args.profile_trace}", file=sys.stderr)
    finally:
        prof.enabled = was
    return rc


def _serve(ap, args, device):
    with _StopOnSigint() as stop:
        if args.inputs == ["-"]:
            return _serve_stream(args, device, stop)
        return _serve_files(ap, args, device, stop)


def _serve_files(ap, args, device, stop):
    """File inputs: one file a stream, or one shared by --streams."""
    if args.shared_input:
        if len(args.inputs) != 1 or args.streams <= 0:
            ap.error("--shared-input takes one input file and --streams N")
        data = _load_u8(args.inputs[0], args.format)
        _warn_if_clipped(data[: 1 << 22], args.inputs[0])
        streams = [data] * args.streams
    else:
        streams = [_load_u8(f, args.format) for f in args.inputs]
        for f_, st_ in zip(args.inputs, streams):
            _warn_if_clipped(st_[: 1 << 22], f_)
    N = len(streams)
    mode = args.transmission_mode

    def discover():
        # identical bytes per stream: one discovery pass serves all
        if args.shared_input:
            return _discover(streams[0], mode, device)
        return [_discover(s, mode, device) for s in streams]

    fleet, snap = _build_fleet(args, device, N, discover)
    if fleet is None:
        return 1
    if snap is not None:
        print(f"# resumed from {args.resume} at round "
              f"{fleet.total_rounds}", file=sys.stderr)

    pcm_out, scraper, srv, box = _attach_common(fleet, args)

    # cold-start alignment per stream (once for identical shared input;
    # resumed runs reuse the checkpointed offsets so the round grid lands
    # on the same frame boundaries)
    offsets = []
    shared_off = None
    for k, s in enumerate(streams):
        if snap is not None:
            off = snap["offsets"][k]
        elif args.shared_input and shared_off is not None:
            off = shared_off
        else:
            off = fleet.find_alignment(s[:2 * 4 * fleet.fs])
        if off is None:
            print(f"stream {k}: no frame sync", file=sys.stderr)
            return 1
        if args.shared_input:
            shared_off = off
        offsets.append(off)
    aligned = [s[off:] for s, off in zip(streams, offsets)]
    chunk = 2 * fleet.round_samples
    tb = fleet.tail_bytes
    # per-stream read positions: resumed runs restore theirs (incl. any
    # past drift corrections)
    pos = list(snap["pos"]) if snap is not None else [0] * N
    anchor = _DriftAnchor(N)
    watch = _DesyncWatch(N)
    if snap is not None:
        # resumed serving must see the same drift/desync signals an
        # uninterrupted run would
        anchor.restore(snap["anchor"])
        watch.restore(snap["watch"])
    done = 0

    def round_at(positions):
        """(blk, tail) host arrays for one round at the given per-stream
        read positions, or None when any stream is exhausted."""
        if any(p + chunk > s.shape[0] for p, s in zip(positions, aligned)):
            return None
        blk = np.stack([s[p:p + chunk]
                        for p, s in zip(positions, aligned)])
        # next round's head feeds the final frame's timing margin
        tails = [s[p + chunk:p + chunk + tb]
                 for p, s in zip(positions, aligned)]
        tail = np.stack(tails) if all(t.shape[0] == tb for t in tails) \
            else None
        return blk, tail

    feeder = None

    def restage_feeder():
        """(Re)build the staging thread reading ahead from the CURRENT
        read grid: called at start and whenever a drift correction or
        re-acquisition moves `pos` (staged rounds were computed against
        the old grid and must be dropped)."""
        nonlocal feeder
        from ..host.feeder import DoubleBufferedFeeder
        if feeder is not None:
            feeder.close()
        read_pos = list(pos)

        def src():
            item = round_at(read_pos)
            if item is None:
                return None
            for k in range(N):
                read_pos[k] += chunk
            return item
        feeder = DoubleBufferedFeeder(src, depth=args.prefetch,
                                      device=device)

    if args.prefetch > 0:
        restage_feeder()
    while True:
        if stop.now(done):
            break
        if args.max_rounds and done >= args.max_rounds:
            break
        if args.prefetch > 0:
            item = feeder.get()
        else:
            item = round_at(pos)
        if item is None:
            break
        blk, tail = item
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        done += 1
        # sample-clock drift re-anchor (the dynamic path's pointer
        # advance, at round granularity)
        corrs = anchor.corrections(fleet.drift_correction)
        for k, c in enumerate(corrs):
            pos[k] += chunk + c
        if args.prefetch > 0 and any(corrs):
            restage_feeder()          # staged rounds used the old grid
        trig = watch.update(fleet.last_fib_ok) \
            if fleet.materialized_rounds > 0 else [False] * N
        if any(trig):
            # hard re-acquisition: device decode state resets fleet-wide
            # (locked streams re-lock within a frame or two, CRC-gated);
            # dead streams rescan for their frame grid from here. A
            # stream that repeatedly fails to re-acquire is disarmed so
            # it cannot keep degrading the healthy ones
            print(f"# desync on stream(s) "
                  f"{[k for k, t in enumerate(trig) if t]} at round "
                  f"{done}: re-acquiring", file=sys.stderr)
            fleet.resync()
            watch.events += 1
            for k, t in enumerate(trig):
                if not t:
                    watch.dead[k] = 0
                    continue
                seg = aligned[k][pos[k]:pos[k] + 2 * 12 * fleet.fs]
                off2 = fleet.find_alignment(seg)
                watch.reacquired(k, off2 is not None)
                if off2 is None:
                    pos[k] += max(seg.shape[0] - tb, 1)   # slide on
                else:
                    pos[k] += off2
            if args.prefetch > 0:
                restage_feeder()
        if box is not None:
            box["json"] = _status_blob(fleet, args, pcm_out)
            _maybe_build_plot(fleet, box, blk)
    if feeder is not None:
        feeder.close()
    return _finish(fleet, args, pcm_out, scraper, srv, box, offsets,
                   anchor=anchor, pos=pos, watch=watch)


if __name__ == "__main__":
    sys.exit(main())
