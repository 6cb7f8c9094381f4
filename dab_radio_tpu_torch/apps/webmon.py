"""Live web dashboard: the GUI analog served over HTTP (port of
``dab_radio_tpu/apps/webmon.py``, same flags, routes and JSON keys).

Decodes an IQ stream continuously (like radio_cli) on the device --backend
names (default cuda; raises without a GPU) and serves the reference GUI's
views to any browser, with no display stack needed on the decoding host
(the reference draws a native ImGui window, examples/gui/):

  /               auto-refreshing page embedding the live dashboard
  /dashboard.png  the monitor's 6-panel render of the LAST frame
                  (sampling buffer, PRS impulse, coarse-freq response,
                  constellation, soft-bit histogram, data spectrum;
                  needs matplotlib)
  /plot.json      the four live OFDM windows as numeric arrays
  /state.json     ensemble database + per-channel stats + demod counters
  /device.json    the tuner (--device) and its channel; POST /tune retunes

Usage: python -m dab_radio_tpu_torch.apps.webmon -i capture.u8 -F u8 \
           --port 8080 [--loop] [--backend cpu]
"""

import argparse
import io
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from ..host.native import IQ_FORMATS
from ..host.io import IQReader
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..models.receiver import DabReceiver
from ..utils.backend import add_backend_flag, apply_backend


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.nb_frames = 0
        self.t0 = time.time()
        self.demod = None
        self.sd = None
        self.rx = None
        self.reader = None
        self.done = False
        self.device = None           # tuner (FileDevice / RTLSDRDevice)
        self.channel = None          # current DAB block label
        self.freq_hz = None
        self.retune = None           # callable(label) set by main()


def _state_json(st: _State) -> bytes:
    with st.lock:
        rx, sd = st.rx, st.sd
        out = {"frames": st.nb_frames,
               "uptime_s": round(time.time() - st.t0, 1),
               "done": st.done}
        if st.reader is not None and st.reader.saturation > 0:
            out["iq_saturation"] = round(st.reader.saturation, 4)
        if sd is not None and np.ndim(sd.carry.freq_coarse) == 0:
            out["freq_hz"] = round(
                (float(sd.carry.freq_coarse) + float(sd.carry.freq_fine))
                * 2.048e6, 1)
            out["desync"] = int(sd.carry.total_desync)
            if sd.last_window is not None:
                from .monitor import estimate_mer_db
                mer = estimate_mer_db(st.demod, np.asarray(sd.last_window))
                if mer == mer:
                    out["mer_db"] = round(mer, 1)
        from ..utils.profiler import get_profiler
        prof = get_profiler()
        if prof.enabled:
            # the reference GUI's profiler tab (render_profiler.cpp):
            # per-stage totals in microseconds
            out["profiler"] = {
                k: {m: round(v, 1) for m, v in row.items()}
                for k, row in sorted(prof.table().items())}
        if rx is not None:
            db = rx.db
            out["ensemble"] = {"id": f"{db.ensemble.id:04X}",
                               "label": db.ensemble.label}
            out["services"] = [
                {"id": f"{sid:04X}", "label": svc.label}
                for sid, svc in sorted(db.services.items())]
            out["subchannels"] = sorted(db.subchannels)
            # the reference GUI's radio browser per-channel view
            # (gui/basic_radio: dynamic label, slideshow, decoder stats)
            chans = []
            for sub_id, ch in sorted(getattr(rx, "channels", {}).items()):
                mgr = getattr(ch, "slideshows", None)
                entry = {"subchannel": sub_id,
                         "kind": type(ch).__name__,
                         "dynamic_label": getattr(ch, "dynamic_label", ""),
                         "slideshows": len(mgr.slideshows) if mgr else 0}
                sf = getattr(ch, "superframe", None)
                if sf is not None:
                    entry["stats"] = dict(sf.stats)
                dec = getattr(ch, "_audio_decoder", None)
                if dec is not None and dec.is_available:
                    entry["pcm_ok"] = dec.total_decoded
                    entry["pcm_err"] = dec.total_errors
                    if getattr(dec, "pcm_mode", None):
                        entry["pcm_mode"] = dec.pcm_mode
                ctl = getattr(ch, "controls", None)
                if ctl is not None:
                    entry["controls"] = {
                        "decode_audio": ctl.decode_audio,
                        "decode_data": ctl.decode_data,
                        "play_audio": ctl.play_audio}
                chans.append(entry)
            out["channels"] = chans
    return json.dumps(out).encode()


def _slideshow_img(st: _State, sub_id: int):
    """Latest slideshow image for a subchannel -> (bytes, content-type)."""
    with st.lock:
        rx = st.rx
        ch = getattr(rx, "channels", {}).get(sub_id) if rx else None
        mgr = getattr(ch, "slideshows", None)
        if not mgr or not mgr.slideshows:
            return None, None
        s = mgr.slideshows[0]            # most recent first
        return bytes(s.data), \
            "image/jpeg" if s.image_type == "jpeg" else "image/png"


def _plot_json(st: _State) -> bytes:
    """Numeric plot payload for the browser-side canvas renderer — the
    reference GUI's live OFDM windows (render_ofdm_demod.cpp:39-336:
    constellation, fine-time impulse response, coarse-frequency PRS
    correlation, data-symbol spectrum) as JSON arrays instead of an
    ImGui draw list. ~40 KB/poll vs the 200+ KB matplotlib PNG."""
    from .monitor import collect_diagnostics
    with st.lock:
        sd, demod = st.sd, st.demod
        if sd is None or sd.last_window is None:
            return b""
        window = np.asarray(sd.last_window).copy()
        carry = sd.carry
        frames = st.nb_frames
    from .monitor import plot_payload
    diag = collect_diagnostics(demod, window, carry)
    out = plot_payload(diag)
    out["frames"] = frames
    return json.dumps(out).encode()


def _device_json(st: _State) -> bytes:
    from ..host.device import BLOCK_FREQUENCIES
    with st.lock:
        dev = getattr(st, "device", None)
        out = {"channels": sorted(BLOCK_FREQUENCIES),
               "channel": getattr(st, "channel", None),
               "freq_hz": getattr(st, "freq_hz", None),
               "device": type(dev).__name__ if dev else None,
               "running": bool(dev and dev._running)}
    return json.dumps(out).encode()


def _dashboard_png(st: _State) -> bytes:
    from .monitor import collect_diagnostics, render_dashboard
    with st.lock:
        sd, demod = st.sd, st.demod
        if sd is None or sd.last_window is None:
            return b""
        window = np.asarray(sd.last_window).copy()
        carry = sd.carry
    diag = collect_diagnostics(demod, window, carry)
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
        path = f.name
    try:
        render_dashboard(diag, carry, path)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


_PAGE = b"""<!doctype html><title>DAB-Radio TPU</title>
<body style="background:#111;color:#ddd;font-family:monospace">
<h3>DAB-Radio TPU &mdash; live monitor</h3>
<div id="tuner"></div><div id="ss"></div><div id="ctl"></div>
<div>
<canvas id="p_imp" width="440" height="140"></canvas>
<canvas id="p_coarse" width="440" height="140"></canvas>
<canvas id="p_spec" width="440" height="140"></canvas>
<canvas id="p_con" width="280" height="140"></canvas>
</div>
<pre id="s"></pre>
<a href="/dashboard.png">full matplotlib dashboard</a>
<script>
async function tick(){
 try{
  const r = await fetch('/state.json');
  const j = await r.json();
  document.getElementById('s').textContent = JSON.stringify(j, null, 1);
  // dynamic labels are OVER-AIR data: build DOM via textContent, never
  // innerHTML (a hostile broadcast must not script the operator page)
  const box = document.getElementById('ss');
  box.replaceChildren();
  const ctlbox = document.getElementById('ctl');
  ctlbox.replaceChildren();
  for (const c of (j.channels || [])) {
   if (c.slideshows > 0) {
    const fig = document.createElement('figure');
    fig.style.cssText = 'display:inline-block;margin:4px';
    const img = document.createElement('img');
    img.src = '/slideshow/' + encodeURIComponent(c.subchannel) +
              '?' + Date.now();
    img.height = 120;
    const cap = document.createElement('figcaption');
    cap.textContent = 'sub ' + c.subchannel + ' ' + (c.dynamic_label || '');
    fig.append(img, cap);
    box.append(fig);
   }
   // per-channel control checkboxes (reference GUI's audio controls)
   if (c.controls) {
    const row = document.createElement('div');
    const lbl = document.createElement('span');
    lbl.textContent = 'sub ' + c.subchannel + ': ';
    row.append(lbl);
    for (const f of ['decode_audio', 'decode_data', 'play_audio']) {
     const id = 'cb_' + c.subchannel + '_' + f;
     const cb = document.createElement('input');
     cb.type = 'checkbox'; cb.id = id; cb.checked = c.controls[f];
     cb.onchange = () => fetch('/control', {method: 'POST',
       body: JSON.stringify({subchannel: c.subchannel, flag: f,
                             value: cb.checked})});
     const tag = document.createElement('label');
     tag.htmlFor = id; tag.textContent = f + ' ';
     row.append(cb, tag);
    }
    ctlbox.append(row);
   }
  }
 }catch(e){}
 setTimeout(tick, 2000);
}
// live plots: the reference GUI's OFDM windows rendered client-side from
// /plot.json (canvas line/scatter; ~1 Hz; no server-side matplotlib)
function line(id, data, label){
 const cv = document.getElementById(id), ctx = cv.getContext('2d');
 ctx.fillStyle = '#181818'; ctx.fillRect(0, 0, cv.width, cv.height);
 if (!data || !data.length) return;
 let lo = Math.min(...data), hi = Math.max(...data);
 if (hi - lo < 1e-6) hi = lo + 1;
 ctx.strokeStyle = '#6cf'; ctx.beginPath();
 for (let i = 0; i < data.length; i++) {
  const x = i / (data.length - 1) * (cv.width - 2) + 1;
  const y = cv.height - 2 - (data[i] - lo) / (hi - lo) * (cv.height - 4);
  i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
 }
 ctx.stroke();
 ctx.fillStyle = '#999'; ctx.font = '10px monospace';
 ctx.fillText(label + '  [' + lo.toFixed(1) + ', ' + hi.toFixed(1) + ']',
              4, 12);
}
function scatter(id, pts, label){
 const cv = document.getElementById(id), ctx = cv.getContext('2d');
 ctx.fillStyle = '#181818'; ctx.fillRect(0, 0, cv.width, cv.height);
 ctx.fillStyle = '#fc6';
 for (const [re, im] of (pts || [])) {
  const x = cv.width / 2 + re * cv.width / 5;
  const y = cv.height / 2 - im * cv.height / 5;
  if (x >= 0 && x < cv.width && y >= 0 && y < cv.height)
   ctx.fillRect(x, y, 2, 2);
 }
 ctx.fillStyle = '#999'; ctx.font = '10px monospace';
 ctx.fillText(label, 4, 12);
}
async function plots(){
 try{
  const r = await fetch('/plot.json');
  if (r.ok) {
   const j = await r.json();
   line('p_imp', j.impulse_db, 'fine-time impulse (dB)');
   line('p_coarse', j.freq_response_db, 'coarse-freq PRS corr (dB)');
   line('p_spec', j.spectrum_db, 'data symbol spectrum (dB)');
   scatter('p_con', j.constellation,
           'DQPSK constellation' + (j.mer_db ? '  MER ' + j.mer_db + ' dB'
                                             : ''));
  }
 }catch(e){}
 setTimeout(plots, 1000);
}
async function tuner(){
 try{
  const r = await fetch('/device.json');
  if (!r.ok) return;
  const j = await r.json();
  if (!j.device) return;
  const box = document.getElementById('tuner');
  if (!box.dataset.built) {
   box.dataset.built = '1';
   const sel = document.createElement('select'); sel.id = 'chan';
   for (const c of j.channels) {
    const o = document.createElement('option');
    o.value = c; o.textContent = c; sel.append(o);
   }
   const btn = document.createElement('button');
   btn.textContent = 'Tune';
   btn.onclick = () => fetch('/tune', {method: 'POST',
     body: JSON.stringify({channel: sel.value})}).then(tuner);
   const tag = document.createElement('span'); tag.id = 'tuned';
   box.append(sel, btn, tag);
  }
  if (j.channel) document.getElementById('chan').value = j.channel;
  document.getElementById('tuned').textContent =
    '  ' + (j.device || '') + (j.channel ? ' @ ' + j.channel : '') +
    (j.freq_hz ? ' (' + (j.freq_hz / 1e6).toFixed(3) + ' MHz)' : '');
 }catch(e){}
 setTimeout(tuner, 3000);
}
tick(); plots(); tuner();
</script>"""


def _make_handler(st: _State):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                body, ctype = _PAGE, "text/html"
            elif path == "/state.json":
                body, ctype = _state_json(st), "application/json"
            elif path == "/plot.json":
                body, ctype = _plot_json(st), "application/json"
                if not body:
                    self.send_response(503)
                    self.end_headers()
                    return
            elif path == "/device.json":
                body, ctype = _device_json(st), "application/json"
            elif path == "/dashboard.png":
                body, ctype = _dashboard_png(st), "image/png"
                if not body:
                    self.send_response(503)
                    self.end_headers()
                    return
            elif path.startswith("/slideshow/"):
                try:
                    sub_id = int(path.rsplit("/", 1)[1])
                except ValueError:
                    sub_id = -1
                body, ctype = _slideshow_img(st, sub_id)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            # per-channel audio controls — the reference GUI's checkboxes
            # (gui/basic_radio render controls -> Basic_Audio_Controls);
            # body: {"subchannel": N, "flag": "decode_audio"|"decode_data"
            #        |"play_audio", "value": bool} or
            #       {"subchannel": N, "action": "run_all"|"stop_all"}
            post_path = self.path.split("?")[0]
            if post_path not in ("/control", "/tune"):
                self.send_response(404)
                self.end_headers()
                return
            # same-origin gate: a hostile page the operator browses can
            # fire no-preflight POSTs at localhost — refuse any request
            # that carries a foreign Origin (direct curl/urllib send none)
            origin = self.headers.get("Origin")
            if origin and origin != f"http://{self.headers.get('Host')}":
                self.send_response(403)
                self.end_headers()
                return
            if post_path == "/tune":
                # tuner retune round-trip (reference device_gui channel
                # list, examples/gui/device/render_devices.cpp): switch
                # the DAB block, reset demod+receiver decode state, and
                # restart the device stream on the new frequency
                from ..host.device import BLOCK_FREQUENCIES
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    label = str(req["channel"])
                    freq = BLOCK_FREQUENCIES[label]
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError):
                    self.send_response(400)
                    self.end_headers()
                    return
                if st.retune is None:
                    self.send_response(404)   # no tuner attached (-i pump)
                    self.end_headers()
                    return
                st.retune(label, freq)
                body = _device_json(st)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                sub_id = int(req["subchannel"])
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError):
                self.send_response(400)
                self.end_headers()
                return
            with st.lock:
                ch = getattr(st.rx, "channels", {}).get(sub_id) \
                    if st.rx else None
                ctl = getattr(ch, "controls", None)
                if ctl is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                if req.get("action") in ("run_all", "stop_all"):
                    getattr(ctl, req["action"])()
                elif req.get("flag") in ("decode_audio", "decode_data",
                                         "play_audio"):
                    setattr(ctl, req["flag"], bool(req.get("value")))
                else:
                    self.send_response(400)
                    self.end_headers()
                    return
            body = _state_json(st)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                  # quiet
            pass

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", default="-")
    ap.add_argument("-F", "--format", default="u8",
                    choices=sorted(IQ_FORMATS) + ["wav"])
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("-b", "--block-size", type=int, default=65536 * 4)
    ap.add_argument("--port", type=int, default=8737)
    ap.add_argument("--loop", action="store_true",
                    help="loop a file input forever")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", choices=["file", "rtlsdr"],
                    help="attach a tuner device instead of the raw -i "
                         "pump: enables the /tune retune endpoint and the "
                         "browser tuner panel ('file' replays -i through "
                         "the device layer; 'rtlsdr' tunes real hardware)")
    ap.add_argument("-c", "--channel", default="9C",
                    help="initial DAB block for --device")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    st = _State()
    from ..utils.profiler import get_profiler
    get_profiler().enabled = True
    st.demod = OFDMDemodulator(args.transmission_mode, device=device)
    st.sd = StreamingDemodulator(st.demod)
    st.rx = DabReceiver(args.transmission_mode, benchmark_all=True,
                        device=device)

    def pump():
        fin = sys.stdin.buffer if args.input == "-" else \
            open(args.input, "rb")
        reader = IQReader(fin, args.format)
        st.reader = reader
        while True:
            raw = fin.read(args.block_size)
            if not raw:
                if args.loop and args.input != "-":
                    fin.seek(reader.data_offset)   # WAV: data chunk, not RIFF
                    continue
                break
            iq = reader.convert(raw)
            for bits in st.sd.process(iq):
                with st.lock:
                    st.rx.process_frame(bits)
                    st.nb_frames += 1
                if args.max_frames and st.nb_frames >= args.max_frames:
                    with st.lock:
                        st.done = True
                    return
        with st.lock:
            st.done = True

    if args.device:
        # tuner-backed mode: IQ flows from the device layer's reader
        # thread; /tune switches blocks with a full decode-state reset
        # (a retune is a new signal — stale sync/deinterleaver/database
        # state would fight it; reference radio.cpp rebuilds its radio
        # per channel switch)
        from ..host.device import (BLOCK_FREQUENCIES, FileDevice,
                                   RTLSDRDevice)
        if args.device == "rtlsdr":
            dev = RTLSDRDevice()
        else:
            if args.input == "-":
                ap.error("--device file requires -i capture")
            if args.format == "wav":
                # FileDevice replays raw sample formats only (the -i pump
                # path strips WAV headers via IQReader); rejecting here
                # beats a KeyError on the reader thread
                ap.error("--device file does not support -F wav; "
                         "use the plain -i pump for WAV captures")
            dev = FileDevice(args.input, args.format, realtime=False,
                             loop=args.loop)
        st.device = dev
        st.channel = args.channel
        st.freq_hz = BLOCK_FREQUENCIES[args.channel]

        def on_iq(iq):
            if st.done:
                return
            for bits in st.sd.process(iq):
                with st.lock:
                    st.rx.process_frame(bits)
                    st.nb_frames += 1
                if args.max_frames and st.nb_frames >= args.max_frames:
                    with st.lock:
                        st.done = True
                    return

        # serialize retunes: ThreadingHTTPServer handles each POST on its
        # own thread, and an interleaved stop/start pair would leave two
        # device reader threads feeding one demodulator
        tune_lock = threading.Lock()

        def retune(label, freq):
            with tune_lock:
                dev.stop()
                with st.lock:
                    st.sd = StreamingDemodulator(st.demod)
                    st.rx = DabReceiver(args.transmission_mode,
                                        benchmark_all=True, device=device)
                    st.nb_frames = 0
                    st.done = False
                    st.channel, st.freq_hz = label, freq
                dev.set_center_frequency(label, freq)
                dev.start()      # FileDevice: replay from the top

        st.retune = retune
        dev.on_data.append(on_iq)
        dev.set_center_frequency(args.channel, st.freq_hz)
        dev.start()
    else:
        t = threading.Thread(target=pump, daemon=True)
        t.start()

    from http.server import ThreadingHTTPServer
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), _make_handler(st))
    print(f"# webmon on http://127.0.0.1:{args.port}/", file=sys.stderr,
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
