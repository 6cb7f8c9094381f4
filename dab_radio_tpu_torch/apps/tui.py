"""Live terminal dashboard, the GUI analog (reference examples/gui/:
RenderOFDMDemodulator + RenderBasicRadio + RenderProfiler, ImGui/ImPlot;
port of ``dab_radio_tpu/apps/tui.py``, same flags and text).

Renders, refreshed as frames decode:
  * demod state: frames/desyncs, coarse+fine CFO (Hz), signal level
  * ensemble database: services, subchannels, protection, bitrate
  * per-channel: type, dynamic label, access-unit/slideshow counters
  * an ASCII DQPSK constellation of the last frame (GUI constellation plot)
  * profiler per-stage table (RenderProfiler analog)

Runs under curses when stdout is a TTY; --plain prints a dashboard snapshot
every refresh interval instead (pipe-friendly, used by tests). The decode
runs on the device --backend names (default cuda; raises without a GPU).

Usage: python -m dab_radio_tpu_torch.apps.tui -i capture.bin -F u8 [--plain]
"""

import argparse
import sys
import time
import weakref

import numpy as np

from ..host.native import IQ_FORMATS
from ..host.io import IQReader
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..models.receiver import DabReceiver
from ..dab.database import STREAM_AUDIO
from ..utils.backend import add_backend_flag, apply_backend
from ..utils.profiler import get_profiler

SAMPLE_RATE = 2_048_000.0


class ChannelStats:
    def __init__(self, ch):
        self.ch = ch
        self.access_units = 0
        self.frames = 0
        if hasattr(ch, "events"):
            ch.events.on_access_unit.append(self._on_au)
            ch.events.on_frame_data.append(self._on_frame)

    def _on_au(self, i, n, au, hdr):
        self.access_units += 1

    def _on_frame(self, payload):
        self.frames += 1


def constellation_ascii(demod, sd, width=48, height=12, nb_transitions=8):
    """DQPSK constellation sampled from symbol transitions across the WHOLE
    frame (the reference plots every demodulated symbol,
    render_ofdm_demod.cpp:149-214; here every ~10th transition keeps the
    per-frame numpy cost negligible)."""
    if sd.last_window is None:
        return ["(no frame yet)"]
    p = demod.params
    w = sd.last_window
    if w.shape[0] < p.nb_null_period + 2 * p.nb_symbol_period:
        return ["(window too short)"]
    bins = np.concatenate([np.arange(1, p.nb_data_carriers // 2 + 1),
                           np.arange(p.nb_fft - p.nb_data_carriers // 2,
                                     p.nb_fft)])
    last_sym = p.nb_frame_symbols - 2
    syms = sorted(set(np.linspace(0, last_sym, nb_transitions).astype(int)))
    pts = []
    for k in syms:
        s0 = p.nb_null_period + k * p.nb_symbol_period + p.nb_cyclic_prefix
        s1 = s0 + p.nb_symbol_period
        if s1 + p.nb_fft > w.shape[0]:
            break
        f0 = np.fft.fft(w[s0:s0 + p.nb_fft])
        f1 = np.fft.fft(w[s1:s1 + p.nb_fft])
        pts.append((f1 * np.conj(f0))[bins])
    if not pts:
        return ["(window too short)"]
    pts = np.concatenate(pts)
    m = np.abs(pts).max() or 1.0
    pts = pts / m
    grid = [[" "] * width for _ in range(height)]
    for z in pts[:: max(1, pts.shape[0] // 2048)]:
        x = int((z.real * 0.45 + 0.5) * (width - 1))
        y = int((-z.imag * 0.45 + 0.5) * (height - 1))
        if 0 <= x < width and 0 <= y < height:
            grid[y][x] = "."
    grid[height // 2][width // 2] = "+"
    return ["".join(row) for row in grid]


_BLOCKS = " ▁▂▃▄▅▆▇█"


def _spark(vals, width=56):
    """One-line block-character sparkline (max-pooled to width)."""
    v = np.asarray(vals, np.float64)
    v = np.where(np.isfinite(v), v, np.nanmin(v[np.isfinite(v)])
                 if np.isfinite(v).any() else 0.0)
    if v.size == 0:
        return "(no data)"
    if v.size >= width:
        k = v.size // width
        v = v[:k * width].reshape(width, k).max(axis=1)
    lo, hi = float(v.min()), float(v.max())
    span = max(hi - lo, 1e-9)
    idx = np.clip(((v - lo) / span * 8).astype(int), 0, 8)
    return "".join(_BLOCKS[i] for i in idx)


_HOST_REFS = weakref.WeakKeyDictionary()


def _host_refs(demod):
    """(prs_fft_conj, prs_time_corr_ref) of `demod` as host numpy: fetched
    from its device once, at the first call, and kept."""
    refs = _HOST_REFS.get(demod)
    if refs is None:
        refs = _HOST_REFS[demod] = (demod.prs_fft_conj.cpu().numpy(),
                                    demod.prs_time_corr_ref.cpu().numpy())
    return refs


def diagnostics_lines(demod, sd, width=56):
    """Live per-frame sparkline panels of every render_ofdm_demod.cpp plot:
    fine-time impulse response, coarse-frequency PRS correlation, and the
    null/data symbol spectra (reference
    examples/gui/ofdm/render_ofdm_demod.cpp:39-336), recomputed in numpy
    from the last frame window each refresh."""
    if sd.last_window is None:
        return []
    prs_fft_conj, prs_time_corr_ref = _host_refs(demod)
    p = demod.params
    w = np.asarray(sd.last_window)
    if w.shape[0] < p.nb_null_period + 2 * p.nb_symbol_period:
        return []
    c = sd.carry
    freq = float(c.freq_coarse) + float(c.freq_fine) \
        if np.ndim(c.freq_coarse) == 0 else 0.0
    prs = w[p.nb_null_period:p.nb_null_period + p.nb_fft]
    prs = prs * np.exp(2j * np.pi * freq * np.arange(p.nb_fft))
    # fine-time PRS matched-filter impulse (ops/sync.py fine_time_offset)
    imp_db = 20 * np.log10(
        np.abs(np.fft.ifft(np.fft.fft(prs) * prs_fft_conj)) + 1e-12)
    # coarse-frequency response (relative-phase correlation spectrum)
    spec = np.fft.fft(prs)
    rel = np.conj(spec[:-1]) * spec[1:]
    rel = np.concatenate([rel, np.zeros(1, rel.dtype)])
    corr = np.fft.fft(np.fft.ifft(rel) * prs_time_corr_ref)
    fr_db = 20 * np.log10(np.abs(np.fft.fftshift(corr)) + 1e-12)
    null_db = 20 * np.log10(
        np.abs(np.fft.fftshift(np.fft.fft(w[:p.nb_fft]))) + 1e-12)
    s2 = p.nb_null_period + p.nb_symbol_period + p.nb_cyclic_prefix
    data_db = 20 * np.log10(np.abs(np.fft.fftshift(
        np.fft.fft(w[s2:s2 + p.nb_fft]))) + 1e-12)
    # sampling-buffer envelope (reference RenderSourceBuffer): |IQ| over
    # the whole frame window, max-pooled
    mag = np.abs(w[::64])
    lines = []
    for name, arr, unit in (("fine-time impulse", imp_db, "dB"),
                            ("coarse-freq corr", fr_db, "dB"),
                            ("null symbol PSD", null_db, "dB"),
                            ("data symbol PSD", data_db, "dB"),
                            ("sampling buffer |iq|", mag, "  ")):
        lines.append(f"  {name:<20s}[{arr.min():7.2f},{arr.max():7.2f}]"
                     f"{unit} " + _spark(arr, width))
    return lines


def _controls_tag(ch):
    c = getattr(ch, "controls", None)
    if c is None:
        return ""
    return ("[" + ("A" if c.decode_audio else "-")
            + ("D" if c.decode_data else "-")
            + ("P" if c.play_audio else "-") + "]")


def _codec_tag(ch):
    hdr = getattr(ch, "header", None)
    if hdr is None:
        return ""
    tag = f" {hdr.sampling_rate // 1000}k"
    tag += "st" if hdr.is_stereo else "mo"
    if hdr.sbr:
        tag += "+SBR"
    if hdr.ps:
        tag += "+PS"
    dec = getattr(ch, "_audio_decoder", None)
    if dec is not None and dec.is_available:
        tag += f" pcm={dec.total_decoded}/{dec.total_errors}e"
        if getattr(dec, "pcm_mode", None) == "ps-mono-dup":
            tag += " [PS DEGRADED: mono-dup]"
    return tag


def render_lines(demod, sd, rx, stats, nb_frames, t0, show_constellation=True,
                 selected=None, reader=None):
    lines = []
    c = sd.carry
    freq = (float(c.freq_coarse) + float(c.freq_fine)) * SAMPLE_RATE \
        if np.ndim(c.freq_coarse) == 0 else 0.0
    lines.append(
        f"DAB-Radio TPU   mode I   {nb_frames} frames   "
        f"{time.time() - t0:6.1f}s   state={'TRACK' if sd.state else 'ACQUIRE'}")
    mer = ""
    if sd.last_window is not None:
        from .monitor import estimate_mer_db
        m = estimate_mer_db(demod, np.asarray(sd.last_window),
                            nb_transitions=4)
        if m == m:
            mer = f"  MER={m:5.1f} dB"
    lines.append(
        f"demod: read={int(c.total_frames)} desync={int(c.total_desync)} "
        f"cfo={freq:+8.1f} Hz  signal_l1={float(c.signal_l1_avg):.4f}{mer}"
        + (f"  CLIP={reader.saturation:.0%}"
           if reader is not None and reader.saturation > 0.02 else ""))
    db = rx.db
    lines.append(
        f"ensemble {db.ensemble.id:04X} '{db.ensemble.label}'  "
        f"services={len(db.services)} subchannels={len(db.subchannels)}")
    for sid, svc in sorted(db.services.items()):
        comp = next((x for x in db.service_components
                     if x.service_id == sid), None)
        sub = db.subchannels.get(comp.subchannel_id) if comp else None
        prot = ""
        kind = "?"
        if sub is not None:
            prot = (f"UEP#{sub.uep_table_index}" if sub.is_uep
                    else f"EEP-{(sub.eep_prot_level or 0) + 1}{sub.eep_type}")
        if comp is not None and comp.transport_mode == STREAM_AUDIO:
            kind = "DAB+" if comp.audio_service_type == 63 else "DAB"
        st = stats.get(comp.subchannel_id) if comp else None
        extra = ""
        if st is not None:
            label = getattr(st.ch, "dynamic_label", "")
            mgr = getattr(st.ch, "slideshows", None)
            n_ss = len(mgr.slideshows) if mgr is not None else 0
            extra = (f" {_controls_tag(st.ch)}{_codec_tag(st.ch)}"
                     f" aus={st.access_units} frames={st.frames}"
                     f" ss={n_ss} label='{label[:32]}'")
            if selected is not None and comp.subchannel_id == selected:
                extra += "  <SEL"
            sf = getattr(st.ch, "superframe", None)
            if sf is not None:
                s_ = sf.stats
                errs = (s_["firecode_errors"], s_["rs_errors"],
                        s_["au_crc_errors"])
                if any(errs):
                    extra += (f" ERR fc={errs[0]} rs={errs[1]} au={errs[2]}")
                elif s_["rs_corrected_bytes"]:
                    extra += f" rs_fixed={s_['rs_corrected_bytes']}B"
        meta = ""
        if svc.extended_country_code or svc.country_id:
            from ..params.tables import country_label
            meta += f" {country_label(svc.extended_country_code, svc.country_id)}"
        if svc.language:
            from ..params.tables import language_label
            meta += f" {language_label(svc.language)}"
        lines.append(f"  {sid:04X} '{svc.label:<16s}' {kind:5s} {prot:8s}"
                     f"{meta}{extra}")
    if show_constellation:
        lines.append("constellation (DQPSK, whole frame):")
        lines.extend("  " + r for r in constellation_ascii(demod, sd))
        diag = diagnostics_lines(demod, sd)
        if diag:
            lines.append("sync diagnostics (live, per frame):")
            lines.extend(diag)
    table = get_profiler().table()
    if table:
        lines.append("profiler (per stage):")
        rows = sorted(table.items(), key=lambda kv: -kv[1]["total_us"])
        for name, d in rows[:8]:
            lines.append(f"  {name:<24s} n={int(d['count']):6d} "
                         f"mean={d['mean_us'] / 1e3:8.2f}ms "
                         f"max={d['max_us'] / 1e3:8.2f}ms")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", default="-", help="IQ file or - for stdin")
    ap.add_argument("-F", "--format", default="u8",
                    choices=sorted(IQ_FORMATS) + ["wav"])
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("-b", "--block-size", type=int, default=65536 * 4)
    ap.add_argument("--plain", action="store_true",
                    help="print dashboard snapshots instead of curses")
    ap.add_argument("--refresh", type=float, default=0.25)
    ap.add_argument("--max-frames", type=int, default=0)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    reader = IQReader(fin, args.format)
    demod = OFDMDemodulator(args.transmission_mode, device=device)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(args.transmission_mode, benchmark_all=True,
                     device=device)
    stats = {}
    rx.on_audio_channel.append(
        lambda sub_id, ch: stats.__setitem__(sub_id, ChannelStats(ch)))
    rx.on_data_channel.append(
        lambda sub_id, ch: stats.__setitem__(sub_id, ChannelStats(ch)))

    nb_frames = 0
    t0 = time.time()

    def pump():
        nonlocal nb_frames
        raw = fin.read(args.block_size)
        if not raw:
            return False
        iq = reader.convert(raw)
        for bits in sd.process(iq):
            rx.process_frame(bits)
            nb_frames += 1
        return True

    if args.plain or not sys.stdout.isatty():
        last = time.time()
        alive = True
        while alive and (not args.max_frames or nb_frames < args.max_frames):
            alive = pump()
            if time.time() - last >= args.refresh:
                last = time.time()
                print("\n".join(render_lines(demod, sd, rx, stats, nb_frames,
                                             t0, reader=reader)))
                print("-" * 72)
                sys.stdout.flush()
        print("\n".join(render_lines(demod, sd, rx, stats, nb_frames, t0,
                                      reader=reader)))
        sys.stdout.flush()
        return 0

    import curses

    sel = [None]                  # selected subchannel id (Tab cycles)

    def _selected_channel():
        if sel[0] is None and stats:
            sel[0] = sorted(stats)[0]
        st = stats.get(sel[0])
        return st.ch if st is not None else None

    def handle_key(key):
        """Audio-control hotkeys (reference GUI channel controls):
        Tab cycle channel, a/d/p toggle decode-audio/decode-data/play,
        r run_all, s stop_all."""
        if key == 9 and stats:    # Tab
            ids = sorted(stats)
            cur = ids.index(sel[0]) if sel[0] in ids else -1
            sel[0] = ids[(cur + 1) % len(ids)]
            return
        ch = _selected_channel()
        c = getattr(ch, "controls", None)
        if c is None:
            return
        if key == ord("a"):
            c.decode_audio = not c.decode_audio
            if c.decode_audio and hasattr(ch, "enable_audio_decode"):
                ch.enable_audio_decode()
        elif key == ord("d"):
            c.decode_data = not c.decode_data
        elif key == ord("p"):
            c.play_audio = not c.play_audio
        elif key == ord("r"):
            c.run_all()
        elif key == ord("s"):
            c.stop_all()

    def run(scr):
        nonlocal nb_frames
        curses.curs_set(0)
        scr.nodelay(True)
        last = 0.0
        alive = True
        while alive and (not args.max_frames or nb_frames < args.max_frames):
            alive = pump()
            key = scr.getch()
            if key in (ord("q"), 27):
                break
            if key != -1:
                handle_key(key)
            now = time.time()
            if now - last < args.refresh and alive:
                continue
            last = now
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            lines = render_lines(demod, sd, rx, stats, nb_frames, t0,
                                 selected=sel[0], reader=reader)
            lines.append("keys: Tab=select  a/d/p=toggle controls  "
                         "r=run_all s=stop_all q=quit")
            for y, line in enumerate(lines):
                if y >= maxy - 1:
                    break
                scr.addnstr(y, 0, line, maxx - 1)
            scr.refresh()
        scr.nodelay(False)
        scr.addnstr(0, 0, "stream ended - press any key", 40)
        scr.getch()

    curses.wrapper(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
