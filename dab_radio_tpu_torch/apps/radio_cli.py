"""IQ (file/stdin) -> OFDM demod -> DAB decode, on a CUDA GPU or the CPU
(port of ``dab_radio_tpu/apps/radio_cli.py``, same flags and byte
contracts).

Pipeline configurations (--configuration):
  dab+ofdm : raw IQ in -> full receiver
  ofdm     : raw IQ in -> soft-bit frames out (stdout)
  dab      : soft-bit frames in -> DAB decode
Plus --scraper-enable (disk sink tree) and --benchmark (decode every
discovered subchannel). --backend picks the device (default cuda; raises
without a GPU). --viterbi tiled decodes the MSC by the overlap-save tiled
Viterbi (dab/msc.py:set_decode_mode).

    python -m dab_radio_tpu_torch.apps.radio_cli -i capture.u8 -F u8 --benchmark
"""

import argparse
import sys
import time

import numpy as np

from ..host.native import IQ_FORMATS
from ..host.io import IQReader
from ..dab.database import STREAM_AUDIO
from ..params.tables import (country_label, language_label,
                                         programme_type_label)
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..models.receiver import DabReceiver
from ..utils.backend import add_backend_flag, apply_backend


def summarize(rx: DabReceiver, file=None):
    # sys.stderr is read at call time, not bound when the module is imported
    file = file or sys.stderr
    db = rx.db
    print(f"ensemble: id={db.ensemble.id:04X} label='{db.ensemble.label}' "
          f"services={len(db.services)} subchannels={len(db.subchannels)}",
          file=file)
    for sid, svc in sorted(db.services.items()):
        # country/language/programme-type labels, as the reference's service
        # view renders them (examples/gui/basic_radio/formatters.cpp)
        extra = ""
        if svc.extended_country_code or svc.country_id:
            extra += " " + country_label(svc.extended_country_code,
                                         svc.country_id)
        if svc.language:
            extra += f" lang={language_label(svc.language)}"
        if svc.programme_type:
            extra += f" pty={programme_type_label(svc.programme_type)}"
        print(f"  service {sid:04X}: '{svc.label}'{extra}", file=file)
    for sub_id, sub in sorted(db.subchannels.items()):
        comp = db.component_by_subchannel(sub_id)
        kind = "?"
        if comp is not None and comp.transport_mode == STREAM_AUDIO:
            kind = "DAB+" if comp.audio_service_type == 63 else "DAB"
        prot = (f"UEP#{sub.uep_table_index}" if sub.is_uep
                else f"EEP-{(sub.eep_prot_level or 0) + 1}{sub.eep_type}")
        err = ""
        ch = rx.channels.get(sub_id)
        sf = getattr(ch, "superframe", None)
        if sf is not None:
            s_ = sf.stats
            err = (f" sf={s_['superframes']} fc_err={s_['firecode_errors']} "
                   f"rs_err={s_['rs_errors']} au_err={s_['au_crc_errors']}")
        dec = getattr(ch, "_audio_decoder", None)
        if dec is not None and dec.is_available:
            err += (f" pcm_ok={dec.total_decoded}"
                    f" pcm_err={dec.total_errors}")
            mode = getattr(dec, "pcm_mode", None)
            if mode:        # "ps-stereo" | degraded "ps-mono-dup"
                err += f" pcm_mode={mode}"
        print(f"  subchannel {sub_id}: start={sub.start_address} "
              f"len={sub.length}CU {prot} type={kind}{err}", file=file)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", default="-", help="IQ file or - for stdin")
    ap.add_argument("-F", "--format", default="u8",
                    choices=sorted(IQ_FORMATS) + ["wav"])
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--configuration", default="dab+ofdm",
                    choices=["dab+ofdm", "ofdm", "dab"])
    ap.add_argument("-b", "--block-size", type=int, default=65536 * 4)
    ap.add_argument("--scraper-enable", action="store_true")
    ap.add_argument("--scraper-output", default="scraper_out")
    ap.add_argument("--audio-decode", action="store_true",
                    help="decode audio to PCM via libavcodec (WAV in scraper)")
    ap.add_argument("--benchmark", action="store_true",
                    help="decode all subchannels, print throughput")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viterbi", default="exact", choices=["exact", "tiled"],
                    help="MSC Viterbi mode (tiled = overlap-save: every "
                         "window in one kernel launch)")
    ap.add_argument("--frames-per-step", type=int, default=1,
                    help="run K tracking steps per host read")
    ap.add_argument("--snapshot-out", default=None,
                    help="write full decode state (demod sync + radio) here at exit")
    ap.add_argument("--resume", default=None,
                    help="resume from a --snapshot-out checkpoint")
    ap.add_argument("--profile-trace", default=None,
                    help="enable the stage profiler and write a Chrome/"
                         "Perfetto trace JSON here on exit")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)
    # the mode is the process's: set it on every call, so that a run after a
    # tiled one decodes as its own flag says
    from ..dab.msc import set_decode_mode
    set_decode_mode(args.viterbi)
    if args.profile_trace:
        from ..utils.profiler import get_profiler
        get_profiler().enabled = True

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    reader = IQReader(fin, args.format) if args.configuration != "dab" else None
    run_ofdm = args.configuration in ("dab+ofdm", "ofdm")
    run_dab = args.configuration in ("dab+ofdm", "dab")

    demod = OFDMDemodulator(args.transmission_mode,
                            device=device) if run_ofdm else None
    sd = StreamingDemodulator(
        demod, frames_per_step=args.frames_per_step) if run_ofdm else None
    rx = DabReceiver(args.transmission_mode, benchmark_all=args.benchmark,
                     device=device) if run_dab else None
    if args.resume:
        import pickle
        with open(args.resume, "rb") as f:
            snap = pickle.load(f)
        if sd is not None and snap.get("demod") is not None:
            sd.restore(snap["demod"])
        if rx is not None and snap.get("radio") is not None:
            rx2 = DabReceiver.from_snapshot(snap["radio"])
            rx2.benchmark_all = args.benchmark
            rx = rx2
        print(f"# resumed from {args.resume}", file=sys.stderr)

    scraper = None
    if args.scraper_enable and rx is not None:
        from ..host.scraper import Scraper
        scraper = Scraper(args.scraper_output)
        scraper.attach(rx)
    if args.audio_decode and rx is not None:
        def _enable_audio(_id, ch):
            if hasattr(ch, "enable_audio_decode"):
                ch.enable_audio_decode()
        rx.on_audio_channel.append(_enable_audio)
        for sub_id, ch in rx.channels.items():   # restored channels
            _enable_audio(sub_id, ch)

    nb_frames = 0
    last_stats = None
    t_start = time.time()
    total_samples = 0
    nb_frame_bits = rx.dab.nb_frame_bits if rx else demod.params.nb_frame_bits
    soft_residue = np.zeros(0, dtype=np.int8)

    def handle_frame(bits):
        nonlocal nb_frames, last_stats
        nb_frames += 1
        if rx is not None:
            rx.process_frame(bits)
            stats = rx.updater.stats()
            if stats != last_stats:
                last_stats = stats
                summarize(rx)
        else:
            sys.stdout.buffer.write(np.asarray(bits, np.int8).tobytes())

    while True:
        raw = fin.read(args.block_size)
        if not raw:
            break
        if run_ofdm:
            iq = reader.convert(raw)
            w = reader.clipping_warning()
            if w:
                print(f"# {w}", file=sys.stderr)
            total_samples += iq.shape[0]
            for bits in sd.process(iq):
                handle_frame(bits)
        else:
            soft = np.concatenate([soft_residue,
                                   np.frombuffer(raw, dtype=np.int8)])
            off = 0
            while off + nb_frame_bits <= soft.shape[0]:
                handle_frame(soft[off:off + nb_frame_bits])
                off += nb_frame_bits
            soft_residue = soft[off:]
        if args.max_frames and nb_frames >= args.max_frames:
            break

    dt = time.time() - t_start
    if args.benchmark:
        msps = total_samples / dt / 1e6 if dt > 0 else 0
        print(f"benchmark: frames={nb_frames} wall={dt:.2f}s "
              f"ingest={msps:.2f} MSPS ({msps / 2.048:.2f}x realtime)",
              file=sys.stderr)
    if rx is not None:
        summarize(rx)
        if sd is not None:
            print(f"demod: frames_read={int(sd.carry.total_frames)} "
                  f"desync={int(sd.carry.total_desync)}", file=sys.stderr)
    if scraper is not None:
        scraper.close()
    if args.snapshot_out:
        import pickle
        with open(args.snapshot_out, "wb") as f:
            pickle.dump({"demod": sd.snapshot() if sd is not None else None,
                         "radio": rx.snapshot() if rx is not None else None},
                        f)
        print(f"# snapshot written to {args.snapshot_out}", file=sys.stderr)
    if args.profile_trace:
        from ..utils.profiler import get_profiler
        get_profiler().dump_chrome_trace(args.profile_trace)
        print(f"# profiler: {len(get_profiler().table())} stages -> "
              f"{args.profile_trace}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
