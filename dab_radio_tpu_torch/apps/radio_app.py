"""radio_app equivalent: tuner device -> OFDM demod -> DAB decode -> audio
(port of ``dab_radio_tpu/apps/radio_app.py``, same flags).

The reference's full application (examples/radio_app.cpp) minus the ImGui
windows: select a DAB block (channel table), read IQ from an RTL-SDR (or a
replayed capture), decode on the device --backend names (default cuda;
raises without a GPU), and play audio into the mixer pipeline (WAV file,
ALSA or null sink).

    python -m dab_radio_tpu_torch.apps.radio_app --device file \\
        -i capture.u8 --audio-out out.wav
"""

import argparse
import queue
import sys
import time

from ..host.device import BLOCK_FREQUENCIES, FileDevice, RTLSDRDevice
from ..host.audio import AudioPipeline, WavFileSink, NullSink
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..models.receiver import DabReceiver
from .radio_cli import summarize
from ..utils.backend import add_backend_flag, apply_backend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", "--channel", default="9C",
                    choices=sorted(BLOCK_FREQUENCIES))
    ap.add_argument("--device", default="file", choices=["file", "rtlsdr"])
    ap.add_argument("-i", "--input", help="capture file for --device file")
    ap.add_argument("-F", "--format", default="u8")
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--audio-out", default="radio_out.wav",
                    help="WAV sink path, 'alsa' for live playback "
                         "(needs libasound), or '' for the null sink")
    ap.add_argument("--seconds", type=float, default=30.0)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)
    # The JAX app enables XLA's compile cache here; the port has no compile
    # step to cache (K1 is built once per checkout by kernels/build.py).

    if args.device == "rtlsdr":
        dev = RTLSDRDevice()
    else:
        if not args.input:
            ap.error("--device file requires -i capture")
        dev = FileDevice(args.input, args.format, realtime=False)
    dev.set_center_frequency(args.channel, BLOCK_FREQUENCIES[args.channel])

    demod = OFDMDemodulator(args.transmission_mode, device=device)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(args.transmission_mode, device=device)

    if args.audio_out == "alsa":
        from ..host.audio import AlsaSink
        try:
            sink = AlsaSink()
        except RuntimeError as e:     # no libasound OR no playback device
            print(f"# live audio unavailable ({e}); using null sink",
                  file=sys.stderr)
            sink = NullSink()
    elif args.audio_out:
        sink = WavFileSink(args.audio_out)
    else:
        sink = NullSink()
    pipeline = AudioPipeline(sink=sink)

    def on_channel(sub_id, ch):
        print(f"+ channel {sub_id} ({ch.kind})", file=sys.stderr)
        if hasattr(ch, "controls"):
            # reference semantics: playback implies audio decode
            ch.controls.run_all()
            if hasattr(ch, "enable_audio_decode"):
                ch.enable_audio_decode()
        src = pipeline.create_source()
        ch.events.on_audio_data.append(
            lambda pcm, rate, nch: ch.controls.play_audio
            and src.write(pcm, rate, nch))
        ch.events.on_dynamic_label.append(
            lambda label: print(f"  label: {label}", file=sys.stderr))
    rx.on_audio_channel.append(on_channel)

    q: "queue.Queue" = queue.Queue(maxsize=64)
    dev.on_data.append(lambda iq: q.put(iq))
    dev.start()

    t_end = time.time() + args.seconds
    last_stats = None
    try:
        while time.time() < t_end:
            try:
                iq = q.get(timeout=1.0)
            except queue.Empty:
                if not dev._running:
                    break
                continue
            for bits in sd.process(iq):
                rx.process_frame(bits)
            pipeline.run_block(4800)
            stats = rx.updater.stats()
            if stats != last_stats:
                last_stats = stats
                summarize(rx)
    finally:
        dev.stop()
        if hasattr(pipeline.sink, "close"):
            pipeline.sink.close()
    summarize(rx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
