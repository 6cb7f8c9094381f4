"""rtl_sdr equivalent: RTL-SDR tuner capture -> raw u8 IQ on stdout.

Port of ``dab_radio_tpu/apps/rtl_sdr.py``, same flags. Byte contract
mirrors the reference (examples/rtl_sdr.cpp): unsigned 8-bit interleaved
I/Q at 2.048 MSPS, pipeable into radio_cli:

    python -m dab_radio_tpu_torch.apps.rtl_sdr -c 9C | \
        python -m dab_radio_tpu_torch.apps.radio_cli -i - -F u8

Requires librtlsdr + hardware; --list-channels works without either.
"""

import argparse
import sys
import threading

import numpy as np

from ..host.device import (BLOCK_FREQUENCIES, RTLSDRDevice, SAMPLE_RATE,
                           list_devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", "--channel", default="9C",
                    help="DAB block (e.g. 5C, 9C, LA)")
    ap.add_argument("-f", "--frequency", type=int, default=0,
                    help="explicit center frequency Hz (overrides --channel)")
    ap.add_argument("-g", "--gain", type=float, default=None,
                    help="tuner gain dB (default: auto pick from list)")
    ap.add_argument("--auto-gain", action="store_true",
                    help="hardware AGC instead of a manual gain")
    ap.add_argument("-p", "--ppm", type=int, default=0,
                    help="frequency correction in ppm")
    ap.add_argument("-s", "--sampling-rate", type=int, default=0,
                    help="override the 2.048 MSPS default")
    ap.add_argument("--sampling-mode", type=int, default=0,
                    choices=[0, 1, 2],
                    help="0=IQ, 1=I-branch direct, 2=Q-branch direct")
    ap.add_argument("--offset-tuning", action="store_true")
    ap.add_argument("--enable-bias-tee", action="store_true",
                    help="DC supply for active antennas")
    ap.add_argument("-o", "--output", default="-",
                    help="write IQ to a file instead of stdout")
    ap.add_argument("-d", "--device-index", type=int, default=0,
                    help="tuner index from --list-devices")
    ap.add_argument("-n", "--nb-samples", type=int, default=0,
                    help="stop after N samples (0 = stream forever)")
    ap.add_argument("--list-channels", action="store_true")
    ap.add_argument("--list-gains", action="store_true")
    ap.add_argument("--list-devices", action="store_true",
                    help="enumerate connected tuners (reference "
                         "device_list.cpp); exits 0 with no output "
                         "when none/no librtlsdr")
    args = ap.parse_args(argv)

    if args.list_channels:
        for label, freq in sorted(BLOCK_FREQUENCIES.items(),
                                  key=lambda kv: kv[1]):
            print(f"{label:4s} {freq / 1e6:10.3f} MHz")
        return 0

    if args.list_devices:
        for d in list_devices():
            print(f"{d['index']}: {d['name']} "
                  f"vendor={d['vendor']} product={d['product']} "
                  f"serial={d['serial']}")
        return 0

    freq = args.frequency or BLOCK_FREQUENCIES.get(args.channel.upper())
    if not freq:
        print(f"unknown channel '{args.channel}' (try --list-channels)",
              file=sys.stderr)
        return 1

    try:
        dev = RTLSDRDevice(args.device_index)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.list_gains:
        print(" ".join(f"{g:.1f}" for g in dev.gains))
        return 0
    if args.auto_gain:
        dev.set_auto_gain()
    elif args.gain is not None:
        dev.set_gain(args.gain)
    if args.ppm:
        dev.set_ppm(args.ppm)
    if args.sampling_rate:
        dev.set_sample_rate(args.sampling_rate)
    if args.sampling_mode:
        dev.set_direct_sampling(args.sampling_mode)
    if args.offset_tuning:
        dev.set_offset_tuning(True)
    if args.enable_bias_tee:
        try:
            dev.set_bias_tee(True)
        except RuntimeError as e:
            print(f"# bias tee unavailable: {e}", file=sys.stderr)
    dev.set_center_frequency(args.channel.upper(), freq)
    rate = args.sampling_rate or SAMPLE_RATE
    print(f"# tuned {args.channel.upper()} @ {freq / 1e6:.3f} MHz, "
          f"{rate} SPS", file=sys.stderr)

    out = sys.stdout.buffer if args.output == "-" else \
        open(args.output, "wb")
    done = threading.Event()
    written = 0

    def on_data(iq: np.ndarray):
        nonlocal written
        # back to the u8 wire format (device callbacks carry complex64)
        u8 = (np.stack([iq.real, iq.imag], -1) * 127.5 + 127.5)
        u8 = np.clip(u8, 0, 255).astype(np.uint8).reshape(-1)
        try:
            out.write(u8.tobytes())
        except BrokenPipeError:
            done.set()
            return
        written += iq.shape[0]
        if args.nb_samples and written >= args.nb_samples:
            done.set()

    dev.on_data.append(on_data)
    dev.start()
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    dev.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
