"""simulate_transmitter equivalent: synthesize DAB OFDM IQ to stdout (port
of ``dab_radio_tpu/apps/simulate_transmitter.py``, same flags and byte
contracts).

Two modes:
  --payload random   : reference contract (random scrambled bytes straight
                       onto carriers, examples/simulate_transmitter.cpp)
  --payload ensemble : full decodable synthetic ensemble (FIC + DAB+
                       services)
Output formats: u8 (rtl_sdr byte contract), s16, f32. The OFDM modulation
runs on the device --backend names (default cuda; raises without a GPU).

    python -m dab_radio_tpu_torch.apps.simulate_transmitter \\
        --payload ensemble --services 2 -n 24 > capture.u8
"""

import argparse
import struct
import sys
import zlib

import numpy as np

from ..params import get_ofdm_params
from ..models.modulator import OFDMModulator
from ..host.native import iq_quantize_u8
from ..utils.backend import add_backend_flag, apply_backend


def _dvb_scrambler_bytes(n: int) -> np.ndarray:
    """PRBS from the DVB-style scrambler the reference uses for its random
    payload (x^14+x^15, seed 0b000000010101001)."""
    reg = 0b000000010101001
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        b = 0
        for k in range(8):
            v = ((reg >> 13) ^ (reg >> 14)) & 1
            b = (b << 1) | v
            reg = ((reg << 1) | v) & 0x7FFF
        out[i] = b
    return out


def _test_card_png(idx: int, w: int = 96, h: int = 64) -> bytes:
    """A small valid RGB PNG colour-bar test card (no image library
    needed; identical rows keep it a few hundred bytes, so at 3 AUs per
    superframe the X-PAD carousel airtime stays in test range)."""
    bars = [(255, 255, 255), (255, 255, 0), (0, 255, 255), (0, 255, 0),
            (255, 0, 255), (255, 0, 0), (0, 0, 255), (40, 40, 40)]
    row = bytearray([0])                      # filter: none
    for x in range(w):
        row += bytes(bars[(x * len(bars) // w + idx) % len(bars)])
    rows = bytes(row) * h

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(rows)))
            + chunk(b"IEND", b""))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--payload", default="random",
                    choices=["random", "ensemble"])
    ap.add_argument("-F", "--format", default="u8", choices=["u8", "s16", "f32"])
    ap.add_argument("-n", "--nb-frames", type=int, default=0,
                    help="0 = stream forever")
    ap.add_argument("--scale", type=float, default=0.5,
                    help="amplitude headroom before quantization")
    ap.add_argument("--services", type=int, default=1,
                    help="(ensemble payload) number of DAB+ services")
    ap.add_argument("--audio", default="tone", choices=["tone", "random"],
                    help="(ensemble payload) AU content: real decodable "
                         "tone audio (AAC+SBR / MP2) or random bytes")
    ap.add_argument("--slideshow", action="store_true",
                    help="(ensemble payload, tone audio) broadcast a "
                         "test-card MOT slideshow + dynamic label on each "
                         "service's X-PAD")
    ap.add_argument("--pad-carousel", action="store_true",
                    help="(with --slideshow) queue each service's label and "
                         "slideshow again whenever its X-PAD drains, as a "
                         "broadcaster's carousel does: a receiver whose "
                         "channel starts late still gets them (without it "
                         "they are sent once, as by the JAX app)")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    out = sys.stdout.buffer
    p = get_ofdm_params(args.transmission_mode)

    if args.payload == "ensemble":
        from ..models.transmitter import EnsembleTransmitter, ServiceSpec
        from ..params import SubchannelConfig
        tx = EnsembleTransmitter(args.transmission_mode, services=[
            ServiceSpec(0xF123 + i, 3 + i, f"Radio TPU {i + 1}",
                        SubchannelConfig(48 * i, 48, False, eep_type="A",
                                         eep_prot_level=2))
            for i in range(args.services)], device=device)
        pad = args.audio == "tone" and args.slideshow

        def queue_pad():
            for i in range(args.services):
                if not tx._tone_source(3 + i).pad_fields:
                    tx.queue_dynamic_label(3 + i, f"Now: Radio TPU {i + 1}")
                    tx.queue_slideshow(3 + i, _test_card_png(i),
                                       name=f"card_{i}.png")
        if args.audio == "tone":
            tx.enable_tone_audio()
            if pad:
                queue_pad()

        def gen():
            if pad and args.pad_carousel:
                queue_pad()
            return tx.next_frame_iq()
    else:
        mod = OFDMModulator(args.transmission_mode, device)
        nb_bytes = p.nb_data_symbols * p.nb_data_carriers * 2 // 8
        scrambler = _dvb_scrambler_bytes(nb_bytes)

        def gen():
            return mod.modulate_reference_bytes(scrambler)

    frame_idx = 0
    while args.nb_frames == 0 or frame_idx < args.nb_frames:
        iq = gen()
        peak = np.abs(iq).max() or 1.0
        iq = iq / peak * args.scale
        if args.format == "u8":
            out.write(iq_quantize_u8(iq))
        elif args.format == "s16":
            x = np.clip(iq.view(np.float32) * 32767, -32768, 32767)
            out.write(x.astype("<i2").tobytes())
        else:
            out.write(iq.astype(np.complex64).tobytes())
        frame_idx += 1
        try:
            out.flush()
        except BrokenPipeError:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
