"""BER-vs-SNR sweep: closed-loop modulator -> channel -> demodulator (port
of ``dab_radio_tpu/apps/ber_sweep.py``, same flags and CSV columns).

The quantitative version of the reference's manual stress tests
(simulate_transmitter + apply_frequency_shift): the FIC portion of every
frame carries real encoded FIBs, so the sweep measures
  raw_ber       hard-decision BER at the demodulator output (aligned to the
                lock offset; the pre-convergence first frame is reported
                separately via first_frame_ber)
  vit_byte_err  post-Viterbi byte error rate of the decoded FIB groups
  fib_crc_rate  fraction of FIBs passing CRC16
across an SNR range. Prints a CSV table.

The channel is models.channel.ChannelModel (host numpy): AWGN + CFO by
default, plus optional TDL multipath/SFN echoes (--echo
"delay_us:gain_db[:doppler[:r]]") and continuous sample-clock drift
(--drift-ppm). The modulator, the demodulator and the FIC decode run on the
device --backend names (default cuda; raises without a GPU); on a GPU the
FIC groups of a frame are one launch of the fused Viterbi kernel.

    python -m dab_radio_tpu_torch.apps.ber_sweep --snr 2,14 --cfo 1200
"""

import argparse
import sys

import numpy as np

from ..models.modulator import OFDMModulator
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..models.channel import ChannelModel, parse_echo_spec
from ..dab.fic import FICDecoder, FICEncoder
from ..ops.scrambler import prbs_bytes
from ..ops.viterbi import viterbi_decode
from ..utils.backend import add_backend_flag, apply_backend, to_device


def run_point(mode: int, snr_db: float, cfo_hz: float, nb_frames: int,
              seed: int = 0, taps=(), drift_ppm: float = 0.0, *, device):
    mod = OFDMModulator(mode, device)
    demod = OFDMDemodulator(mode, device=device)
    fic_enc = FICEncoder(mode)
    fic_dec = FICDecoder(mode, device)
    dab = fic_enc.dab
    rng = np.random.default_rng(seed)
    p = mod.params

    # per frame: real FIC content + random MSC bits
    frames_bits = []
    tx_group_bytes = []         # (F, G, 96) expected post-Viterbi bytes
    for _ in range(nb_frames):
        payloads = [rng.integers(0, 256, 28).astype(np.uint8).tobytes()
                    for _ in range(dab.nb_fibs)]
        fic_soft = fic_enc.encode_fic(payloads)
        fic_bits = (fic_soft > 0).astype(np.uint8)
        msc_bits = rng.integers(0, 2, dab.nb_msc_bits).astype(np.uint8)
        frames_bits.append(np.concatenate([fic_bits, msc_bits]))
        fibs = [np.frombuffer(bytes(fic_enc.encode_fib_payload(pl)), np.uint8)
                for pl in payloads]
        per_cif = dab.nb_fibs_per_cif
        groups = [np.concatenate(fibs[g * per_cif:(g + 1) * per_cif])
                  for g in range(dab.nb_cifs)]
        tx_group_bytes.append(np.stack(groups))
    bits = np.stack(frames_bits).reshape(
        nb_frames, p.nb_data_symbols, 2 * p.nb_data_carriers)
    iq = mod.modulate_stream(bits).cpu().numpy()

    lead = 20000
    x = np.concatenate([np.zeros(lead, np.complex64), iq,
                        np.zeros(2 * p.nb_frame_samples, np.complex64)])
    channel = ChannelModel(
        taps=list(taps), cfo_hz=cfo_hz, drift_ppm=drift_ppm, snr_db=snr_db,
        seed=seed,
        # calibrate SNR against the faded signal, not the silent lead/tail
        snr_ref=(lead + p.nb_frame_samples // 2, lead + iq.shape[0]))

    sd = StreamingDemodulator(demod)
    frames = sd.process(channel.apply(x))

    # align the locked frames to the tx stream (lock may start late). Anchor
    # on the first frame that clearly matches some tx frame: frame 0 can be
    # pure noise at pathological CFOs (exactly half-bin: the fractional
    # detector's sign is genuinely ambiguous for one frame), and anchoring on
    # noise misaligns every subsequent comparison.
    ref_flat = [b.reshape(-1) for b in bits]
    offset, first_ber = 0, 1.0
    for k, fr in enumerate(frames):
        hard = (np.asarray(fr) > 0).astype(np.uint8)
        bers = [float((hard != r).mean()) for r in ref_flat]
        j = int(np.argmin(bers))
        if k == 0:
            first_ber, offset = bers[j], j
        if bers[j] < 0.3:
            offset = j - k
            break

    errs = total = 0
    vit_byte_errs = vit_bytes = 0
    crc_pass = crc_total = 0
    for k, soft in enumerate(frames):
        j = offset + k
        if j >= nb_frames:
            break
        if k == 0 or j < 0:   # pre-convergence; reported via first_frame_ber
            continue
        hard = (np.asarray(soft) > 0).astype(np.uint8)
        errs += int((hard != ref_flat[j]).sum())
        total += ref_flat[j].size

        fic_soft = np.asarray(soft).reshape(-1)[: dab.nb_fic_bits]
        groups = to_device(fic_soft.reshape(fic_dec.nb_groups, -1), device)
        dec_bits = viterbi_decode(groups, fic_dec.spec)[0].cpu().numpy(
            ).astype(np.uint8)
        data = np.packbits(dec_bits, axis=-1)
        data ^= prbs_bytes(data.shape[1])[None, :]
        vit_byte_errs += int((data != tx_group_bytes[j]).sum())
        vit_bytes += data.size
        fibs, info = fic_dec.postprocess(dec_bits)
        crc_pass += len(fibs)
        crc_total += dab.nb_fibs

    return {
        "snr_db": snr_db,
        "locked_frames": len(frames),
        "raw_ber": errs / total if total else 1.0,
        "first_frame_ber": first_ber,
        "vit_byte_err": vit_byte_errs / vit_bytes if vit_bytes else 1.0,
        "fib_crc_rate": crc_pass / crc_total if crc_total else 0.0,
        "desync": int(sd.carry.total_desync),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--snr", default="0,3,6,9,12,15,20",
                    help="comma-separated SNR points (dB)")
    ap.add_argument("--cfo", type=float, default=0.0, help="CFO in Hz")
    ap.add_argument("-n", "--nb-frames", type=int, default=4)
    ap.add_argument("--echo", default="",
                    help="TDL taps 'delay_us:gain_db[:doppler_hz[:r]]', "
                         "comma-separated (e.g. '240:-3' = SFN echo at the "
                         "mode-I guard edge)")
    ap.add_argument("--drift-ppm", type=float, default=0.0,
                    help="continuous sample-clock drift in ppm")
    ap.add_argument("--seed", type=int, default=0)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)
    taps = parse_echo_spec(args.echo) if args.echo else []

    cols = ["snr_db", "locked_frames", "raw_ber", "first_frame_ber",
            "vit_byte_err", "fib_crc_rate", "desync"]
    print(",".join(cols))
    for snr in [float(s) for s in args.snr.split(",")]:
        r = run_point(args.transmission_mode, snr, args.cfo, args.nb_frames,
                      seed=args.seed, taps=taps, drift_ppm=args.drift_ppm,
                      device=device)
        print(f"{r['snr_db']},{r['locked_frames']},{r['raw_ber']:.6f},"
              f"{r['first_frame_ber']:.4f},{r['vit_byte_err']:.6f},"
              f"{r['fib_crc_rate']:.3f},{r['desync']}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
