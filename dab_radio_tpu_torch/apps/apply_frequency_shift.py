"""apply_frequency_shift equivalent: mix a u8 IQ stream by a frequency offset
(CFO fault injection for sync stress tests, examples/apply_frequency_shift.cpp;
port of ``dab_radio_tpu/apps/apply_frequency_shift.py``, same flags and byte
contract). Host numpy; --backend is taken for a uniform command line and
checked as every app checks it.

    python -m dab_radio_tpu_torch.apps.apply_frequency_shift -f 1200 \\
        --backend cpu < in.u8 > out.u8"""

import argparse
import sys

import numpy as np

from ..host.native import iq_convert, iq_quantize_u8
from ..params.ofdm import SAMPLE_RATE_HZ
from ..utils.backend import add_backend_flag, apply_backend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--frequency", type=float, required=True,
                    help="shift in Hz")
    ap.add_argument("-s", "--sample-rate", type=float, default=SAMPLE_RATE_HZ)
    ap.add_argument("-b", "--block-size", type=int, default=65536)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    apply_backend(args)

    freq_norm = args.frequency / args.sample_rate
    fin, fout = sys.stdin.buffer, sys.stdout.buffer
    t = 0
    while True:
        raw = fin.read(args.block_size)
        if not raw:
            break
        iq = iq_convert(raw, "u8")
        n = iq.shape[0]
        rot = np.exp(2j * np.pi * freq_norm
                     * (t + np.arange(n, dtype=np.float64)))
        fout.write(iq_quantize_u8((iq * rot).astype(np.complex64)))
        t += n
    return 0


if __name__ == "__main__":
    sys.exit(main())
