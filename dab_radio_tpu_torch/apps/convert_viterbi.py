"""convert_viterbi equivalent: lossy soft<->hard bit stream conversion
(8x compression), same byte contract as examples/convert_viterbi.cpp (port
of ``dab_radio_tpu/apps/convert_viterbi.py``, same flags). Host numpy."""

import argparse
import sys

import numpy as np

from ..host.native import soft_to_hard, hard_to_soft
from ..utils.backend import add_backend_flag, apply_backend


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-d", "--decompress", action="store_true",
                    help="hard packed bytes -> int8 soft bits")
    ap.add_argument("-b", "--block-size", type=int, default=65536)
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    apply_backend(args)

    fin, fout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        raw = fin.read(args.block_size)
        if not raw:
            break
        if args.decompress:
            fout.write(hard_to_soft(raw, len(raw) * 8).tobytes())
        else:
            soft = np.frombuffer(raw, dtype=np.int8)
            n = (soft.shape[0] // 8) * 8
            fout.write(soft_to_hard(soft[:n]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
