"""loop_file equivalent: replay a file to stdout forever, optionally paced to
a byte rate (examples/loop_file.cpp, incl. WAV data-chunk awareness; port of
``dab_radio_tpu/apps/loop_file.py``, same flags). Host code."""

import argparse
import struct
import sys
import time

from ..utils.backend import add_backend_flag, apply_backend


def _wav_data_offset(f) -> int:
    """If the file is a WAV, return the offset of the data chunk payload."""
    header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        return 0
    off = 12
    while True:
        chunk = f.read(8)
        if len(chunk) < 8:
            return 0
        cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
        off += 8
        if cid == b"data":
            return off
        f.seek(size, 1)
        off += size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-b", "--block-size", type=int, default=65536)
    ap.add_argument("-r", "--rate", type=float, default=0.0,
                    help="bytes/s pacing; 0 = as fast as possible")
    ap.add_argument("-n", "--loops", type=int, default=0, help="0 = forever")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    apply_backend(args)

    out = sys.stdout.buffer
    loops = 0
    with open(args.input, "rb") as f:
        data_start = _wav_data_offset(f)
        while args.loops == 0 or loops < args.loops:
            f.seek(data_start)
            while True:
                raw = f.read(args.block_size)
                if not raw:
                    break
                try:
                    out.write(raw)
                    out.flush()
                except BrokenPipeError:
                    return 0
                if args.rate > 0:
                    time.sleep(len(raw) / args.rate)
            loops += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
