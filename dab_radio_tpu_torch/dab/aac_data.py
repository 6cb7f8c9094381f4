"""PAD extraction from AAC access units (DAB+).

Parity surface: reference src/dab/audio/aac_data_decoder.cpp — the PAD rides
in the AAC data_stream_element() (syntax reverse-engineered from libfaad):
element type 4, 8-bit length with 255-escape, F-PAD at the tail and X-PAD
(byte-reversed) before it (ETSI TS 102 563 clause 5.4).
"""

from .pad import PADProcessor


class AACDataDecoder:
    def __init__(self):
        self.pad = PADProcessor()

    def process_access_unit(self, au: bytes) -> bool:
        """Extract and route PAD from one AAC access unit; returns True if a
        data_stream_element was found."""
        ok = self._process_dse(au)
        if not ok:
            self.pad.process(b"\x00\x00", b"")
        return ok

    def _process_dse(self, data: bytes) -> bool:
        if len(data) < 2:
            return False
        data_type = (data[0] >> 5) & 0b111
        if data_type != 4:                    # syntax: data_stream_element
            return False
        i = 1
        length = data[i]
        i += 1
        if length == 255:
            if len(data) < 3:
                return False
            length += data[i]
            i += 1
        if length > len(data) - i or length < 2:
            return False
        pad = data[i:i + length]
        xpad = pad[:-2]
        fpad = pad[-2:]
        self.pad.process(fpad, xpad)
        return True


def build_data_stream_element(fpad: bytes, xpad: bytes) -> bytes:
    """TX-side inverse (tests/transmitter): wrap PAD into a
    data_stream_element prefix suitable for prepending to an AU."""
    payload = bytes(xpad) + bytes(fpad)
    n = len(payload)
    if n < 255:
        return bytes([4 << 5, n]) + payload
    assert n <= 255 + 254
    return bytes([4 << 5, 255, n - 255]) + payload
