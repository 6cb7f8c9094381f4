"""Classic DAB (MP2 / MPEG-1,2 Layer II) frame handling.

Parity surface: reference src/dab/audio/mp2_audio_decoder.cpp: parse the MPEG
audio frame header (the reference gets it from mpg123 frame info), locate the
X-PAD/F-PAD around the scale-factor CRC at the frame tail (ETSI TS 103 466
figure 5 / clause B.3: 4 CRC bytes, or 2 when 48 kHz MPEG-1 Layer II below
56 kbps per channel), and hand PCM decode to the host codecs module.
"""

from dataclasses import dataclass
from typing import Optional

from .pad import PADProcessor, MAX_XPAD_BYTES

# MPEG-1 Layer II bitrates (kbps), index 1..14
_BITRATES_V1_L2 = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                   320, 384]
_BITRATES_V2_L2 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                   160]
_RATES_V1 = [44100, 48000, 32000]
_RATES_V2 = [22050, 24000, 16000]


@dataclass
class MP2FrameHeader:
    mpeg_version: int          # 1 or 2
    sample_rate: int
    bitrate_kbps: int
    is_stereo: bool
    frame_bytes: int


def parse_mp2_header(buf: bytes) -> Optional[MP2FrameHeader]:
    if len(buf) < 4 or buf[0] != 0xFF or (buf[1] & 0xE0) != 0xE0:
        return None
    version_bits = (buf[1] >> 3) & 0b11
    layer_bits = (buf[1] >> 1) & 0b11
    if layer_bits != 0b10:                 # Layer II
        return None
    if version_bits == 0b11:
        version, rates, bitrates = 1, _RATES_V1, _BITRATES_V1_L2
    elif version_bits == 0b10:
        version, rates, bitrates = 2, _RATES_V2, _BITRATES_V2_L2
    else:
        return None
    bitrate_idx = (buf[2] >> 4) & 0xF
    rate_idx = (buf[2] >> 2) & 0b11
    padding = (buf[2] >> 1) & 1
    mode = (buf[3] >> 6) & 0b11
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None
    bitrate = bitrates[bitrate_idx]
    rate = rates[rate_idx]
    nb_samples = 1152
    frame_bytes = nb_samples * bitrate * 1000 // 8 // rate + padding
    return MP2FrameHeader(version, rate, bitrate, mode != 0b11, frame_bytes)


def locate_pad(frame: bytes, header: MP2FrameHeader):
    """Return (fpad, xpad_reversed) slices of an MP2 DAB audio frame."""
    fpad = frame[-2:]
    crc_bytes = 4
    if (header.sample_rate == 48000 and header.mpeg_version == 1):
        channels = 2 if header.is_stereo else 1
        if header.bitrate_kbps // channels < 56:
            crc_bytes = 2
    xpad = frame[: len(frame) - 2 - crc_bytes]
    if len(xpad) > MAX_XPAD_BYTES:
        xpad = xpad[-MAX_XPAD_BYTES:]
    return fpad, xpad


class MP2PadExtractor:
    """Per-frame PAD extraction for classic DAB channels."""

    def __init__(self):
        self.pad = PADProcessor()

    def process_frame(self, frame: bytes) -> Optional[MP2FrameHeader]:
        header = parse_mp2_header(frame)
        if header is None:
            return None
        fpad, xpad = locate_pad(frame, header)
        self.pad.process(fpad, xpad)
        return header
