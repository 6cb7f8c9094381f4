"""Stream IO helpers: WAV-wrapped IQ reader and block iteration.

Parity surface: reference examples/app_helpers/app_wav_reader.h +
app_iq_readers.h: WAV files whose 2-channel PCM payload carries I/Q pairs;
sample format inferred from the fmt chunk.
"""

import struct
from typing import BinaryIO, Optional, Tuple

import numpy as np

from ..utils.profiler import profile_scope
from .native import iq_convert


def parse_wav_header(f: BinaryIO) -> Optional[Tuple[str, int, int, int]]:
    """Returns (iq_format, sample_rate, data_offset, data_size) for an IQ
    WAV, or None if the stream is not a WAV (rewinding in that case is the
    caller's job). data_size is the data chunk's declared byte length
    (0 = streaming WAV with unknown length — read to EOF)."""
    header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        return None
    fmt = None
    offset = 12
    while True:
        chunk = f.read(8)
        if len(chunk) < 8:
            return None
        cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
        offset += 8
        if cid == b"fmt ":
            data = f.read(size)
            offset += size
            audio_fmt, channels, rate, _, _, bits = struct.unpack(
                "<HHIIHH", data[:16])
            if channels != 2:
                return None
            if audio_fmt == 1 and bits == 8:
                fmt = "u8"
            elif audio_fmt == 1 and bits == 16:
                fmt = "s16le"
            elif audio_fmt == 1 and bits == 32:
                fmt = "s32le"
            elif audio_fmt == 3 and bits == 32:
                fmt = "f32le"
            elif audio_fmt == 3 and bits == 64:
                fmt = "f64le"
            else:
                return None
            sample_rate = rate
        elif cid == b"data":
            if fmt is None:
                return None
            # size 0 or 0xFFFFFFFF: streaming writers that never patch
            # the header — treat as unknown
            return fmt, sample_rate, offset, \
                (0 if size == 0xFFFFFFFF else size)
        else:
            f.read(size)
            offset += size


class IQReader:
    """Unified IQ block reader over raw or WAV-wrapped streams."""

    def __init__(self, f: BinaryIO, fmt: str = "u8"):
        self.f = f
        self.fmt = fmt
        self.sample_rate = None
        self.data_offset = 0        # rewind target for looping (WAV: the
        self.data_size = 0          # WAV data chunk bytes (0 = unknown)
        if fmt == "wav":            # data chunk, never the RIFF header)
            parsed = parse_wav_header(f)
            if parsed is None:
                raise ValueError("not a 2-channel IQ WAV stream")
            (self.fmt, self.sample_rate, self.data_offset,
             self.data_size) = parsed
        self._sat_tot = (0, 0)     # one tuple: atomic for cross-thread reads
        self._clip_warned = False

    @property
    def saturation(self) -> float:
        """Fraction of ingested u8/s8 components at full scale. A
        mis-scaled or over-driven capture hard-clips: DQPSK survives
        (clipping preserves phase) so FIC still decodes, but higher-rate
        MSC subchannels silently die — this counter is the tell. ~0 on a
        healthy capture; formats wider than 8 bits report 0."""
        sat, tot = self._sat_tot   # single read: no torn ratio off-thread
        return sat / tot if tot else 0.0

    def _track_saturation(self, raw: bytes):
        sat, tot = self._sat_tot
        if self.fmt == "u8":
            a = np.frombuffer(raw, np.uint8)
            self._sat_tot = (sat + int((a <= 0).sum() + (a >= 255).sum()),
                             tot + a.shape[0])
        elif self.fmt == "s8":
            a = np.frombuffer(raw, np.int8)
            self._sat_tot = (sat + int((a <= -128).sum()
                                       + (a >= 127).sum()),
                             tot + a.shape[0])

    def clipping_warning(self, threshold: float = 0.02) -> Optional[str]:
        """One-shot operator warning once saturation passes threshold."""
        if self._clip_warned or self.saturation <= threshold:
            return None
        self._clip_warned = True
        return (f"WARNING: {self.saturation:.0%} of IQ samples at full "
                "scale — capture is clipping (FIC may still decode; MSC "
                "will not)")

    def convert(self, raw: bytes) -> np.ndarray:
        """Raw bytes -> complex64, tracking saturation — the one
        conversion entry point for callers that manage their own reads."""
        with profile_scope("io/convert"):
            self._track_saturation(raw)
            return iq_convert(raw, self.fmt)

    def read_block(self, nb_bytes: int) -> Optional[np.ndarray]:
        raw = self.f.read(nb_bytes)
        if not raw:
            return None
        return self.convert(raw)


def u8_saturation(u8: np.ndarray) -> float:
    """Full-scale fraction of a raw u8 IQ array (the array-input twin of
    IQReader.saturation, for callers that memory-map whole captures)."""
    u8 = np.asarray(u8)
    if u8.size == 0:
        return 0.0
    return float(((u8 <= 0) | (u8 >= 255)).mean())
