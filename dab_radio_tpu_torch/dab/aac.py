"""DAB+ audio superframe layer (ETSI TS 102 563).

Parity surface: reference src/dab/audio/aac_frame_processor.{h,cpp}:
accumulate 5 DAB logical frames into a superframe, column-interleaved
RS(120,110) correction, firecode CRC16 sync with a desync counter (max 10),
superframe header parse (dac_rate/sbr/ps/stereo/mpeg-surround -> sampling
rate and 2/3/4/6 access units), 12-bit AU start offsets, per-AU CRC16.

Includes the encoder inverse (superframe builder) for closed-loop tests and
the ensemble transmitter, plus MPEG-4 AudioSpecificConfig / ADTS header
generation (reference src/dab/audio/aac_audio_decoder.cpp:86-296) for
bitstream export and codec initialisation.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..ops.crc import crc16, crc16_ragged, firecode_crc16
from ..ops.rs import dab_plus_rs, rs_encode

TOTAL_DAB_FRAMES = 5
DESYNC_MAX_COUNT = 10
RS_MESSAGE, RS_DATA, RS_PARITY, RS_PAD = 120, 110, 10, 135


@dataclass(frozen=True)
class SuperFrameHeader:
    sampling_rate: int            # 32000 | 48000
    is_stereo: bool
    sbr: bool                     # spectral band replication (HE-AAC)
    ps: bool                      # parametric stereo (HE-AAC v2)
    mpeg_surround: int

    @property
    def num_aus(self) -> int:
        dac = self.sampling_rate == 48000
        if self.sbr:
            return 3 if dac else 2
        return 6 if dac else 4

    @property
    def core_sample_rate(self) -> int:
        """AAC core rate (halved when SBR upsamples)."""
        return self.sampling_rate // 2 if self.sbr else self.sampling_rate


def _read_au_starts(buf: bytes, n: int) -> List[int]:
    """n 12-bit big-endian values packed at buf[0:ceil(12n/8)]."""
    vals, acc, nbits = [], 0, 0
    i = 0
    while len(vals) < n:
        acc = (acc << 8) | buf[i]
        nbits += 8
        i += 1
        while nbits >= 12 and len(vals) < n:
            vals.append((acc >> (nbits - 12)) & 0xFFF)
            nbits -= 12
    return vals


def _write_au_starts(vals: List[int]) -> bytes:
    acc, nbits = 0, 0
    out = bytearray()
    for v in vals:
        acc = (acc << 12) | (v & 0xFFF)
        nbits += 12
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


class SuperframeProcessor:
    """Streaming DAB+ superframe decoder: push one logical frame per CIF;
    returns (header, [au_payloads]) whenever a superframe validates."""

    def __init__(self):
        self.frame_bytes: Optional[int] = None
        self.buffer: List[bytes] = []
        self.is_synced = False
        self.desync_count = 0
        self.stats = {"firecode_errors": 0, "rs_errors": 0, "au_crc_errors": 0,
                      "superframes": 0, "rs_corrected_bytes": 0}

    def process_frame(self, frame: bytes):
        sf = self.push_frame(frame)
        if sf is None:
            return None
        arr = np.frombuffer(sf, dtype=np.uint8).reshape(
            RS_MESSAGE, len(sf) // RS_MESSAGE)
        corrected, nerr = dab_plus_rs().decode(arr.T.copy())
        return self.finish(corrected, nerr)

    def push_frame(self, frame: bytes):
        """Accumulation half of process_frame: returns the raw assembled
        superframe bytes once TOTAL_DAB_FRAMES are buffered, else None.
        The caller must RS-decode the column-deinterleaved codewords and
        call finish() before the next push — this split lets a serving
        fleet batch ONE RS decode across every stream's completed
        superframes per round (FusedFleet._consume) instead of paying
        the Berlekamp-Massey dispatch overhead per superframe."""
        if self.frame_bytes != len(frame):
            self.frame_bytes = len(frame)
            self.buffer.clear()
            self.is_synced = False

        if self.desync_count >= DESYNC_MAX_COUNT:
            self.desync_count = 0
            self.is_synced = False

        if not self.is_synced and not self.buffer:
            if not self._firecode_ok(frame):
                self.stats["firecode_errors"] += 1
                return None

        self.buffer.append(bytes(frame))
        if len(self.buffer) < TOTAL_DAB_FRAMES:
            return None
        sf = b"".join(self.buffer)
        self.buffer.clear()
        return sf

    @staticmethod
    def _firecode_ok(buf: bytes) -> bool:
        rx = (buf[0] << 8) | buf[1]
        # all-zero header window: CRC16(init 0) of zeros is 0, which would
        # false-sync inside zero padding regions; a real superframe header
        # is never all-zero (byte 2 carries the audio params)
        if rx == 0 and not any(buf[2:11]):
            return False
        return firecode_crc16(buf[2:11]) == rx

    def finish(self, corrected: np.ndarray, nerr: np.ndarray):
        """Post-RS half of process_frame: corrected (n_cols, 120) uint8
        codewords + per-codeword error counts (-1 = uncorrectable) from
        push_frame's superframe. Returns (header, [au_payloads]) or
        None."""
        if (nerr < 0).any():
            self.stats["rs_errors"] += 1
            self.desync_count += 1
            return None
        self.stats["rs_corrected_bytes"] += int(nerr.sum())
        sf = np.ascontiguousarray(corrected.T).reshape(-1).tobytes()
        n_cols = corrected.shape[0]

        if not self._firecode_ok(sf):
            self.stats["firecode_errors"] += 1
            self.desync_count += 1
            return None
        self.desync_count = 0
        self.is_synced = True

        d = sf[2]
        dac_rate = (d >> 6) & 1
        header = SuperFrameHeader(
            sampling_rate=48000 if dac_rate else 32000,
            is_stereo=bool((d >> 4) & 1),
            sbr=bool((d >> 5) & 1),
            ps=bool((d >> 3) & 1),
            mpeg_surround=d & 0b111)

        num_aus = header.num_aus
        starts = [0] * (num_aus + 1)
        au_start_bytes = -(-(12 * (num_aus - 1)) // 8)
        starts[1:num_aus] = _read_au_starts(sf[3:], num_aus - 1)
        starts[0] = 3 + au_start_bytes
        starts[num_aus] = RS_DATA * n_cols

        # per-AU CRC16, one ragged native call for the whole superframe
        spans = []
        for i in range(num_aus):
            a, b = starts[i], starts[i + 1]
            if b - a < 2 or b > len(sf):
                self.stats["au_crc_errors"] += 1
            else:
                spans.append((a, b))
        crcs = crc16_ragged([sf[a:b - 2] for a, b in spans])
        aus = []
        for (a, b), crc in zip(spans, crcs):
            if ((sf[b - 2] << 8) | sf[b - 1]) == crc:
                aus.append(sf[a:b - 2])
            else:
                self.stats["au_crc_errors"] += 1
        self.stats["superframes"] += 1
        return header, aus


class SuperframeEncoder:
    """Inverse path: AU payloads -> 5 logical frames (tests/transmitter)."""

    def __init__(self, frame_bytes: int, header: SuperFrameHeader):
        if (frame_bytes * TOTAL_DAB_FRAMES) % RS_MESSAGE:
            raise ValueError("superframe size must be a multiple of 120")
        self.frame_bytes = frame_bytes
        self.header = header
        self.n_cols = frame_bytes * TOTAL_DAB_FRAMES // RS_MESSAGE

    def au_capacity(self) -> int:
        """Total AU payload bytes (excluding per-AU CRCs) in one superframe."""
        num_aus = self.header.num_aus
        au_start_bytes = -(-(12 * (num_aus - 1)) // 8)
        return RS_DATA * self.n_cols - 3 - au_start_bytes - 2 * num_aus

    def encode(self, au_payloads: List[bytes]) -> List[bytes]:
        h = self.header
        num_aus = h.num_aus
        assert len(au_payloads) == num_aus
        au_start_bytes = -(-(12 * (num_aus - 1)) // 8)
        data_len = RS_DATA * self.n_cols

        aus = [p + crc16(p).to_bytes(2, "big") for p in au_payloads]
        starts = [3 + au_start_bytes]
        for a in aus[:-1]:
            starts.append(starts[-1] + len(a))
        # TS 102 563: the last AU extends to the end of the payload, so the
        # AUs must exactly fill it (au_capacity() gives the byte budget)
        if starts[-1] + len(aus[-1]) != data_len:
            raise ValueError(
                f"access units must exactly fill the superframe payload: "
                f"{starts[-1] + len(aus[-1])} != {data_len}")

        d = ((1 if h.sampling_rate == 48000 else 0) << 6) \
            | (int(h.sbr) << 5) | (int(h.is_stereo) << 4) \
            | (int(h.ps) << 3) | (h.mpeg_surround & 0b111)
        body = bytearray(data_len)
        body[2] = d
        body[3:3 + au_start_bytes] = _write_au_starts(starts[1:])
        pos = starts[0]
        for a in aus:
            body[pos:pos + len(a)] = a
            pos += len(a)
        fc = firecode_crc16(bytes(body[2:11]))
        body[0], body[1] = fc >> 8, fc & 0xFF

        # RS parity per column-interleaved codeword
        msgs = np.frombuffer(bytes(body), dtype=np.uint8).reshape(RS_DATA, self.n_cols).T
        codewords = rs_encode(msgs, RS_PARITY, RS_PAD)          # (n_cols, 120)
        sf = codewords.T.reshape(-1).tobytes()
        return [sf[i * self.frame_bytes:(i + 1) * self.frame_bytes]
                for i in range(TOTAL_DAB_FRAMES)]


# ---- bitstream headers for export / codec init ----

_SAMPLE_RATE_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4,
                      32000: 5, 24000: 6, 22050: 7, 16000: 8, 12000: 9,
                      11025: 10, 8000: 11}


def mpeg4_audio_specific_config(header: SuperFrameHeader) -> bytes:
    """AudioSpecificConfig for the DAB+ AAC stream (AAC-LC core, 960-sample
    frames, explicit SBR extension), mirroring the reference's hand-built
    bitstream (aac_audio_decoder.cpp:86-251)."""
    bits = []

    def put(v, n):
        for k in range(n - 1, -1, -1):
            bits.append((v >> k) & 1)

    core_rate = header.core_sample_rate
    put(2, 5)                                   # AAC-LC
    put(_SAMPLE_RATE_INDEX[core_rate], 4)
    put(2 if header.is_stereo else 1, 4)        # channel configuration
    put(1, 1)                                   # frameLengthFlag: 960 transform
    put(0, 1)                                   # dependsOnCoreCoder
    put(0, 1)                                   # extensionFlag
    if header.sbr:
        put(0x2B7, 11)                          # sync extension
        put(5, 5)                               # SBR object type
        put(1, 1)                               # SBR present
        put(_SAMPLE_RATE_INDEX[header.sampling_rate], 4)
    while len(bits) % 8:
        bits.append(0)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def adts_header(header: SuperFrameHeader, nb_au_bytes: int) -> bytes:
    """7-byte ADTS header for raw-AAC export (reference GetMPEG4Header;
    note DAB+ uses 960-sample frames which ADTS cannot express — players
    treat the stream as 1024, same caveat as the reference's exports)."""
    rate_idx = _SAMPLE_RATE_INDEX[header.core_sample_rate]
    channels = 2 if header.is_stereo else 1
    frame_len = nb_au_bytes + 7
    b = bytearray(7)
    b[0] = 0xFF
    b[1] = 0xF1                                  # MPEG-4, layer 0, no CRC
    b[2] = (1 << 6) | (rate_idx << 2) | ((channels >> 2) & 1)
    b[3] = ((channels & 0b11) << 6) | ((frame_len >> 11) & 0b11)
    b[4] = (frame_len >> 3) & 0xFF
    b[5] = ((frame_len & 0b111) << 5) | 0b11111
    b[6] = 0b11111100
    return bytes(b)
