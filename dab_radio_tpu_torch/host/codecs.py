"""Audio decoders (AAC for DAB+, MP2 for classic DAB).

Mirrors the reference's AAC_Audio_Decoder (faad2, src/dab/audio/
aac_audio_decoder.cpp) and MP2_Audio_Decoder (mpg123): initialised from the
superframe header, emits interleaved int16 PCM.

DAB+ HE-AAC uses the 960-sample transform; the system libavcodec decodes the
AAC-LC@960 *core* but not SBR@960, so the decode is split: dab.aac_bits
walks the AU and strips the SBR fill element, libavcodec decodes the core to
float, and dab.sbr reconstructs the high band (differentially validated
against libavcodec's own HE-AAC@1024 SBR — see tests/test_sbr.py).
Parametric stereo (HE-AAC v2) reconstructs true stereo via dab.ps_synth
(20- and 34-band configs, differentially validated against libavcodec's
HE-AAC v2 decode); only mixed-resolution 34-band streams fall back to
duplicated mono, surfaced via AACDecoder.pcm_mode.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np

from .native import codecs_lib
from ..dab.aac import (SuperFrameHeader, mpeg4_audio_specific_config,
                       adts_header, _SAMPLE_RATE_INDEX)

_PCM_CAPACITY = 16 * 4096


class _Decoder:
    def __init__(self, kind: int, extradata: bytes = b""):
        self._lib = codecs_lib()
        self._h = None
        if self._lib is None:
            return
        buf = np.frombuffer(extradata, dtype=np.uint8) if extradata else None
        self._h = self._lib.dec_open(
            kind, buf.ctypes.data if buf is not None else None,
            len(extradata))
        self._pcm = np.empty(_PCM_CAPACITY, dtype=np.int16)
        self.total_decoded = 0
        self.total_errors = 0

    @property
    def is_available(self) -> bool:
        return self._h is not None

    def decode(self, frame: bytes) -> Optional[Tuple[np.ndarray, int, int]]:
        """Returns (pcm int16 interleaved, sample_rate, channels) or None."""
        if self._h is None:
            return None
        buf = np.frombuffer(frame, dtype=np.uint8)
        rate = ctypes.c_int32(0)
        ch = ctypes.c_int32(0)
        n = self._lib.dec_decode(self._h, buf.ctypes.data, buf.shape[0],
                                 self._pcm.ctypes.data, _PCM_CAPACITY,
                                 ctypes.byref(rate), ctypes.byref(ch))
        if n <= 0:
            self.total_errors += n < 0
            return None
        self.total_decoded += 1
        return self._pcm[:n].copy(), int(rate.value), int(ch.value)

    def _decode_f32(self, frame: bytes):
        buf = np.frombuffer(frame, dtype=np.uint8)
        pcm = np.empty(_PCM_CAPACITY, dtype=np.float32)
        rate = ctypes.c_int32(0)
        ch = ctypes.c_int32(0)
        n = self._lib.dec_decode_f32(self._h, buf.ctypes.data, buf.shape[0],
                                     pcm.ctypes.data, _PCM_CAPACITY,
                                     ctypes.byref(rate), ctypes.byref(ch))
        if n <= 0:
            return None
        return pcm[:n].copy(), int(rate.value), int(ch.value)

    def close(self):
        if self._h is not None:
            self._lib.dec_close(self._h)
            self._h = None


def _core_lc_asc(core_rate: int, channels: int) -> bytes:
    """AudioSpecificConfig for the bare AAC-LC@960 core (no SBR signaling —
    the SBR stage runs in dab.sbr, not in libavcodec)."""
    from ..dab.bits import BitWriter
    bw = BitWriter()
    bw.write(2, 5).write(_SAMPLE_RATE_INDEX[core_rate], 4)
    bw.write(channels, 4)
    bw.write(1, 1).write(0, 1).write(0, 1)   # 960 transform
    return bw.tobytes()


class AACDecoder(_Decoder):
    """DAB+ HE-AAC access-unit decoder (LC core via libavcodec + own SBR)."""

    def __init__(self, header: SuperFrameHeader):
        self.header = header
        self.pcm_mode = None      # "ps-stereo" | "ps-mono-dup" once decoding
        # PS streams carry a mono SCE core; ps_synth reconstructs stereo
        self.core_channels = 2 if (header.is_stereo and not header.ps) else 1
        super().__init__(0, _core_lc_asc(header.core_sample_rate,
                                         self.core_channels))
        from ..dab.aac_bits import RawDataBlockWalker
        self._walker = RawDataBlockWalker(
            _SAMPLE_RATE_INDEX[header.core_sample_rate], 960)
        self._sbr = None
        if header.sbr:
            from ..dab.sbr import SBRDecoder
            self._sbr = SBRDecoder(header.sampling_rate, num_time_slots=15,
                                   is_cpe=self.core_channels == 2)

    def decode_au(self, au: bytes):
        if self._h is None:
            return None
        if self._sbr is None:
            # trim any slot padding after the END element (broadcast AUs
            # fill fixed superframe slots; trailing bytes confuse
            # libavcodec's raw-AAC multi-frame parsing)
            try:
                walk = self._walker.walk(au)
                au = au[:(walk.end_bit + 7) // 8]
            except (ValueError, EOFError):
                pass
            out = self.decode(au)
            if out is None or not self.header.ps:
                return out
            pcm, rate, ch = out
            if ch == 1:
                self.pcm_mode = "ps-mono-dup"
                pcm = np.repeat(pcm.reshape(-1, 1), 2, axis=1).reshape(-1)
                ch = 2
            return pcm, rate, ch

        # SBR path: split payload, core decode in float, reconstruct
        payload = None
        core_au = au
        try:
            walk = self._walker.walk(au)
            if walk.has_sbr:
                payload = walk.sbr[0]
                core_au = self._walker.strip_sbr(au, walk)
        except (ValueError, EOFError):
            pass                           # fall back to whole-AU core decode
        out = self._decode_f32(core_au)
        if out is None:
            self.total_errors += 1
            return None
        pcm, rate, ch = out
        core = pcm.reshape(-1, max(ch, 1)).astype(np.float64)
        if payload is not None:
            up = self._sbr.decode_frame(core, payload.data, payload.nbits,
                                        payload.has_crc)
        else:
            up = self._sbr.decode_frame(core, None)
        self.total_decoded += 1
        out16 = np.clip(up, -32768, 32767).astype(np.int16)
        if self.header.ps:
            # true parametric-stereo synthesis gives 2 channels from the
            # mono core (dab/ps_synth.py, every 20/34-band and mixed-
            # resolution config incl. 5/11-band ipd upmaps); the mono-dup
            # branch is an unexpected-shape safety net, surfaced via
            # pcm_mode
            if out16.shape[1] == 2:
                self.pcm_mode = "ps-stereo"
            else:
                self.pcm_mode = "ps-mono-dup"
                out16 = np.repeat(out16[:, :1], 2, axis=1)
        elif self.header.is_stereo and ch == 1:
            out16 = np.repeat(out16[:, :1], 2, axis=1)
        return out16.reshape(-1), self.header.sampling_rate, out16.shape[1] \
            if out16.ndim > 1 else 1

    def adts_frame(self, au: bytes) -> bytes:
        """AU wrapped with an ADTS header for bitstream export."""
        return adts_header(self.header, len(au)) + au


class MP2Decoder(_Decoder):
    """Classic DAB MPEG Layer II frame decoder."""

    def __init__(self):
        super().__init__(1)
