"""MPEG-4 AAC / SBR constant tables (ISO/IEC 14496-3).

Loaded from `_aac_tables.npz`, generated by tools/extract_aac_tables.py from
the system libavcodec static archive — the same spec constants the reference
gets from its vendored faad2 (reference vendor/, .gitmodules:1-30; e.g.
src/dab/audio/aac_audio_decoder.cpp uses them via NeAACDecDecode).
"""

import functools
import json
import os

import numpy as np

from .bits import Huffman

_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_aac_tables.npz")

# MPEG-4 samplingFrequencyIndex -> rate
SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)

# spectral codebook properties (ISO/IEC 14496-3 table 4.151):
# cb -> (tuple dim, is_signed, LAV)
SPECTRAL_CB = {
    1: (4, True, 1), 2: (4, True, 1), 3: (4, False, 2), 4: (4, False, 2),
    5: (2, True, 4), 6: (2, True, 4), 7: (2, False, 7), 8: (2, False, 7),
    9: (2, False, 12), 10: (2, False, 12), 11: (2, False, 16),
}
ESC_CB = 11
NOISE_CB = 13  # PNS
INTENSITY_CB = (14, 15)


@functools.lru_cache(maxsize=1)
def _npz():
    # materialize eagerly (40 KB total): NpzFile re-reads + re-inflates the
    # zip member on EVERY key access, which was ~20% of host SBR decode
    with np.load(_NPZ) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=1)
def _manifest():
    return json.loads(bytes(_npz()["_manifest"]).decode())


def swb_offsets(sampling_index: int, frame_len: int = 960) -> np.ndarray:
    """Scalefactor-band boundary offsets for long windows (incl. trailing
    frame_len entry); indexed by MPEG-4 samplingFrequencyIndex."""
    name = _manifest()[f"ff_swb_offset_{frame_len}"][sampling_index]
    return _npz()[name]


def num_swb(sampling_index: int, frame_len: int = 960) -> int:
    return int(_npz()[f"num_swb_{frame_len}"][sampling_index])


@functools.lru_cache(maxsize=None)
def spectral_huffman(cb: int) -> Huffman:
    t = _npz()
    return Huffman(t[f"spectral_codes_{cb}"], t[f"spectral_bits_{cb}"])


@functools.lru_cache(maxsize=1)
def scalefactor_huffman() -> Huffman:
    """120-entry DPCM scalefactor codebook; decoded index - 60 = delta."""
    t = _npz()
    return Huffman(t["scalefactor_codes"], t["scalefactor_bits"])


@functools.lru_cache(maxsize=None)
def sbr_huffman(name: str) -> Huffman:
    """name in {t,f}_huff_{env,env_bal,noise,noise_bal}_{1_5dB,3_0dB}."""
    t = _npz()
    return Huffman(t[f"sbr_{name}_codes"], t[f"sbr_{name}_bits"])


@functools.lru_cache(maxsize=None)
def sbr_huffman_raw(prefix: str) -> Huffman:
    """Huffman from raw npz key prefix (e.g. 'ps_huff_iid_df1')."""
    t = _npz()
    return Huffman(t[f"{prefix}_codes"], t[f"{prefix}_bits"])


def sbr_qmf_window(downsampled: bool = False) -> np.ndarray:
    """640-tap QMF prototype (spec table 4.A.87); the 320-tap analysis
    window is its 2x decimation (computed, matching ffmpeg's runtime init —
    the archive's copy lives in .bss)."""
    us = _npz()["sbr_qmf_window_us"]
    return us[::2].copy() if downsampled else us


@functools.lru_cache(maxsize=1)
def sbr_noise_table() -> np.ndarray:
    """(512,) complex64 pseudo-noise table (spec table 4.A.88)."""
    t = _npz()["sbr_noise_table"]
    return (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)


def sbr_limiter_gains() -> np.ndarray:
    return _npz()["sbr_limgain"]


def sbr_bw_table() -> np.ndarray:
    """Inverse-filtering chirp-factor table (NONE/LOW/MID/HIGH)."""
    return _npz()["sbr_bw_tab"]


def sbr_k0_offset(sampling_rate: int) -> np.ndarray:
    """Row of the startMin offset table for k0 (spec table 4.157 aux)."""
    t = _npz()["sbr_offset"]
    if sampling_rate == 16000:
        return t[0]
    if sampling_rate == 22050:
        return t[1]
    if sampling_rate == 24000:
        return t[2]
    if sampling_rate == 32000:
        return t[3]
    if 32000 < sampling_rate <= 64000:
        return t[4]
    return t[5]
