"""Minimal AAC-LC@960 access-unit encoder.

The reference's closed-loop tests fill DAB+ access units with random bytes
(it has no encoder; neither does the system ffmpeg at 960 frames). This
encoder-lite produces *valid* LC@960 raw_data_blocks from chosen quantized
spectral coefficients — long windows only, codebook-0/11 sections, uniform
scalefactors — enough for the transmitter to broadcast real decodable audio
(tones) and for e2e tests to assert non-silent PCM through the full
superframe -> AU -> core + SBR decode chain. Decoded output is verified
against libavcodec (which decodes LC@960).

Spectral bin k maps to frequency (k + 0.5) * fs / 1920.
"""

from typing import List, Optional

import numpy as np

from .bits import BitWriter, BitReader
from . import aac_tables as T
from .aac_bits import SCE, CPE, DSE, FIL, END, EXT_SBR_DATA

_ESC = T.ESC_CB  # codebook 11


def _encode_pair(bw: BitWriter, y: int, z: int):
    huff = T.spectral_huffman(_ESC)
    ay, az = abs(y), abs(z)
    idx = min(ay, 16) * 17 + min(az, 16)
    huff.encode(bw, idx)
    for v in (y, z):
        if v != 0:
            bw.write(1 if v < 0 else 0, 1)
    for v in (ay, az):
        if v >= 16:
            n = v.bit_length() - 1
            assert 4 <= n <= 12 and v < (1 << (n + 1))
            bw.write((1 << (n - 4)) - 1, n - 4)  # unary ones
            bw.write(0, 1)                       # terminator
            bw.write(v - (1 << n), n)            # offset from 2^n


def _encode_ics(bw: BitWriter, coeffs: np.ndarray, swb: np.ndarray,
                num_swb: int, global_gain: int, common_window: bool):
    """individual_channel_stream with a shared long-window ics_info written
    by the caller when common_window is set."""
    sf_huff = T.scalefactor_huffman()
    # sections: runs of all-zero sfbs (cb 0) vs data sfbs (cb 11)
    max_sfb = 0
    used = []
    for b in range(num_swb):
        lo, hi = int(swb[b]), int(swb[b + 1])
        nz = np.any(coeffs[lo:hi])
        used.append(bool(nz))
        if nz:
            max_sfb = b + 1
    used = used[:max_sfb]

    bw.write(global_gain, 8)
    if not common_window:
        _write_ics_info(bw, max_sfb)
    # section_data (5-bit lengths, esc 31)
    b = 0
    while b < max_sfb:
        cb = _ESC if used[b] else 0
        run = 1
        while b + run < max_sfb and (used[b + run] == used[b]):
            run += 1
        bw.write(cb, 4)
        r = run
        while r >= 31:
            bw.write(31, 5)
            r -= 31
        bw.write(r, 5)
        b += run
    # scale_factor_data: uniform -> dpcm delta 0 (index 60)
    for u in used:
        if u:
            sf_huff.encode(bw, 60)
    bw.write(0, 1)                          # pulse
    bw.write(0, 1)                          # tns
    bw.write(0, 1)                          # gain control
    for b in range(max_sfb):
        if not used[b]:
            continue
        lo, hi = int(swb[b]), int(swb[b + 1])
        for i in range(lo, hi, 2):
            _encode_pair(bw, int(coeffs[i]), int(coeffs[i + 1]))
    return max_sfb


def _write_ics_info(bw: BitWriter, max_sfb: int):
    bw.write(0, 1)                          # ics_reserved
    bw.write(0, 2)                          # ONLY_LONG
    bw.write(0, 1)                          # window_shape: sine
    bw.write(max_sfb, 6)
    bw.write(0, 1)                          # predictor_data_present


def encode_au_960(sampling_index: int, coeffs: np.ndarray,
                  global_gain: int = 100,
                  dse_payload: Optional[bytes] = None,
                  sbr_payload: Optional[bytes] = None,
                  sbr_payload_bits: int = 0) -> bytes:
    """coeffs: (channels, 960) int quantized spectral values (|v| <= 8191).
    channels 1 -> SCE, 2 -> CPE (common window, no M/S)."""
    coeffs = np.asarray(coeffs, np.int64)
    channels = coeffs.shape[0]
    swb = T.swb_offsets(sampling_index, 960)
    num_swb = T.num_swb(sampling_index, 960)
    bw = BitWriter()
    if dse_payload is not None:
        bw.write(DSE, 3).write(0, 4)
        n = len(dse_payload)
        assert n < 255 + 255
        bw.write(0, 1)                      # no byte-align
        if n >= 255:
            bw.write(255, 8).write(n - 255, 8)
        else:
            bw.write(n, 8)
        for byte in dse_payload:
            bw.write(byte, 8)
    if channels == 1:
        bw.write(SCE, 3).write(0, 4)
        _encode_ics(bw, coeffs[0], swb, num_swb, global_gain,
                    common_window=False)
    else:
        bw.write(CPE, 3).write(0, 4)
        bw.write(1, 1)                      # common_window
        max_sfb = 0
        for c in range(2):
            for b in range(num_swb):
                lo, hi = int(swb[b]), int(swb[b + 1])
                if np.any(coeffs[c, lo:hi]):
                    max_sfb = max(max_sfb, b + 1)
        _write_ics_info(bw, max_sfb)
        bw.write(0, 2)                      # ms_mask_present = 0
        for c in range(2):
            # per-channel sections must stay within the shared max_sfb;
            # simplest: treat every sfb < max_sfb as used for both
            _encode_ics_fixed(bw, coeffs[c], swb, max_sfb, global_gain)
    if sbr_payload is not None:
        n_bytes = (4 + sbr_payload_bits + 7) // 8
        bw.write(FIL, 3)
        if n_bytes >= 15:
            bw.write(15, 4).write(n_bytes - 14, 8)
        else:
            bw.write(n_bytes, 4)
        bw.write(EXT_SBR_DATA, 4)
        br = BitReader(sbr_payload)
        rem = sbr_payload_bits
        while rem >= 16:
            bw.write(br.read(16), 16)
            rem -= 16
        if rem:
            bw.write(br.read(rem), rem)
        bw.write(0, 8 * n_bytes - 4 - sbr_payload_bits)
    bw.write(END, 3)
    bw.align()
    return bw.tobytes()


def _encode_ics_fixed(bw: BitWriter, coeffs: np.ndarray, swb: np.ndarray,
                      max_sfb: int, global_gain: int):
    """ICS body (after shared ics_info) with all sfbs < max_sfb in one
    codebook-11 section."""
    sf_huff = T.scalefactor_huffman()
    bw.write(global_gain, 8)
    b = 0
    while b < max_sfb:
        run = min(max_sfb - b, 10 ** 9)
        bw.write(_ESC, 4)
        r = run
        while r >= 31:
            bw.write(31, 5)
            r -= 31
        bw.write(r, 5)
        b += run
    for _ in range(max_sfb):
        sf_huff.encode(bw, 60)
    bw.write(0, 1)
    bw.write(0, 1)
    bw.write(0, 1)
    hi = int(swb[max_sfb]) if max_sfb else 0
    for i in range(0, hi, 2):
        _encode_pair(bw, int(coeffs[i]), int(coeffs[i + 1]))


def tone_coeffs(sampling_rate: int, freq_hz: float, channels: int,
                amp: int = 60) -> np.ndarray:
    """Quantized spectrum with one active bin near freq_hz (core rate)."""
    k = int(round(freq_hz * 1920 / sampling_rate - 0.5))
    k = max(0, min(959, k))
    c = np.zeros((channels, 960), np.int64)
    c[:, k] = amp
    return c
