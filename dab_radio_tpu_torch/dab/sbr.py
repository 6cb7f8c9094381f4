"""Spectral Band Replication decoder (ISO/IEC 14496-3 clause 4.6.18).

DAB+ uses HE-AAC with the 960-sample transform; mainstream decoders
(including the system libavcodec) only implement SBR at 1024, which is why
the reference vendors faad2 (src/dab/audio/aac_audio_decoder.cpp:86-251).
Here SBR is implemented as a stand-alone stage: the AAC-LC@960 core decodes
through libavcodec (which supports it), the SBR payload is split out of the
AU by dab.aac_bits, and this module reconstructs the high band — QMF
analysis of the core PCM, LPC-based high-frequency generation, envelope
adjustment, 64-band QMF synthesis to PCM at 2x rate.

The algorithm is parameterized by numTimeSlots so the identical code path
runs at 16 slots (1024 frames), where it is differentially validated against
libavcodec's own conformant SBR decode, and at 15 slots (960 frames) for
DAB+.

Huffman/QMF/noise tables are the ISO spec constants extracted from the
system libavcodec archive (see tools/extract_aac_tables.py).
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bits import BitReader
from . import aac_tables as T
from ..ops.qmf import AnalysisQMF, SynthesisQMF

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
_EPS = 1e-12
_EPS0 = 1e-8
# gain smoothing filter (spec table 4.190, bs_smoothing_mode == 0)
_H_SMOOTH = np.array([0.33333333333333, 0.30150283239582, 0.21816949906249,
                      0.11516383427084, 0.03183050093751])
_MAX_BOOST = 1.584893192  # +2 dB
_HIGH_CAL = 2.0 ** -1.5   # high-band amplitude calibration (see _adjust)
_T_HF_GEN = 8   # LPC history slots kept in X_low
_T_HF_ADJ = 2   # envelope-adjustment slot offset


class SBRError(ValueError):
    pass


# --------------------------------------------------------------------------
# header + frequency band tables
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SBRHeader:
    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 0
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1


def parse_sbr_header(br: BitReader) -> SBRHeader:
    amp_res = br.read1()
    start_freq = br.read(4)
    stop_freq = br.read(4)
    xover_band = br.read(3)
    br.skip(2)  # bs_reserved
    extra1 = br.read1()
    extra2 = br.read1()
    h = dict(amp_res=amp_res, start_freq=start_freq, stop_freq=stop_freq,
             xover_band=xover_band)
    if extra1:
        h.update(freq_scale=br.read(2), alter_scale=br.read1(),
                 noise_bands=br.read(2))
    if extra2:
        h.update(limiter_bands=br.read(2), limiter_gains=br.read(2),
                 interpol_freq=br.read1(), smoothing_mode=br.read1())
    return SBRHeader(**h)


def write_sbr_header(bw, h: SBRHeader):
    d = SBRHeader()
    extra1 = (h.freq_scale, h.alter_scale, h.noise_bands) != (
        d.freq_scale, d.alter_scale, d.noise_bands)
    extra2 = (h.limiter_bands, h.limiter_gains, h.interpol_freq,
              h.smoothing_mode) != (d.limiter_bands, d.limiter_gains,
                                    d.interpol_freq, d.smoothing_mode)
    bw.write(h.amp_res, 1).write(h.start_freq, 4).write(h.stop_freq, 4)
    bw.write(h.xover_band, 3).write(0, 2)
    bw.write(int(extra1), 1).write(int(extra2), 1)
    if extra1:
        bw.write(h.freq_scale, 2).write(h.alter_scale, 1)
        bw.write(h.noise_bands, 2)
    if extra2:
        bw.write(h.limiter_bands, 2).write(h.limiter_gains, 2)
        bw.write(h.interpol_freq, 1).write(h.smoothing_mode, 1)


def _k0_k2(h: SBRHeader, fs: int):
    """First (k0) and last (k2) QMF bands of the master table; fs is the SBR
    (output) sampling rate. Spec 4.6.18.3.2.1."""
    temp = 3000 if fs < 32000 else (4000 if fs < 64000 else 5000)
    start_min = (temp * 128 + fs // 2) // fs
    stop_min = (temp * 256 + fs // 2) // fs
    k0 = start_min + int(T.sbr_k0_offset(fs)[h.start_freq])
    if h.stop_freq == 14:
        k2 = 2 * k0
    elif h.stop_freq == 15:
        k2 = 3 * k0
    else:
        ratio = 64.0 / stop_min
        bounds = [round(stop_min * ratio ** (k / 13.0)) for k in range(14)]
        dk = sorted(b - a for a, b in zip(bounds[:-1], bounds[1:]))
        k2 = stop_min + sum(dk[: h.stop_freq])
    k2 = min(64, k2)
    if k0 >= k2:
        raise SBRError(f"k0 {k0} >= k2 {k2}")
    if fs == 44100 and k2 - k0 > 35:
        raise SBRError("too many QMF subbands")
    if fs >= 48000 and k2 - k0 > 32:
        raise SBRError("too many QMF subbands")
    if fs < 44100 and k2 - k0 > 48:
        raise SBRError("too many QMF subbands")
    return k0, k2


def make_master_table(h: SBRHeader, fs: int) -> np.ndarray:
    k0, k2 = _k0_k2(h, fs)
    if h.freq_scale == 0:
        dk = 2 if h.alter_scale else 1
        if dk == 2:
            n_master = ((k2 - k0 + 2) >> 1) & ~1
        else:
            n_master = (k2 - k0) & ~1
        if n_master <= 0:
            raise SBRError("empty master table")
        vdk = [dk] * n_master
        k2_diff = k2 - k0 - n_master * dk
        i, step = (0, 1) if k2_diff < 0 else (n_master - 1, -1)
        while k2_diff != 0:
            vdk[i] += 1 if k2_diff > 0 else -1
            k2_diff += -1 if k2_diff > 0 else 1
            i += step
        return np.concatenate([[k0], k0 + np.cumsum(vdk)]).astype(np.int64)

    bands = {1: 12, 2: 10, 3: 8}[h.freq_scale]
    two_regions = k2 / k0 > 2.2449
    k1 = 2 * k0 if two_regions else k2

    def warped(ka, kb, nb):
        pts = [round(ka * (kb / ka) ** (i / nb)) for i in range(nb + 1)]
        dk = sorted(b - a for a, b in zip(pts[:-1], pts[1:]))
        if dk and dk[0] == 0:
            raise SBRError("zero-width band")
        return dk

    nb0 = 2 * round(bands * math.log2(k1 / k0) / 2.0)
    if nb0 <= 0:
        raise SBRError("empty master table")
    vdk0 = warped(k0, k1, nb0)
    table = np.concatenate([[k0], k0 + np.cumsum(vdk0)])
    if two_regions:
        warp = 1.3 if h.alter_scale else 1.0
        nb1 = 2 * round(bands * math.log2(k2 / k1) / (2.0 * warp))
        if nb1 > 0:
            vdk1 = warped(k1, k2, nb1)
            if vdk1[0] < vdk0[-1]:
                change = min(vdk0[-1] - vdk1[0],
                             (vdk1[-1] - vdk1[0]) // 2)
                vdk1[0] += change
                vdk1[-1] -= change
                vdk1 = sorted(vdk1)
            table = np.concatenate([table, k1 + np.cumsum(vdk1)])
    return table.astype(np.int64)


@dataclass
class FreqTables:
    k0: int
    k2: int
    kx: int               # first SBR band
    M: int                # number of SBR bands
    f_master: np.ndarray
    f_high: np.ndarray    # high-res envelope borders (QMF bands)
    f_low: np.ndarray
    f_noise: np.ndarray
    f_lim: np.ndarray     # limiter borders, relative to kx
    n: tuple              # (N_low, N_high)
    patch_start: List[int] = field(default_factory=list)
    patch_num: List[int] = field(default_factory=list)


def make_freq_tables(h: SBRHeader, fs: int) -> FreqTables:
    f_master = make_master_table(h, fs)
    n_master = len(f_master) - 1
    if h.xover_band >= n_master:
        raise SBRError("xover_band out of range")
    f_high = f_master[h.xover_band:]
    n_high = len(f_high) - 1
    n_low = n_high - n_high // 2
    idx = [0] + [2 * i - (n_high & 1) for i in range(1, n_low + 1)]
    f_low = f_high[idx]
    kx = int(f_high[0])
    M = int(f_high[-1]) - kx
    if kx > 32 or kx + M > 64:
        raise SBRError("SBR range outside QMF bank")
    k2 = int(f_high[-1])
    k0 = int(f_master[0])

    nq = max(1, round(h.noise_bands * math.log2(k2 / kx)))
    nq = min(nq, 5)
    if nq > n_low:
        nq = n_low
    f_noise = [int(f_low[0])]
    i = 0
    for k in range(1, nq + 1):
        i += (n_low - i) // (nq - k + 1)
        f_noise.append(int(f_low[i]))
    f_noise = np.asarray(f_noise, np.int64)

    ft = FreqTables(k0=k0, k2=k2, kx=kx, M=M, f_master=f_master,
                    f_high=f_high.copy(), f_low=f_low.copy(),
                    f_noise=f_noise, f_lim=None, n=(n_low, n_high))
    _make_patches(ft, fs)
    _make_limiter(ft, h)
    return ft


def _make_patches(ft: FreqTables, fs: int):
    """Patch construction, spec 4.6.18.6.3."""
    goal_sb = (2048000 + fs // 2) // fs
    k0, kx, M = ft.k0, ft.kx, ft.M
    f_master = ft.f_master
    n_master = len(f_master) - 1
    msb = k0
    usb = kx
    if goal_sb < kx + M:
        k = 0
        while int(f_master[k]) < goal_sb:
            k += 1
    else:
        k = n_master
    ft.patch_start, ft.patch_num = [], []
    while True:
        j = k + 1
        odd = 0
        sb = 0
        while True:
            j -= 1
            sb = int(f_master[j])
            odd = (sb - 2 + k0) & 1
            if sb <= k0 - 1 + msb - odd:
                break
        patch_num = max(sb - usb, 0)
        patch_start = k0 - odd - patch_num
        if patch_num > 0:
            ft.patch_start.append(patch_start)
            ft.patch_num.append(patch_num)
            usb = sb
            msb = sb
        else:
            msb = kx
        if int(f_master[k]) - sb < 3:
            k = n_master
        if sb == kx + M:
            break
        if len(ft.patch_start) > 6:
            raise SBRError("too many patches")


def _make_limiter(ft: FreqTables, h: SBRHeader):
    """Limiter frequency table, spec 4.6.18.3.2.3 — patch borders merged
    with f_low, thinned to a target density in bands/octave."""
    kx = ft.kx
    borders = set(int(b) - kx for b in ft.f_low)
    patch_borders = {0, ft.M}
    acc = kx
    for n in ft.patch_num:
        acc += n
        patch_borders.add(acc - kx)
    borders |= patch_borders
    lims = sorted(b for b in borders if 0 <= b <= ft.M)
    if h.limiter_bands == 0:
        ft.f_lim = np.asarray([0, ft.M], np.int64)
        return
    dens = {1: 1.2, 2: 2.0, 3: 3.0}[h.limiter_bands]
    out = list(lims)
    i = 1
    while i < len(out):
        lo, hi = out[i - 1], out[i]
        octaves = math.log2((hi + kx) / (lo + kx)) if lo + kx > 0 else 1.0
        if octaves < 0.49 / dens:
            if lo == hi or (hi in patch_borders and lo not in patch_borders):
                out.pop(i - 1) if lo not in patch_borders else out.pop(i)
            elif lo not in patch_borders:
                out.pop(i - 1)
            else:
                out.pop(i)
            i = max(i - 1, 1)
        else:
            i += 1
    if out[0] != 0:
        out.insert(0, 0)
    if out[-1] != ft.M:
        out.append(ft.M)
    ft.f_lim = np.asarray(sorted(set(out)), np.int64)


# --------------------------------------------------------------------------
# per-frame channel data
# --------------------------------------------------------------------------

@dataclass
class ChannelData:
    frame_class: int = FIXFIX
    n_env: int = 1
    t_env: List[int] = field(default_factory=lambda: [0, 0])
    freq_res: List[int] = field(default_factory=lambda: [1])
    pointer: int = 0
    l_a: int = -1
    n_q: int = 1
    t_q: List[int] = field(default_factory=lambda: [0, 0])
    df_env: List[int] = field(default_factory=list)
    df_noise: List[int] = field(default_factory=list)
    invf_mode: List[int] = field(default_factory=list)
    env_q: Optional[np.ndarray] = None      # list of per-env quantized rows
    noise_q: Optional[np.ndarray] = None
    add_harmonic: Optional[np.ndarray] = None
    amp_res: int = 1


def _num_env_bands(cd_res: int, ft: FreqTables) -> int:
    return ft.n[1] if cd_res else ft.n[0]


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def read_sbr_grid(br: BitReader, nts: int, amp_res: int) -> ChannelData:
    cd = ChannelData()
    cd.amp_res = amp_res
    cd.frame_class = br.read(2)
    if cd.frame_class == FIXFIX:
        cd.n_env = 1 << br.read(2)
        if cd.n_env > 4:
            raise SBRError("FIXFIX with 8 envelopes")
        if cd.n_env == 1:
            cd.amp_res = 0  # spec: single-env FIXFIX uses 1.5 dB quant
        res = br.read1()
        cd.freq_res = [res] * cd.n_env
        cd.t_env = [round(i * nts / cd.n_env) for i in range(cd.n_env)] + [nts]
        cd.pointer = 0
        cd.l_a = -1
    elif cd.frame_class == FIXVAR:
        var_bord = br.read(2)
        n_rel = br.read(2)
        cd.n_env = n_rel + 1
        t = [0] * (cd.n_env + 1)
        t[0] = 0
        t[cd.n_env] = nts + var_bord
        rels = [br.read(2) for _ in range(n_rel)]
        for i, r in enumerate(rels):
            t[cd.n_env - 1 - i] = t[cd.n_env - i] - 2 * r - 2
        cd.t_env = t
        cd.pointer = br.read(_ceil_log2(cd.n_env + 1))
        cd.freq_res = [0] * cd.n_env
        for i in range(cd.n_env):
            cd.freq_res[cd.n_env - 1 - i] = br.read1()
        cd.l_a = -1 if cd.pointer == 0 else cd.n_env + 1 - cd.pointer
    elif cd.frame_class == VARFIX:
        var_bord = br.read(2)
        n_rel = br.read(2)
        cd.n_env = n_rel + 1
        t = [var_bord]
        for _ in range(n_rel):
            t.append(t[-1] + 2 * br.read(2) + 2)
        t.append(nts)
        cd.t_env = t
        cd.pointer = br.read(_ceil_log2(cd.n_env + 1))
        cd.freq_res = [br.read1() for _ in range(cd.n_env)]
        # conformant decoders (ffmpeg aacsbr, faad2) treat bs_pointer<=1 as
        # "no transient envelope" for VARFIX: l_a = pointer-1 only if >1
        cd.l_a = cd.pointer - 1 if cd.pointer > 1 else -1
    else:  # VARVAR
        bord0 = br.read(2)
        bord1 = br.read(2)
        rel0 = br.read(2)
        rel1 = br.read(2)
        cd.n_env = rel0 + rel1 + 1
        if cd.n_env > 5:
            raise SBRError("too many envelopes")
        t = [0] * (cd.n_env + 1)
        t[0] = bord0
        t[cd.n_env] = nts + bord1
        for i in range(rel0):
            t[i + 1] = t[i] + 2 * br.read(2) + 2
        for i in range(rel1):
            t[cd.n_env - 1 - i] = t[cd.n_env - i] - 2 * br.read(2) - 2
        cd.t_env = t
        cd.pointer = br.read(_ceil_log2(cd.n_env + 1))
        cd.freq_res = [br.read1() for _ in range(cd.n_env)]
        cd.l_a = -1 if cd.pointer == 0 else cd.n_env + 1 - cd.pointer
    if any(b > a for a, b in zip(cd.t_env[1:], cd.t_env[:-1])):
        raise SBRError("non-monotonic envelope borders")

    cd.n_q = 1 if cd.n_env == 1 else 2
    if cd.n_env == 1:
        cd.t_q = [cd.t_env[0], cd.t_env[-1]]
    else:
        if cd.frame_class == FIXFIX:
            mid = cd.n_env // 2
        elif cd.frame_class == VARFIX:
            # faad2 middleBorder: ptr 0 -> 1, ptr 1 -> L_E-1, else ptr-1
            mid = (1 if cd.pointer == 0 else
                   cd.n_env - 1 if cd.pointer == 1 else cd.pointer - 1)
        else:
            mid = cd.n_env - 1 if cd.pointer <= 1 else cd.n_env + 1 - cd.pointer
        cd.t_q = [cd.t_env[0], cd.t_env[mid], cd.t_env[-1]]
    return cd


def write_sbr_grid(bw, cd: ChannelData, nts: int):
    """Writer supports FIXFIX only (all the transmitter/tests need)."""
    assert cd.frame_class == FIXFIX
    bw.write(FIXFIX, 2)
    bw.write({1: 0, 2: 1, 4: 2}[cd.n_env], 2)
    bw.write(cd.freq_res[0], 1)


# --------------------------------------------------------------------------
# envelope / noise / misc payload
# --------------------------------------------------------------------------

def _env_tables(amp_res: int, coupled_ch: bool):
    if coupled_ch:
        if amp_res:
            return (T.sbr_huffman("t_huff_env_bal_3_0dB"),
                    T.sbr_huffman("f_huff_env_bal_3_0dB"), 12, 5)
        return (T.sbr_huffman("t_huff_env_bal_1_5dB"),
                T.sbr_huffman("f_huff_env_bal_1_5dB"), 24, 6)
    if amp_res:
        return (T.sbr_huffman("t_huff_env_3_0dB"),
                T.sbr_huffman("f_huff_env_3_0dB"), 31, 6)
    return (T.sbr_huffman("t_huff_env_1_5dB"),
            T.sbr_huffman("f_huff_env_1_5dB"), 60, 7)


def _noise_tables(coupled_ch: bool):
    if coupled_ch:
        return (T.sbr_huffman("t_huff_noise_bal_3_0dB"),
                T.sbr_huffman("f_huff_env_bal_3_0dB"), 12, 5)
    return (T.sbr_huffman("t_huff_noise_3_0dB"),
            T.sbr_huffman("f_huff_env_3_0dB"), 31, 5)


def read_sbr_envelope(br: BitReader, cd: ChannelData, ft: FreqTables,
                      prev_last: Optional[np.ndarray], coupled_ch: bool):
    t_huff, f_huff, lav, start_bits = _env_tables(cd.amp_res, coupled_ch)
    # coupled (balance) channel values are stored doubled: start values and
    # huffman deltas are scaled by 2 before dequant with pan offset 12/24
    # (ffmpeg aacsbr read_sbr_envelope `delta`, faad2 equivalent)
    delta = 2 if coupled_ch else 1
    envs = []
    prev = prev_last  # quantized values of previous envelope (high-res grid)
    for e in range(cd.n_env):
        nb = _num_env_bands(cd.freq_res[e], ft)
        row = np.zeros(nb, np.int64)
        if cd.df_env[e] == 0:
            row[0] = delta * br.read(start_bits)
            for b in range(1, nb):
                row[b] = row[b - 1] + delta * (f_huff.decode(br) - lav)
        else:
            pm = _map_res(prev, cd.freq_res[e], ft) if prev is not None \
                else np.zeros(nb, np.int64)
            for b in range(nb):
                row[b] = pm[b] + delta * (t_huff.decode(br) - lav)
        envs.append(row)
        prev = _to_high(row, cd.freq_res[e], ft)
    cd.env_q = envs
    return prev


def read_sbr_noise(br: BitReader, cd: ChannelData, ft: FreqTables,
                   prev_last: Optional[np.ndarray], coupled_ch: bool):
    t_huff, f_huff, lav, start_bits = _noise_tables(coupled_ch)
    delta = 2 if coupled_ch else 1   # balance values stored doubled (ffmpeg)
    rows = []
    nq = len(ft.f_noise) - 1
    prev = prev_last
    for q in range(cd.n_q):
        row = np.zeros(nq, np.int64)
        if cd.df_noise[q] == 0:
            row[0] = delta * br.read(start_bits)
            for b in range(1, nq):
                row[b] = row[b - 1] + delta * (f_huff.decode(br) - lav)
        else:
            pm = prev if prev is not None else np.zeros(nq, np.int64)
            for b in range(nq):
                row[b] = pm[b] + delta * (t_huff.decode(br) - lav)
        rows.append(row)
        prev = row
    cd.noise_q = rows
    return prev


def _band_ranges(res: int, ft: FreqTables):
    tab = ft.f_high if res else ft.f_low
    return tab[:-1], tab[1:]


def _map_res(prev_high: np.ndarray, res: int, ft: FreqTables) -> np.ndarray:
    """Map the previous envelope (stored on the high-res grid) onto the
    current envelope's grid for delta-time decoding."""
    if res:
        return prev_high
    lo, hi = _band_ranges(0, ft)
    hlo = ft.f_high[:-1]
    out = np.zeros(len(lo), np.int64)
    for i, l in enumerate(lo):
        j = int(np.searchsorted(hlo, l, side="right")) - 1
        out[i] = prev_high[max(0, j)]
    return out


def _to_high(row: np.ndarray, res: int, ft: FreqTables) -> np.ndarray:
    """Store an envelope on the high-res grid (for next delta-time)."""
    if res:
        return row
    lo = ft.f_low
    hlo = ft.f_high[:-1]
    out = np.zeros(ft.n[1], np.int64)
    for j, k in enumerate(hlo):
        i = int(np.searchsorted(lo, k, side="right")) - 1
        out[j] = row[min(max(i, 0), len(row) - 1)]
    return out


# --------------------------------------------------------------------------
# frame payload container
# --------------------------------------------------------------------------

@dataclass
class SBRFrame:
    header: Optional[SBRHeader]
    channels: List[ChannelData]
    coupling: bool = False
    ps: object = None        # parsed dab.ps.PSData when the stream carries PS


class SBRBitstream:
    """Stateful parser: carries header + delta-time references between
    frames (one instance per audio element)."""

    def __init__(self, sample_rate: int, num_time_slots: int,
                 is_cpe: bool):
        self.fs = sample_rate
        self.nts = num_time_slots
        self.is_cpe = is_cpe
        self.header: Optional[SBRHeader] = None
        self.ft: Optional[FreqTables] = None
        self.prev_env = [None, None]
        self.prev_noise = [None, None]
        self.prev_cd: List[Optional[ChannelData]] = [None, None]
        self._ps_bitstream = None
        self._frame = None

    def parse(self, payload: bytes, nbits: int, has_crc: bool) -> Optional[SBRFrame]:
        br = BitReader(payload)
        if has_crc:
            br.skip(10)
        if br.read1():  # bs_header_flag
            h = parse_sbr_header(br)
            if h != self.header:
                self.header = h
                self.ft = make_freq_tables(h, self.fs)
                self.prev_env = [None, None]
                self.prev_noise = [None, None]
        if self.header is None:
            return None  # upsample-only until a header arrives
        frame = SBRFrame(self.header, [], False)
        if self.is_cpe:
            self._parse_cpe(br, frame)
        else:
            self._parse_sce(br, frame)
        return frame

    def _amp_res(self):
        return self.header.amp_res

    def _parse_sce(self, br, frame):
        if br.read1():
            br.skip(4)  # bs_reserved
        cd = read_sbr_grid(br, self.nts, self._amp_res())
        self._dtdf(br, cd)
        self._invf(br, cd)
        self.prev_env[0] = read_sbr_envelope(br, cd, self.ft,
                                             self.prev_env[0], False)
        self.prev_noise[0] = read_sbr_noise(br, cd, self.ft,
                                            self.prev_noise[0], False)
        self._harmonics(br, cd)
        self._extended(br, frame)
        frame.channels = [cd]
        self.prev_cd[0] = cd

    def _parse_cpe(self, br, frame):
        if br.read1():
            br.skip(8)  # bs_reserved x2
        frame.coupling = bool(br.read1())
        if frame.coupling:
            cd0 = read_sbr_grid(br, self.nts, self._amp_res())
            cd1 = ChannelData(**{f: getattr(cd0, f) for f in (
                "frame_class", "n_env", "t_env", "freq_res", "pointer",
                "l_a", "n_q", "t_q", "amp_res")})
            self._dtdf(br, cd0)
            self._dtdf(br, cd1)
            self._invf(br, cd0)
            cd1.invf_mode = list(cd0.invf_mode)
            self.prev_env[0] = read_sbr_envelope(
                br, cd0, self.ft, self.prev_env[0], False)
            self.prev_noise[0] = read_sbr_noise(
                br, cd0, self.ft, self.prev_noise[0], False)
            self.prev_env[1] = read_sbr_envelope(
                br, cd1, self.ft, self.prev_env[1], True)
            self.prev_noise[1] = read_sbr_noise(
                br, cd1, self.ft, self.prev_noise[1], True)
        else:
            cd0 = read_sbr_grid(br, self.nts, self._amp_res())
            cd1 = read_sbr_grid(br, self.nts, self._amp_res())
            self._dtdf(br, cd0)
            self._dtdf(br, cd1)
            self._invf(br, cd0)
            self._invf(br, cd1)
            self.prev_env[0] = read_sbr_envelope(
                br, cd0, self.ft, self.prev_env[0], False)
            self.prev_env[1] = read_sbr_envelope(
                br, cd1, self.ft, self.prev_env[1], False)
            self.prev_noise[0] = read_sbr_noise(
                br, cd0, self.ft, self.prev_noise[0], False)
            self.prev_noise[1] = read_sbr_noise(
                br, cd1, self.ft, self.prev_noise[1], False)
        self._harmonics(br, cd0)
        self._harmonics(br, cd1)
        self._extended(br, frame)
        frame.channels = [cd0, cd1]
        self.prev_cd = [cd0, cd1]

    def _dtdf(self, br, cd):
        cd.df_env = [br.read1() for _ in range(cd.n_env)]
        cd.df_noise = [br.read1() for _ in range(cd.n_q)]

    def _invf(self, br, cd):
        nq = len(self.ft.f_noise) - 1
        cd.invf_mode = [br.read(2) for _ in range(nq)]

    def _harmonics(self, br, cd):
        n_high = self.ft.n[1]
        if br.read1():
            cd.add_harmonic = np.array(
                [br.read1() for _ in range(n_high)], np.int64)
        else:
            cd.add_harmonic = np.zeros(n_high, np.int64)

    def _extended(self, br, frame=None):
        if br.bits_left < 1:
            return
        if br.read1():
            cnt = br.read(4)
            if cnt == 15:
                cnt += br.read(8)
            end = min(br.pos + 8 * cnt, br.nbits)
            while br.pos + 2 <= end:
                ext_id = br.read(2)
                if ext_id == 2 and frame is not None:   # EXTENSION_ID_PS
                    from .ps import PSBitstream
                    if self._ps_bitstream is None:
                        self._ps_bitstream = PSBitstream(2 * self.nts)
                    try:
                        frame.ps = self._ps_bitstream.parse(br)
                    except (EOFError, ValueError):
                        frame.ps = None
                    break
                break
            br.pos = end


# --------------------------------------------------------------------------
# DSP: HF generation + envelope adjustment + assembly
# --------------------------------------------------------------------------
#
# Buffer layout (matching the conformant decoder flow): X_low/X_high hold
# T_HF_GEN=8 history slots followed by the current frame's 2*nts slots.
# Envelope borders (in half-slots t*2) address buffer index t*2 + T_HF_ADJ,
# so the SBR output lags the core by 6 QMF slots; VAR-class trailing borders
# spill up to 6 slots past the frame, carried in the previous frame's Y.

class _ChannelDSP:
    def __init__(self, nts: int):
        self.nts = nts
        self.analysis = AnalysisQMF()
        self.synthesis = SynthesisQMF()
        self.x_low = np.zeros((_T_HF_GEN + 2 * nts, 32), np.complex128)
        self.y_prev = np.zeros((2 * nts + 8, 64), np.complex128)
        self.g_carry = None      # (4, M) gain slots carried for smoothing
        self.q_carry = None
        self.bw_array = None
        self.invf_prev = None
        self.index_noise = 0
        self.index_sine = 0
        self.s_index_mapped_prev = None
        self.e_a_prev = -1
        self.spill = 0           # prev frame's envelope spill (slots past end)

    def reset(self, nq: int):
        self.bw_array = np.zeros(nq, np.float64)
        self.invf_prev = [0] * nq
        self.g_carry = None
        self.q_carry = None
        self.index_noise = 0
        self.index_sine = 0
        self.s_index_mapped_prev = None
        self.e_a_prev = -1
        self.y_prev = np.zeros_like(self.y_prev)
        self.spill = 0


class SBRDecoder:
    """One audio element's SBR stage. Feed the *core* PCM (int16 scale) and
    the frame's parsed SBR data; returns PCM at 2x rate, same scale.

    sample_rate: SBR output rate (2x core). num_time_slots: 15 for 960
    frames (DAB+), 16 for 1024.
    """

    def __init__(self, sample_rate: int, num_time_slots: int = 15,
                 is_cpe: bool = False):
        self.fs = sample_rate
        self.nts = num_time_slots
        self.is_cpe = is_cpe
        self.bitstream = SBRBitstream(sample_rate, num_time_slots, is_cpe)
        nch = 2 if is_cpe else 1
        self.dsp = [_ChannelDSP(num_time_slots) for _ in range(nch)]
        self._ft_seen = None
        self._align = None
        self._ps = None                 # ps_synth.PSSynthesis when active
        self._ps_syn = None
        self.ps_unsupported = False     # mixed-res 34-band PS: mono dup

    # -- public ------------------------------------------------------------

    def decode_frame(self, core_pcm: np.ndarray, payload: Optional[bytes],
                     payload_bits: int = 0, has_crc: bool = False
                     ) -> np.ndarray:
        """core_pcm: (frame_len, nch) float at int16 scale; returns
        (2*frame_len, nch) float."""
        frame = None
        if payload is not None:
            try:
                frame = self.bitstream.parse(payload, payload_bits, has_crc)
            except (EOFError, ValueError):
                frame = None
        ft = self.bitstream.ft
        if ft is not self._ft_seen and ft is not None:
            self._ft_seen = ft
            for d in self.dsp:
                d.reset(len(ft.f_noise) - 1)
        nch = core_pcm.shape[1]
        e_origs = self._dequant(frame) if frame is not None else None
        Xs = []
        for c in range(nch):
            d = self.dsp[min(c, len(self.dsp) - 1)]
            W = d.analysis.process(core_pcm[:, c])
            x = d.x_low
            x[:_T_HF_GEN] = x[-_T_HF_GEN:]
            x[_T_HF_GEN:] = W
            if frame is None or ft is None:
                X = np.zeros((2 * self.nts, 64), np.complex128)
                X[:, :32] = x[_T_HF_ADJ:_T_HF_ADJ + 2 * self.nts]
                # an unparseable frame right after an envelope that spilled
                # past the frame boundary still owes the carried high-band
                # slots (round-2 ADVICE #4)
                if d.spill and ft is not None:
                    kx_ = ft.kx
                    X[:d.spill, kx_:] = d.y_prev[
                        2 * self.nts:2 * self.nts + d.spill, kx_:]
                    d.spill = 0
                Xs.append(X)
                continue
            cd = frame.channels[min(c, len(frame.channels) - 1)]
            e_orig, q_orig = e_origs[min(c, len(e_origs) - 1)]
            x_high = self._hf_gen(d, cd, ft)
            Y = self._adjust(d, cd, ft, x_high, e_orig, q_orig)
            X = np.zeros((2 * self.nts, 64), np.complex128)
            kx = ft.kx
            X[:, :kx] = x[_T_HF_ADJ:_T_HF_ADJ + 2 * self.nts, :kx]
            spill = d.spill
            if spill:
                X[:spill, kx:] = d.y_prev[2 * self.nts:2 * self.nts + spill,
                                          kx:]
            X[spill:, kx:] = Y[spill:2 * self.nts, kx:]
            d.y_prev = Y
            d.spill = max(0, 2 * cd.t_env[-1] - 2 * self.nts)
            Xs.append(X)

        # parametric stereo: mono SCE + PS params -> true stereo (one frame
        # of filterbank latency; ps_synth.py, every 20/34-band and
        # mixed-resolution config). The except is the degrade-to-mono
        # safety net for malformed parameter combinations a hostile
        # bitstream could produce — decode must not crash the channel
        # (surfaced via ps_unsupported -> pcm_mode "ps-mono-dup").
        ps_data = frame.ps if frame is not None else None
        if not self.is_cpe and (self._ps is not None or ps_data is not None):
            if self._ps is None:
                from .ps_synth import PSSynthesis
                self._ps = PSSynthesis(2 * self.nts)
                self._ps_syn = [SynthesisQMF(), SynthesisQMF()]
            try:
                res = self._ps.process(Xs[0], ps_data)
                out = np.zeros((core_pcm.shape[0] * 2, 2), np.float64)
                if res is not None:
                    out[:, 0] = self._ps_syn[0].process(res[0])
                    out[:, 1] = self._ps_syn[1].process(res[1])
                nch = 2
            except (NotImplementedError, ValueError, IndexError, KeyError):
                self.ps_unsupported = True
                self._ps = None
                out = np.zeros((core_pcm.shape[0] * 2, nch), np.float64)
                for c in range(nch):
                    out[:, c] = self.dsp[min(c, len(self.dsp) - 1)] \
                        .synthesis.process(Xs[c])
        else:
            out = np.zeros((core_pcm.shape[0] * 2, nch), np.float64)
            for c in range(nch):
                out[:, c] = self.dsp[min(c, len(self.dsp) - 1)] \
                    .synthesis.process(Xs[c])
        # one-sample delay matching the conformant decoder's output timing
        # (measured against libavcodec HE-AAC@1024: lag exactly -1)
        if self._align is None or self._align.shape[1] != nch:
            self._align = np.zeros((1, nch))
        aligned = np.concatenate([self._align, out[:-1]])
        self._align = out[-1:].copy()
        return aligned

    # -- dequantization ----------------------------------------------------

    def _dequant(self, frame: SBRFrame):
        """Returns per channel (e_orig rows, q_orig rows) in linear energy /
        linear noise-ratio units."""
        outs = []
        if self.is_cpe and frame.coupling:
            cd0, cd1 = frame.channels
            alpha = 1.0 if cd0.amp_res else 0.5
            pan_off = 12 if cd0.amp_res else 24
            e0s, e1s, q0s, q1s = [], [], [], []
            for e in range(cd0.n_env):
                E = np.exp2(alpha * cd0.env_q[e] + 7.0)
                pan = np.exp2((pan_off - cd1.env_q[e]) * alpha)
                e0s.append(2.0 * E / (1.0 + pan))
                e1s.append(2.0 * E * pan / (1.0 + pan))
            for q in range(cd0.n_q):
                Q = np.exp2(6.0 - cd0.noise_q[q])
                pan = np.exp2(12 - cd1.noise_q[q])
                q0s.append(2.0 * Q / (1.0 + pan))
                q1s.append(2.0 * Q * pan / (1.0 + pan))
            outs = [(e0s, q0s), (e1s, q1s)]
        else:
            for cd in frame.channels:
                alpha = 1.0 if cd.amp_res else 0.5
                es = [np.exp2(alpha * cd.env_q[e] + 7.0)
                      for e in range(cd.n_env)]
                qs = [np.exp2(6.0 - cd.noise_q[q]) for q in range(cd.n_q)]
                outs.append((es, qs))
        return outs

    # -- HF generation -----------------------------------------------------

    def _hf_gen(self, d: _ChannelDSP, cd: ChannelData, ft: FreqTables):
        x = d.x_low
        # second-order LPC per low band over the whole buffer (spec 4.6.18.6.2)
        x0 = x[2:]
        x1 = x[1:-1]
        x2 = x[:-2]
        phi01 = (x0 * np.conj(x1)).sum(axis=0)
        phi02 = (x0 * np.conj(x2)).sum(axis=0)
        phi11 = (x1 * np.conj(x1)).sum(axis=0).real
        phi12 = (x1 * np.conj(x2)).sum(axis=0)
        phi22 = (x2 * np.conj(x2)).sum(axis=0).real
        det = phi11 * phi22 - (np.abs(phi12) ** 2) / 1.000001
        alpha1 = np.where(np.abs(det) > _EPS,
                          (phi01 * phi12 - phi02 * phi11)
                          / np.where(np.abs(det) > _EPS, det, 1.0), 0.0)
        alpha0 = np.where(phi11 > _EPS,
                          -(phi01 + alpha1 * np.conj(phi12))
                          / np.where(phi11 > _EPS, phi11, 1.0), 0.0)
        bad = (np.abs(alpha0) >= 4) | (np.abs(alpha1) >= 4)
        alpha0 = np.where(bad, 0.0, alpha0)
        alpha1 = np.where(bad, 0.0, alpha1)

        # chirp factors per noise band (spec 4.6.18.5)
        bw_tab = T.sbr_bw_table()
        nq = len(ft.f_noise) - 1
        for i in range(nq):
            new_bw = bw_tab[cd.invf_mode[i]]
            if cd.invf_mode[i] == 1 and d.invf_prev[i] == 0:
                new_bw = 0.6
            a = 0.75 if new_bw < d.bw_array[i] else 0.90625
            bw = a * new_bw + (1 - a) * d.bw_array[i]
            d.bw_array[i] = 0.0 if bw < 0.015625 else bw
        d.invf_prev = list(cd.invf_mode)

        x_high = np.zeros((x.shape[0], 64), np.complex128)
        i_start = 2 * cd.t_env[0] + _T_HF_ADJ
        i_end = 2 * cd.t_env[-1] + _T_HF_ADJ
        k = ft.kx
        noise_edges = ft.f_noise
        for p_start, p_num in zip(ft.patch_start, ft.patch_num):
            for i in range(p_num):
                src = p_start + i
                g = int(np.searchsorted(noise_edges, k, side="right")) - 1
                g = min(max(g, 0), nq - 1)
                bw = d.bw_array[g]
                sl = slice(i_start, i_end)
                x_high[sl, k] = (x[sl, src]
                                 + bw * alpha0[src] * x[i_start - 1:i_end - 1,
                                                        src]
                                 + bw * bw * alpha1[src]
                                 * x[i_start - 2:i_end - 2, src])
                k += 1
        return x_high

    # -- envelope adjustment + assembly ------------------------------------

    def _band_map(self, ft: FreqTables, res: int) -> np.ndarray:
        """QMF band m (0..M) -> envelope band index for freq res."""
        tab = ft.f_high if res else ft.f_low
        m = np.arange(ft.kx, ft.kx + ft.M)
        return np.clip(np.searchsorted(tab, m, side="right") - 1, 0,
                       len(tab) - 2)

    def _adjust(self, d: _ChannelDSP, cd: ChannelData, ft: FreqTables,
                x_high, e_orig_rows, q_orig_rows):
        M, kx = ft.M, ft.kx
        nts2 = 2 * self.nts
        noise_map = np.clip(np.searchsorted(ft.f_noise,
                                            np.arange(kx, kx + M),
                                            side="right") - 1, 0,
                            len(ft.f_noise) - 2)
        lim = ft.f_lim
        Y = np.zeros((nts2 + 8, 64), np.complex128)
        smoothing = self.bitstream.header.smoothing_mode == 0
        h_sl = 4 if smoothing else 0

        e_a_prev = 0 if d.e_a_prev == -1 else -1
        # e_a carry rule: envelope 0 counts as transient if the previous
        # frame's transient envelope was its final envelope
        e_a0 = d.e_a_prev
        e_a1 = cd.l_a

        # per-envelope gain/noise/sine vectors
        gains, q_ms, s_ms = [], [], []
        s_index_mapped_per_env = []
        s_prev = (d.s_index_mapped_prev if d.s_index_mapped_prev is not None
                  else np.zeros(M, np.int64))
        hi_map = self._band_map(ft, 1)
        f_high = ft.f_high
        # sinusoid center bands: middle of each high-res band
        sine_m = np.zeros(M, np.int64)
        for b in range(ft.n[1]):
            if cd.add_harmonic is not None and cd.add_harmonic[b]:
                center = (int(f_high[b]) + int(f_high[b + 1])) // 2 - kx
                sine_m[np.clip(center, 0, M - 1)] = 1

        for e in range(cd.n_env):
            res = cd.freq_res[e]
            bmap = self._band_map(ft, res)
            E = np.asarray(e_orig_rows[e], np.float64)[bmap]
            qrow = q_orig_rows[0 if 2 * cd.t_env[e] < 2 * cd.t_q[1] or
                               cd.n_q == 1 else 1]
            Q = np.asarray(qrow, np.float64)[noise_map]
            # current-envelope energy estimate
            a, b = 2 * cd.t_env[e] + _T_HF_ADJ, 2 * cd.t_env[e + 1] + _T_HF_ADJ
            seg = x_high[a:b, kx:kx + M]
            if self.bitstream.header.interpol_freq:
                e_curr = (np.abs(seg) ** 2).mean(axis=0)
            else:
                pw = (np.abs(seg) ** 2).mean(axis=0)
                e_curr = np.zeros(M)
                for bb in range(ft.n[1] if res else ft.n[0]):
                    sel = bmap == bb
                    if sel.any():
                        e_curr[sel] = pw[sel].mean()
            delta = 0 if (e == e_a1 or e == e_a0) else 1
            # sinusoid presence: onset at l_A, else only if carried
            if cd.l_a != -1 and e >= cd.l_a:
                s_idx = sine_m.copy()
            else:
                s_idx = sine_m * s_prev
            s_index_mapped_per_env.append(s_idx)

            g = np.where(
                s_idx == 0,
                np.sqrt(E / ((1.0 + e_curr) * (1.0 + Q * delta))),
                np.sqrt(E * Q / ((1.0 + e_curr) * (1.0 + Q))))
            q_m = np.sqrt(E * Q / (1.0 + Q))
            s_m = np.where(s_idx != 0, np.sqrt(E / (1.0 + Q)), 0.0)

            # limiter (spec 4.6.18.7.5) per limiter band
            limgain = float(T.sbr_limiter_gains()[
                self.bitstream.header.limiter_gains])
            for k in range(len(lim) - 1):
                sl = slice(int(lim[k]), int(lim[k + 1]))
                if sl.start >= sl.stop:
                    continue
                g_max = min(limgain * math.sqrt(
                    (_EPS0 + E[sl].sum()) / (_EPS0 + e_curr[sl].sum())),
                    1.0e5)
                over = g[sl] > g_max
                q_m[sl] = np.where(over, q_m[sl] * (g_max /
                                                    np.maximum(g[sl], _EPS)),
                                   q_m[sl])
                g[sl] = np.minimum(g[sl], g_max)
                denom = (e_curr[sl] * g[sl] ** 2
                         + s_m[sl] ** 2
                         + np.where((s_m[sl] == 0) & (delta == 1),
                                    q_m[sl] ** 2, 0.0)).sum()
                boost = min(math.sqrt((E[sl].sum() + _EPS0)
                                      / (denom + _EPS0)), _MAX_BOOST)
                g[sl] *= boost
                q_m[sl] *= boost
                s_m[sl] *= boost
            # calibration to the conformant decoder's output level (applied
            # after limiter/boost so it is not renormalized away): our QMF
            # pair is unity-gain, the reference convention lands 2^-3 in
            # energy (measured against libavcodec HE-AAC@1024, constant
            # across bands and envelope values)
            gains.append((g * _HIGH_CAL, q_m * _HIGH_CAL, s_m * _HIGH_CAL))

        d.s_index_mapped_prev = (s_index_mapped_per_env[-1]
                                 if s_index_mapped_per_env else None)

        # assembly with gain smoothing over slot history
        g_hist = (d.g_carry if d.g_carry is not None
                  else [gains[0][0]] * 4) if gains else []
        q_hist = (d.q_carry if d.q_carry is not None
                  else [gains[0][1]] * 4) if gains else []
        g_hist = list(g_hist)
        q_hist = list(q_hist)
        noise_tab = T.sbr_noise_table()
        for e in range(cd.n_env):
            g, q_m, s_m = gains[e]
            s_idx = s_index_mapped_per_env[e]
            no_smooth = (e == e_a0 or e == e_a1) or h_sl == 0
            # band-vectorized sine/noise injection: the sequential noise-
            # index walk advances once per NON-sine band in band order, so
            # each slot's indices are index_noise + cumsum(~sine)
            sine = s_idx[:M].astype(bool)
            nonsine = ~sine
            n_non = int(nonsine.sum())
            noise_steps = np.cumsum(nonsine)
            sgn_im = np.where(((kx + np.arange(M)) & 1) != 0, -1.0, 1.0)
            # within an envelope the raw gains are constant, so the 5-tap
            # smoother converges after 4 slots: only the cross-envelope
            # transition slots need the full history sum
            Hc = np.cumsum(_H_SMOOTH)
            prev_g, prev_q = g_hist[-4:], q_hist[-4:]
            g_conv, q_conv = g * Hc[4], q_m * Hc[4]
            for t, sl_i in enumerate(range(2 * cd.t_env[e],
                                           2 * cd.t_env[e + 1])):
                g_hist.append(g)
                q_hist.append(q_m)
                if no_smooth:
                    g_filt, q_filt = g, q_m
                elif t >= 4:
                    g_filt, q_filt = g_conv, q_conv
                else:
                    g_filt = g * Hc[t]
                    q_filt = q_m * Hc[t]
                    for j in range(t + 1, 5):
                        g_filt = g_filt + _H_SMOOTH[j] * prev_g[4 - (j - t)]
                        q_filt = q_filt + _H_SMOOTH[j] * prev_q[4 - (j - t)]
                y = x_high[sl_i + _T_HF_ADJ, kx:kx + M] * g_filt
                d.index_sine = (d.index_sine + 1) & 3
                phi = (1, 1j, -1, -1j)[d.index_sine]
                if sine.any():
                    y[sine] += s_m[sine] * (phi.real
                                            + 1j * sgn_im[sine] * phi.imag)
                if q_filt is not None and n_non:
                    idxs = (d.index_noise + noise_steps) & 0x1FF
                    y[nonsine] += q_filt[nonsine] * noise_tab[idxs[nonsine]]
                    d.index_noise = (d.index_noise + n_non) & 0x1FF
                Y[sl_i, kx:kx + M] = y
        d.g_carry = g_hist[-4:] if g_hist else None
        d.q_carry = q_hist[-4:] if q_hist else None
        d.e_a_prev = 0 if (cd.l_a == cd.n_env) else -1
        return Y


# --------------------------------------------------------------------------
# payload writer (transmitter / test-fixture side)
# --------------------------------------------------------------------------

def build_sbr_payload(header: SBRHeader, fs: int, nts: int,
                      env_rows_per_ch, noise_rows_per_ch,
                      invf_modes=None, is_cpe: bool = False,
                      freq_res: int = 1, send_header: bool = True,
                      ps_data=None, ps_send_header: bool = True,
                      frame_class: int = FIXFIX, pointer: int = 0,
                      var_bord: int = 0, rel_bords=(),
                      var_bord1: int = 0, rel_bords1=(),
                      coupling: bool = False,
                      env_df=None, noise_df=None,
                      prev_env_rows_per_ch=None,
                      prev_noise_rows_per_ch=None) -> tuple:
    """Serialize one frame of SBR data (delta-freq coding).

    env_rows_per_ch: per channel, a list of n_env quantized envelope rows
    (high-res grid when freq_res=1); with coupling=True (CPE only), channel
    1 rows are quantized *balance* values. Grids: FIXFIX (default), FIXVAR
    and VARFIX (var_bord + rel_bords, len(rel_bords) == n_env-1, and
    pointer), and VARVAR (var_bord/rel_bords = leading border + rels,
    var_bord1/rel_bords1 = trailing; n_env = len(rel_bords) +
    len(rel_bords1) + 1 <= 5). Returns (payload bytes, nbits)."""
    from .bits import BitWriter
    ft = make_freq_tables(header, fs)
    bw = BitWriter()
    bw.write(1 if send_header else 0, 1)
    if send_header:
        write_sbr_header(bw, header)
    nch = 2 if is_cpe else 1
    assert len(env_rows_per_ch) == nch
    n_env = len(env_rows_per_ch[0])
    # single-envelope FIXFIX frames use 1.5 dB quantization regardless of
    # the header's bs_amp_res
    eff_amp_res = 0 if (n_env == 1 and frame_class == FIXFIX) \
        else header.amp_res
    nq_bands = len(ft.f_noise) - 1
    nq = 1 if n_env == 1 else 2
    if invf_modes is None:
        invf_modes = [2] * nq_bands

    bw.write(0, 1)                        # bs_data_extra
    if is_cpe:
        bw.write(1 if coupling else 0, 1)

    def grid():
        bw.write(frame_class, 2)
        if frame_class == FIXFIX:
            bw.write({1: 0, 2: 1, 4: 2}[n_env], 2)
            bw.write(freq_res, 1)
        elif frame_class in (FIXVAR, VARFIX):
            assert len(rel_bords) == n_env - 1
            bw.write(var_bord, 2)
            bw.write(n_env - 1, 2)
            for r in rel_bords:
                bw.write(r, 2)
            bw.write(pointer, _ceil_log2(n_env + 1))
            for _ in range(n_env):        # same res every env (either order)
                bw.write(freq_res, 1)
        else:                             # VARVAR (ISO 14496-3 4.6.18.3.3)
            assert len(rel_bords) + len(rel_bords1) == n_env - 1
            assert n_env <= 5
            bw.write(var_bord, 2)         # bs_var_bord_0: t[0]
            bw.write(var_bord1, 2)        # bs_var_bord_1: t[n_env]-nts
            bw.write(len(rel_bords), 2)   # bs_num_rel_0
            bw.write(len(rel_bords1), 2)  # bs_num_rel_1
            for r in rel_bords:           # leading: t[i+1]-t[i] = 2r+2
                bw.write(r, 2)
            for r in rel_bords1:          # trailing: consumed last-to-first
                bw.write(r, 2)
            bw.write(pointer, _ceil_log2(n_env + 1))
            for _ in range(n_env):
                bw.write(freq_res, 1)

    e_df = list(env_df) if env_df is not None else [0] * n_env
    q_df = list(noise_df) if noise_df is not None else [0] * nq
    assert len(e_df) == n_env and len(q_df) == nq

    def dtdf():
        for f in e_df:
            bw.write(f, 1)
        for f in q_df:
            bw.write(f, 1)

    def invf():
        for m in invf_modes:
            bw.write(m, 2)

    def envelope(rows, coupled_ch=False, prev=None):
        """df=0 rows delta-freq code; df=1 rows delta-TIME code against the
        previous envelope (caller supplies the previous frame's final
        envelope as `prev`; constant freq_res keeps the grid mapping the
        identity)."""
        t_huff, f_huff, lav, start_bits = _env_tables(eff_amp_res, coupled_ch)
        delta = 2 if coupled_ch else 1   # balance rows are stored-domain
        last = prev
        for e, row in enumerate(rows):
            row = [int(v) for v in row]
            assert all(v % delta == 0 for v in row), "balance values even"
            if e_df[e]:
                assert last is not None, "df=1 needs a previous envelope"
                for a, b in zip(last, row):
                    t_huff.encode(bw, (b - int(a)) // delta + lav)
            else:
                bw.write(row[0] // delta, start_bits)
                for a, b in zip(row[:-1], row[1:]):
                    f_huff.encode(bw, (b - a) // delta + lav)
            last = row

    def noise(rows, coupled_ch=False, prev=None):
        t_huff, f_huff, lav, start_bits = _noise_tables(coupled_ch)
        delta = 2 if coupled_ch else 1
        last = prev
        for q, row in enumerate(rows):
            row = [int(v) for v in row]
            assert all(v % delta == 0 for v in row), "balance values even"
            if q_df[q]:
                assert last is not None, "df=1 needs a previous noise floor"
                for a, b in zip(last, row):
                    t_huff.encode(bw, (b - int(a)) // delta + lav)
            else:
                bw.write(row[0] // delta, start_bits)
                for a, b in zip(row[:-1], row[1:]):
                    f_huff.encode(bw, (b - a) // delta + lav)
            last = row

    def _pe(ch):
        return None if prev_env_rows_per_ch is None \
            else prev_env_rows_per_ch[ch]

    def _pn(ch):
        return None if prev_noise_rows_per_ch is None \
            else prev_noise_rows_per_ch[ch]

    if is_cpe and coupling:
        grid()                            # one shared grid (ch1 copies it)
        dtdf()
        dtdf()
        invf()                            # one shared invf
        envelope(env_rows_per_ch[0], prev=_pe(0))
        noise(noise_rows_per_ch[0], prev=_pn(0))
        envelope(env_rows_per_ch[1], coupled_ch=True, prev=_pe(1))
        noise(noise_rows_per_ch[1], coupled_ch=True, prev=_pn(1))
        bw.write(0, 1)                    # add_harmonic ch0
        bw.write(0, 1)                    # add_harmonic ch1
    elif is_cpe:
        grid()
        grid()
        dtdf()
        dtdf()
        invf()
        invf()
        envelope(env_rows_per_ch[0], prev=_pe(0))
        envelope(env_rows_per_ch[1], prev=_pe(1))
        noise(noise_rows_per_ch[0], prev=_pn(0))
        noise(noise_rows_per_ch[1], prev=_pn(1))
        bw.write(0, 1)                    # add_harmonic ch0
        bw.write(0, 1)                    # add_harmonic ch1
    else:
        grid()
        dtdf()
        invf()
        envelope(env_rows_per_ch[0], prev=_pe(0))
        noise(noise_rows_per_ch[0], prev=_pn(0))
        bw.write(0, 1)
    if ps_data is not None:
        from .ps import write_ps_data
        pw = BitWriter()
        write_ps_data(pw, ps_data, nts=2 * nts, send_header=ps_send_header)
        n_bytes = -(-(2 + len(pw)) // 8)     # ext id + ps bits, byte count
        bw.write(1, 1)                       # bs_extended_data
        if n_bytes >= 15:
            bw.write(15, 4)
            bw.write(n_bytes - 15, 8)
        else:
            bw.write(n_bytes, 4)
        bw.write(2, 2)                       # EXTENSION_ID_PS
        bw.extend(pw)
        bw.write(0, 8 * n_bytes - 2 - len(pw))
    else:
        bw.write(0, 1)                       # bs_extended_data
    return bw.tobytes(), len(bw)


def add_sbr_fill_to_au(au: bytes, payload: bytes, payload_bits: int,
                       walker) -> bytes:
    """Splice an EXT_SBR_DATA fill element into an AU just before END."""
    from .bits import BitWriter
    from .aac_bits import FIL, END, EXT_SBR_DATA, _copy_bits
    res = walker.walk(au)
    bw = BitWriter()
    _copy_bits(au, 0, res.end_bit - 3, bw)    # everything up to END id
    n_bytes = (4 + payload_bits + 7) // 8     # ext header nibble + payload
    cnt = n_bytes
    bw.write(FIL, 3)
    if cnt >= 15:
        bw.write(15, 4)
        bw.write(cnt - 14, 8)
    else:
        bw.write(cnt, 4)
    bw.write(EXT_SBR_DATA, 4)
    br = BitReader(payload)
    rem = payload_bits
    while rem >= 16:
        bw.write(br.read(16), 16)
        rem -= 16
    if rem:
        bw.write(br.read(rem), rem)
    pad = 8 * cnt - 4 - payload_bits
    bw.write(0, pad)
    bw.write(END, 3)
    bw.align()
    return bw.tobytes()
