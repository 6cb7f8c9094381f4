"""Parametric stereo synthesis (HE-AAC v2, ISO/IEC 14496-3 8.6.4.6).

Turns the SBR-reconstructed mono QMF signal into stereo using the decoded
IID/ICC(/IPD/OPD) parameters from dab.ps. Both band configurations are
implemented: the 20-stereo-band baseline (the one DAB+ broadcasts use) and
the 34-band high-resolution config, including mixed-resolution streams via
bitwise-derived 10/20->34 parameter upmaps and 5/11->17-band ipd/opd
upmaps (libavcodec's remap34 non-full maps; validated by the mixed34_ipd
differentials) — no configuration falls back to mono duplication.

Structure mirrors the conformant float decoders (ffmpeg aacps, faad2
ps_dec): hybrid analysis filterbank over the 3 lowest QMF bands (8-band
complex filter on band 0, 2-band real on bands 1-2, 71 hybrid channels
total), transient-ducked 3-link allpass decorrelation, per-parameter-band
2x2 mixing with per-slot linear interpolation between envelope borders, and
hybrid synthesis by summation. All filter/decorrelator/mixing constants are
the exact float tables libavcodec generates at runtime, captured by running
its own ff_ps_init tablegen (tools/extract_aac_tables.py); this module is
differentially validated against libavcodec's HE-AAC v2 decode at 1024
(tests/test_ps.py) and then runs unchanged at 960 for DAB+.

The hybrid analysis uses a 13-tap zero-delay (symmetric, 6-slot lookahead)
filter, so synthesis carries ONE FRAME of latency: process(X, params)
returns the stereo QMF for the *previous* frame (None on the first call).

Parity surface: the reference decodes PS via faad2 when built with PS
support (src/dab/audio/aac_audio_decoder.cpp:86-251 builds the HE-AAC v2
AudioSpecificConfig).
"""

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import aac_tables as T

# 2-band hybrid prototype for QMF bands 1-2 (ISO 14496-3 table 8.34; ffmpeg
# g1_Q2 — inlined as immediates in libavcodec, so stated here; even taps
# are zero by construction, center 0.5)
_G1_Q2 = np.array([0.0, 0.01899487526049, 0.0, -0.07293139167538,
                   0.0, 0.30596630545168, 0.5], np.float64)

# configuration constants (libavcodec aacps_float.o .rodata:
# NR_BANDS/NR_PAR_BANDS/NR_ALLPASS_BANDS/NR_IPDOPD_BANDS/DECAY_CUTOFF/
# SHORT_DELAY_BAND = [71,91]/[20,34]/[30,50]/[11,17]/[10,32]/[42,62])
_AP_LINKS = 3
_MAX_DELAY = 14
_AP_DELAY = 5
_DECAY_SLOPE = 0.05
_PEAK_DECAY_FACTOR = 0.76592833836465
_A_SMOOTH = 0.25
_TRANSIENT_IMPACT = 1.5
# allpass link feedback gains (spec 8.6.4.6.4)
_A_LINK = np.array([0.65143905753106, 0.56471812200776, 0.48954165955695])
# link delays {3,4,5} slots -> read offset n+2-m into a 5-slot history
_LINK_DELAY = np.array([3, 4, 5])


class _Cfg:
    """Per-band-configuration constants and filterbank/decorrelator tables
    (20-stereo-band baseline vs the 34-band high-resolution config)."""

    def __init__(self, is34: bool):
        npz = T._npz()
        i = 1 if is34 else 0
        self.is34 = is34
        self.NB = (71, 91)[i]
        self.NPAR = (20, 34)[i]
        self.NAP = (30, 50)[i]
        self.NIPD = (11, 17)[i]
        self.DECAY_CUTOFF = (10, 32)[i]
        self.SHORT_DELAY = (42, 62)[i]
        pf = npz["ps_phi_fract"].astype(np.float64)
        self.phi = pf[i, :, 0] + 1j * pf[i, :, 1]          # (50,)
        qf = npz["ps_Q_fract_allpass"].astype(np.float64)
        self.Q = qf[i, :, :, 0] + 1j * qf[i, :, :, 1]      # (50, 3)
        key = "ps_ff_k_to_i_34" if is34 else "ps_ff_k_to_i_20"
        self.k_to_i = npz[key].astype(np.int64)            # (NB,)
        self.band_masks = [np.where(self.k_to_i == b)[0]
                           for b in range(self.NPAR)]

        def full_filter(name, nb):
            """(nb, 8, 2) folded taps -> full 13-tap complex filter."""
            raw = npz[name].astype(np.float64).reshape(nb, 8, 2)
            F = np.zeros((nb, 13), np.complex128)
            F[:, :6] = raw[:, :6, 0] + 1j * raw[:, :6, 1]
            F[:, 6] = raw[:, 6, 0]
            F[:, 7:] = np.conj(F[:, 5::-1])    # conj-symmetric tail
            return F

        if is34:
            # QMF bands 0..4 -> 12+8+4+4+4 = 32 complex sub-bands
            self.F34 = [full_filter("ps_f34_0_12", 12),
                        full_filter("ps_f34_1_8", 8),
                        full_filter("ps_f34_2_4", 4)]
        else:
            self.F8 = full_filter("ps_f20_0_8", 8)


_CFGS = {}


def _get_cfg(is34: bool) -> _Cfg:
    if is34 not in _CFGS:
        _CFGS[is34] = _Cfg(is34)
    return _CFGS[is34]


@functools.lru_cache(maxsize=1)
def _native_ps():
    """Native decorrelator kernels (io_kernels.cpp), None if unavailable."""
    from ..host.native import io_lib
    lib = io_lib()
    return lib if lib is not None and hasattr(lib, "ps_allpass") else None


def _map_idx_10_to_20(par: np.ndarray, full: bool = True) -> np.ndarray:
    """5/10/11-band coded resolution -> 10/20-band internal (ffmpeg
    map_idx_10_to_20): each coded band covers two internal bands."""
    n = 20 if full else 11
    out = np.zeros(n, np.int64)
    top = 10 if full else 5
    out[:2 * top] = np.repeat(par[:top], 2)
    return out


# 34-band upmaps for mixed-resolution streams (one parameter set coded at
# 10/20-band resolution on a 34-band stream). Derived empirically and
# pinned BITWISE against libavcodec's decode (per-band one-hot probes +
# random-row equality, tests/test_ps.py mixed34): the 20->34 map averages
# the straddling bands 1 and 4 (C-style truncating division) and triples
# the top two source bands; the 10->34 map is pure duplication.
_IDX_10_TO_34 = np.repeat(np.arange(10), [3, 3, 4, 2, 4, 2, 2, 4, 4, 6])


def _map_idx_20_to_34(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.int64)
    out = np.empty(34, np.int64)
    out[[0, 2, 3, 5]] = p[[0, 1, 2, 3]]
    out[1] = int(np.fix((int(p[0]) + int(p[1])) / 2.0))
    out[4] = int(np.fix((int(p[2]) + int(p[3])) / 2.0))
    out[6:10] = np.repeat(p[4:6], 2)
    out[10:12] = p[6:8]
    out[12:16] = np.repeat(p[8:10], 2)
    out[16:20] = p[10:14]
    out[20:28] = np.repeat(p[14:18], 2)
    out[28:34] = np.repeat(p[18:20], 3)
    return out


@dataclass
class _Params:
    """One frame's mapped stereo parameters."""
    ends: List[int]                  # envelope end slots (exclusive)
    iid: np.ndarray                  # (n_env, 20) int indices
    icc: np.ndarray
    ipd: Optional[np.ndarray]        # (n_env, 11) or None
    opd: Optional[np.ndarray]
    fine_iid: bool
    use_hb: bool                     # mixing procedure B (icc_mode >= 3)
    is34: bool = False               # band configuration of this frame


class PSSynthesis:
    def __init__(self, n_slots: int = 32):
        npz = T._npz()
        self.HA = npz["ps_HA"].astype(np.float64)          # (46, 8, 4)
        self.HB = npz["ps_HB"].astype(np.float64)
        self.pd = (npz["ps_pd_re_smooth"].astype(np.float64)
                   + 1j * npz["ps_pd_im_smooth"].astype(np.float64))
        self.n_slots = n_slots
        self.c = _get_cfg(False)
        self.reset()

    def reset(self):
        c = self.c
        self.x_prev = None               # (n, 64) prev frame's mono QMF
        self.pending: Optional[_Params] = None
        self.lookback = np.zeros((6, 64), np.complex128)
        self.delay = np.zeros((c.NB, _MAX_DELAY), np.complex128)
        self.ap_delay = np.zeros((c.NAP, _AP_LINKS, _AP_DELAY),
                                 np.complex128)
        self.peak_decay_nrg = np.zeros(c.NPAR)
        self.power_smooth = np.zeros(c.NPAR)
        self.peak_decay_diff_smooth = np.zeros(c.NPAR)
        self.H_state = np.zeros((4, c.NPAR), np.complex128)
        self.opd_hist = np.zeros(c.NIPD, np.int64)
        self.ipd_hist = np.zeros(c.NIPD, np.int64)
        self.last_iid = np.zeros(c.NPAR, np.int64)
        self.last_icc = np.zeros(c.NPAR, np.int64)
        self.last_ipd = np.zeros(c.NIPD, np.int64)
        self.last_opd = np.zeros(c.NIPD, np.int64)
        self.last_fine = False
        self.last_use_hb = False

    def _set_config(self, is34: bool):
        """Switch 20 <-> 34 band configuration (resets decode state; real
        streams never toggle mid-service)."""
        if self.c.is34 != is34:
            x_prev, pending, lookback = (self.x_prev, self.pending,
                                         self.lookback)
            self.c = _get_cfg(is34)
            self.reset()
            self.x_prev, self.pending = x_prev, pending
            self.lookback = lookback

    # -- parameter mapping --------------------------------------------------

    def map_params(self, d) -> Optional[_Params]:
        """dab.ps.PSData -> internal parameters at the stream's band
        configuration (20-band baseline, or 34-band when either coded
        mode is 2/5; 10/20-band-coded parameter sets on a 34-band stream
        upsample via the frequency-aligned index maps)."""
        if d is None:
            return None
        iid34 = d.enable_iid and d.iid_mode in (2, 5)
        icc34 = d.enable_icc and d.icc_mode in (2, 5)
        is34 = iid34 or icc34
        cfg = _get_cfg(is34)       # the frame's config; the synthesis state
        # switches when this frame is PROCESSED (one frame later)
        n_env = d.num_env
        ends = [int(b) + 1 for b in d.border_position[:n_env]]
        if len(ends) < n_env:              # missing borders: uniform FIX
            ends = [(e + 1) * self.n_slots // n_env for e in range(n_env)]
        fine = d.iid_mode > 2
        use_hb = d.icc_mode >= 3

        def rows(par, n_coded, full=True):
            n = cfg.NPAR if full else cfg.NIPD
            if par is None:
                return np.zeros((n_env, n), np.int64)
            out = []
            for e in range(min(n_env, par.shape[0])):
                row = np.asarray(par[e], np.int64)
                if is34 and full:
                    if n_coded == 20:
                        row = _map_idx_20_to_34(row)
                    elif n_coded == 10:
                        row = row[_IDX_10_TO_34]
                elif is34:
                    # ipd/opd on a 34-band stream: ffmpeg's remap34 maps
                    # 11-band rows through the first 17 entries of the same
                    # map_idx_20_to_34 table (averaged bands 1/4 use the
                    # C-truncating division), and 5-band rows through the
                    # 10->34 duplication with mapped[16] = 0 (no source
                    # band 5 exists at 5-band ipd resolution). Validated
                    # by the mixed34_ipd libavcodec differential.
                    if n_coded == 11:
                        row = _map_idx_20_to_34(
                            np.concatenate([row, np.zeros(9, np.int64)])
                        )[:17]
                    elif n_coded == 5:
                        row = np.concatenate(
                            [row[_IDX_10_TO_34[:16]],
                             np.zeros(1, np.int64)])
                elif n_coded in (10, 5):
                    row = _map_idx_10_to_20(row, full)
                out.append(row[:n])
            return np.stack(out) if out else np.zeros((0, n), np.int64)

        from . import ps as _ps
        iid = rows(d.iid_par, _ps.nr_par(d.iid_mode)) if d.enable_iid \
            else np.zeros((n_env, cfg.NPAR), np.int64)
        icc = rows(d.icc_par, _ps.nr_par(d.icc_mode)) if d.enable_icc \
            else np.zeros((n_env, cfg.NPAR), np.int64)
        ipd = opd = None
        if d.enable_ipdopd and d.ipd_par is not None:
            nipd = int(T._npz()["ps_nr_iidopd_par_tab"][d.iid_mode])
            ipd = rows(d.ipd_par, nipd, full=False)
            opd = rows(d.opd_par, nipd, full=False)
        p = _Params(ends, iid, icc, ipd, opd, fine, use_hb, is34)
        self._finalize_envelopes(p)
        return p

    def _finalize_envelopes(self, p: _Params):
        """Append the constant tail envelope when the last border stops
        short of the frame (ffmpeg's fake-envelope logic), or synthesize a
        single envelope from the previous frame's rows when num_env==0."""
        n = self.n_slots
        npar = _get_cfg(p.is34).NPAR
        if p.iid.shape[0] == 0:
            last_ok = self.last_iid.shape[0] == npar
            p.iid = self.last_iid[None].copy() if last_ok \
                else np.zeros((1, npar), np.int64)
            p.icc = self.last_icc[None].copy() if last_ok \
                else np.zeros((1, npar), np.int64)
            if p.ipd is not None:
                nipd = _get_cfg(p.is34).NIPD
                ipd_ok = self.last_ipd.shape[0] == nipd
                p.ipd = self.last_ipd[None].copy() if ipd_ok \
                    else np.zeros((1, nipd), np.int64)
                p.opd = self.last_opd[None].copy() if ipd_ok \
                    else np.zeros((1, nipd), np.int64)
            p.ends = [n]
            return
        if p.ends[-1] < n:
            p.ends.append(n)
            p.iid = np.concatenate([p.iid, p.iid[-1:]])
            p.icc = np.concatenate([p.icc, p.icc[-1:]])
            if p.ipd is not None:
                p.ipd = np.concatenate([p.ipd, p.ipd[-1:]])
                p.opd = np.concatenate([p.opd, p.opd[-1:]])
        p.ends[-1] = n                   # clamp overlong borders

    # -- filterbanks --------------------------------------------------------

    def hybrid_analysis(self, W: np.ndarray) -> np.ndarray:
        """W: (n_slots+12, 64) windowed mono QMF (6 history + frame + 6
        lookahead). Returns s: (NB, n_slots) hybrid-domain signal."""
        n = self.n_slots
        c = self.c
        s = np.empty((c.NB, n), np.complex128)
        if c.is34:
            # bands 0..4 -> 12+8+4+4+4 straight complex sub-bands
            base = 0
            for qmf_band, F in ((0, c.F34[0]), (1, c.F34[1]), (2, c.F34[2]),
                                (3, c.F34[2]), (4, c.F34[2])):
                win = np.lib.stride_tricks.sliding_window_view(
                    W[:, qmf_band], 13)[:n]
                s[base:base + F.shape[0]] = (win @ F.T).T
                base += F.shape[0]
            s[32:] = W[6:6 + n, 5:64].T
            return s
        # band 0 -> 8 complex sub-bands -> 6 channels
        win = np.lib.stride_tricks.sliding_window_view(
            W[:, 0], 13)[:n]                         # (n, 13)
        Tq = win @ c.F8.T                             # (n, 8)
        s[0] = Tq[:, 6]
        s[1] = Tq[:, 7]
        s[2] = Tq[:, 0]
        s[3] = Tq[:, 1]
        s[4] = Tq[:, 2] + Tq[:, 5]
        s[5] = Tq[:, 3] + Tq[:, 4]
        # bands 1, 2 -> 2 real-modulated sub-bands each
        for qmf_band, base, reverse in ((1, 6, True), (2, 8, False)):
            win = np.lib.stride_tricks.sliding_window_view(
                W[:, qmf_band], 13)[:n]
            inphase = _G1_Q2[6] * win[:, 6]
            # symmetric odd-tap pairs (1,11),(3,9),(5,7); even taps are zero
            op = (win[:, [1, 3, 5]] + win[:, [11, 9, 7]]) @ _G1_Q2[[1, 3, 5]]
            plus, minus = inphase + op, inphase - op
            if reverse:
                s[base], s[base + 1] = minus, plus
            else:
                s[base], s[base + 1] = plus, minus
        # bands 3..63: pass-through (zero-delay filter => center tap)
        s[10:] = W[6:6 + n, 3:64].T
        return s

    def hybrid_synthesis(self, s: np.ndarray) -> np.ndarray:
        """(NB, n_slots) hybrid -> (n_slots, 64) QMF by summation."""
        n = s.shape[1]
        X = np.zeros((n, 64), np.complex128)
        if self.c.is34:
            X[:, 0] = s[0:12].sum(axis=0)
            X[:, 1] = s[12:20].sum(axis=0)
            X[:, 2] = s[20:24].sum(axis=0)
            X[:, 3] = s[24:28].sum(axis=0)
            X[:, 4] = s[28:32].sum(axis=0)
            X[:, 5:] = s[32:].T
        else:
            X[:, 0] = s[0:6].sum(axis=0)
            X[:, 1] = s[6] + s[7]
            X[:, 2] = s[8] + s[9]
            X[:, 3:] = s[10:].T
        return X

    # -- decorrelation ------------------------------------------------------

    def decorrelate(self, s: np.ndarray) -> np.ndarray:
        n = self.n_slots
        c = self.c
        NAP, SDB = c.NAP, c.SHORT_DELAY
        power = np.zeros((c.NPAR, n))
        mag2 = (s.real ** 2 + s.imag ** 2)
        for i, idx in enumerate(c.band_masks):
            power[i] = mag2[idx].sum(axis=0)
        # transient ducker (sequential IIR over slots, vector over bands);
        # the native kernel (io_kernels.cpp:ps_ducker/ps_allpass) mirrors
        # the NumPy expressions exactly — bit-identical, just without
        # per-slot Python dispatch
        lib = _native_ps()
        gain = np.empty((c.NPAR, n))
        pk, psm, pdds = (self.peak_decay_nrg, self.power_smooth,
                         self.peak_decay_diff_smooth)
        if lib is not None:
            pk, psm, pdds = (np.ascontiguousarray(a, np.float64)
                             for a in (pk, psm, pdds))
            pw = np.ascontiguousarray(power)
            lib.ps_ducker(pw.ctypes.data, c.NPAR, n,
                          pk.ctypes.data, psm.ctypes.data, pdds.ctypes.data,
                          _PEAK_DECAY_FACTOR, _A_SMOOTH, _TRANSIENT_IMPACT,
                          gain.ctypes.data)
        else:
            for t in range(n):
                p = power[:, t]
                pk = np.maximum(_PEAK_DECAY_FACTOR * pk, p)
                psm = psm + _A_SMOOTH * (p - psm)
                pdds = pdds + _A_SMOOTH * (pk - p - pdds)
                denom = _TRANSIENT_IMPACT * pdds
                gain[:, t] = np.where(denom > psm,
                                      psm / np.maximum(denom, 1e-30), 1.0)
        self.peak_decay_nrg, self.power_smooth = pk, psm
        self.peak_decay_diff_smooth = pdds
        gain_k = gain[c.k_to_i]                       # (NB, n)

        d = np.empty_like(s)
        # allpass channels
        ks = np.arange(NAP)
        g_decay = np.clip(1.0 - _DECAY_SLOPE * (ks - c.DECAY_CUTOFF), 0., 1.)
        ag = _A_LINK[None, :] * g_decay[:, None]      # (NAP, 3)
        dl = np.concatenate([self.delay[:NAP], s[:NAP]], axis=1)
        v_in = dl[:, _MAX_DELAY - 2:_MAX_DELAY - 2 + n] * \
            c.phi[:NAP, None]                         # (NAP, n)
        ap = np.concatenate([self.ap_delay,
                             np.zeros((NAP, _AP_LINKS, n), np.complex128)],
                            axis=2)
        Q = c.Q[:NAP]                                 # (NAP, 3)
        out_ap = np.empty((NAP, n), np.complex128)
        if lib is not None:
            v_c = np.ascontiguousarray(v_in)
            ag_c = np.ascontiguousarray(ag)
            q_c = np.ascontiguousarray(Q, np.complex128)
            ld = np.ascontiguousarray(_LINK_DELAY, np.int64)
            lib.ps_allpass(v_c.ctypes.data, NAP, n, ap.shape[2],
                           ag_c.ctypes.data, q_c.ctypes.data,
                           ld.ctypes.data, _AP_DELAY,
                           ap.ctypes.data, out_ap.ctypes.data)
        else:
            for t in range(n):
                v = v_in[:, t]
                for m in range(_AP_LINKS):
                    a = ag[:, m] * v
                    link = ap[:, m, t + _AP_DELAY - _LINK_DELAY[m]]
                    nv = link * Q[:, m] - a
                    ap[:, m, t + _AP_DELAY] = v + ag[:, m] * nv
                    v = nv
                out_ap[:, t] = v
        d[:NAP] = out_ap * gain_k[:NAP]
        self.ap_delay = ap[:, :, n:n + _AP_DELAY].copy()
        # short-delay channels (delay 14) and tail (delay 1)
        dm = np.concatenate([self.delay[NAP:], s[NAP:]], axis=1)
        d[NAP:SDB] = dm[:SDB - NAP, :n] * gain_k[NAP:SDB]
        d[SDB:] = dm[SDB - NAP:, _MAX_DELAY - 1:_MAX_DELAY - 1 + n] \
            * gain_k[SDB:]
        self.delay = np.concatenate([self.delay, s], axis=1)[:, n:]
        return d

    # -- stereo mixing ------------------------------------------------------

    def _h_target(self, p: _Params, e: int):
        """Per-band 2x2 mixing coefficients for envelope e (complex)."""
        lut = self.HB if p.use_hb else self.HA
        iid_idx = np.clip(p.iid[e] + 7 + (23 if p.fine_iid else 0), 0, 45)
        icc_idx = np.clip(p.icc[e], 0, 7)
        h = lut[iid_idx, icc_idx].T.astype(np.complex128)  # (4, NPAR)
        if p.ipd is not None:
            b = np.arange(self.c.NIPD)
            opd_idx = self.opd_hist * 8 + np.clip(p.opd[e], 0, 7)
            ipd_idx = self.ipd_hist * 8 + np.clip(p.ipd[e], 0, 7)
            opd_c = self.pd[opd_idx]
            ipd_c = self.pd[ipd_idx]
            self.opd_hist = opd_idx & 0x3F
            self.ipd_hist = ipd_idx & 0x3F
            ipd_adj = opd_c * np.conj(ipd_c)
            h[0, b] = h[0, b].real * opd_c
            h[2, b] = h[2, b].real * opd_c
            h[1, b] = h[1, b].real * ipd_adj
            h[3, b] = h[3, b].real * ipd_adj
        return h

    def stereo_process(self, s: np.ndarray, d: np.ndarray, p: _Params):
        n = self.n_slots
        c = self.c
        # per-slot interpolated H (4, NPAR, n)
        Hs = np.empty((4, c.NPAR, n), np.complex128)
        h_prev = self.H_state
        start = 0
        for e in range(len(p.ends)):
            stop = min(p.ends[e], n)
            h_tgt = self._h_target(p, e)
            width = max(stop - start, 1)
            step = (h_tgt - h_prev) / width
            if stop > start:
                j = np.arange(1, stop - start + 1)
                Hs[:, :, start:stop] = h_prev[:, :, None] + \
                    step[:, :, None] * j[None, None, :]
            h_prev = h_tgt
            start = stop
        if start < n:                     # borders fell short (clamped)
            Hs[:, :, start:] = h_prev[:, :, None]
        self.H_state = h_prev
        Hk = Hs[:, c.k_to_i]              # (4, NB, n)
        if p.ipd is not None:
            # negative-frequency hybrid channels: conjugate phase
            # (20-band: channels 0,1; 34-band: channels 9..13, ffmpeg's
            # "is34 && k <= 13 && k >= 9")
            Hk = Hk.copy()
            neg = slice(9, 14) if c.is34 else slice(0, 2)
            Hk[:, neg] = Hk[:, neg].real - 1j * Hk[:, neg].imag
        L = Hk[0] * s + Hk[2] * d
        R = Hk[1] * s + Hk[3] * d
        return L, R

    # -- top level ----------------------------------------------------------

    def process(self, X: np.ndarray, ps_data):
        """Feed this frame's mono QMF (n_slots, 64) + its PSData; returns
        the *previous* frame's stereo QMF (L, R) or None on the first call.
        ps_data may be None (parameters then hold from the last frame)."""
        params = None
        if ps_data is not None:
            params = self.map_params(ps_data)
        if params is None:
            is34 = self.pending.is34 if self.pending is not None \
                else self.c.is34
            npar = _get_cfg(is34).NPAR
            last_ok = self.last_iid.shape[0] == npar
            params = _Params(
                [self.n_slots],
                self.last_iid[None].copy() if last_ok
                else np.zeros((1, npar), np.int64),
                self.last_icc[None].copy() if last_ok
                else np.zeros((1, npar), np.int64),
                None, None, self.last_fine, self.last_use_hb, is34)

        if self.x_prev is None:
            self.x_prev = X.copy()
            self.pending = params
            return None
        pend = self.pending
        self._set_config(pend.is34)    # resets state on a config switch
        W = np.concatenate([self.lookback, self.x_prev, X[:6]], axis=0)
        s = self.hybrid_analysis(W)
        d = self.decorrelate(s)
        L, R = self.stereo_process(s, d, pend)
        out = (self.hybrid_synthesis(L), self.hybrid_synthesis(R))
        self.last_iid = pend.iid[-1].copy()
        self.last_icc = pend.icc[-1].copy()
        if pend.ipd is not None:
            self.last_ipd = pend.ipd[-1].copy()
            self.last_opd = pend.opd[-1].copy()
        self.last_fine = pend.fine_iid
        self.last_use_hb = pend.use_hb
        self.lookback = self.x_prev[-6:].copy()
        self.x_prev = X.copy()
        self.pending = params
        return out
