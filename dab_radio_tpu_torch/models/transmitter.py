"""Full DAB ensemble transmitter (port of ``dab_radio_tpu/models/transmitter.py``).

Builds a complete, decodable synthetic ensemble: FIG-carrying FIC, MSC
subchannels with DAB+ superframes or raw stream payloads, proper frequency
interleaving, so the whole receiver can be validated closed-loop without RF
captures. The byte and bit layers are numpy (the FIG constructors and audio
sources are copies of the JAX module's); the OFDM modulation runs on the
transmitter's device. The X-PAD carousel helpers of the JAX transmitter
(dynamic label, slideshow) are not ported.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from dab_radio_tpu.params import get_dab_params, get_ofdm_params, SubchannelConfig
from dab_radio_tpu.dab.aac import SuperframeEncoder, SuperFrameHeader
from ..dab.fic import FICEncoder
from ..dab.msc import MSCEncoder
from .modulator import OFDMModulator


def fig_header(fig_type: int, body: bytes) -> bytes:
    assert len(body) <= 29
    return bytes([(fig_type << 5) | len(body)]) + body


def fig0(ext: int, data: bytes, pd: int = 0, cn: int = 0, oe: int = 0) -> bytes:
    return fig_header(0, bytes([(cn << 7) | (oe << 6) | (pd << 5) | ext]) + data)


def fig0_0_ensemble(eid: int, cif_upper=0, cif_lower=0) -> bytes:
    return fig0(0, bytes([eid >> 8, eid & 0xFF, cif_upper & 0b11111,
                          cif_lower & 0xFF]))


def fig0_1_subchannel(cfg: SubchannelConfig, subchannel_id: int) -> bytes:
    b0 = (subchannel_id << 2) | ((cfg.start_address >> 8) & 0b11)
    b1 = cfg.start_address & 0xFF
    if cfg.is_uep:
        return fig0(1, bytes([b0, b1, (0 << 7) | (0 << 6) | cfg.uep_table_index]))
    option = 0 if cfg.eep_type == "A" else 1
    return fig0(1, bytes([
        b0, b1,
        0x80 | (option << 4) | (cfg.eep_prot_level << 2) | ((cfg.length >> 8) & 0b11),
        cfg.length & 0xFF]))


def fig0_2_stream_audio(service_id: int, subchannel_id: int, ascty: int,
                        primary: bool = True) -> bytes:
    return fig0(2, bytes([service_id >> 8, service_id & 0xFF, 0x01,
                          ascty & 0b111111,
                          (subchannel_id << 2) | (int(primary) << 1)]))


def fig0_2_packet_ref(service_id: int, scid: int, primary: bool = True) -> bytes:
    b0 = (0b11 << 6) | ((scid >> 6) & 0b111111)
    b1 = ((scid & 0b111111) << 2) | (int(primary) << 1)
    return fig0(2, bytes([service_id >> 8, service_id & 0xFF, 0x01, b0, b1]))


def fig0_3_packet_component(scid: int, subchannel_id: int, dscty: int,
                            packet_address: int, dg_flag: int = 1) -> bytes:
    return fig0(3, bytes([
        (scid >> 4) & 0xFF, ((scid & 0xF) << 4) | 0,
        (dg_flag << 7) | (dscty & 0b111111),
        (subchannel_id << 2) | ((packet_address >> 8) & 0b11),
        packet_address & 0xFF]))


def fig0_14_fec(subchannel_id: int, fec_scheme: int) -> bytes:
    return fig0(14, bytes([(subchannel_id << 2) | (fec_scheme & 0b11)]))


def fig0_9_country(lto: int = 0, ecc: int = 0xE1, table_id: int = 1) -> bytes:
    return fig0(9, bytes([lto & 0b111111, ecc, table_id]))


def fig0_13_user_app(service_id: int, scids: int, app_type: int) -> bytes:
    return fig0(13, bytes([service_id >> 8, service_id & 0xFF,
                           (scids << 4) | 1,
                           (app_type >> 3) & 0xFF,
                           ((app_type & 0b111) << 5) | 0]))


def fig1_label(ext: int, id_bytes: bytes, label: str, charset: int = 0) -> bytes:
    lab = label.encode("ascii", errors="replace").ljust(16)[:16]
    # flag the first 8 characters for the short label
    return fig_header(1, bytes([(charset << 4) | ext]) + id_bytes + lab
                      + bytes([0xFF, 0x00]))


@dataclass
class ServiceSpec:
    """One service in the synthetic ensemble.

    kind: 'dab+' (AAC superframes), 'dab' (MP2 frames), or 'packet'
    (MOT data groups over packet mode)."""
    service_id: int
    subchannel_id: int
    label: str
    cfg: SubchannelConfig
    kind: str = "dab+"
    superframe_header: SuperFrameHeader = field(
        default_factory=lambda: SuperFrameHeader(48000, True, True, False, 0))
    scid: int = 0
    packet_address: int = 2


class ToneAudioSource:
    """Valid DAB+ access units carrying a steady tone.

    Replaces the random AU filler with real decodable audio: AAC-LC@960
    spectral data (dab.aac_enc) plus, for SBR configs, a crafted SBR payload
    (dab.sbr writer) and a DSE with F-PAD/X-PAD. Every AU slot is padded to
    its superframe size (trailing bytes after END are legal and ignored)."""

    def __init__(self, header: SuperFrameHeader, freq: float = 440.0,
                 amp: int = 60, global_gain: int = 160,
                 fpad: bytes = b"\x00\x00", xpad: bytes = b""):
        from dab_radio_tpu.dab.aac import _SAMPLE_RATE_INDEX
        from dab_radio_tpu.dab.aac_enc import encode_au_960, tone_coeffs
        from dab_radio_tpu.dab import sbr as S
        self.header = header
        core = header.core_sample_rate
        ch = 2 if (header.is_stereo and not header.ps) else 1
        coeffs = tone_coeffs(core, freq, ch, amp)
        sbr_payload, sbr_bits = None, 0
        if header.sbr:
            sh = S.SBRHeader(amp_res=1, start_freq=5, stop_freq=3,
                             xover_band=0, freq_scale=2, alter_scale=1,
                             noise_bands=2, limiter_bands=2, limiter_gains=2,
                             interpol_freq=1, smoothing_mode=0)
            ft = S.make_freq_tables(sh, header.sampling_rate)
            env = np.full(ft.n[1], 48, np.int64)     # 1.5 dB: 2^(48/2+7)
            noise = np.full(len(ft.f_noise) - 1, 13, np.int64)
            ps_data = None
            if header.ps:
                # HE-AAC v2: IID left-pan so receivers can assert true
                # stereo reconstruction (dab/ps_synth.py)
                from dab_radio_tpu.dab.ps import PSData, nr_par
                ps_data = PSData(enable_iid=True, iid_mode=1, num_env=1)
                ps_data.iid_par = np.full((1, nr_par(1)), 4, np.int64)
            sbr_payload, sbr_bits = S.build_sbr_payload(
                sh, header.sampling_rate, 15,
                [[env]] * ch, [[noise]] * ch, is_cpe=(ch == 2),
                ps_data=ps_data)
        self._enc = encode_au_960
        self._enc_args = (_SAMPLE_RATE_INDEX[core], coeffs, global_gain,
                          sbr_payload, sbr_bits)
        self._au = self._make_au(bytes(xpad) + bytes(fpad))
        # PAD carousel: (fpad, xpad_reversed) pairs consumed one per AU
        from collections import deque
        self.pad_fields = deque()

    def _make_au(self, dse_payload: bytes) -> bytes:
        sri, coeffs, gg, sp, sb = self._enc_args
        return self._enc(sri, coeffs, gg, dse_payload=dse_payload,
                         sbr_payload=sp, sbr_payload_bits=sb)

    def __call__(self, cap: int, num: int) -> List[bytes]:
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        aus = []
        for n in sizes:
            au = self._au
            if self.pad_fields:
                fpad, xpad_rev = self.pad_fields.popleft()
                au = self._make_au(bytes(xpad_rev) + bytes(fpad))
            if len(au) > n:
                raise ValueError(
                    f"tone AU ({len(au)}B) exceeds superframe slot "
                    f"{n}B — lower the subchannel bitrate demands")
            # zero padding after END (libavcodec's raw-AAC parser chokes
            # on non-zero trailing bytes); the superframe firecode guard
            # rejects the degenerate all-zero sync window this creates
            aus.append(au + b"\x00" * (n - len(au)))
        return aus


class MP2ToneSource:
    """Real MP2 frames (libavcodec encoder) carrying a steady tone; the
    last two bytes of each frame (the ancillary-data region Layer II
    decoders ignore — where DAB carries F-PAD) are zeroed."""

    def __init__(self, nb_frame_bytes: int, freq: float = 440.0):
        from dab_radio_tpu.host.native import codecs_lib
        self.nb = nb_frame_bytes
        self._frames: List[bytes] = []
        lib = codecs_lib()
        kbps = nb_frame_bytes * 8 // 24
        self._ok = False
        if lib is not None:
            h = lib.enc_open(1, 48000, 2, kbps * 1000)
            if h:
                fs = lib.enc_frame_size(h)
                t = np.arange(fs * 40) / 48000.0
                tone = (0.4 * np.sin(2 * np.pi * freq * t) * 32767)
                pcm = np.stack([tone, tone], axis=1).astype(np.int16)
                out = np.zeros(1 << 18, np.uint8)
                sizes = np.zeros(256, np.int32)
                for i in range(40):
                    c = np.ascontiguousarray(pcm[i * fs:(i + 1) * fs])
                    npk = lib.enc_encode(h, c.ctypes.data, fs,
                                         out.ctypes.data, out.shape[0],
                                         sizes.ctypes.data, 256)
                    off = 0
                    for k in range(max(npk, 0)):
                        self._frames.append(out[off:off + sizes[k]].tobytes())
                        off += sizes[k]
                lib.enc_close(h)
                self._frames = [f for f in self._frames
                                if len(f) == nb_frame_bytes]
                self._ok = len(self._frames) >= 4
        self._i = 0

    @property
    def is_available(self) -> bool:
        return self._ok

    def __call__(self) -> bytes:
        f = bytearray(self._frames[self._i % len(self._frames)])
        self._i += 1
        f[-1] = f[-2] = 0                   # F-PAD: none
        return bytes(f)


class EnsembleTransmitter:
    """Synthesizes IQ for a complete DAB ensemble (mode I-IV)."""

    def __init__(self, transmission_mode: int = 1, ensemble_id: int = 0xC0FE,
                 ensemble_label: str = "TPU Ensemble",
                 services: Optional[List[ServiceSpec]] = None,
                 device: torch.device = torch.device("cpu")):
        self.mode = transmission_mode
        self.dab = get_dab_params(transmission_mode)
        self.ofdm = get_ofdm_params(transmission_mode)
        self.ensemble_id = ensemble_id
        self.ensemble_label = ensemble_label
        self.services = services or []
        self.fic_encoder = FICEncoder(transmission_mode)
        self.modulator = OFDMModulator(transmission_mode, device)
        self.msc_encoders: Dict[int, MSCEncoder] = {}
        self.sf_encoders: Dict[int, SuperframeEncoder] = {}
        self.sf_pending: Dict[int, List[bytes]] = {}
        self._au_source = {}
        self._cif_counter = 0
        self.packet_encoders: Dict[int, object] = {}
        self._kinds: Dict[int, str] = {}
        self._mp2_rng = np.random.default_rng(1234)
        self._mp2_sources: Dict[int, MP2ToneSource] = {}
        for s in self.services:
            enc = MSCEncoder(s.cfg)
            self.msc_encoders[s.subchannel_id] = enc
            self._kinds[s.subchannel_id] = s.kind
            if s.kind == "dab+":
                sf = SuperframeEncoder(enc.nb_data_bytes, s.superframe_header)
                self.sf_encoders[s.subchannel_id] = sf
                self.sf_pending[s.subchannel_id] = []
            elif s.kind == "packet":
                from dab_radio_tpu.dab.packets import PacketStreamEncoder
                if enc.nb_data_bytes % 24:
                    raise ValueError(
                        "packet subchannel frame size must hold whole packets")
                self.packet_encoders[s.subchannel_id] = \
                    PacketStreamEncoder(s.packet_address)

    # ---- FIC content ----

    def _fib_payloads(self) -> List[bytes]:
        figs = [fig0_0_ensemble(self.ensemble_id,
                                (self._cif_counter // 250) % 20,
                                self._cif_counter % 250)]
        for s in self.services:
            fig = fig0_1_subchannel(s.cfg, s.subchannel_id)
            if s.kind == "dab+":
                fig += fig0_2_stream_audio(s.service_id, s.subchannel_id, 63)
            elif s.kind == "dab":
                fig += fig0_2_stream_audio(s.service_id, s.subchannel_id, 0)
            else:
                fig += fig0_2_packet_ref(s.service_id, s.scid)
                figs.append(
                    fig0_3_packet_component(s.scid, s.subchannel_id, 60,
                                            s.packet_address)
                    + fig0_14_fec(s.subchannel_id, 0))
                # packet components need a user app type to complete
                # (EN 300 401 via FIG 0/13; app 7 = EPG-ish carousel)
                figs.append(fig0_13_user_app(s.service_id, 0, 7))
            figs.append(fig)
            continue
        figs.append(fig0_9_country())
        figs.append(fig1_label(0, self.ensemble_id.to_bytes(2, "big"),
                               self.ensemble_label))
        for s in self.services:
            figs.append(fig1_label(1, s.service_id.to_bytes(2, "big"), s.label))
        # rotate the carousel across frames so every FIG is broadcast even
        # when the mode has fewer FIBs per frame than FIG entries (mode II/III
        # have 3; a fixed selection would never transmit the labels)
        start = getattr(self, "_fib_carousel", 0)
        sel = [figs[(start + i) % len(figs)]
               for i in range(self.dab.nb_fibs)]
        self._fib_carousel = (start + self.dab.nb_fibs) % len(figs)
        return sel

    # ---- audio payload ----

    def set_au_source(self, subchannel_id: int, make_aus):
        """make_aus(capacity, num_aus) -> list of AU payload bytes that
        exactly fill the superframe (see SuperframeEncoder)."""
        self._au_source[subchannel_id] = make_aus
        self._sf_index = 0

    def enable_tone_audio(self, base_freq: float = 440.0):
        """Broadcast real decodable audio on every audio service: AAC tone
        AUs (with SBR payloads for SBR configs) on DAB+ subchannels, real
        MP2 frames on classic DAB subchannels. Each service gets its own
        frequency (base * (1 + index/2))."""
        for i, s in enumerate(self.services):
            freq = base_freq * (1.0 + 0.5 * i)
            if s.kind == "dab+":
                self.set_au_source(
                    s.subchannel_id,
                    ToneAudioSource(s.superframe_header, freq=freq))
            elif s.kind == "dab":
                enc = self.msc_encoders[s.subchannel_id]
                src = MP2ToneSource(enc.nb_data_bytes, freq=freq)
                if src.is_available:
                    self._mp2_sources[s.subchannel_id] = src

    def push_packet_data_group(self, subchannel_id: int, group: bytes):
        """Queue an MSC data group onto a packet service's carousel."""
        self.packet_encoders[subchannel_id].push_data_group(group)

    def _next_mp2_frame(self, nb_bytes: int) -> bytes:
        """A frame-header-valid MP2-shaped payload (content is random; the
        receiver's PAD extractor only parses the header and frame tail)."""
        # MPEG-1 Layer II, 48 kHz; pick the bitrate index matching nb_bytes
        from dab_radio_tpu.dab.mp2 import _BITRATES_V1_L2
        target_kbps = nb_bytes * 8 // 24
        idx = _BITRATES_V1_L2.index(target_kbps) \
            if target_kbps in _BITRATES_V1_L2 else 8
        frame = bytearray(
            self._mp2_rng.integers(0, 256, nb_bytes).astype(np.uint8).tobytes())
        frame[0] = 0xFF
        frame[1] = 0xFC                      # MPEG-1, Layer II, no CRC
        frame[2] = (idx << 4) | (1 << 2)     # 48 kHz, no padding
        frame[3] = 0x00                      # stereo
        frame[-1] = frame[-2] = 0            # F-PAD: none
        return bytes(frame)

    def _next_subchannel_frame(self, sub_id: int) -> bytes:
        kind = self._kinds.get(sub_id, "dab+")
        enc = self.msc_encoders[sub_id]
        if kind == "dab":
            src = self._mp2_sources.get(sub_id)
            if src is not None:
                return src()
            return self._next_mp2_frame(enc.nb_data_bytes)
        if kind == "packet":
            return self.packet_encoders[sub_id].emit(enc.nb_data_bytes)
        pend = self.sf_pending[sub_id]
        if not pend:
            sf = self.sf_encoders[sub_id]
            make = self._au_source.get(sub_id)
            num = sf.header.num_aus
            cap = sf.au_capacity()
            if make is not None:
                aus = make(cap, num)
            else:
                base = cap // num
                sizes = [base] * (num - 1) + [cap - base * (num - 1)]
                rng = np.random.default_rng(len(pend) + sub_id)
                aus = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                       for n in sizes]
            pend.extend(sf.encode(aus))
        return pend.pop(0)

    # ---- frame synthesis ----

    def next_frame_bits(self) -> np.ndarray:
        """Soft-bit layout of one transmission frame (before OFDM)."""
        fic = self.fic_encoder.encode_fic(self._fib_payloads())
        cif_bits = self.dab.nb_cif_bits
        cifs = np.zeros((self.dab.nb_cifs, cif_bits), dtype=np.int8)
        for c in range(self.dab.nb_cifs):
            for s in self.services:
                enc = self.msc_encoders[s.subchannel_id]
                payload = self._next_subchannel_frame(s.subchannel_id)
                sub = enc.encode_cif(payload)
                a = s.cfg.start_address * 64
                cifs[c, a:a + sub.shape[0]] = sub
            self._cif_counter += 1
        return np.concatenate([fic, cifs.reshape(-1)])

    def modulate_frame_bits(self, soft: np.ndarray) -> np.ndarray:
        """Frame soft bits -> one frame of complex64 IQ samples."""
        bits = (np.asarray(soft) > 0).astype(np.uint8)
        p = self.ofdm
        bits = bits.reshape(p.nb_data_symbols, 2 * p.nb_data_carriers)
        return self.modulator.modulate_frame(bits).cpu().numpy()

    def next_frame_iq(self) -> np.ndarray:
        """One transmission frame of complex64 IQ samples."""
        return self.modulate_frame_bits(self.next_frame_bits())

    def generate(self, nb_frames: int) -> np.ndarray:
        return np.concatenate([self.next_frame_iq() for _ in range(nb_frames)])
