"""A frozen copy of the port's transmit chain: ensemble description, FIG
and FIB encoding, DAB+ superframes, classic DAB's MP2 frames, MSC and FIC
channel coding, time interleaving and the OFDM modulator.

Copied from the port's ``models/transmitter.py`` (FIG constructors, the FIB
carousel, the frame layout, ``_next_mp2_frame``),
``dab/aac.py:SuperframeEncoder``, ``dab/fic.py:FICEncoder``,
``dab/msc.py:MSCEncoder`` and ``models/modulator.py`` (QPSK, frequency
interleaving, differential phase, IFFT, cyclic prefix, NULL), rewritten to
code all frames of a period at once. ``periodic=True`` makes the traffic
loop seamlessly: the time interleaver of the period's first CIFs holds the
bits of its last logical frames, as if the period had been sent before.
``periodic=False`` starts from an empty interleaver, as the port's
transmitter does.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from . import standard as S

RS_DATA, RS_MESSAGE = 110, 120
SUPERFRAME_FRAMES = 5
FIB_DATA_BYTES = 30


@dataclass(frozen=True)
class Service:
    service_id: int
    subchannel_id: int
    label: str
    sub: S.Subchannel
    kind: str = "dab+"
    sampling_rate: int = 48000
    stereo: bool = True
    sbr: bool = True
    ps: bool = False

    @property
    def num_aus(self) -> int:
        if self.sbr:
            return 3 if self.sampling_rate == 48000 else 2
        return 6 if self.sampling_rate == 48000 else 4

    @property
    def frame_bytes(self) -> int:
        """Bytes of one logical frame (24 ms) of the subchannel."""
        return S.bitrate_kbps(self.sub) * 3

    @property
    def group_frames(self) -> int:
        """Logical frames of one group of units: a DAB+ superframe's 5, an
        MP2 frame's 1 (classic DAB: the logical frame is the MP2 frame)."""
        return SUPERFRAME_FRAMES if self.kind == "dab+" else 1

    @property
    def group_units(self) -> int:
        """Units of one group: a superframe's AUs, or the one MP2 frame."""
        return self.num_aus if self.kind == "dab+" else 1


@dataclass(frozen=True)
class Ensemble:
    mode: int
    ensemble_id: int
    label: str
    services: List[Service] = field(default_factory=list)


def _protection(group: dict, start: int) -> S.Subchannel:
    size = group["size_cu"]
    if "eep" in group:                       # "3-A": level 3, type A
        level, kind = group["eep"].split("-")
        return S.Subchannel(start, size, False, eep_type=kind,
                            eep_prot_level=int(level) - 1)
    rows = [i for i, r in enumerate(S.UEP_ROWS)
            if r[0] == size and r[2] == group["uep_level"]]
    if not rows:
        raise ValueError(f"no UEP row of {size} CU at level "
                         f"{group['uep_level']}")
    return S.Subchannel(start, size, True, uep_table_index=rows[0])


KINDS = ("dab+", "dab")


def ensemble_of(multiplex: dict) -> Ensemble:
    """The ensemble a configuration's "multiplex" describes: groups of
    services, laid out one after another from capacity unit 0."""
    services, start, n = [], 0, 0
    for group in multiplex["services"]:
        if group.get("kind", "dab+") not in KINDS:
            raise ValueError(f"a service kind the generator does not code: "
                             f"{group['kind']!r} (one of {KINDS})")
        sid = int(group["first_service_id"], 16)
        for i in range(group["count"]):
            sub = _protection(group, start)
            sf = group.get("superframe", {})
            services.append(Service(
                sid + i, group["first_subchannel_id"] + i,
                group["label"].format(n=n + 1), sub, group.get("kind", "dab+"),
                sf.get("sampling_rate", 48000), sf.get("stereo", True),
                sf.get("sbr", True), sf.get("ps", False)))
            start += group["size_cu"]
            n += 1
    if start > 864:
        raise ValueError(f"the services take {start} CU of the MSC's 864")
    return Ensemble(multiplex["mode"], int(multiplex["ensemble_id"], 16),
                    multiplex["ensemble_label"], services)


# ---- FIGs (EN 300 401 clause 5.2, 6, 8) ----

def _fig(fig_type: int, body: bytes) -> bytes:
    return bytes([(fig_type << 5) | len(body)]) + body


def _fig0(ext: int, data: bytes) -> bytes:
    return _fig(0, bytes([ext]) + data)


def _fig0_1(sub: S.Subchannel, subchannel_id: int) -> bytes:
    b0 = (subchannel_id << 2) | ((sub.start_address >> 8) & 0b11)
    b1 = sub.start_address & 0xFF
    if sub.is_uep:
        return _fig0(1, bytes([b0, b1, sub.uep_table_index]))
    option = 0 if sub.eep_type == "A" else 1
    return _fig0(1, bytes([b0, b1, 0x80 | (option << 4)
                           | (sub.eep_prot_level << 2)
                           | ((sub.length >> 8) & 0b11), sub.length & 0xFF]))


def _fig0_2(service_id: int, subchannel_id: int, ascty: int) -> bytes:
    return _fig0(2, bytes([service_id >> 8, service_id & 0xFF, 0x01,
                           ascty & 0b111111, (subchannel_id << 2) | 0b10]))


def _fig1_label(ext: int, id_bytes: bytes, label: str) -> bytes:
    lab = label.encode("ascii", errors="replace").ljust(16)[:16]
    return _fig(1, bytes([ext]) + id_bytes + lab + bytes([0xFF, 0x00]))


def fib_payloads(ens: Ensemble, frame: int) -> List[bytes]:
    """The FIB payloads of one frame: the carousel of the port's
    transmitter, FIG 0/0 counting 4 CIFs a frame from frame 0."""
    nb_fibs = S.dab_params(ens.mode).nb_fibs
    cif = 4 * frame
    figs = [_fig0(0, bytes([ens.ensemble_id >> 8, ens.ensemble_id & 0xFF,
                            (cif // 250) % 20, cif % 250]))]
    for s in ens.services:
        figs.append(_fig0_1(s.sub, s.subchannel_id)
                    + _fig0_2(s.service_id, s.subchannel_id,
                              63 if s.kind == "dab+" else 0))
    figs.append(_fig0(9, bytes([0, 0xE1, 1])))
    figs.append(_fig1_label(0, ens.ensemble_id.to_bytes(2, "big"), ens.label))
    for s in ens.services:
        figs.append(_fig1_label(1, s.service_id.to_bytes(2, "big"), s.label))
    start = (frame * nb_fibs) % len(figs)
    return [figs[(start + i) % len(figs)] for i in range(nb_fibs)]


def encode_fibs(payloads: List[bytes]) -> np.ndarray:
    """FIG byte strings -> (n, 32) FIBs: 0xFF end marker, zeros, CRC16."""
    fibs = np.zeros((len(payloads), 32), np.uint8)
    for k, p in enumerate(payloads):
        buf = bytearray(p)
        if len(buf) < FIB_DATA_BYTES:
            buf.append(0xFF)
        fibs[k, :len(buf)] = np.frombuffer(bytes(buf), np.uint8)
    crc = S.crc16_rows(fibs[:, :FIB_DATA_BYTES])
    fibs[:, 30], fibs[:, 31] = crc >> 8, crc & 0xFF
    return fibs


def fic_bits(ens: Ensemble, frames: int) -> np.ndarray:
    """(frames, nb_fic_bits) 0/1: each frame's FIB groups scrambled,
    convolutionally coded and punctured."""
    dab = S.dab_params(ens.mode)
    fibs = np.stack([encode_fibs(fib_payloads(ens, f))
                     for f in range(frames)])              # (F, nb_fibs, 32)
    groups = fibs.reshape(frames * dab.nb_cifs, -1)        # a CIF's FIBs
    groups = groups ^ S.prbs_bytes(groups.shape[1])
    coded = S.conv_encode(np.unpackbits(groups, axis=1))
    tx = coded[:, S.puncture_mask(S.fic_schedule())]
    return tx.reshape(frames, -1)


# ---- DAB+ superframes (TS 102 563) ----

def _au_sizes(svc: Service) -> List[int]:
    n_cols = svc.frame_bytes * SUPERFRAME_FRAMES // RS_MESSAGE
    num = svc.num_aus
    start_bytes = -(-(12 * (num - 1)) // 8)
    cap = RS_DATA * n_cols - 3 - start_bytes - 2 * num
    base = cap // num
    return [base] * (num - 1) + [cap - base * (num - 1)]


def random_aus(svc: Service, superframes: int, rng) -> List[List[bytes]]:
    """[superframe][au] random AU payloads that fill each superframe."""
    cols = [rng.integers(0, 256, (superframes, n), dtype=np.uint8)
            for n in _au_sizes(svc)]
    return [[c[k].tobytes() for c in cols] for k in range(superframes)]


def _au_starts(vals: List[int]) -> bytes:
    acc, nbits, out = 0, 0, bytearray()
    for v in vals:
        acc, nbits = (acc << 12) | (v & 0xFFF), nbits + 12
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def encode_superframes(svc: Service, aus: List[List[bytes]]) -> np.ndarray:
    """[superframe][au] payloads -> (superframes * 5, frame_bytes) logical
    frames: header byte, AU starts, AUs with their CRC, firecode, and the
    RS(120,110) parity of each column."""
    n_sf, fb = len(aus), svc.frame_bytes
    n_cols = fb * SUPERFRAME_FRAMES // RS_MESSAGE
    num = svc.num_aus
    start_bytes = -(-(12 * (num - 1)) // 8)
    sizes = [n + 2 for n in _au_sizes(svc)]
    starts = list(np.cumsum([3 + start_bytes] + sizes[:-1]))
    body = np.zeros((n_sf, RS_DATA * n_cols), np.uint8)
    body[:, 2] = ((1 if svc.sampling_rate == 48000 else 0) << 6) \
        | (int(svc.sbr) << 5) | (int(svc.stereo) << 4) | (int(svc.ps) << 3)
    body[:, 3:3 + start_bytes] = np.frombuffer(_au_starts(starts[1:]), np.uint8)
    for i, (at, size) in enumerate(zip(starts, sizes)):
        pay = np.frombuffer(b"".join(sf[i] for sf in aus),
                            np.uint8).reshape(n_sf, size - 2)
        crc = S.crc16_rows(pay)
        body[:, at:at + size - 2] = pay
        body[:, at + size - 2], body[:, at + size - 1] = crc >> 8, crc & 0xFF
    fc = S.crc16_rows(body[:, 2:11], poly=0x782F, init=0, final_xor=0)
    body[:, 0], body[:, 1] = fc >> 8, fc & 0xFF
    msgs = body.reshape(n_sf, RS_DATA, n_cols).transpose(0, 2, 1)
    cw = S.rs_encode(msgs.reshape(-1, RS_DATA)).reshape(n_sf, n_cols,
                                                        RS_MESSAGE)
    return cw.transpose(0, 2, 1).reshape(n_sf * SUPERFRAME_FRAMES, fb)


# ---- classic DAB: MP2 frames (EN 300 401 clause 7) ----

# MPEG-1 Layer II bitrates (kbit/s) by the header's bitrate index
MP2_BITRATES = [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320, 384]


def random_mp2(svc: Service, frames: int, rng) -> List[List[bytes]]:
    """[logical frame][0] one MP2 frame a logical frame, frame_bytes each:
    an MPEG-1 Layer II header (48 kHz, the subchannel's bitrate, no CRC, no
    padding, stereo), a random body and a zero F-PAD in the last 2 bytes
    (no X-PAD). The port's _next_mp2_frame writes 0xFC as the second
    byte, whose protection bit 0 announces a CRC that the frame does not
    carry; here it is 0xFD."""
    kbps = S.bitrate_kbps(svc.sub)
    if kbps not in MP2_BITRATES[1:]:
        raise ValueError(f"{kbps} kbit/s is no MPEG-1 Layer II bitrate")
    body = rng.integers(0, 256, (frames, svc.frame_bytes), dtype=np.uint8)
    body[:, 0] = 0xFF
    body[:, 1] = 0xFD                 # MPEG-1, Layer II, no CRC
    body[:, 2] = (MP2_BITRATES.index(kbps) << 4) | (1 << 2)    # 48 kHz
    body[:, 3] = 0x00                 # stereo
    body[:, -2:] = 0                  # F-PAD: none
    return [[row.tobytes()] for row in body]


def random_units(svc: Service, groups: int, rng) -> List[List[bytes]]:
    """[group][unit] random payloads of a period: superframes of AUs for
    DAB+, MP2 frames for classic DAB."""
    if svc.kind == "dab+":
        return random_aus(svc, groups, rng)
    return random_mp2(svc, groups, rng)


def logical_frames(svc: Service, units: List[List[bytes]]) -> np.ndarray:
    """[group][unit] -> (logical frames, frame_bytes): DAB+ superframes
    coded with their RS parity, MP2 frames as they are."""
    if svc.kind == "dab+":
        return encode_superframes(svc, units)
    return np.frombuffer(b"".join(g[0] for g in units),
                         np.uint8).reshape(len(units), svc.frame_bytes)


# ---- MSC channel coding and time interleaving ----

def msc_cif_bits(svc: Service, frames: np.ndarray,
                 periodic: bool) -> np.ndarray:
    """(L, frame_bytes) logical frames -> (L, nb_cif_bits) 0/1: scrambled,
    coded, punctured, padded, then CIF c carries bit i of logical frame
    c - CIF_OFFSETS[i % 16] (mod L when periodic, else 0 before the first)."""
    L, nbytes = frames.shape
    data = frames ^ S.prbs_bytes(nbytes)
    coded = S.conv_encode(np.unpackbits(data, axis=1))
    tx = coded[:, S.puncture_mask(S.msc_schedule(svc.sub))]
    nb = svc.sub.nb_cif_bits
    if tx.shape[1] < nb:                    # UEP padding bits
        tx = np.concatenate([tx, np.zeros((L, nb - tx.shape[1]), np.uint8)],
                            axis=1)
    offs = S.CIF_OFFSETS[np.arange(nb) % S.DEPTH]
    src = np.arange(L)[:, None] - offs[None, :]           # (L, nb)
    cols = np.broadcast_to(np.arange(nb), src.shape)
    if periodic:
        return tx[src % L, cols]
    return np.where(src >= 0, tx[np.maximum(src, 0), cols], 0).astype(np.uint8)


def frame_bits(ens: Ensemble, logical: dict, frames: int,
               periodic: bool) -> np.ndarray:
    """(frames, nb_frame_bits) 0/1: FIC, then each CIF's subchannels at
    their start addresses. logical: {service index: (4 * frames,
    frame_bytes) logical frames}."""
    dab = S.dab_params(ens.mode)
    msc = np.zeros((frames * dab.nb_cifs, dab.nb_cif_bits), np.uint8)
    for k, svc in enumerate(ens.services):
        a = svc.sub.start_address * 64
        bits = msc_cif_bits(svc, logical[k], periodic)
        msc[:, a:a + bits.shape[1]] = bits
    return np.concatenate([fic_bits(ens, frames),
                           msc.reshape(frames, -1)], axis=1)


# ---- OFDM modulation (clause 14) ----

def modulate(mode: int, bits: np.ndarray, device) -> torch.Tensor:
    """(F, nb_frame_bits) 0/1 -> (F, nb_frame_samples) complex64 on
    `device`: b0, b1 of logical carrier i to QPSK, the frequency
    interleaver, the PRS times the running product of the symbols, IFFT
    (unnormalised), cyclic prefix, NULL in front."""
    p = S.OFDM_MODES[mode]
    ncarr = p.nb_data_carriers
    cmap = S.carrier_map(mode)
    inv = np.empty(ncarr, dtype=np.int64)
    inv[cmap] = np.arange(ncarr)
    cbins = S.carrier_bins(mode)
    b = torch.as_tensor(bits, device=device).reshape(
        bits.shape[0], p.nb_data_symbols, 2 * ncarr)
    b0 = b[..., :ncarr].to(torch.float32)
    b1 = b[..., ncarr:].to(torch.float32)
    amp = 1.0 / np.sqrt(2.0)
    q = torch.complex(1.0 - 2.0 * b0, 1.0 - 2.0 * b1) * amp
    q = q[..., torch.as_tensor(inv, device=device)]
    prs = torch.as_tensor(S.prs_spectrum(mode)[cbins].astype(np.complex64),
                          device=device).expand(bits.shape[0], 1, ncarr)
    slots = torch.cumprod(torch.cat([prs, q], dim=-2), dim=-2)
    spec = torch.zeros((*slots.shape[:-1], p.nb_fft), dtype=torch.complex64,
                       device=device)
    spec[..., torch.as_tensor(cbins, device=device)] = slots
    td = torch.fft.ifft(spec) * p.nb_fft
    sym = torch.cat([td[..., -p.nb_cyclic_prefix:], td], dim=-1)
    body = sym.reshape(bits.shape[0], p.nb_frame_symbols * p.nb_symbol_period)
    null = torch.zeros((bits.shape[0], p.nb_null_period),
                       dtype=torch.complex64, device=device)
    return torch.cat([null, body], dim=-1)
