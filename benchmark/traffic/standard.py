"""The tables and codes of the DAB standards that the traffic and the
reference both need, frozen here so that nothing of the program under test
can move them.

Copied from the port's ``params/`` (ofdm.py, prs.py, mapper.py,
puncture.py, protection.py), ``ops/scrambler.py``, ``ops/crc.py``,
``ops/rs.py:rs_encode`` and ``ops/viterbi.py:conv_encode`` as they stood
when the benchmark was written; the convolutional encoder is rewritten as
shifts over a batch of messages (same output bit for bit). Sources:
ETSI EN 300 401 V2.1.1 clauses 10 (energy dispersal), 11 (convolutional
code, puncturing, UEP/EEP), 12 (time interleaving), 14 (OFDM, PRS,
frequency interleaving); ETSI TS 102 563 (RS(120,110), firecode).
"""

import functools
from dataclasses import dataclass

import numpy as np

# ---- OFDM and logical frame geometry (EN 300 401 clause 14) ----


@dataclass(frozen=True)
class OFDMParams:
    mode: int
    nb_frame_symbols: int   # symbols a frame, PRS included, NULL excluded
    nb_symbol_period: int   # samples a symbol (FFT + cyclic prefix)
    nb_null_period: int
    nb_fft: int
    nb_data_carriers: int

    @property
    def nb_cyclic_prefix(self) -> int:
        return self.nb_symbol_period - self.nb_fft

    @property
    def nb_frame_samples(self) -> int:
        return self.nb_null_period + self.nb_frame_symbols * self.nb_symbol_period

    @property
    def nb_data_symbols(self) -> int:
        return self.nb_frame_symbols - 1

    @property
    def nb_frame_bits(self) -> int:
        return self.nb_data_symbols * self.nb_data_carriers * 2


OFDM_MODES = {
    1: OFDMParams(1, 76, 2552, 2656, 2048, 1536),
    2: OFDMParams(2, 76, 638, 664, 512, 384),
    3: OFDMParams(3, 153, 319, 345, 256, 192),
    4: OFDMParams(4, 76, 1276, 1328, 1024, 768),
}


@dataclass(frozen=True)
class DABParams:
    nb_frame_bits: int
    nb_fic_bits: int
    nb_fibs: int
    nb_cifs: int
    nb_fibs_per_cif: int

    @property
    def nb_cif_bits(self) -> int:
        return (self.nb_frame_bits - self.nb_fic_bits) // self.nb_cifs


def dab_params(mode: int) -> DABParams:
    o = OFDM_MODES[mode]
    sym_bits = o.nb_data_carriers * 2
    fic_symbols, fibs, cifs, per_cif = {1: (3, 12, 4, 3), 2: (3, 3, 1, 3),
                                         3: (8, 4, 1, 4), 4: (3, 6, 2, 3)}[mode]
    return DABParams(o.nb_frame_bits, sym_bits * fic_symbols, fibs, cifs,
                     per_cif)


# ---- phase reference symbol (clause 14.3.2, tables 23 and 24) ----

_PRS_BLOCKS = {
    1: [
        (-768, -737, 0, 1), (-736, -705, 1, 2), (-704, -673, 2, 0), (-672, -641, 3, 1),
        (-640, -609, 0, 3), (-608, -577, 1, 2), (-576, -545, 2, 2), (-544, -513, 3, 3),
        (-512, -481, 0, 2), (-480, -449, 1, 1), (-448, -417, 2, 2), (-416, -385, 3, 3),
        (-384, -353, 0, 1), (-352, -321, 1, 2), (-320, -289, 2, 3), (-288, -257, 3, 3),
        (-256, -225, 0, 2), (-224, -193, 1, 2), (-192, -161, 2, 2), (-160, -129, 3, 1),
        (-128, -97, 0, 1), (-96, -65, 1, 3), (-64, -33, 2, 1), (-32, -1, 3, 2),
        (1, 32, 0, 3), (33, 64, 3, 1), (65, 96, 2, 1), (97, 128, 1, 1),
        (129, 160, 0, 2), (161, 192, 3, 2), (193, 224, 2, 1), (225, 256, 1, 0),
        (257, 288, 0, 2), (289, 320, 3, 2), (321, 352, 2, 3), (353, 384, 1, 3),
        (385, 416, 0, 0), (417, 448, 3, 2), (449, 480, 2, 1), (481, 512, 1, 3),
        (513, 544, 0, 3), (545, 576, 3, 3), (577, 608, 2, 3), (609, 640, 1, 0),
        (641, 672, 0, 3), (673, 704, 3, 0), (705, 736, 2, 1), (737, 768, 1, 1),
    ],
    2: [
        (-192, -161, 0, 2), (-160, -129, 1, 3), (-128, -97, 2, 2), (-96, -65, 3, 2),
        (-64, -33, 0, 1), (-32, -1, 1, 2), (1, 32, 2, 0), (33, 64, 1, 2),
        (65, 96, 0, 2), (97, 128, 3, 1), (129, 160, 2, 0), (161, 192, 1, 3),
    ],
    3: [
        (-96, -65, 0, 2), (-64, -33, 1, 3), (-32, -1, 2, 0),
        (1, 32, 3, 2), (33, 64, 2, 2), (65, 96, 1, 2),
    ],
    4: [
        (-384, -353, 0, 0), (-352, -321, 1, 1), (-320, -289, 2, 1), (-288, -257, 3, 2),
        (-256, -225, 0, 2), (-224, -193, 1, 2), (-192, -161, 2, 0), (-160, -129, 3, 3),
        (-128, -97, 0, 3), (-96, -65, 1, 1), (-64, -33, 2, 3), (-32, -1, 3, 2),
        (1, 32, 0, 0), (33, 64, 3, 1), (65, 96, 2, 0), (97, 128, 1, 2),
        (129, 160, 0, 0), (161, 192, 3, 1), (193, 224, 2, 2), (225, 256, 1, 2),
        (257, 288, 0, 2), (289, 320, 3, 1), (321, 352, 2, 3), (353, 384, 1, 0),
    ],
}

_H_TABLE = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1,
     0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0,
     0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3,
     0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2,
     0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2],
], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def prs_spectrum(mode: int) -> np.ndarray:
    """The PRS in FFT-bin order (bin 0 is DC), complex64, (nb_fft,)."""
    nb_fft = OFDM_MODES[mode].nb_fft
    spectrum = np.zeros(nb_fft, dtype=np.complex64)
    for (kmin, kmax, i, n) in _PRS_BLOCKS[mode]:
        ks = np.arange(kmin, kmax + 1)
        phi = (np.pi / 2.0) * (_H_TABLE[i, ks - kmin] + n)
        spectrum[np.where(ks >= 0, ks, nb_fft + ks)] = \
            np.exp(1j * phi).astype(np.complex64)
    return spectrum


# ---- frequency interleaving (clause 14.6.1) ----

@functools.lru_cache(maxsize=None)
def carrier_map(mode: int) -> np.ndarray:
    """carrier_map[i] = j: logical bit pair i rides data-carrier slot j
    (slots -F..-1, +1..+F, DC skipped)."""
    p = OFDM_MODES[mode]
    n, k = p.nb_fft, p.nb_fft // 4
    pi_table = np.zeros(n, dtype=np.int64)
    acc = 0
    for i in range(1, n):
        acc = (13 * acc + k - 1) % n
        pi_table[i] = acc
    dc = n // 2
    lo, hi = dc - p.nb_data_carriers // 2, dc + p.nb_data_carriers // 2
    vals = pi_table[(pi_table >= lo) & (pi_table <= hi) & (pi_table != dc)]
    return np.where(vals < dc, vals - lo, vals - lo - 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def carrier_bins(mode: int) -> np.ndarray:
    """Data-carrier slot -> FFT bin."""
    p = OFDM_MODES[mode]
    half = p.nb_data_carriers // 2
    return np.concatenate([np.arange(p.nb_fft - half, p.nb_fft),
                           np.arange(1, half + 1)]).astype(np.int64)


# ---- puncturing (clause 11.1.2, table 13) ----

_PI_COUNTS = np.array([
    [2, 1, 1, 1, 1, 1, 1, 1], [2, 1, 1, 1, 2, 1, 1, 1],
    [2, 1, 2, 1, 2, 1, 1, 1], [2, 1, 2, 1, 2, 1, 2, 1],
    [2, 2, 2, 1, 2, 1, 2, 1], [2, 2, 2, 1, 2, 2, 2, 1],
    [2, 2, 2, 2, 2, 2, 2, 1], [2, 2, 2, 2, 2, 2, 2, 2],
    [3, 2, 2, 2, 2, 2, 2, 2], [3, 2, 2, 2, 3, 2, 2, 2],
    [3, 2, 3, 2, 3, 2, 2, 2], [3, 2, 3, 2, 3, 2, 3, 2],
    [3, 3, 3, 2, 3, 2, 3, 2], [3, 3, 3, 2, 3, 3, 3, 2],
    [3, 3, 3, 3, 3, 3, 3, 2], [3, 3, 3, 3, 3, 3, 3, 3],
    [4, 3, 3, 3, 3, 3, 3, 3], [4, 3, 3, 3, 4, 3, 3, 3],
    [4, 3, 4, 3, 4, 3, 3, 3], [4, 3, 4, 3, 4, 3, 4, 3],
    [4, 4, 4, 3, 4, 3, 4, 3], [4, 4, 4, 3, 4, 4, 4, 3],
    [4, 4, 4, 4, 4, 4, 4, 3], [4, 4, 4, 4, 4, 4, 4, 4],
], dtype=np.int32)


def _counts_to_vector(counts) -> np.ndarray:
    return (np.arange(4)[None, :] < np.asarray(counts)[:, None]).reshape(-1)


def puncture_vector(pi_index: int) -> np.ndarray:
    return _counts_to_vector(_PI_COUNTS[pi_index - 1])


PI_X = _counts_to_vector(np.full(6, 2))


def puncture_mask(schedule) -> np.ndarray:
    """Keep-mask over the mother code's symbols of [(vector, symbols)]."""
    return np.concatenate([np.tile(vec, -(-n // vec.shape[0]))[:n]
                           for vec, n in schedule])


def fic_schedule():
    return [(puncture_vector(16), 128 * 21), (puncture_vector(15), 128 * 3),
            (PI_X, 24)]


# ---- subchannel protection (clauses 6.2.1, 11.3) ----

# (size CU, kbit/s, level, L1..L4, PI1..PI4, padding bits), table 8
UEP_ROWS = [
    (16, 32, 5, (3, 4, 17, 0), (5, 3, 2, 0), 0),
    (21, 32, 4, (3, 3, 18, 0), (11, 6, 5, 0), 0),
    (24, 32, 3, (3, 4, 14, 3), (15, 9, 6, 8), 0),
    (29, 32, 2, (3, 4, 14, 3), (22, 13, 8, 13), 0),
    (35, 32, 1, (3, 5, 13, 3), (24, 17, 12, 17), 4),
    (24, 48, 5, (4, 3, 26, 3), (5, 4, 2, 3), 0),
    (29, 48, 4, (3, 4, 26, 3), (9, 6, 4, 6), 0),
    (35, 48, 3, (3, 4, 26, 3), (15, 10, 6, 9), 4),
    (42, 48, 2, (3, 4, 26, 3), (24, 14, 8, 15), 0),
    (52, 48, 1, (3, 5, 25, 3), (24, 18, 13, 18), 0),
    (29, 56, 5, (6, 10, 23, 3), (5, 4, 2, 3), 0),
    (35, 56, 4, (6, 10, 23, 3), (9, 6, 4, 5), 0),
    (42, 56, 3, (6, 12, 21, 3), (16, 7, 6, 9), 0),
    (52, 56, 2, (6, 10, 23, 3), (23, 13, 8, 13), 8),
    (32, 64, 5, (6, 9, 31, 2), (5, 3, 2, 3), 0),
    (42, 64, 4, (6, 9, 33, 0), (11, 6, 5, 0), 0),
    (48, 64, 3, (6, 12, 27, 3), (16, 8, 6, 9), 0),
    (58, 64, 2, (6, 10, 29, 3), (23, 13, 8, 13), 8),
    (70, 64, 1, (6, 11, 28, 3), (24, 18, 12, 18), 4),
    (40, 80, 5, (6, 10, 41, 3), (6, 3, 2, 3), 0),
    (52, 80, 4, (6, 10, 41, 3), (11, 6, 5, 6), 0),
    (58, 80, 3, (6, 11, 40, 3), (16, 8, 6, 7), 0),
    (70, 80, 2, (6, 10, 41, 3), (23, 13, 8, 13), 8),
    (84, 80, 1, (6, 10, 41, 3), (24, 17, 12, 18), 4),
    (48, 96, 5, (7, 9, 53, 3), (5, 4, 2, 4), 0),
    (58, 96, 4, (7, 10, 52, 3), (9, 6, 4, 6), 0),
    (70, 96, 3, (6, 12, 51, 3), (16, 9, 6, 10), 4),
    (84, 96, 2, (6, 10, 53, 3), (22, 12, 9, 12), 0),
    (104, 96, 1, (6, 13, 50, 3), (24, 18, 13, 19), 0),
    (58, 112, 5, (14, 17, 50, 3), (5, 4, 2, 5), 0),
    (70, 112, 4, (11, 21, 49, 3), (9, 6, 4, 8), 0),
    (84, 112, 3, (11, 23, 47, 3), (16, 8, 6, 9), 0),
    (104, 112, 2, (11, 21, 49, 3), (23, 12, 9, 14), 4),
    (64, 128, 5, (12, 19, 62, 3), (5, 3, 2, 4), 0),
    (84, 128, 4, (11, 21, 61, 3), (11, 6, 5, 7), 0),
    (96, 128, 3, (11, 22, 60, 3), (16, 9, 6, 10), 4),
    (116, 128, 2, (11, 21, 61, 3), (22, 12, 9, 14), 0),
    (140, 128, 1, (11, 20, 62, 3), (24, 17, 13, 19), 8),
    (80, 160, 5, (11, 19, 87, 3), (5, 4, 2, 4), 0),
    (104, 160, 4, (11, 23, 83, 3), (11, 6, 5, 9), 0),
    (116, 160, 3, (11, 24, 82, 3), (16, 8, 6, 11), 0),
    (140, 160, 2, (11, 21, 85, 3), (22, 11, 9, 13), 0),
    (168, 160, 1, (11, 22, 84, 3), (24, 18, 12, 19), 0),
    (96, 192, 5, (11, 20, 110, 3), (6, 4, 2, 5), 0),
    (116, 192, 4, (11, 22, 108, 3), (10, 6, 4, 9), 0),
    (140, 192, 3, (11, 24, 106, 3), (16, 10, 6, 11), 0),
    (168, 192, 2, (11, 20, 110, 3), (22, 13, 9, 13), 8),
    (208, 192, 1, (11, 21, 109, 3), (24, 20, 13, 24), 0),
    (116, 224, 5, (12, 22, 131, 3), (8, 6, 2, 6), 4),
    (140, 224, 4, (12, 26, 127, 3), (12, 8, 4, 11), 0),
    (168, 224, 3, (11, 20, 134, 3), (16, 10, 7, 9), 0),
    (208, 224, 2, (11, 22, 132, 3), (24, 16, 10, 15), 0),
    (232, 224, 1, (11, 24, 130, 3), (24, 20, 12, 20), 4),
    (128, 256, 5, (11, 24, 154, 3), (6, 5, 2, 5), 0),
    (168, 256, 4, (11, 24, 154, 3), (12, 9, 5, 10), 4),
    (192, 256, 3, (11, 27, 151, 3), (16, 10, 7, 10), 0),
    (232, 256, 2, (11, 22, 156, 3), (24, 14, 10, 13), 8),
    (280, 256, 1, (11, 26, 152, 3), (24, 19, 14, 18), 4),
    (160, 320, 5, (11, 26, 200, 3), (8, 5, 2, 6), 4),
    (208, 320, 4, (11, 25, 201, 3), (13, 9, 5, 10), 8),
    (280, 320, 2, (11, 26, 200, 3), (24, 17, 9, 17), 0),
    (192, 384, 5, (11, 27, 247, 3), (8, 6, 2, 7), 0),
    (280, 384, 3, (11, 24, 250, 3), (16, 9, 7, 10), 4),
    (416, 384, 1, (12, 28, 245, 3), (24, 20, 14, 23), 8),
]

# EEP: (CU multiple, L1 = m n + b, L2 = m n + b, PI1, PI2, kbit/s multiple)
EEP_A = [(12, (6, -3), (0, 3), (24, 23), 8), (8, (2, -3), (4, 3), (14, 13), 8),
         (6, (6, -3), (0, 3), (8, 7), 8), (4, (4, -3), (2, 3), (3, 2), 8)]
EEP_2A_N1 = (8, (0, 5), (0, 1), (13, 12), 8)
EEP_B = [(27, (24, -3), (0, 3), (10, 9), 32), (21, (24, -3), (0, 3), (6, 5), 32),
         (18, (24, -3), (0, 3), (4, 3), 32), (15, (24, -3), (0, 3), (2, 1), 32)]


@dataclass(frozen=True)
class Subchannel:
    """One MSC subchannel: start and size in CU, UEP table row or EEP
    type and 0-based level."""
    start_address: int
    length: int
    is_uep: bool
    uep_table_index: int = 0
    eep_type: str = "A"
    eep_prot_level: int = 0

    @property
    def nb_cif_bits(self) -> int:
        return self.length * 64


def _eep(sub: Subchannel):
    if sub.eep_type == "A":
        return EEP_2A_N1 if sub.length == 8 else EEP_A[sub.eep_prot_level]
    return EEP_B[sub.eep_prot_level]


def msc_schedule(sub: Subchannel):
    if sub.is_uep:
        _, _, _, lx, pix, _ = UEP_ROWS[sub.uep_table_index]
        sched = [(puncture_vector(p), 128 * n) for n, p in zip(lx, pix) if n]
    else:
        mult, l1, l2, pix, _ = _eep(sub)
        if sub.length % mult or sub.length <= 0:
            raise ValueError(f"EEP subchannel of {sub.length} CU is not a "
                             f"multiple of {mult} CU")
        n = sub.length // mult
        sched = [(puncture_vector(p), 128 * (m * n + b))
                 for (m, b), p in zip((l1, l2), pix) if m * n + b]
    return sched + [(PI_X, 24)]


def bitrate_kbps(sub: Subchannel) -> int:
    if sub.is_uep:
        return UEP_ROWS[sub.uep_table_index][1]
    mult, _, _, _, rate = _eep(sub)
    return sub.length // mult * rate


# time interleaving (clause 12): bit i of a logical frame leaves this many
# CIFs after the frame's own
CIF_OFFSETS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                       dtype=np.int64)
DEPTH = 16


# ---- energy dispersal (clause 10) ----

@functools.lru_cache(maxsize=None)
def prbs_bytes(nb_bytes: int) -> np.ndarray:
    """The PRBS 1 + x^-5 + x^-9 from all ones, MSB first a byte."""
    reg = 0x1FF
    out = np.empty(nb_bytes, dtype=np.uint8)
    for i in range(nb_bytes):
        b = 0
        for j in range(8):
            v = ((reg >> 8) ^ (reg >> 4)) & 1
            b |= v << (7 - j)
            reg = ((reg << 1) | v) & 0xFFFF
        out[i] = b
    return out


# ---- CRC16 (FIB, AU: 0x1021 init and final xor 0xFFFF; firecode: 0x782F) ----

@functools.lru_cache(maxsize=None)
def _crc_table(poly: int) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
        lut[i] = crc
    return lut


def crc16_rows(rows: np.ndarray, poly: int = 0x1021, init: int = 0xFFFF,
               final_xor: int = 0xFFFF) -> np.ndarray:
    """CRC16 of each row of a (B, L) uint8 array -> (B,) uint16."""
    d = np.asarray(rows, dtype=np.uint8)
    lut = _crc_table(poly)
    crc = np.full(d.shape[0], init, np.uint32)
    for i in range(d.shape[1]):
        crc = ((crc << 8) & 0xFFFF) ^ lut[((crc >> 8) ^ d[:, i]) & 0xFF]
    return (crc ^ final_xor).astype(np.uint16)


def crc16(data: bytes, **kw) -> int:
    return int(crc16_rows(np.frombuffer(data, np.uint8)[None], **kw)[0])


def firecode(data: bytes) -> int:
    return crc16(data, poly=0x782F, init=0, final_xor=0)


# ---- RS(120,110) over GF(2^8), x^8+x^4+x^3+x^2+1 (TS 102 563) ----

@functools.lru_cache(maxsize=1)
def gf_tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    exp[255:510] = exp[:255]
    return exp, log


@functools.lru_cache(maxsize=1)
def _gf_mul_table() -> np.ndarray:
    exp, log = gf_tables()
    a = np.arange(256)
    t = exp[(log[a][:, None] + log[a][None, :]) % 255].astype(np.int32)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def gf_mul(a, b):
    return _gf_mul_table()[a, b]


def rs_encode(msg: np.ndarray, nroots: int = 10) -> np.ndarray:
    """Systematic RS: (M, k) messages -> (M, k + nroots) uint8."""
    exp, _ = gf_tables()
    g = np.zeros(nroots + 1, dtype=np.int32)
    g[0] = 1
    for i in range(nroots):
        ng = np.zeros_like(g)
        ng[1:] ^= g[:-1]
        ng ^= gf_mul(g, int(exp[i]))
        g = ng
    g = g[::-1].copy()
    m = np.asarray(msg, dtype=np.int32)
    rem = np.zeros((m.shape[0], nroots), dtype=np.int32)
    for s in range(m.shape[1]):
        fb = m[:, s] ^ rem[:, 0]
        rem[:, :-1] = rem[:, 1:]
        rem[:, -1] = 0
        rem ^= gf_mul(g[1:][None, :], fb[:, None])
    return np.concatenate([m, rem], axis=1).astype(np.uint8)


# ---- the mother code (clause 11.1.1): K = 7, rate 1/4 ----

POLYS = (0o133, 0o171, 0o145, 0o133)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """(B, n) 0/1 messages -> (B, 4 (n + 6)) coded bits x0 x1 x2 x3 a step,
    the trellis closed by six zero bits. Output bit p at step t is the
    parity of the register [b_t, b_t-1, ..., b_t-6] under POLYS[p], whose
    bit 6 taps the newest input bit."""
    b = np.asarray(bits, dtype=np.uint8)
    B, n = b.shape
    T = n + 6
    padded = np.zeros((B, T + 6), np.uint8)
    padded[:, 6:6 + n] = b
    out = np.zeros((B, T, 4), np.uint8)
    for p, poly in enumerate(POLYS):
        for j in range(7):                    # b_{t-j} under poly bit 6-j
            if (poly >> (6 - j)) & 1:
                out[:, :, p] ^= padded[:, 6 - j:6 - j + T]
    return out.reshape(B, 4 * T)
