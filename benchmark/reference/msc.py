"""The plain reference of the MSC channel decode of ETSI EN 300 401 V2.1.1,
in float64 and int64: a subchannel's soft bits of consecutive CIFs in, its
logical frames' bytes out; and the MP2 frame of a classic DAB logical frame
(ETSI TS 103 466).

    time deinterleave (clause 12) -> depuncture: EEP-A, EEP-B or UEP
    (clauses 11.1.2, 11.3) -> the K=7 rate-1/4 Viterbi decode of the mother
    code (clause 11.1.1), from state 0 to state 0 -> energy dispersal
    undone (clause 10) -> bytes, the first bit of a logical frame the most
    significant bit of its first byte

Every table is written out here from the standard: the UEP table of
clauses 6.2.1 and 11.3.1 (all 64 rows), the EEP-A and EEP-B profiles of
clause 11.3.2, the 24 puncturing vectors and the tail's vector of clause
11.1.2, the generator polynomials, the time interleaver's CIF delays and
the energy dispersal's register. Nothing is imported from the receiver
(``dab_radio_tpu_torch``), from the JAX package or from JAX; there are no
kernels, batching tricks or caches. A soft bit is a number whose sign is
the bit's (positive reads as 1) and whose size is the confidence, as the
demodulator hands them out (int8 values, or reference/demod.py's); a
punctured symbol is fed as 0.

Where the receiver (``dab_radio_tpu_torch``) departs from this reference,
or the standard leaves a choice open:
- Viterbi ties (not in the standard): of the two paths into a state with
  equal metrics, the one from the predecessor whose oldest bit is 0 wins,
  as in the receiver (kernels/viterbi_acs.py: a tie goes to the even
  predecessor). Any rule decodes correctly; only this one gives the
  receiver's bits on every input.
- Start state: here the other 63 states start at minus infinity; the
  receiver starts them 5,080 below state 0 (integer metrics). A path from
  another start state would have to gain more than that in the first 6
  steps, which no input from a signal in sync does.
- Trellis length: the serving round (parallel/mesh.py) pads every lane to
  one length with strong zero bits after the tail; a path through the pad
  stays in state 0, so the decoded bits are this reference's.
- The UEP rows at 128 kbit/s: the receiver's table (params/protection.py)
  agrees with clause 11.3.1 here (64 CU at level 5, 84 CU at level 4; the
  coded bits then fill the subchannel exactly); its note concerns another
  implementation that swaps the two sizes. PORT_DIFFERENCES lists the
  places where the receiver's tables differ from these, with the clause:
  there are none.
- MP2 frames are split for 48 kHz sampling alone (one frame a 24 ms
  logical frame); at 24 kHz a frame spans two logical frames and is not
  split here.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CU_BITS = 64                       # a capacity unit: 64 bits of a CIF
CODE_RATE = 4                      # the mother code's symbols a bit
TAIL_BITS = 6                      # K - 1 zero bits end the trellis
NB_STATES = 64

# ---- clause 11.1.1: the mother code ----
# x_{k,i} is the XOR of a_{i-d} over the delays d of its polynomial
# (octal 133, 171, 145, 133; the polynomial's leading coefficient is a_i)
POLYNOMIALS_OCTAL = (0o133, 0o171, 0o145, 0o133)
TAP_DELAYS = ((0, 2, 3, 5, 6),     # x0: a_i + a_{i-2} + a_{i-3} + a_{i-5} + a_{i-6}
              (0, 1, 2, 3, 6),     # x1: a_i + a_{i-1} + a_{i-2} + a_{i-3} + a_{i-6}
              (0, 1, 4, 6),        # x2: a_i + a_{i-1} + a_{i-4} + a_{i-6}
              (0, 2, 3, 5, 6))     # x3: as x0

# ---- clause 11.1.2: the puncturing vectors PI_1 .. PI_24 and the tail's ----
# (1: the mother code's symbol is sent, 0: it is left out); each vector is
# applied 4 times to a block of 128 symbols (32 bits)
PUNCTURING_VECTORS = {
    1: "1100 1000 1000 1000 1000 1000 1000 1000",
    2: "1100 1000 1000 1000 1100 1000 1000 1000",
    3: "1100 1000 1100 1000 1100 1000 1000 1000",
    4: "1100 1000 1100 1000 1100 1000 1100 1000",
    5: "1100 1100 1100 1000 1100 1000 1100 1000",
    6: "1100 1100 1100 1000 1100 1100 1100 1000",
    7: "1100 1100 1100 1100 1100 1100 1100 1000",
    8: "1100 1100 1100 1100 1100 1100 1100 1100",
    9: "1110 1100 1100 1100 1100 1100 1100 1100",
    10: "1110 1100 1100 1100 1110 1100 1100 1100",
    11: "1110 1100 1110 1100 1110 1100 1100 1100",
    12: "1110 1100 1110 1100 1110 1100 1110 1100",
    13: "1110 1110 1110 1100 1110 1100 1110 1100",
    14: "1110 1110 1110 1100 1110 1110 1110 1100",
    15: "1110 1110 1110 1110 1110 1110 1110 1100",
    16: "1110 1110 1110 1110 1110 1110 1110 1110",
    17: "1111 1110 1110 1110 1110 1110 1110 1110",
    18: "1111 1110 1110 1110 1111 1110 1110 1110",
    19: "1111 1110 1111 1110 1111 1110 1110 1110",
    20: "1111 1110 1111 1110 1111 1110 1111 1110",
    21: "1111 1111 1111 1110 1111 1110 1111 1110",
    22: "1111 1111 1111 1110 1111 1111 1111 1110",
    23: "1111 1111 1111 1111 1111 1111 1111 1110",
    24: "1111 1111 1111 1111 1111 1111 1111 1111",
}
# the 24 symbols of the 6 tail bits
TAIL_VECTOR = "1100 1100 1100 1100 1100 1100"

# ---- clauses 6.2.1 and 11.3.1: UEP, the 64 rows in table order ----
# (size in CU, kbit/s, protection level, (L1, L2, L3, L4),
#  (PI1, PI2, PI3, PI4), padding bits): L_k blocks of 128 mother symbols
# punctured by PI_k, then the tail, then the padding bits
UEP_TABLE = [
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

# ---- clause 11.3.2: EEP, levels 1 to 4 of each type ----
# (the subchannel's size is n times this many CU, L1 = m1 n + b1,
#  L2 = m2 n + b2, (PI1, PI2), kbit/s for each n)
EEP_A = {1: (12, (6, -3), (0, 3), (24, 23), 8),
         2: (8, (2, -3), (4, 3), (14, 13), 8),
         3: (6, (6, -3), (0, 3), (8, 7), 8),
         4: (4, (4, -3), (2, 3), (3, 2), 8)}
# 2-A with n = 1 (8 CU, 8 kbit/s): L1 = 5, L2 = 1, PI 13 and 12
EEP_2A_N1 = (8, (0, 5), (0, 1), (13, 12), 8)
EEP_B = {1: (27, (24, -3), (0, 3), (10, 9), 32),
         2: (21, (24, -3), (0, 3), (6, 5), 32),
         3: (18, (24, -3), (0, 3), (4, 3), 32),
         4: (15, (24, -3), (0, 3), (2, 1), 32)}

# where the receiver's tables differ from these: {(table, key): clause}
PORT_DIFFERENCES = {}

# ---- clause 12: time interleaving ----
# bit i of logical frame r is sent in CIF r + CIF_DELAYS[i mod 16]
CIF_DELAYS = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)
DEPTH = 16


@dataclass(frozen=True)
class Subchannel:
    """A subchannel as FIG 0/1 gives it: its start and size in CU, and its
    protection: a row of UEP_TABLE, or EEP as "<level>-<type>" ("3-A")."""
    start_address: int
    size_cu: int
    uep_index: Optional[int] = None
    eep: Optional[str] = None


def _vector(s: str) -> np.ndarray:
    return np.array([c == "1" for c in s.replace(" ", "")])


def segments(sub: Subchannel):
    """[(vector, mother symbols)] of the subchannel's coded logical frame,
    and its padding bits: the segments of L blocks, then the tail."""
    if sub.uep_index is not None:
        size, _, _, ls, pis, padding = UEP_TABLE[sub.uep_index]
        if size != sub.size_cu:
            raise ValueError(f"UEP row {sub.uep_index} is {size} CU, not "
                             f"{sub.size_cu}")
        pairs = list(zip(ls, pis))
    else:
        level, kind = sub.eep.split("-")
        level = int(level)
        if kind == "A" and level == 2 and sub.size_cu == 8:
            unit, l1, l2, pis, _ = EEP_2A_N1
        else:
            unit, l1, l2, pis, _ = (EEP_A if kind == "A" else EEP_B)[level]
        if sub.size_cu % unit or sub.size_cu <= 0:
            raise ValueError(f"EEP {sub.eep} takes multiples of {unit} CU")
        n = sub.size_cu // unit
        pairs = [(m * n + b, pi) for (m, b), pi in zip((l1, l2), pis)]
        padding = 0
    segs = [(_vector(PUNCTURING_VECTORS[pi]), 128 * blocks)
            for blocks, pi in pairs if blocks]
    segs.append((_vector(TAIL_VECTOR), CODE_RATE * TAIL_BITS))
    sent = sum(int(v.sum()) * (n // v.shape[0]) for v, n in segs)
    if sent + padding != CU_BITS * sub.size_cu:
        raise ValueError(f"{sub}: {sent} coded bits and {padding} padding "
                         f"bits do not fill {sub.size_cu} CU")
    return segs, padding


def data_bits(sub: Subchannel) -> int:
    """Bits of the subchannel's logical frame (24 ms)."""
    segs, _ = segments(sub)
    return sum(n for _, n in segs) // CODE_RATE - TAIL_BITS


def time_deinterleave(cifs: torch.Tensor) -> torch.Tensor:
    """(N, bits) soft bits of a subchannel in N consecutive CIFs -> (N - 15,
    bits): logical frame r, bit i read from CIF r + CIF_DELAYS[i mod 16]."""
    n, bits = cifs.shape
    i = torch.arange(bits, device=cifs.device)
    delay = torch.tensor(CIF_DELAYS, device=cifs.device)[i % DEPTH]
    rows = torch.arange(n - DEPTH + 1, device=cifs.device)[:, None] + delay
    return cifs[rows, i]


def depuncture(frames: torch.Tensor, sub: Subchannel) -> torch.Tensor:
    """(M, bits) soft bits of logical frames -> (M, steps, 4) soft symbols of
    the mother code, 0 where a symbol was not sent; the padding bits at the
    end are dropped."""
    segs, _ = segments(sub)
    keep = np.concatenate([np.tile(v, n // v.shape[0]) for v, n in segs])
    out = torch.zeros((frames.shape[0], keep.shape[0]), dtype=torch.float64,
                      device=frames.device)
    out[:, torch.as_tensor(keep, device=frames.device)] = \
        frames[:, :int(keep.sum())].to(torch.float64)
    return out.reshape(frames.shape[0], -1, CODE_RATE)


def _trellis(device):
    """For each new state s' (the last 6 input bits, a_i at bit 5 and
    a_{i-6} dropped): its two predecessors (M, 64, 2: the dropped bit 0 or
    1) and the +/-1 signs of the 4 symbols sent on each transition."""
    new = np.arange(NB_STATES)
    pred = ((new & 31) << 1)[:, None] | np.arange(2)[None, :]
    a = new >> 5                                  # the input bit a_i
    sign = np.empty((NB_STATES, 2, CODE_RATE))
    for k in range(2):
        # a_{i-d}: d = 0 the input, d = 1..6 the predecessor's bits 5..0
        hist = [a] + [(pred[:, k] >> (6 - d)) & 1 for d in range(1, 7)]
        for r, delays in enumerate(TAP_DELAYS):
            x = np.bitwise_xor.reduce([hist[d] for d in delays])
            sign[:, k, r] = 2 * x - 1
    return (torch.as_tensor(pred, device=device),
            torch.as_tensor(sign, dtype=torch.float64, device=device))


def viterbi(symbols: torch.Tensor) -> torch.Tensor:
    """(M, T, 4) soft symbols -> (M, T - 6) int64 bits: the path of the
    largest correlation sum(soft * sign) from state 0 to state 0, a loop
    over the trellis steps, vectorised over the messages. Ties go to the
    predecessor whose oldest bit is 0 (see the module's notes)."""
    M, T, _ = symbols.shape
    dev = symbols.device
    pred, sign = _trellis(dev)
    metric = torch.full((M, NB_STATES), -torch.inf, dtype=torch.float64,
                        device=dev)
    metric[:, 0] = 0.0
    chose = torch.empty((T, M, NB_STATES), dtype=torch.bool, device=dev)
    for t in range(T):
        branch = torch.einsum("mr,skr->msk", symbols[:, t], sign)
        cand = metric[:, pred] + branch                   # (M, 64, 2)
        chose[t] = cand[..., 1] > cand[..., 0]
        metric = torch.where(chose[t], cand[..., 1], cand[..., 0])
    state = torch.zeros(M, dtype=torch.int64, device=dev)
    bits = torch.empty((M, T), dtype=torch.int64, device=dev)
    rows = torch.arange(M, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = state >> 5
        state = pred[state, chose[t, rows, state].to(torch.int64)]
    return bits[:, :T - TAIL_BITS]


def prbs(nb_bits: int) -> np.ndarray:
    """Clause 10's energy dispersal sequence, x^9 + x^5 + 1 from a register
    of all ones: each bit is register stage 5 XOR stage 9, then fed back
    into stage 1."""
    reg = [1] * 9
    out = np.empty(nb_bits, np.int64)
    for k in range(nb_bits):
        bit = reg[4] ^ reg[8]
        out[k] = bit
        reg = [bit] + reg[:8]
    return out


def decode(cifs, sub: Subchannel) -> List[bytes]:
    """Soft bits of a stream's consecutive CIFs, (N, bits of the MSC's CIF)
    (a tensor, whose device is used, or an array), for one subchannel ->
    the bytes of its logical frames 0 .. N - 16 (the first CIF carries
    logical frame 0's first bits; a frame needs the 16 CIFs from its own)."""
    cifs = torch.as_tensor(cifs)
    lo = sub.start_address * CU_BITS
    own = cifs[:, lo:lo + sub.size_cu * CU_BITS].to(torch.int64)
    bits = viterbi(depuncture(time_deinterleave(own), sub))
    bits = bits.cpu().numpy() ^ prbs(bits.shape[1])[None, :]
    return [np.packbits(row.astype(np.uint8)).tobytes() for row in bits]


def mp2_frames(logical: List[bytes], kbps: int,
               sampling_rate: int = 48000) -> List[bytes]:
    """A classic DAB subchannel's logical frames -> its MPEG audio frames
    (ETSI TS 103 466): at 48 kHz a Layer II frame of 1152 samples lasts
    24 ms, one logical frame, and holds 144 * kbps / 48 bytes, its F-PAD
    in the last 2."""
    if sampling_rate != 48000:
        raise ValueError("only 48 kHz is split here (one frame a logical "
                         "frame)")
    size = 144 * kbps // 48
    for frame in logical:
        if len(frame) != size:
            raise ValueError(f"a {len(frame)}-byte logical frame is no MP2 "
                             f"frame of {kbps} kbit/s at 48 kHz")
    return list(logical)
