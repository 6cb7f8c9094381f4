"""Frequency-interleaver carrier map.

ETSI EN 300 401 clause 14.6.1: the permutation PI(i) = (13*PI(i-1) + K - 1)
mod N with K = N/4 is filtered to the active carrier window (DC removed) to
give, for each logical carrier index (the order bits are transmitted), the
physical data-carrier slot it lands on.
Parity surface: reference src/ofdm/dab_mapper_ref.cpp:10-51.

Convention here matches the reference demodulator: `carrier_map[i] = j` means
logical bit-pair i is carried on data-carrier slot j, where slots are numbered
0..nb_carriers-1 over the frequency window -F..+F with DC skipped.
"""

import functools
import numpy as np


@functools.lru_cache(maxsize=None)
def get_carrier_mapper(nb_fft: int, nb_carriers: int) -> np.ndarray:
    n = nb_fft
    k = n // 4
    pi_table = np.zeros(n, dtype=np.int64)
    acc = 0
    # sequential recurrence; tiny (run once per mode, cached)
    for i in range(1, n):
        acc = (13 * acc + k - 1) % n
        pi_table[i] = acc

    dc = n // 2
    lo = dc - nb_carriers // 2
    hi = dc + nb_carriers // 2
    valid = (pi_table >= lo) & (pi_table <= hi) & (pi_table != dc)
    vals = pi_table[valid]
    # below-DC slots keep their offset; above-DC slots shift down by one (DC removed)
    slots = np.where(vals < dc, vals - lo, vals - lo - 1)
    assert slots.shape[0] == nb_carriers
    return slots.astype(np.int32)


@functools.lru_cache(maxsize=None)
def get_inverse_carrier_mapper(nb_fft: int, nb_carriers: int) -> np.ndarray:
    """slot -> logical index (used by the transmitter to interleave)."""
    fwd = get_carrier_mapper(nb_fft, nb_carriers)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(nb_carriers, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def get_carrier_to_fft_bin(nb_fft: int, nb_carriers: int) -> np.ndarray:
    """Data-carrier slot -> FFT bin index.

    Slots run over frequencies -F..-1, +1..+F in order; negative frequencies
    live in the top half of the FFT output.
    """
    half = nb_carriers // 2
    neg = np.arange(nb_fft - half, nb_fft)   # -F .. -1
    pos = np.arange(1, half + 1)             # +1 .. +F
    return np.concatenate([neg, pos]).astype(np.int32)
