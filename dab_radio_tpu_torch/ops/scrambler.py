"""Energy-dispersal PRBS (additive scrambler).

ETSI EN 300 401 clause 10: G(x) = 1 + x^-5 + x^-9, initialised to all ones.
The stream is generated bit-reversed per byte to match over-the-air byte
order, same as the reference (src/dab/algorithms/additive_scrambler.h:5-36).
Since the sequence is static we precompute it once as a byte array and
descrambling is a vectorized XOR (NumPy on host, jnp on device).
"""

import functools
import numpy as np

_MAX_PRBS_BYTES = 1 << 16


@functools.lru_cache(maxsize=4)
def prbs_bytes(nb_bytes: int = _MAX_PRBS_BYTES, syncword: int = 0x1FF) -> np.ndarray:
    """First nb_bytes of the energy-dispersal PRBS, MSB-first per byte.

    The 9-bit shift register starts as all ones (the reference seeds a 16-bit
    register with 0xFFFF; only the low 9 bits feed the taps, so the sequences
    agree)."""
    reg = syncword & 0xFFFF
    out = np.empty(nb_bytes, dtype=np.uint8)
    for i in range(nb_bytes):
        b = 0
        for j in range(8):
            v = ((reg >> 8) ^ (reg >> 4)) & 1
            b |= v << (7 - j)
            reg = ((reg << 1) | v) & 0xFFFF
        out[i] = b
    return out


def descramble(data: np.ndarray) -> np.ndarray:
    """XOR a byte stream with the PRBS starting from a reset register."""
    n = data.shape[-1]
    return (data ^ prbs_bytes()[..., :n]).astype(np.uint8)


@functools.lru_cache(maxsize=4)
def prbs_bits(nb_bits: int) -> np.ndarray:
    """PRBS as a 0/1 bit array (for descrambling bit-domain streams)."""
    by = prbs_bytes(-(-nb_bits // 8))
    bits = np.unpackbits(by)[:nb_bits]
    return bits
