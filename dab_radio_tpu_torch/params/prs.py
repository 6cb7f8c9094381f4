"""Phase reference symbol (PRS) spectrum generation.

ETSI EN 300 401 clause 14.3.2: the PRS subcarrier phases are phi_k =
(pi/2)*(h_{i,k-k'} + n) where (k_min, k_max, i, n) ranges come from table 23
(and its appendix-B analogues for modes II-IV) and h from table 24.
Parity surface: reference src/ofdm/dab_prs_ref.cpp:24-195.

The generated spectrum is laid out in FFT-bin order: bin 0 is DC (always 0),
bins 1..F carry positive frequencies, bins N-F..N-1 carry negative frequencies.
"""

import numpy as np

# (k_min, k_max, i, n) per contiguous 32-carrier block. ETSI table 23 (mode I)
# and the appendix-B tables for modes II-IV.
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

# ETSI EN 300 401 table 24: h_{i,j} for i in 0..3, j in 0..31.
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


def get_prs_reference(transmission_mode: int, nb_fft: int | None = None) -> np.ndarray:
    """PRS spectrum as complex64 in FFT-bin order, shape (nb_fft,)."""
    if transmission_mode not in _PRS_BLOCKS:
        raise ValueError(f"invalid transmission mode {transmission_mode}")
    blocks = _PRS_BLOCKS[transmission_mode]
    k_min = blocks[0][0]
    nb_carriers = -2 * k_min + 1
    if nb_fft is None:
        # smallest power of two that fits the carriers
        nb_fft = 1
        while nb_fft < nb_carriers:
            nb_fft *= 2
    if nb_fft < nb_carriers:
        raise ValueError(f"nb_fft {nb_fft} too small for {nb_carriers} carriers")

    spectrum = np.zeros(nb_fft, dtype=np.complex64)
    for (kmin, kmax, i, n) in blocks:
        ks = np.arange(kmin, kmax + 1)
        h = _H_TABLE[i, ks - kmin]
        phi = (np.pi / 2.0) * (h + n)
        vals = np.exp(1j * phi).astype(np.complex64)
        bins = np.where(ks >= 0, ks, nb_fft + ks)
        spectrum[bins] = vals
    return spectrum
