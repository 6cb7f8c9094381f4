"""Convolutional-code puncturing vectors and depuncture index builders.

ETSI EN 300 401 clause 11.1.2 table 13: 24 puncturing vectors PI_1..PI_24 of
length 32 plus the 24-bit tail vector. Each vector is built from 8 groups of 4
where group g keeps its first count[g] mother-code symbols. Parity surface:
reference src/dab/constants/puncture_codes.h:42-75 (count-table form) and the
depuncture loop in src/dab/algorithms/dab_viterbi_decoder.cpp:114-181.
"""

import numpy as np

CODE_RATE = 4  # mother code 1/4

# count of transmitted symbols in each 4-symbol group, 8 groups per vector.
_PI_COUNTS = np.array([
    [2, 1, 1, 1, 1, 1, 1, 1],
    [2, 1, 1, 1, 2, 1, 1, 1],
    [2, 1, 2, 1, 2, 1, 1, 1],
    [2, 1, 2, 1, 2, 1, 2, 1],
    [2, 2, 2, 1, 2, 1, 2, 1],
    [2, 2, 2, 1, 2, 2, 2, 1],
    [2, 2, 2, 2, 2, 2, 2, 1],
    [2, 2, 2, 2, 2, 2, 2, 2],
    [3, 2, 2, 2, 2, 2, 2, 2],
    [3, 2, 2, 2, 3, 2, 2, 2],
    [3, 2, 3, 2, 3, 2, 2, 2],
    [3, 2, 3, 2, 3, 2, 3, 2],
    [3, 3, 3, 2, 3, 2, 3, 2],
    [3, 3, 3, 2, 3, 3, 3, 2],
    [3, 3, 3, 3, 3, 3, 3, 2],
    [3, 3, 3, 3, 3, 3, 3, 3],
    [4, 3, 3, 3, 3, 3, 3, 3],
    [4, 3, 3, 3, 4, 3, 3, 3],
    [4, 3, 4, 3, 4, 3, 3, 3],
    [4, 3, 4, 3, 4, 3, 4, 3],
    [4, 4, 4, 3, 4, 3, 4, 3],
    [4, 4, 4, 3, 4, 4, 4, 3],
    [4, 4, 4, 4, 4, 4, 4, 3],
    [4, 4, 4, 4, 4, 4, 4, 4],
], dtype=np.int32)


def _counts_to_vector(counts: np.ndarray) -> np.ndarray:
    """Expand a per-group count table into a boolean keep-mask of length 4*len."""
    lanes = np.arange(CODE_RATE)[None, :]
    return (lanes < counts[:, None]).reshape(-1)


def get_puncture_vector(pi_index: int) -> np.ndarray:
    """Boolean keep-mask of length 32 for PI_1..PI_24 (1-indexed)."""
    if not (1 <= pi_index <= 24):
        raise ValueError(f"invalid puncture index {pi_index}")
    return _counts_to_vector(_PI_COUNTS[pi_index - 1])


# tail-bit puncturing: 24 mother symbols, keep-mask (1,1,0,0)*6
PI_X_VECTOR = _counts_to_vector(np.full(6, 2, dtype=np.int32))


def build_puncture_mask(schedule) -> np.ndarray:
    """Concatenate the periodic keep-mask over a [(vector, nb_mother_symbols)]
    schedule. Returns bool mask over the full mother-code symbol stream;
    mask.sum() is the number of transmitted (punctured-stream) symbols."""
    parts = []
    for vec, nb_out in schedule:
        period = vec.shape[0]
        if nb_out % CODE_RATE != 0:
            raise ValueError("segment length must be a multiple of the code rate")
        reps = -(-nb_out // period)
        parts.append(np.tile(vec, reps)[:nb_out])
    return np.concatenate(parts)


def build_depuncture_gather(schedule):
    """For a puncture schedule, produce (gather_idx, mask, nb_in):
    gather_idx[i] = index into the received symbol stream for mother symbol i
    (clamped to 0 where punctured), mask[i] = True where transmitted.
    Depunctured stream = where(mask, rx[gather_idx], 0)."""
    mask = build_puncture_mask(schedule)
    idx = np.cumsum(mask) - 1
    idx = np.maximum(idx, 0).astype(np.int32)
    return idx, mask, int(mask.sum())


def fic_puncture_schedule():
    """Mode-I/II/IV FIB-group schedule: PI_16 over 21*128, PI_15 over 3*128,
    then the tail (reference src/dab/fic/fic_decoder.cpp:57-85)."""
    return [
        (get_puncture_vector(16), 128 * 21),
        (get_puncture_vector(15), 128 * 3),
        (PI_X_VECTOR, 24),
    ]
