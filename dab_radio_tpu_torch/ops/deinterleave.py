"""MSC time deinterleaver (port of ``dab_radio_tpu/ops/deinterleave.py``,
ETSI EN 300 401 clause 12, table 21).

The history is an explicit (16, nb_bits) int8 tensor, oldest row first, and
deinterleaving is one gather along the history axis.
"""

import numpy as np
import torch

CIF_OFFSETS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                       dtype=np.int32)
DEPTH = 16


def make_gather_index(nb_bits: int) -> np.ndarray:
    """index[i] = which oldest-first history row bit i is read from."""
    return CIF_OFFSETS[np.arange(nb_bits) % DEPTH]


def deinterleave_push(history: torch.Tensor, new_cif: torch.Tensor,
                      gather_idx: torch.Tensor):
    """Push one CIF of soft bits and reconstruct the oldest frame.

    history: (..., 16, nb_bits) int8, row 0 = oldest. new_cif: (..., nb_bits).
    gather_idx: (nb_bits,) int64. Returns (new_history, deinterleaved
    (..., nb_bits)); the output is valid once 16 CIFs have been pushed."""
    new_history = torch.cat([history[..., 1:, :], new_cif[..., None, :]],
                            dim=-2)
    idx = gather_idx.expand(*new_history.shape[:-2], 1, gather_idx.shape[0])
    return new_history, torch.gather(new_history, -2, idx)[..., 0, :]


def deinterleave_push_block(history: torch.Tensor, seq: torch.Tensor,
                            gather_idx: torch.Tensor):
    """Push C CIFs at once: output c's bit i reads row c + 1 + gather_idx[i]
    of [history ‖ seq], one gather in place of C deinterleave_push calls.

    history: (..., 16, nb_bits) oldest-first; seq: (..., C, nb_bits).
    Returns (new_history (..., 16, nb_bits), outs (..., C, nb_bits))."""
    C = seq.shape[-2]
    combined = torch.cat([history, seq], dim=-2)              # (..., 16+C, nb)
    rows = torch.arange(1, C + 1, dtype=torch.int64, device=seq.device)
    idx = (rows[:, None] + gather_idx[None, :]).expand(
        *combined.shape[:-2], C, gather_idx.shape[0])
    return combined[..., C:, :], torch.gather(combined, -2, idx)
