"""Punctured convolutional codec for DAB: K=7, rate-1/4 mother code
(port of ``dab_radio_tpu/ops/viterbi.py``).

ETSI EN 300 401 clause 11.1: generator polynomials (octal) 133, 171, 145,
133. Soft bits are int8 in [-127, +127] with punctured positions fed as 0,
add-compare-select over 64 states, chainback to state 0.

The decode runs kernel K1 (``kernels/viterbi_acs.py``): the CUDA kernels for
CUDA tensors, their plain PyTorch versions for CPU tensors. Results are
those of the JAX ``viterbi_decode`` bit for bit, ties included, with the
path error in the same form (pm[end] + T * 508).

The numpy table and encoder functions below are copies of the JAX
module's: importing that module would load ``jax``.

State convention: state s after consuming bit a(t) is the 6 most recent
input bits with a(t) at bit 5; the transition from s with new input b is
s' = (b << 5) | (s >> 1).
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..params.puncture import build_depuncture_gather, CODE_RATE
from ..kernels import viterbi_acs

K = 7
NB_STATES = 1 << (K - 1)
POLYS = (0o133, 0o171, 0o145, 0o133)
SOFT_HIGH = 127   # logical bit 1
SOFT_LOW = -127   # logical bit 0


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def _expected_outputs() -> np.ndarray:
    """(64, 2, 4) int32: expected soft sign (+/-1) of each coded bit for a
    transition from state s with input b. Register = [b, s5..s0] where poly
    bit 6 taps the newest input bit."""
    s = np.arange(NB_STATES, dtype=np.int64)[:, None, None]
    b = np.arange(2, dtype=np.int64)[None, :, None]
    reg = (b << 6) | s
    polys = np.array(POLYS, dtype=np.int64)[None, None, :]
    bits = _parity(reg & polys)
    return (2 * bits - 1).astype(np.int32)   # bit -> +/-1


def conv_encode(bits: np.ndarray, append_tail: bool = True) -> np.ndarray:
    """Encode 0/1 bits with the DAB mother code. Returns the serialized coded
    bit stream x0(0) x1(0) x2(0) x3(0) x0(1) ... as 0/1 uint8.
    With append_tail, six zero bits terminate the trellis at state 0."""
    bits = np.asarray(bits, dtype=np.uint8)
    if append_tail:
        bits = np.concatenate([bits, np.zeros(K - 1, dtype=np.uint8)])
    exp = (_expected_outputs() + 1) // 2     # back to 0/1, (64, 2, 4)
    out = np.empty((bits.shape[0], CODE_RATE), dtype=np.uint8)
    state = 0
    for t, b in enumerate(bits.tolist()):
        out[t] = exp[state, b]
        state = (b << 5) | (state >> 1)
    return out.reshape(-1)


def puncture(coded: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Keep only transmitted mother symbols (TX side)."""
    return coded[mask]


def bits_to_soft(bits: np.ndarray) -> np.ndarray:
    """0/1 bits -> ideal int8 soft symbols (+127 for 1, -127 for 0)."""
    return np.where(np.asarray(bits) > 0, SOFT_HIGH, SOFT_LOW).astype(np.int8)


@dataclass(frozen=True, eq=False)
class ViterbiSpec:
    """Static decode plan for one puncture schedule."""
    gather_idx: np.ndarray     # (nb_mother,) int32 into the received stream
    mask: np.ndarray           # (nb_mother,) bool, True where transmitted
    nb_in: int                 # transmitted symbols consumed
    nb_steps: int              # trellis steps = nb_mother / 4
    nb_data_bits: int          # decoded bits excluding the 6 tail bits

    @classmethod
    def from_schedule(cls, schedule) -> "ViterbiSpec":
        idx, mask, nb_in = build_depuncture_gather(schedule)
        nb_steps = mask.shape[0] // CODE_RATE
        return cls(idx, mask, nb_in, nb_steps, nb_data_bits=nb_steps - (K - 1))

    @functools.lru_cache(maxsize=None)
    def tables(self, device: torch.device):
        """(gather_idx int64, mask bool) on `device`, made once per device."""
        return (torch.as_tensor(self.gather_idx, dtype=torch.int64,
                                device=device),
                torch.as_tensor(self.mask, device=device))


def depuncture(rx_soft: torch.Tensor, spec: ViterbiSpec,
               dtype=torch.int32) -> torch.Tensor:
    """(..., nb_in) int8 -> (..., nb_steps, 4) with zeros at punctured
    positions (zero soft symbols are metric-neutral)."""
    idx, mask = spec.tables(rx_soft.device)
    d = torch.where(mask, rx_soft[..., idx], 0).to(dtype)
    return d.reshape(*rx_soft.shape[:-1], spec.nb_steps, CODE_RATE)


def viterbi_decode_soft(depunctured: torch.Tensor):
    """Decode (..., T, 4) depunctured soft symbols from state 0 to state 0.

    Returns (bits (..., T) int8 of 0/1 including tail, path_error (...,)
    int32)."""
    batch_shape = depunctured.shape[:-2]
    T = depunctured.shape[-2]
    d = depunctured.to(torch.int8).reshape(-1, T, CODE_RATE).contiguous()
    bits, err = viterbi_acs.decode(d)
    return bits.reshape(*batch_shape, T), err.reshape(batch_shape)


def viterbi_decode(rx_soft: torch.Tensor, spec: ViterbiSpec):
    """End-to-end: depuncture + decode + drop tail bits.

    rx_soft: (..., nb_in) int8 soft symbols. Returns (data_bits (..., nb_data)
    int8, path_error (...,) int32)."""
    d = depuncture(rx_soft, spec, dtype=torch.int8)
    bits, err = viterbi_decode_soft(d)
    return bits[..., :spec.nb_data_bits], err
