"""Viterbi ACS forward pass and chainback: CUDA kernels and their plain
PyTorch versions (kernel K1, ``csrc/viterbi_acs.cu``).

Replaces the Pallas TPU kernel ``dab_radio_tpu/ops/viterbi_pallas.py``
(``_acs_kernel``) and its ``lax.scan`` chainback, and gives the results of
``dab_radio_tpu/ops/viterbi.py:viterbi_decode_soft_radix4`` bit for bit:
radix-2 add-compare-select over the 64 states of the K=7 trellis, a tie
going to the even predecessor, int32 metrics with no rebasing, and the path
error pm[0] + T * 508.

Layouts shared by the kernels and the plain versions:
  d:    (B, T, 4) int8 depunctured soft symbols (0 where punctured)
  dec:  (T, B) int64, bit s set when new state s came from its odd
        predecessor 2*(s & 31) + 1: 64 decision bits per step and message
  err:  (B,) int32 path error of the survivor ending in state 0
  bits: (B, T) int8 decoded input bits, tail included

The wrappers take the plain version only for CPU tensors; for a CUDA tensor
they launch the kernel or raise.
"""

import collections
import ctypes

import numpy as np
import torch

from . import build

NB_STATES = 64
CODE_RATE = 4
INITIAL_NON_START = 5 * CODE_RATE * 254     # margin of the non-start states
STEP_ERR_OFFSET = CODE_RATE * 127           # 508: sum_r |d_r - 127 e_r| offset

# 1 << s for s in 0..63 as int64 (bit 63 is the sign bit)
_BIT_WEIGHTS = np.left_shift(np.uint64(1), np.arange(NB_STATES,
                                                     dtype=np.uint64)).view(np.int64)

# launches of each kernel, and of the forward kernel by trellis length T
# (tells the FIC decodes, T = 774, from the MSC ones); reset_launches()
LAUNCHES = {"viterbi_acs": 0, "viterbi_chainback": 0}
ACS_LAUNCHES_BY_T = collections.Counter()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ACS_LAUNCHES_BY_T.clear()


def _lib():
    lib = build.load("viterbi_acs")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_acs_forward.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.viterbi_acs_forward.restype = ci
        lib.viterbi_chainback.argtypes = [vp, vp, ci, ci, vp]
        lib.viterbi_chainback.restype = ci
        lib._typed = True
    return lib


def _check_cuda(t: torch.Tensor, dtype, ndim: int, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------- plain

def viterbi_acs_plain(d: torch.Tensor):
    """Plain PyTorch forward pass: a loop over T of the radix-2 ACS.
    d (B, T, 4) int8 -> (dec (T, B) int64, err (B,) int32)."""
    from ..ops.viterbi import _expected_outputs
    B, T, _ = d.shape
    dev = d.device
    # neg[s*2+b, r] = -e[s, b, r]: branch metric = sum_r d_r * neg[s*2+b, r]
    neg = -torch.as_tensor(
        _expected_outputs().reshape(2 * NB_STATES, CODE_RATE), device=dev)
    # branch metrics of every step at once, (T, B, j, p, b) for the
    # transition from old state 2j+p with input b; a float32 product is
    # exact here (|sum| <= 508)
    bm = (d.to(torch.float32) @ neg.T.to(torch.float32)).to(torch.int32)
    bm = bm.view(B, T, 32, 2, 2).transpose(0, 1)
    pm = torch.full((B, NB_STATES), INITIAL_NON_START, dtype=torch.int32,
                    device=dev)
    pm[:, 0] = 0
    odd = torch.empty((T, B, 2, 32), dtype=torch.bool, device=dev)
    for t in range(T):
        cand = pm.view(B, 32, 2, 1) + bm[t]                   # (B, j, p, b)
        even_c, odd_c = cand[:, :, 0, :], cand[:, :, 1, :]    # (B, j, b)
        sel = odd_c < even_c                                  # tie -> even
        # new state s' = b*32 + j
        pm = torch.where(sel, odd_c, even_c).transpose(1, 2).reshape(
            B, NB_STATES)
        odd[t] = sel.transpose(1, 2)
    odd = odd.view(T, B, NB_STATES)
    weights = torch.as_tensor(_BIT_WEIGHTS, device=dev)
    dec = (odd.to(torch.int64) * weights).sum(-1)             # bits disjoint
    err = (pm[:, 0] + T * STEP_ERR_OFFSET).to(torch.int32)
    return dec, err


def chainback_plain(dec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch chainback from state 0: dec (T, B) int64 ->
    bits (B, T) int8."""
    T, B = dec.shape
    state = torch.zeros(B, dtype=torch.int64, device=dec.device)
    bits = torch.empty((T, B), dtype=torch.int8, device=dec.device)
    for t in range(T - 1, -1, -1):
        bits[t] = (state >> 5).to(torch.int8)
        state = ((state & 31) << 1) | ((dec[t] >> state) & 1)
    return bits.T.contiguous()


# ---------------------------------------------------------------- wrappers

def viterbi_acs(d: torch.Tensor):
    """Forward ACS over (B, T, 4) int8 -> (dec (T, B) int64, err (B,) int32)."""
    if d.device.type == "cpu":
        return viterbi_acs_plain(d)
    _check_cuda(d, torch.int8, 3, "viterbi_acs")
    B, T, rate = d.shape
    if rate != CODE_RATE:
        raise ValueError(f"viterbi_acs: expected (B, T, 4), got {tuple(d.shape)}")
    if d.data_ptr() % 4:
        raise ValueError("viterbi_acs: the kernel reads each step's 4 symbols "
                         "as one 32-bit word; the tensor must be 4-byte aligned")
    dec = torch.empty((T, B), dtype=torch.int64, device=d.device)
    err = torch.empty((B,), dtype=torch.int32, device=d.device)
    if B == 0 or T == 0:
        return dec, err.fill_(0)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        rc = _lib().viterbi_acs_forward(d.data_ptr(), dec.data_ptr(),
                                        err.data_ptr(), B, T, stream)
    if rc:
        raise RuntimeError(f"viterbi_acs_forward launch failed: CUDA error {rc}")
    LAUNCHES["viterbi_acs"] += 1
    ACS_LAUNCHES_BY_T[T] += 1
    return dec, err


def chainback(dec: torch.Tensor) -> torch.Tensor:
    """Chainback from state 0 over (T, B) int64 decisions -> bits (B, T) int8."""
    if dec.device.type == "cpu":
        return chainback_plain(dec)
    _check_cuda(dec, torch.int64, 2, "chainback")
    T, B = dec.shape
    bits = torch.empty((B, T), dtype=torch.int8, device=dec.device)
    if B == 0 or T == 0:
        return bits
    stream = torch.cuda.current_stream(dec.device).cuda_stream
    with torch.cuda.device(dec.device):
        rc = _lib().viterbi_chainback(dec.data_ptr(), bits.data_ptr(), B, T,
                                      stream)
    if rc:
        raise RuntimeError(f"viterbi_chainback launch failed: CUDA error {rc}")
    LAUNCHES["viterbi_chainback"] += 1
    return bits


def decode(d: torch.Tensor):
    """Full decode of (B, T, 4) int8 depunctured symbols ->
    (bits (B, T) int8, err (B,) int32)."""
    dec, err = viterbi_acs(d)
    return chainback(dec), err
