"""Viterbi decode, kernel K1 (``csrc/viterbi_acs.cu``): the CUDA kernels, their
plain PyTorch versions, and the wrapper that picks between the kernels.

Replaces the Pallas TPU kernel ``dab_radio_tpu/ops/viterbi_pallas.py``
(``_acs_kernel``) and its ``lax.scan`` chainback, and gives the results of
``dab_radio_tpu/ops/viterbi.py:viterbi_decode_soft_radix4`` bit for bit:
radix-2 add-compare-select over the 64 states of the K=7 trellis, a tie
going to the even predecessor, int32 metrics with no rebasing, and the path
error pm[end] + T * 508. A message runs from state 0 to state 0 unless the
caller names other states (``start_state``, ``end_state``), which the
kernels take as arguments.

Four entries:
  viterbi_decode_fused    forward pass and chainback in one launch,
                          decisions in shared memory (``decode`` for
                          T <= MAX_FUSED_T)
  viterbi_acs             forward pass writing decisions to device memory
  viterbi_chainback       chainback reading them (``decode`` for longer T)
  viterbi_decode_windows  the fused kernel in windowed mode
                          (``decode_windows``): each message is a window of
                          a longer trellis, started from uniform metrics
                          unless it is its trellis's first tile, and traced
                          back from its best final state; no path error.
                          The overlap-save tiled decode of
                          ``dab_radio_tpu/ops/viterbi.py:
                          viterbi_decode_soft_tiled`` runs on it

Layouts shared by the kernels and the plain versions:
  d:    (B, T, 4) int8 depunctured soft symbols (0 where punctured)
  dec:  (T, B) int64, bit s set when new state s came from its odd
        predecessor 2*(s & 31) + 1: 64 decision bits per step and message.
        On the card each message's words lie together: the kernels' dec is
        the transposed view of a contiguous (B, T) tensor
  err:  (B,) int32 path error of the survivor ending in the end state
  bits: (B, T) int8 decoded input bits, tail included

The wrappers take the plain version only for CPU tensors; for a CUDA tensor
they launch the kernel or raise.
"""

import collections
import ctypes

import numpy as np
import torch

from . import build
from ..utils import graphs

NB_STATES = 64
CODE_RATE = 4
INITIAL_NON_START = 5 * CODE_RATE * 254     # margin of the non-start states
STEP_ERR_OFFSET = CODE_RATE * 127           # 508: sum_r |d_r - 127 e_r| offset

# 1 << s for s in 0..63 as int64 (bit 63 is the sign bit)
_BIT_WEIGHTS = np.left_shift(np.uint64(1), np.arange(NB_STATES,
                                                     dtype=np.uint64)).view(np.int64)

# What the kernels are built for: one H100 (sm_90a)
SM_COUNT = 132
MAX_BLOCK_SMEM = 232448        # dynamic shared memory a block may ask for
MAX_MESSAGES_PER_BLOCK = 16    # one warp per message, at most 512 threads
RING_BYTES = 4096              # staged symbols of one message (1024 steps)

# launches of each kernel, and of a forward pass by trellis length T,
# whichever kernel ran it (tells the FIC decodes, T = 774, from the MSC
# ones); reset_launches(). A replay of a captured program adds the launches
# its capture recorded (utils/graphs.py).
LAUNCHES = {"viterbi_decode_fused": 0, "viterbi_acs": 0,
            "viterbi_chainback": 0, "viterbi_decode_windows": 0}
ACS_LAUNCHES_BY_T = collections.Counter()
graphs.LAUNCH_COUNTERS += [LAUNCHES, ACS_LAUNCHES_BY_T]


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ACS_LAUNCHES_BY_T.clear()


def launched(**counts) -> dict:
    """What LAUNCHES reads after a reset and these launches: every kernel
    at 0 but those named."""
    return dict(dict.fromkeys(LAUNCHES, 0), **counts)


def fused_smem_per_message(T: int) -> int:
    """Shared memory of one message in the fused kernel: the symbol ring,
    8 bytes of decisions and 1 byte of decoded bit per step, in 16s."""
    return RING_BYTES + (8 * T + (T + 7) // 8 * 8 + 15) // 16 * 16


# the longest trellis whose decisions fit in a block's shared memory
MAX_FUSED_T = (MAX_BLOCK_SMEM - RING_BYTES) // 9
while fused_smem_per_message(MAX_FUSED_T) > MAX_BLOCK_SMEM:
    MAX_FUSED_T -= 1


def _messages_per_block(B: int, smem: int) -> int:
    """1 while every message can have an SM of its own, else the share of
    one SM, as far as a block's shared memory and warps allow."""
    fit = min(MAX_BLOCK_SMEM // smem, MAX_MESSAGES_PER_BLOCK)
    return 1 if B <= SM_COUNT else min(fit, -(-B // SM_COUNT))


def plan(B: int, T: int):
    """How ``decode`` runs B messages of T steps on the card:
    (route, messages_per_block, smem_per_message).

    route is "fused" while one message's decisions fit in a block's shared
    memory (T <= MAX_FUSED_T = 25372), else "pair": the forward kernel
    writing decisions to device memory and the chainback kernel. This
    follows from the shape alone, never from a failed build or launch.
    With no more messages than SMs each message gets a block, and so an SM,
    of its own. With more, a block takes ceil(B / SM_COUNT) messages, as far
    as its shared memory and 16 warps allow, so that one wave of blocks
    fills every SM's shared memory."""
    smem = fused_smem_per_message(T)
    route = "fused" if smem <= MAX_BLOCK_SMEM else "pair"
    if route == "pair":
        smem = RING_BYTES
    return route, _messages_per_block(B, smem), smem


def _lib():
    lib = build.load("viterbi_acs")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.viterbi_decode_fused.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                             ci, vp]
        lib.viterbi_decode_fused.restype = ci
        lib.viterbi_acs_forward.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.viterbi_acs_forward.restype = ci
        lib.viterbi_chainback.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.viterbi_chainback.restype = ci
        lib.viterbi_decode_windows.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.viterbi_decode_windows.restype = ci
        # plan() stays a pure function of (B, T); its constants are held
        # against the library's once, when the library is first loaded
        limits = (ci * 3)()
        lib.viterbi_limits.restype = None
        lib.viterbi_limits(limits)
        if list(limits) != [RING_BYTES, MAX_MESSAGES_PER_BLOCK, MAX_BLOCK_SMEM]:
            raise RuntimeError(f"viterbi_acs: the library was built for "
                               f"{list(limits)}, the wrapper plans for "
                               f"{[RING_BYTES, MAX_MESSAGES_PER_BLOCK, MAX_BLOCK_SMEM]}")
        lib.viterbi_fused_smem_needed.argtypes = [ci]
        lib.viterbi_fused_smem_needed.restype = ci
        for T in (1, 320, 774, 1542, 9222, MAX_FUSED_T):
            if lib.viterbi_fused_smem_needed(T) != fused_smem_per_message(T):
                raise RuntimeError(f"viterbi_acs: the library and the wrapper "
                                   f"size a message of T={T} differently")
        lib._typed = True
    return lib


# ---------------------------------------------------------------- plain

def _check_state(state: int, what: str):
    if not 0 <= state < NB_STATES:
        raise ValueError(f"{what} must be a state in 0..63, got {state}")


def start_metrics(B: int, device, first_tile: torch.Tensor = None,
                  start_state: int = 0):
    """(B, 64) int32 initial path metrics: start_state at 0 and the rest at
    INITIAL_NON_START; with first_tile (B,) bool, all 64 at 0 for every
    message whose flag is not set (a window inside a longer trellis)."""
    _check_state(start_state, "start_state")
    pm0 = torch.full((B, NB_STATES), INITIAL_NON_START, dtype=torch.int32,
                     device=device)
    pm0[:, start_state].fill_(0)
    if first_tile is not None:
        pm0 = pm0 * first_tile.to(torch.int32)[:, None]
    return pm0


def best_state(pm: torch.Tensor) -> torch.Tensor:
    """(B, 64) int32 metrics -> (B,) int64: the state of the least metric,
    the lowest among equals. torch.argmin does not promise which of equal
    entries it names, so this is one minimum over pm * 64 + state (exact
    while |pm| < 2^56, the metric deciding first)."""
    key = pm.to(torch.int64) * NB_STATES + torch.arange(
        NB_STATES, device=pm.device)
    return key.amin(dim=-1) & (NB_STATES - 1)


def _forward_plain(d: torch.Tensor, pm: torch.Tensor):
    """The radix-2 ACS loop from metrics pm (B, 64) int32:
    d (B, T, 4) int8 -> (dec (T, B) int64, final metrics (B, 64) int32)."""
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
    return dec, pm


def viterbi_acs_plain(d: torch.Tensor, start_state: int = 0,
                      end_state: int = 0):
    """Plain PyTorch forward pass: a loop over T of the radix-2 ACS.
    d (B, T, 4) int8 -> (dec (T, B) int64, err (B,) int32)."""
    _check_state(end_state, "end_state")
    dec, pm = _forward_plain(d, start_metrics(d.shape[0], d.device,
                                              start_state=start_state))
    err = (pm[:, end_state] + d.shape[1] * STEP_ERR_OFFSET).to(torch.int32)
    return dec, err


def chainback_plain(dec: torch.Tensor, state0=0) -> torch.Tensor:
    """Plain PyTorch chainback from state0, one state for every message or
    a (B,) int64 tensor of them: dec (T, B) int64 -> bits (B, T) int8."""
    T, B = dec.shape
    if torch.is_tensor(state0):
        state = state0.to(torch.int64)
    else:
        _check_state(state0, "state0")
        state = torch.full((B,), state0, dtype=torch.int64, device=dec.device)
    bits = torch.empty((T, B), dtype=torch.int8, device=dec.device)
    for t in range(T - 1, -1, -1):
        bits[t] = (state >> 5).to(torch.int8)
        state = ((state & 31) << 1) | ((dec[t] >> state) & 1)
    return bits.T.contiguous()


def decode_windows_plain(d: torch.Tensor,
                         first_tile: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch windowed decode: d (B, L, 4) int8 windows, first_tile
    (B,) bool -> bits (B, L) int8, each window from its start metrics
    (``start_metrics``) back from its best final state (``best_state``)."""
    dec, pm = _forward_plain(d, start_metrics(d.shape[0], d.device,
                                              first_tile))
    return chainback_plain(dec, best_state(pm))


# ---------------------------------------------------------------- wrappers

def _check_symbols(d: torch.Tensor, what: str):
    """Raise unless d is what the kernels take: a contiguous (B, T, 4) int8
    CUDA tensor, 4-byte aligned."""
    if d.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {d.device}")
    if (d.dtype != torch.int8 or d.dim() != 3 or d.shape[2] != CODE_RATE
            or not d.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous (B, T, 4) int8 "
                         f"tensor, got {d.dtype} {tuple(d.shape)}")
    if d.data_ptr() % 4:
        raise ValueError(f"{what}: the kernel reads each step's 4 symbols as "
                         "one 32-bit word; the tensor must be 4-byte aligned")


def viterbi_acs(d: torch.Tensor, start_state: int = 0, end_state: int = 0):
    """Forward ACS over (B, T, 4) int8 from start_state -> (dec (T, B)
    int64, err (B,) int32 of the survivor ending in end_state). On the card
    dec is the transposed view of a contiguous (B, T) tensor."""
    if d.device.type == "cpu":
        return viterbi_acs_plain(d, start_state, end_state)
    _check_symbols(d, "viterbi_acs")
    _check_state(start_state, "start_state")
    _check_state(end_state, "end_state")
    B, T, _ = d.shape
    dec = torch.empty((B, T), dtype=torch.int64, device=d.device).T
    err = torch.empty((B,), dtype=torch.int32, device=d.device)
    if B == 0 or T == 0:
        return dec, err.fill_(0)
    per_block = _messages_per_block(B, RING_BYTES)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        rc = _lib().viterbi_acs_forward(d.data_ptr(), dec.data_ptr(),
                                        err.data_ptr(), B, T, start_state,
                                        end_state, per_block, stream)
    if rc:
        raise RuntimeError(f"viterbi_acs_forward launch failed: CUDA error {rc}")
    LAUNCHES["viterbi_acs"] += 1
    ACS_LAUNCHES_BY_T[T] += 1
    return dec, err


def chainback(dec: torch.Tensor, end_state: int = 0) -> torch.Tensor:
    """Chainback from end_state over (T, B) int64 decisions -> bits (B, T)
    int8. The kernel reads each message's words as a row: a dec that is not
    the transposed view of a contiguous (B, T) tensor is copied into one."""
    if dec.device.type == "cpu":
        return chainback_plain(dec, end_state)
    if dec.device.type != "cuda" or dec.dtype != torch.int64 or dec.dim() != 2:
        raise ValueError(f"chainback: expected a 2-d int64 CUDA or CPU tensor, "
                         f"got {dec.dtype} {tuple(dec.shape)} on {dec.device}")
    _check_state(end_state, "end_state")
    T, B = dec.shape
    rows = dec.T.contiguous()               # no copy for viterbi_acs's dec
    bits = torch.empty((B, T), dtype=torch.int8, device=dec.device)
    if B == 0 or T == 0:
        return bits
    stream = torch.cuda.current_stream(dec.device).cuda_stream
    with torch.cuda.device(dec.device):
        rc = _lib().viterbi_chainback(rows.data_ptr(), bits.data_ptr(), B, T,
                                      end_state, stream)
    if rc:
        raise RuntimeError(f"viterbi_chainback launch failed: CUDA error {rc}")
    LAUNCHES["viterbi_chainback"] += 1
    return bits


def decode_fused(d: torch.Tensor, start_state: int = 0, end_state: int = 0):
    """The fused kernel alone, on a CUDA tensor: (B, T, 4) int8 ->
    (bits (B, T) int8, err (B,) int32) in one launch. Raises for a T above
    MAX_FUSED_T."""
    _check_symbols(d, "decode_fused")
    _check_state(start_state, "start_state")
    _check_state(end_state, "end_state")
    B, T, _ = d.shape
    route, per_block, smem = plan(B, T)
    if route != "fused":
        raise ValueError(f"decode_fused: T={T} needs {fused_smem_per_message(T)}"
                         f" bytes of shared memory a message, a block has "
                         f"{MAX_BLOCK_SMEM}; decode() takes the kernel pair")
    bits = torch.empty((B, T), dtype=torch.int8, device=d.device)
    err = torch.empty((B,), dtype=torch.int32, device=d.device)
    if B == 0 or T == 0:
        return bits, err.fill_(0)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        rc = _lib().viterbi_decode_fused(d.data_ptr(), bits.data_ptr(),
                                         err.data_ptr(), B, T, start_state,
                                         end_state, per_block, smem, stream)
    if rc:
        raise RuntimeError(f"viterbi_decode_fused launch failed: CUDA error {rc}")
    LAUNCHES["viterbi_decode_fused"] += 1
    ACS_LAUNCHES_BY_T[T] += 1
    return bits, err


def decode_windows(d: torch.Tensor, first_tile: torch.Tensor) -> torch.Tensor:
    """Windowed decode of (B, L, 4) int8 windows -> bits (B, L) int8, in one
    launch of the fused kernel's windowed mode. first_tile (B,) bool marks
    the windows that open their trellis (true start metrics); the others
    start from all metrics at 0. Every window is traced back from the state
    of its least final metric, the lowest among equals. There is no path
    error.

    A CPU tensor takes ``decode_windows_plain``. A CUDA tensor launches the
    kernel or raises; a window whose decisions do not fit in a block's
    shared memory (L > MAX_FUSED_T) is refused: the kernel pair has no
    windowed mode."""
    if (first_tile.dtype != torch.bool or first_tile.dim() != 1
            or first_tile.shape[0] != d.shape[0]
            or first_tile.device != d.device):
        raise ValueError(f"decode_windows: first_tile must be a (B,) bool "
                         f"tensor on {d.device}, got {first_tile.dtype} "
                         f"{tuple(first_tile.shape)} on {first_tile.device}")
    if d.device.type == "cpu":
        return decode_windows_plain(d, first_tile)
    _check_symbols(d, "decode_windows")
    B, L, _ = d.shape
    route, per_block, smem = plan(B, L)
    if route != "fused":
        raise ValueError(f"decode_windows: a window of {L} steps needs "
                         f"{fused_smem_per_message(L)} bytes of shared memory,"
                         f" a block has {MAX_BLOCK_SMEM}")
    bits = torch.empty((B, L), dtype=torch.int8, device=d.device)
    if B == 0 or L == 0:
        return bits
    first_tile = first_tile.contiguous()
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        rc = _lib().viterbi_decode_windows(d.data_ptr(), first_tile.data_ptr(),
                                           bits.data_ptr(), B, L, per_block,
                                           smem, stream)
    if rc:
        raise RuntimeError(f"viterbi_decode_windows launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["viterbi_decode_windows"] += 1
    ACS_LAUNCHES_BY_T[L] += 1
    return bits


def decode(d: torch.Tensor, start_state: int = 0, end_state: int = 0):
    """Full decode of (B, T, 4) int8 depunctured symbols ->
    (bits (B, T) int8, err (B,) int32): the best path from start_state to
    end_state, both 0 for a terminated DAB codeword.

    A CPU tensor takes the plain versions. A CUDA tensor takes the route
    ``plan`` names for its shape: the fused kernel, or for T > MAX_FUSED_T
    the forward and chainback kernels with the decisions in device memory."""
    if d.device.type == "cpu":
        dec, err = viterbi_acs_plain(d, start_state, end_state)
        return chainback_plain(dec, end_state), err
    _check_symbols(d, "decode")
    if plan(d.shape[0], d.shape[1])[0] == "fused":
        return decode_fused(d, start_state, end_state)
    dec, err = viterbi_acs(d, start_state, end_state)
    return chainback(dec, end_state), err
