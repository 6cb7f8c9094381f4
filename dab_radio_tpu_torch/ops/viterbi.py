"""Punctured convolutional codec for DAB: K=7, rate-1/4 mother code
(port of ``dab_radio_tpu/ops/viterbi.py``).

ETSI EN 300 401 clause 11.1: generator polynomials (octal) 133, 171, 145,
133. Soft bits are int8 in [-127, +127] with punctured positions fed as 0,
add-compare-select over 64 states, chainback to state 0.

The default decode runs kernel K1 (``kernels/viterbi_acs.py``): the CUDA
kernels for CUDA tensors, their plain PyTorch versions for CPU tensors.
Results are those of the JAX ``viterbi_decode`` bit for bit, ties included,
with the path error in the same form (pm[end] + T * 508).

The decode variants of the JAX module are here too, each bit-identical to
its original: the LUT branch metrics (``branch="lut"``), the log-depth
chainback (``chainback="parallel"``), register exchange
(``chainback="fused"``), radix-8, and the overlap-save tiled decode. Which
code a call runs follows from its arguments alone:

  chainback="sequential", branch="matmul"   K1: ``decode`` for the exact
                                            decode, ``decode_windows`` (one
                                            launch over every window) for
                                            the tiled one
  any other chainback or branch, radix-8    the algorithm the argument
                                            names, as torch operations on
                                            the tensor's device

A start or end state other than 0 changes no route: K1 takes both states.

The variants were written to cut the depth of a sequential scan. In torch
each scan is a Python loop of small operations, a few dozen launches a
trellis step, so on a GPU they are bound by launch overhead and far slower
than K1 (root ``PERF.md``); they are kept for parity and as the reference
of a later kernel.

Metrics are int32 with no rebasing where the JAX module carries rebased
float32: both are exact integer arithmetic, so minima, ties and path errors
agree. The packed minimum 4 m + p (8 m + p for radix-8) stays inside int32
for trellises of up to MAX_VARIANT_T steps.

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


# |8 m + p| < 2^31 with |m| <= INITIAL_NON_START + 508 T
MAX_VARIANT_T = ((1 << 28) - 5 * CODE_RATE * 254 - 1) // (CODE_RATE * 127)


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


@functools.lru_cache(maxsize=1)
def _branch_sign_matrix() -> np.ndarray:
    """(4, 128) int32: negated expected signs laid out so that
    d_t(..., 4) @ S -> (..., 128) = branch error minus the per-step
    constant 4*127. Exact identity for int8 soft symbols (incl. punctured
    zeros): |d - 127*e| = 127 - e*d, so sum_r |d_r - 127 e_r| =
    508 - sum_r e_r d_r; the 508 shifts every candidate equally and drops
    out of the min/argmin. Column layout: s*2 + b (state-major)."""
    e = _expected_outputs()                  # (64, 2, 4)
    return np.ascontiguousarray(
        -e.reshape(NB_STATES * 2, CODE_RATE).T).astype(np.int32)


# per trellis step, the dropped constant (for the path error)
_STEP_ERR_OFFSET = CODE_RATE * SOFT_HIGH


@functools.lru_cache(maxsize=1)
def _branch_pattern_lut():
    """LUT factorization of the branch metrics: the 128 per-(state, bit)
    branch errors of one trellis step take only 16 distinct values
    (+/-d0 +/-d1 +/-d2 +/-d3), so instead of the (128, 4) @ (4, B) sign
    product one can compute the 16 sums with a (16, 4) @ (4, B) product and
    expand them with a static 128-row gather.

    Returns (idx (128,) int32, H (16, 4) f32) with
    _branch_sign_matrix().T[k, :] == H[idx[k], :] for every k."""
    S = _branch_sign_matrix().T                      # (128, 4), entries +/-1
    H = np.array([[1 - 2 * ((m >> i) & 1) for i in range(4)]
                  for m in range(16)], np.int64)     # (16, 4)
    bits = ((1 - S) // 2).astype(np.int64)           # (128, 4) in {0, 1}
    idx = (bits * (1 << np.arange(4))).sum(axis=1)
    assert (H[idx] == S).all()
    return idx.astype(np.int32), H.astype(np.float32)


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


_INITIAL_NON_START = 5 * CODE_RATE * (SOFT_HIGH - SOFT_LOW)   # error margin


def _flat_lanes(depunctured: torch.Tensor):
    """(..., T, 4) -> (batch_shape, B, T) and the (B, T, 4) view."""
    batch_shape = depunctured.shape[:-2]
    T = depunctured.shape[-2]
    return batch_shape, T, depunctured.reshape(-1, T, CODE_RATE)


def _check_variant_T(T: int):
    if T > MAX_VARIANT_T:
        raise ValueError(f"a trellis of {T} steps overflows the int32 packed "
                         f"minimum; the most is {MAX_VARIANT_T}")


def _start_sm(B: int, start_state: int, device) -> torch.Tensor:
    """(64, B) int32 start metrics, state-major."""
    return viterbi_acs.start_metrics(B, device,
                                     start_state=start_state).T.contiguous()


def viterbi_decode_soft(depunctured: torch.Tensor, start_state: int = 0,
                        end_state: int = 0):
    """Decode (..., T, 4) depunctured soft symbols.

    Returns (bits (..., T) int8 of 0/1 including tail, path_error (...,)
    int32): K1 (``viterbi_acs.decode``), from start_state to end_state."""
    batch_shape, T, d = _flat_lanes(depunctured)
    d = d.to(torch.int8).contiguous()
    bits, err = viterbi_acs.decode(d, start_state, end_state)
    return bits.reshape(*batch_shape, T), err.reshape(batch_shape)


@functools.lru_cache(maxsize=None)
def _branch_tables(branch: str, device: torch.device):
    """The branch-metric tables of `branch` on `device`, made once per
    device (a captured CUDA graph may copy nothing from the host)."""
    if branch == "lut":
        idx16, H16 = _branch_pattern_lut()
        return (torch.as_tensor(H16, device=device),             # (16, 4)
                torch.as_tensor(idx16, dtype=torch.int64, device=device))
    return (torch.as_tensor(_branch_sign_matrix().T.astype(np.float32),
                            device=device),)                     # (128, 4)


def _branch_err_fn(branch: str, B: int, device):
    """d_t (B, 4) float32 -> (64, 2, B) int32 branch metrics (s, b, B) of one
    trellis step, by the (128, 4) sign product ("matmul") or by the 16
    distinct sums and a 128-row gather ("lut"). The float32 products are
    exact (|sum| <= 508)."""
    if branch not in ("matmul", "lut"):
        raise ValueError(f"branch must be 'matmul' or 'lut', got {branch!r}")
    tables = _branch_tables(branch, torch.device(device))
    if branch == "lut":
        H, idx = tables

        def branch_err(d_t):
            v = (H @ d_t.T).to(torch.int32)                      # (16, B)
            return v[idx].reshape(NB_STATES, 2, B)
    else:
        St, = tables

        def branch_err(d_t):
            return (St @ d_t.T).to(torch.int32).reshape(NB_STATES, 2, B)
    return branch_err


def _radix4_candidates(pm, bm_a, bm_b, B):
    """Candidate metrics (j, p, b1, b2, B) of two fused trellis steps from
    old state s0 = 4 j + p: pm (64, B), bm_a (s0, b1, B), bm_b (s1, b2, B)
    with s1 = (b1 << 5) | (s0 >> 1)."""
    tmp = bm_b.reshape(2, 32, 2, B)[:, :, None].expand(2, 32, 2, 2, B)
    bmb = torch.movedim(tmp, 0, 2).reshape(NB_STATES, 2, 2, B)
    cand = pm[:, None, None, :] + bm_a[:, :, None, :] + bmb
    return cand.reshape(16, 4, 2, 2, B)


def _packed_min(cands, radix: int):
    """One minimum over the predecessor axis 1 gives the survivor metric
    and the decision, with the first of equal metrics winning: the minimum
    of radix * m + p is the least m and, among those, the least p. int32,
    exact (see MAX_VARIANT_T). Returns (metrics, decisions uint8) without
    axis 1."""
    p_idx = torch.arange(radix, dtype=torch.int32, device=cands.device
                         ).reshape(1, radix, *([1] * (cands.dim() - 2)))
    packed = (cands * radix + p_idx).amin(dim=1)
    shift = radix.bit_length() - 1
    return packed >> shift, (packed & (radix - 1)).to(torch.uint8)


def _radix4_forward_sm(pm0, xs, branch: str = "matmul"):
    """State-major radix-4 forward pass.

    pm0: (64, B) int32. xs: (T/2, 2, B, 4) float32. Returns (pm (64, B)
    int32, decisions (T/2, 64, B) uint8): the ancestor index p of each new
    state, whose predecessor two steps back is ((s & 15) << 2) | p.

    A Python loop of T/2 iterations, each a dozen small operations on
    (64, B) tensors: on a GPU its time is the launches', not the
    arithmetic's.

    branch="lut" computes the 16 distinct +/-d sums with a (16, 4) product
    and expands them with a static gather instead of the (128, 4) sign
    product: identical metrics (_branch_pattern_lut)."""
    T2, B = xs.shape[0], pm0.shape[-1]
    _check_variant_T(2 * T2)
    branch_err = _branch_err_fn(branch, B, pm0.device)
    pm = pm0
    decisions = torch.empty((T2, NB_STATES, B), dtype=torch.uint8,
                            device=pm0.device)
    for t in range(T2):
        quads = _radix4_candidates(pm, branch_err(xs[t, 0]),
                                   branch_err(xs[t, 1]), B)
        new_pm, dec = _packed_min(quads, 4)              # (j, b1, b2, B)
        # s2 = (b2 << 5) | (b1 << 4) | j -> order (b2, b1, j)
        pm = torch.movedim(new_pm, (0, 1, 2), (2, 1, 0)).reshape(NB_STATES, B)
        decisions[t] = torch.movedim(dec, (0, 1, 2), (2, 1, 0)
                                     ).reshape(NB_STATES, B)
    return pm, decisions


def _chainback_sm(decisions, state0, radix_bits: int):
    """Sequential chainback of a state-major forward pass of radix
    2**radix_bits: decisions (Tr, 64, B) uint8, state0 (B,) ->
    bits (Tr * radix_bits, B) int8 in forward time order. The per-step
    lookup is a gather at the current state."""
    Tr, _, B = decisions.shape
    r = radix_bits
    keep = (1 << (6 - r)) - 1
    state = state0.to(torch.int64)
    shifts = torch.arange(6 - r, 6, device=decisions.device)[:, None]
    bits = torch.empty((Tr, r, B), dtype=torch.int8, device=decisions.device)
    for t in range(Tr - 1, -1, -1):
        bits[t] = ((state[None, :] >> shifts) & 1).to(torch.int8)
        p = decisions[t].gather(0, state[None, :])[0].to(torch.int64)
        state = ((state & keep) << r) | p
    return bits.reshape(Tr * r, B)


def _radix4_chainback_sm(decisions, state0):
    """decisions (T/2, 64, B) uint8, state0 (B,) -> bits (T, B) int8."""
    return _chainback_sm(decisions, state0, 2)


def _chainback_parallel_sm(decisions, state0, radix_bits: int):
    """Log-depth chainback: compose the per-step traceback pointer maps by
    doubling instead of walking them one after the other.

    decisions: (Tr, 64, B) uint8 ancestor indices from a state-major forward
    pass of radix 2**radix_bits; state0: (B,) traceback anchors. Returns
    bits (Tr*radix_bits, B) int8 in forward time order, bit-identical to
    the sequential chainback (pointer composition is pure index algebra; no
    arithmetic, no ties).

    Each step's traceback is a map over the 64 states,
    prev = ((s & (2^(6-r)-1)) << r) | dec[s]; the walk s_t = ptr_t(s_{t+1})
    is the suffix composition H_t = ptr_t . ptr_{t+1} . ... . ptr_{Tr-1}
    evaluated at the anchor. With G the composition of the k maps from t on,
    G[t] <- G[t][G[t + k]] doubles k: ceil(log2 Tr) passes of one gather
    over the whole (Tr, 64, B) table, O(Tr log Tr) work.

    Cost: the table is held as uint8 and each pass makes its indices as
    int64 (torch.gather takes no other), so the peak is about 10 bytes for
    each of Tr * 64 * B entries: 0.5 KB a trellis step and lane, 4.8 GB at
    9,728 lanes of 771 radix-4 steps. A caller with more lanes than its
    memory holds decodes them in chunks."""
    Tr, S, B = decisions.shape
    r = radix_bits
    keep = (1 << (6 - r)) - 1
    iota = torch.arange(S, dtype=torch.uint8, device=decisions.device
                        )[None, :, None]
    H = ((iota & keep) << r) | decisions                        # (Tr, 64, B)
    k = 1
    while k < Tr:
        head = torch.gather(H[:Tr - k], 1, H[k:].to(torch.int64))
        H = torch.cat([head, H[Tr - k:]], dim=0)
        k *= 2
    anchor = state0.to(torch.int64)
    s = torch.gather(H, 1, anchor[None, None, :].expand(Tr, 1, B))[:, 0, :]
    s_next = torch.cat([s[1:].to(torch.int64), anchor[None, :]], dim=0)
    # newest input bit sits at register bit 5: step t emits bits (6-r)..5
    # of s_{t+1} in time order
    shifts = torch.arange(6 - r, 6, device=decisions.device)[:, None]
    bits = ((s_next[:, None, :] >> shifts) & 1).to(torch.int8)
    return bits.reshape(Tr * r, B)


def _radix4_forward_re(pm0, xs, branch: str = "matmul"):
    """Chainback-free radix-4 forward pass: register exchange.

    Every state carries its decoded bit history as packed words; each ACS
    step takes the survivor predecessor's history (one gather along the
    state axis at ((s' & 15) << 2) | decision) and appends the two bits
    that the new state's index implies (s' = (b2<<5)|(b1<<4)|j). No
    traceback at all, at O(T^2 / 32) word moves against the chainback's
    O(T): for short trellises. Survivor selection is the identical
    packed-min ACS, so the bits match the sequential chainback bit for bit,
    ties included.

    pm0: (64, B) int32. xs: (T/2, 2, B, 4) float32. Returns (pm (64, B)
    int32, hist (64, B, W) int64) with bit 2t+k of the stream at word
    (2t+k)>>5, bit position (2t+k)&31 (LSB-first); a word holds 32 bits in
    an int64, so that bit 31 is no sign bit."""
    T2, B = xs.shape[0], pm0.shape[-1]
    _check_variant_T(2 * T2)
    dev = pm0.device
    W = -(-(2 * T2) // 32)
    branch_err = _branch_err_fn(branch, B, dev)
    sp = torch.arange(NB_STATES, device=dev)
    pred_base = ((sp & 15) << 2)[:, None]                       # (64, 1)
    # bits appended at state s': b1 = (s'>>4)&1 (older), b2 = s'>>5
    new2 = (((sp >> 4) & 1) | ((sp >> 5) << 1))[:, None]        # (64, 1)
    pm = pm0
    hist = torch.zeros((NB_STATES, B, W), dtype=torch.int64, device=dev)
    for t in range(T2):
        quads = _radix4_candidates(pm, branch_err(xs[t, 0]),
                                   branch_err(xs[t, 1]), B)
        new_pm, dec = _packed_min(quads, 4)
        pm = torch.movedim(new_pm, (0, 1, 2), (2, 1, 0)).reshape(NB_STATES, B)
        dec = torch.movedim(dec, (0, 1, 2), (2, 1, 0)).reshape(NB_STATES, B)
        pred = pred_base | dec.to(torch.int64)                  # (64, B)
        hist = torch.gather(hist, 0, pred[:, :, None].expand(-1, -1, W))
        hist[:, :, (2 * t) >> 5] |= new2 << ((2 * t) & 31)
    return pm, hist


def _re_extract_bits(hist, state0, T: int):
    """hist (64, B, W) from _radix4_forward_re, state0 (B,) anchor states ->
    bits (T, B) int8 in forward time order."""
    B = hist.shape[1]
    h = hist[state0.to(torch.int64), torch.arange(B, device=hist.device)]
    shifts = torch.arange(32, device=hist.device)
    bits = ((h[:, :, None] >> shifts) & 1).to(torch.int8)       # (B, W, 32)
    return bits.reshape(B, -1)[:, :T].T


def _radix8_forward_sm(pm0, xs):
    """State-major radix-8 forward pass: three trellis steps per loop
    iteration (T/3 iterations against T/2 for radix-4).

    pm0: (64, B) int32. xs: (T/3, 3, B, 4) float32. Returns (pm (64, B)
    int32, decisions (T/3, 64, B) uint8, a 3-bit ancestor index)."""
    T3, B = xs.shape[0], pm0.shape[-1]
    _check_variant_T(3 * T3)
    branch_err = _branch_err_fn("matmul", B, pm0.device)
    pm = pm0
    decisions = torch.empty((T3, NB_STATES, B), dtype=torch.uint8,
                            device=pm0.device)
    for t in range(T3):
        bm_a = branch_err(xs[t, 0])                   # (s0, b1, B)
        bm_b = branch_err(xs[t, 1])                   # (s1, b2, B)
        bm_c = branch_err(xs[t, 2])                   # (s2, b3, B)
        # s1 = (b1<<5)|(s0>>1): remap onto (s0, b1, b2)
        t2 = bm_b.reshape(2, 32, 2, B)[:, :, None].expand(2, 32, 2, 2, B)
        bmb = torch.movedim(t2, 0, 2).reshape(NB_STATES, 2, 2, B)
        # s2 = (b2<<5)|(b1<<4)|(s0>>2): remap onto (s0, b1, b2, b3)
        t3 = bm_c.reshape(2, 2, 16, 1, 2, B).expand(2, 2, 16, 4, 2, B)
        bmc = torch.movedim(t3, (0, 1), (3, 2)).reshape(NB_STATES, 2, 2, 2, B)
        cand = (pm[:, None, None, None, :] + bm_a[:, :, None, None, :]
                + bmb[:, :, :, None, :] + bmc)       # (s0, b1, b2, b3, B)
        # final s3 = (b3<<5)|(b2<<4)|(b1<<3)|(s0>>3); candidates ordered by
        # p = s0 & 7 = 4*p3 + 2*p2 + p1: first-min-wins over that order
        # reproduces the per-step even-predecessor tie-breaks
        new_pm, dec = _packed_min(cand.reshape(8, 8, 2, 2, 2, B), 8)
        pm = torch.movedim(new_pm, (0, 1, 2, 3), (3, 2, 1, 0)
                           ).reshape(NB_STATES, B)
        decisions[t] = torch.movedim(dec, (0, 1, 2, 3), (3, 2, 1, 0)
                                     ).reshape(NB_STATES, B)
    return pm, decisions


def _radix8_chainback_sm(decisions, state0):
    """decisions (T/3, 64, B) uint8, state0 (B,) -> bits (T, B) int8."""
    return _chainback_sm(decisions, state0, 3)


def _steps_sm(d: torch.Tensor, radix_bits: int) -> torch.Tensor:
    """(B, T, 4) symbols -> (T/r, r, B, 4) float32, time-major."""
    B, T, _ = d.shape
    return d.to(torch.float32).transpose(0, 1).reshape(
        T // radix_bits, radix_bits, B, CODE_RATE)


def viterbi_decode_soft_radix8(depunctured: torch.Tensor, start_state: int = 0,
                               end_state: int = 0,
                               chainback: str = "sequential"):
    """Radix-8 decode in torch: three trellis steps per loop iteration.
    Bit-exact against viterbi_decode_soft / _radix4 including the tie-breaks
    (see _radix8_forward_sm). Requires T % 3 == 0."""
    if chainback not in ("sequential", "parallel"):
        raise ValueError("radix8 has no register-exchange (fused) chainback")
    batch_shape, T, d = _flat_lanes(depunctured)
    if T % 3:
        raise ValueError("radix-8 needs T divisible by 3")
    B = d.shape[0]
    pm_final, decisions = _radix8_forward_sm(
        _start_sm(B, start_state, d.device), _steps_sm(d, 3))
    state0 = torch.full((B,), end_state, dtype=torch.int64, device=d.device)
    if chainback == "parallel":
        bits = _chainback_parallel_sm(decisions, state0, 3)   # (T, B)
    else:
        bits = _radix8_chainback_sm(decisions, state0)        # (T, B)
    error = (pm_final[end_state] + T * _STEP_ERR_OFFSET).to(torch.int32)
    return bits.T.reshape(*batch_shape, T), error.reshape(batch_shape)


def _check_flags(chainback: str, branch: str):
    if chainback not in ("sequential", "parallel", "fused"):
        raise ValueError("chainback must be 'sequential', 'parallel' or "
                         f"'fused', got {chainback!r}")
    if branch not in ("matmul", "lut"):
        raise ValueError(f"branch must be 'matmul' or 'lut', got {branch!r}")


def _radix4_bits(pm0, xs, T, chainback, branch, anchor):
    """Forward pass and traceback of one state-major radix-4 decode.
    anchor: (B,) states, or None for the best final state of each lane.
    Returns (pm_final (64, B), bits (T, B))."""
    def state0(pm):
        return viterbi_acs.best_state(pm.T) if anchor is None else anchor
    if chainback == "fused":
        pm, hist = _radix4_forward_re(pm0, xs, branch=branch)
        return pm, _re_extract_bits(hist, state0(pm), T)
    pm, decisions = _radix4_forward_sm(pm0, xs, branch=branch)
    if chainback == "parallel":
        return pm, _chainback_parallel_sm(decisions, state0(pm), 2)
    return pm, _radix4_chainback_sm(decisions, state0(pm))


def viterbi_decode_soft_radix4(depunctured: torch.Tensor, start_state: int = 0,
                               end_state: int = 0,
                               chainback: str = "sequential",
                               branch: str = "matmul"):
    """The exact decode under the JAX package's name for it. With the
    default chainback and branch it is K1 (``viterbi_decode_soft``), whose
    radix-2 recursion gives the radix-4 scan's bits, ties and path error.
    Any other chainback or branch runs the radix-4 algorithm that the
    arguments name, in torch: two trellis steps per loop iteration in the
    state-major (64, B) layout, candidates ordered by p = s0 & 3 =
    (p_step2 << 1) | p_step1 so that first-minimum-wins reproduces the
    even-predecessor-first preference of both steps.

    chainback="parallel" composes the traceback maps in log depth
    (_chainback_parallel_sm), "fused" is register exchange
    (_radix4_forward_re); branch="lut" the 16-entry branch metrics.

    Requires an even number of trellis steps (always true for DAB: byte
    payloads + 6 tail bits)."""
    _check_flags(chainback, branch)
    batch_shape, T, d = _flat_lanes(depunctured)
    if T % 2:
        raise ValueError("radix-4 needs an even trellis length")
    if (chainback, branch) == ("sequential", "matmul"):
        return viterbi_decode_soft(depunctured, start_state, end_state)
    B = d.shape[0]
    anchor = torch.full((B,), end_state, dtype=torch.int64, device=d.device)
    pm_final, bits = _radix4_bits(_start_sm(B, start_state, d.device),
                                  _steps_sm(d, 2), T, chainback, branch,
                                  anchor)
    error = (pm_final[end_state] + T * _STEP_ERR_OFFSET).to(torch.int32)
    return bits.T.reshape(*batch_shape, T), error.reshape(batch_shape)


def tile_windows(depunctured: torch.Tensor, chunk: int = 128,
                 overlap: int = 96):
    """The windows of the tiled decode: (B, T, 4) symbols -> (windows
    (B * C, L, 4) int8 with C = ceil(T / chunk) and L = chunk + 2 * overlap,
    first (B * C,) bool). Window c of a lane covers steps c * chunk - overlap
    to (c + 1) * chunk + overlap, with neutral (zero) symbols outside
    [0, T); `first` marks each lane's window 0, which starts from the true
    state-0 metrics while the others start from uniform ones."""
    if depunctured.dim() != 3:
        raise ValueError("the tiled decode expects one batch dimension")
    if chunk % 2 or overlap % 2:
        raise ValueError("chunk and overlap must be even")
    B, T, _ = depunctured.shape
    dev = depunctured.device
    nb_chunks = -(-T // chunk)
    L = chunk + 2 * overlap
    d_pad = torch.nn.functional.pad(
        depunctured.to(torch.int8),
        (0, 0, overlap, nb_chunks * chunk - T + overlap))
    idx = (torch.arange(nb_chunks, device=dev)[:, None] * chunk
           + torch.arange(L, device=dev)[None, :])
    windows = d_pad[:, idx].reshape(B * nb_chunks, L, CODE_RATE)
    first = (torch.arange(nb_chunks, device=dev) == 0).repeat(B)
    return windows, first


def viterbi_decode_soft_tiled(depunctured: torch.Tensor,
                              chunk: int = 128, overlap: int = 96,
                              chainback: str = "sequential",
                              branch: str = "matmul"):
    """Overlap-save tiled decode: the T trellis steps split into chunks that
    decode in parallel, each with `overlap` warmup steps (ACS from uniform
    metrics converges to the survivor paths within 5 to 10 constraint
    lengths) and `overlap` cooldown steps before its traceback anchor, the
    best final state.

    Sequential depth drops from T to chunk + 2*overlap at (1 + 2*overlap /
    chunk) times the work. Not guaranteed bit-exact under extreme noise (the
    per-layer CRCs gate such frames anyway); exact on clean input and equal
    to the full decode at operating SNR.

    With chainback="sequential" and branch="matmul" every window of every
    lane goes through K1's windowed mode in one launch
    (``viterbi_acs.decode_windows``; its plain version on the CPU); any
    other flag runs the radix-4 algorithm it names over the windows, in
    torch. Same windows and same anchors either way, so the bits are those
    of the JAX function.

    depunctured: (B, T, 4). Returns (bits (B, T) int8, None)."""
    _check_flags(chainback, branch)
    windows, first = tile_windows(depunctured, chunk, overlap)
    B, T, _ = depunctured.shape
    nb_chunks = -(-T // chunk)
    L = chunk + 2 * overlap                       # extended chunk length

    if chainback == "sequential" and branch == "matmul":
        bits = viterbi_acs.decode_windows(windows, first)     # (BC, L)
    else:
        pm0 = viterbi_acs.start_metrics(B * nb_chunks, windows.device,
                                        first).T
        _, bits = _radix4_bits(pm0.contiguous(), _steps_sm(windows, 2), L,
                               chainback, branch, None)
        bits = bits.T                                         # (BC, L)
    bits = bits.reshape(B, nb_chunks, L)[:, :, overlap:overlap + chunk]
    return bits.reshape(B, nb_chunks * chunk)[:, :T], None


def viterbi_decode(rx_soft: torch.Tensor, spec: ViterbiSpec,
                   chainback: str = "sequential", branch: str = "matmul"):
    """End-to-end: depuncture + decode + drop tail bits.

    rx_soft: (..., nb_in) int8 soft symbols. Returns (data_bits (..., nb_data)
    int8, path_error (...,) int32). A trellis of odd length has no radix-4
    form and takes the default decode whatever the flags, as in the JAX
    package."""
    d = depuncture(rx_soft, spec, dtype=torch.int8)
    if spec.nb_steps % 2 == 0:
        bits, err = viterbi_decode_soft_radix4(d, chainback=chainback,
                                               branch=branch)
    else:
        bits, err = viterbi_decode_soft(d)
    return bits[..., :spec.nb_data_bits], err


def viterbi_decode_tiled(rx_soft: torch.Tensor, spec: ViterbiSpec,
                         chunk: int = 128, overlap: int = 96,
                         chainback: str = "sequential"):
    """Tiled variant of viterbi_decode (see viterbi_decode_soft_tiled for
    the accuracy contract). Returns (data_bits, None)."""
    d = depuncture(rx_soft, spec, dtype=torch.int8)
    squeeze = d.dim() == 2
    if squeeze:
        d = d[None]
    bits, _ = viterbi_decode_soft_tiled(d, chunk=chunk, overlap=overlap,
                                        chainback=chainback)
    bits = bits[..., :spec.nb_data_bits]
    return (bits[0] if squeeze else bits), None


def pack_bits_msb(bits: np.ndarray) -> np.ndarray:
    """0/1 bit array -> uint8 bytes, MSB first (host side)."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
