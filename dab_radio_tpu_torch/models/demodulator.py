"""Streaming OFDM demodulator (port of ``dab_radio_tpu/models/demodulator.py``).

Demodulation is ``frame_step(carry, window)`` over one frame-sized window
plus a timing margin, with all synchronisation state in an explicit carry
of tensors on the demodulator's device. The host driver only moves a read
pointer (acquisition / per-frame timing drift). A leading batch axis on the
window and carry demodulates many streams at once (``frame_step_batch``).
On a CUDA device the frame step, the K-frame scan, the acquisition's
null-dip search and its L1 level run as captured CUDA graphs
(``utils/graphs.py``), one for each input shape and frame count, as the
JAX package jits them.

Per frame the step performs:
  1. running L1 signal average update (AGC reference for null-dip search)
  2. coarse integral CFO by PRS relative-phase correlation (fast/slow blend)
  3. fine time sync by PRS matched filter (desync reset if peak < 20 dB)
  4. CFO-corrected batched FFT demod of all symbols
  5. differential QPSK + frequency deinterleave + int8 soft-bit demap
  6. fractional CFO update from the cyclic-prefix phase error

IQ is complex64 throughout: the JAX package's float32-pair wire format
works around its device transport and has no counterpart here.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..params import get_ofdm_params, get_prs_reference
from ..params.mapper import get_carrier_mapper, get_carrier_to_fft_bin
from ..ops import sync as sync_ops
from ..ops.demod import demod_frame_body
from ..ops.pll import apply_pll
from ..utils.backend import to_device
from ..utils.graphs import CapturedProgram
from ..utils.profiler import profile_scope


@dataclass(frozen=True)
class DemodConfig:
    """Sync hyperparameters (same fields and defaults as the JAX package)."""
    signal_l1_beta: float = 0.95
    null_search_nb_samples: int = 100
    thresh_null_start: float = 0.35
    thresh_null_end: float = 0.75
    fine_freq_beta: float = 0.9
    enable_coarse_freq: bool = True
    max_coarse_freq_norm: float = 0.5
    coarse_slow_beta: float = 0.1
    impulse_peak_threshold_db: float = 20.0
    impulse_peak_distance_prob: float = 0.15
    # apply the measured fractional CFO within the same frame when it
    # exceeds this many FFT bins; small errors keep the smoothed carry path
    fine_sameframe_bins: float = 0.05
    # > 0: transform the frame body's symbols in chunks of this size
    symbol_chunk: int = 0


_CARRY_DTYPES = (torch.float32, torch.float32, torch.bool, torch.float32,
                 torch.int32, torch.int32)


class DemodCarry(NamedTuple):
    """Per-stream synchronisation state carried between frames."""
    freq_coarse: torch.Tensor     # f32, normalised
    freq_fine: torch.Tensor       # f32, normalised
    is_coarse_found: torch.Tensor  # bool
    signal_l1_avg: torch.Tensor   # f32
    total_frames: torch.Tensor    # i32
    total_desync: torch.Tensor    # i32

    @classmethod
    def init(cls, batch_shape=(), *, device) -> "DemodCarry":
        return cls(*[torch.zeros(batch_shape, dtype=dt, device=device)
                     for dt in _CARRY_DTYPES])

    @classmethod
    def from_numpy(cls, arrays, device) -> "DemodCarry":
        return cls(*[to_device(np.asarray(a), device).to(dt)
                     for a, dt in zip(arrays, _CARRY_DTYPES)])

    def numpy(self) -> list:
        return [x.cpu().numpy() for x in self]


def _select(cond, a: DemodCarry, b: DemodCarry) -> DemodCarry:
    return DemodCarry(*[torch.where(cond, x, y) for x, y in zip(a, b)])


class OFDMDemodulator:
    """Holds the mode constants (on `device`) and the frame step.

    cuda_graph (see ``utils/graphs.py``): None runs ``frame_step``,
    ``frame_step_batch``, ``frame_scan``, ``acquire`` and ``l1`` as
    captured CUDA graphs on a CUDA device and eagerly on the CPU, True asks
    for the capture (raises for a CPU device), False is the eager path.
    Their results are the same either way, bit for bit, and are the
    caller's own: a captured call returns copies of the graph's buffers,
    so a caller may keep a carry or the bits across calls."""

    def __init__(self, transmission_mode: int = 1,
                 config: DemodConfig = DemodConfig(), *,
                 device: torch.device, cuda_graph=None):
        self.mode = transmission_mode
        self.cfg = config
        self.device = torch.device(device)
        self.params = p = get_ofdm_params(transmission_mode)

        prs = get_prs_reference(transmission_mode, p.nb_fft)
        dev = self.device
        self.prs_fft_conj = torch.as_tensor(
            np.conj(prs).astype(np.complex64), device=dev)
        self.prs_time_corr_ref = torch.as_tensor(
            sync_ops.make_prs_time_correlation_ref(prs), device=dev)
        self.carrier_map = torch.as_tensor(
            get_carrier_mapper(p.nb_fft, p.nb_data_carriers),
            dtype=torch.int64, device=dev)
        self.carrier_bins = torch.as_tensor(
            get_carrier_to_fft_bin(p.nb_fft, p.nb_data_carriers),
            dtype=torch.int64, device=dev)

        self.body_len = p.nb_frame_symbols * p.nb_symbol_period
        self.margin = p.nb_symbol_period          # timing drift search span
        self.window_len = p.nb_null_period + self.body_len + self.margin
        self.frame_advance = p.nb_frame_samples   # nominal samples per frame
        self._body_ar = torch.arange(self.body_len, device=dev)
        self._window_ar = torch.arange(self.window_len, device=dev)
        # the counterparts of the JAX class's jitted step and scan: one
        # program each, a graph for each window shape and frame count
        self._step_program = CapturedProgram(self._frame_step_impl, dev,
                                             cuda_graph=cuda_graph)
        self._scan_program = CapturedProgram(self._frame_scan_impl, dev,
                                             cuda_graph=cuda_graph)
        # JAX's jitted _acquire and _l1, a graph for each block shape
        self._acquire_program = CapturedProgram(self._acquire_impl, dev,
                                                cuda_graph=cuda_graph)
        self._l1_program = CapturedProgram(sync_ops.l1_average, dev,
                                           cuda_graph=cuda_graph)

    def _as_iq(self, x) -> torch.Tensor:
        return to_device(x, self.device, np.complex64)

    def _run(self, program: CapturedProgram, *args):
        """program(*args) with the IQ argument (the last) as ``_as_iq``
        makes it; a captured program takes a numpy one as complex64 on the
        host and stages it itself. A captured program's results are copied
        out of its buffers."""
        *head, iq = args
        if program.captured and not torch.is_tensor(iq):
            iq = np.require(iq, np.complex64)
        else:
            iq = self._as_iq(iq)
        out = program(*head, iq)
        if program.captured:
            out = pytree.tree_map(
                lambda x: x.clone() if torch.is_tensor(x) else x, out)
        return out

    # ---------------- device ops ----------------

    def _frame_step_impl(self, carry: DemodCarry, window: torch.Tensor):
        p, cfg = self.params, self.cfg
        nfft, cp = p.nb_fft, p.nb_cyclic_prefix

        # 1. signal level EMA (frame-granularity running average)
        measured = sync_ops.l1_average(window)
        l1 = torch.where(carry.signal_l1_avg > 0,
                         cfg.signal_l1_beta * carry.signal_l1_avg
                         + (1 - cfg.signal_l1_beta) * measured,
                         measured)

        prs_rx = window[..., p.nb_null_period: p.nb_null_period + nfft]

        # 2. coarse integral CFO
        if cfg.enable_coarse_freq:
            pred = sync_ops.coarse_freq_estimate(
                prs_rx, self.prs_time_corr_ref, nfft, cfg.max_coarse_freq_norm)
            coarse, delta_c = sync_ops.coarse_freq_update(
                pred, carry.freq_coarse, carry.is_coarse_found, nfft,
                cfg.coarse_slow_beta)
            fine = sync_ops.wrap_fine_offset(carry.freq_fine - delta_c, nfft)
        else:
            coarse = torch.zeros_like(carry.freq_coarse)
            fine = carry.freq_fine

        # 3. fine time sync on the CFO-corrected PRS
        offset, sync_ok, _ = sync_ops.fine_time_offset(
            prs_rx, self.prs_fft_conj, coarse + fine,
            nfft, cp, p.nb_symbol_period,
            cfg.impulse_peak_threshold_db, cfg.impulse_peak_distance_prob)
        offset = torch.clamp(offset, -cp, self.margin)

        # 4-5. aligned frame body -> soft bits (a gather at a device offset)
        start = (p.nb_null_period + offset).to(torch.int64)
        body = torch.gather(window, -1, start[..., None] + self._body_ar)

        # measure the fractional CFO on this window first; a large residual
        # is corrected within the same frame
        if cfg.fine_sameframe_bins > 0:
            syms_pre = apply_pll(body, coarse + fine).reshape(
                *body.shape[:-1], p.nb_frame_symbols, p.nb_symbol_period)
            ferr_pre = sync_ops.fine_freq_error(
                sync_ops.cyclic_phase_error(syms_pre, nfft, cp), nfft)
            big = ferr_pre.abs() > (cfg.fine_sameframe_bins / nfft)
            fine = torch.where(
                big, sync_ops.wrap_fine_offset(fine - ferr_pre, nfft), fine)

        bits, cyc_err, _ = demod_frame_body(
            body, coarse + fine, nb_fft=nfft,
            nb_symbol_period=p.nb_symbol_period,
            nb_frame_symbols=p.nb_frame_symbols,
            nb_cyclic_prefix=cp,
            carrier_bins=self.carrier_bins,
            carrier_map=self.carrier_map,
            symbol_chunk=cfg.symbol_chunk)

        # 6. fractional CFO update (used from the next frame on)
        ferr = sync_ops.fine_freq_error(cyc_err, nfft)
        fine2 = sync_ops.wrap_fine_offset(fine - cfg.fine_freq_beta * ferr, nfft)

        tracked = DemodCarry(coarse, fine2,
                             torch.ones_like(carry.is_coarse_found),
                             l1, carry.total_frames + 1, carry.total_desync)
        reset = DemodCarry(torch.zeros_like(coarse), torch.zeros_like(fine2),
                           torch.zeros_like(carry.is_coarse_found),
                           l1, carry.total_frames, carry.total_desync + 1)
        new_carry = _select(sync_ok, tracked, reset)
        return new_carry, {"bits": bits, "sync_ok": sync_ok, "offset": offset}

    def _acquire_impl(self, l1_avg, block):
        cfg = self.cfg
        return sync_ops.find_null_dip(
            block, to_device(l1_avg, self.device, np.float32),
            nb_block=cfg.null_search_nb_samples,
            thresh_start=cfg.thresh_null_start, thresh_end=cfg.thresh_null_end)

    def acquire(self, block, l1_avg):
        """Null-dip search over a block against the level l1_avg (a number
        or a tensor): (found, end_index)."""
        if not torch.is_tensor(l1_avg):
            l1_avg = np.asarray(l1_avg, np.float32)
        return self._run(self._acquire_program, l1_avg, block)

    def l1(self, block) -> torch.Tensor:
        """The block's mean L1 level (sync_ops.l1_average)."""
        return self._run(self._l1_program, block)

    def frame_scan(self, nb_frames: int, carry: DemodCarry, buf):
        """Demodulate up to nb_frames consecutive frames without a host
        read in between. buf: (nb_frames*frame_advance + window_len,)
        complex, or (B, that many) with carry fields (B,) for B streams at
        once, each with a read position of its own. The read position is a
        device tensor: each frame's timing offset advances the next window
        (clamped so every slice is in bounds); after the first desync the
        remaining frames are masked invalid. Returns (carry,
        consumed_samples, {bits (F, nb_bits), valid (F,)}), with a leading
        B on all three for a batch."""
        return self._run(self._scan_program, nb_frames, carry, buf)

    def _frame_scan_impl(self, nb_frames: int, carry: DemodCarry, buf):
        batch = buf.shape[:-1]
        max_pos = nb_frames * self.frame_advance
        pos = torch.zeros(batch, dtype=torch.int64, device=self.device)
        alive = torch.ones(batch, dtype=torch.bool, device=self.device)
        bits, valid = [], []
        for _ in range(nb_frames):
            window = torch.gather(buf, -1, pos[..., None] + self._window_ar)
            new_c, out = self._frame_step_impl(carry, window)
            ok = out["sync_ok"] & alive
            carry = _select(alive, new_c, carry)
            pos = torch.where(ok, pos + out["offset"] + self.frame_advance, pos)
            pos = torch.clamp(pos, 0, max_pos)
            alive = ok
            bits.append(out["bits"])
            valid.append(ok)
        return carry, pos, {"bits": torch.stack(bits, dim=-2),
                            "valid": torch.stack(valid, dim=-1)}

    def frame_step(self, carry: DemodCarry, window):
        """Single-stream step; window (window_len,) complex."""
        return self._run(self._step_program, carry, window)

    def frame_step_batch(self, carry: DemodCarry, windows):
        """Batched step; windows (B, window_len) complex, carry fields (B,)."""
        return self._run(self._step_program, carry, windows)


class _StreamBuffer:
    """Amortized-O(chunk) ingest buffer: live samples sit in one
    preallocated array between ``_start``/``_end``; ``view`` returns
    zero-copy slices."""

    def __init__(self, dtype=np.complex64, capacity: int = 1 << 16):
        self._arr = np.empty(capacity, dtype)
        self._start = 0
        self._end = 0

    def __len__(self):
        return self._end - self._start

    def append(self, x: np.ndarray):
        n = x.shape[0]
        if self._end + n > self._arr.shape[0]:
            live = len(self)
            cap = self._arr.shape[0]
            while cap < 2 * (live + n):  # keep headroom: compaction stays rare
                cap *= 2
            if cap != self._arr.shape[0]:
                new = np.empty(cap, self._arr.dtype)
                new[:live] = self._arr[self._start:self._end]
                self._arr = new
            else:
                self._arr[:live] = self._arr[self._start:self._end]
            self._start, self._end = 0, live
        self._arr[self._end:self._end + n] = x
        self._end += n

    def view(self, a: int, b: int) -> np.ndarray:
        return self._arr[self._start + a:self._start + b]

    def consume(self, n: int):
        self._start = min(self._start + n, self._end)

    def to_array(self) -> np.ndarray:
        return self._arr[self._start:self._end].copy()

    def set(self, data: np.ndarray):
        self._start, self._end = 0, 0
        self.append(np.asarray(data, self._arr.dtype))


class StreamingDemodulator:
    """Host-side streaming driver over one IQ stream.

    Owns a growable sample buffer and a read pointer; alternates between
    acquisition (null-dip search) and per-frame tracking. Emits one int8
    soft-bit numpy array per locked frame."""

    ACQUIRE, TRACK = 0, 1

    def __init__(self, demod: OFDMDemodulator, frames_per_step: int = 1):
        self.demod = demod
        self.carry = DemodCarry.init(device=demod.device)
        self.state = self.ACQUIRE
        self._buf = _StreamBuffer()
        self._l1 = 0.0
        # the most recent tracked frame window, a host copy of the stream
        # buffer (diagnostics/GUI hook: apps/monitor.py, tui.py, webmon.py)
        self.last_window = None
        # frames_per_step > 1 runs K tracking steps per host read
        self.frames_per_step = max(1, frames_per_step)

    def reset(self):
        self.carry = DemodCarry.init(device=self.demod.device)
        self.state = self.ACQUIRE

    # ---- checkpoint/resume: numpy only, loadable on any device ----

    def snapshot(self) -> dict:
        return {
            "carry": self.carry.numpy(),
            "state": self.state,
            "buf": self._buf.to_array(),
            "l1": self._l1,
        }

    def restore(self, snap: dict):
        self.carry = DemodCarry.from_numpy(snap["carry"], self.demod.device)
        self.state = snap["state"]
        self._buf = _StreamBuffer()
        self._buf.set(snap["buf"])
        self._l1 = snap["l1"]

    def process(self, iq: np.ndarray):
        """Consume an arbitrary-size chunk of complex64 IQ; returns the
        soft-bit frames (np.int8 arrays) that locked."""
        with profile_scope("demod/process"):
            return self._process(iq)

    def _process(self, iq: np.ndarray):
        d = self.demod
        p = d.params
        dev = d.device
        self._buf.append(np.asarray(iq, np.complex64))
        frames = []
        ptr = 0
        while True:
            avail = len(self._buf) - ptr
            if self.state == self.ACQUIRE:
                acq_len = d.window_len
                if avail < acq_len:
                    break
                with profile_scope("demod/acquire"):
                    block = d._as_iq(self._buf.view(ptr, ptr + acq_len))
                if self._l1 == 0.0:
                    self._l1 = float(d.l1(block))
                found, end_idx = d.acquire(block, self._l1)
                self._l1 = 0.7 * self._l1 + 0.3 * float(d.l1(block))
                if bool(found):
                    # rewind past the dip-search granularity so the timing
                    # error is positive
                    rewind = 2 * self.demod.cfg.null_search_nb_samples
                    null_start = (ptr + int(end_idx)
                                  - p.nb_null_period - rewind)
                    ptr = max(null_start, ptr)
                    self.state = self.TRACK
                    prev = self.carry
                    # fresh sync state, but cumulative counters survive
                    # re-acquisition
                    self.carry = DemodCarry.init(device=dev)._replace(
                        signal_l1_avg=torch.tensor(self._l1,
                                                   dtype=torch.float32,
                                                   device=dev),
                        total_frames=prev.total_frames,
                        total_desync=prev.total_desync)
                else:
                    ptr += acq_len - p.nb_null_period
            else:
                K = self.frames_per_step
                scan_len = K * d.frame_advance + d.window_len
                if K > 1 and avail >= scan_len:
                    with profile_scope("demod/frame_scan"):
                        raw = self._buf.view(ptr, ptr + scan_len)
                        carry, consumed, outs = d.frame_scan(K, self.carry, raw)
                    with profile_scope("demod/fetch"):
                        valid = outs["valid"].cpu().numpy()
                        bits = outs["bits"].cpu().numpy()
                    self.carry = carry
                    nb_ok = int(valid.sum())
                    for k in range(nb_ok):
                        frames.append(bits[k])
                    self.last_window = raw[:d.window_len].copy()
                    ptr += int(consumed)
                    if nb_ok < K:
                        self.state = self.ACQUIRE
                        ptr += p.nb_null_period
                    continue
                if avail < d.window_len:
                    break
                with profile_scope("demod/frame_step"):
                    raw_window = self._buf.view(ptr, ptr + d.window_len)
                    self.carry, out = d.frame_step(self.carry, raw_window)
                self.last_window = raw_window.copy()
                with profile_scope("demod/fetch"):
                    synced = bool(out["sync_ok"])
                    if synced:
                        frames.append(out["bits"].cpu().numpy())
                        ptr += int(out["offset"]) + d.frame_advance
                if not synced:
                    # desync: re-acquire, advancing past the failed region
                    self.state = self.ACQUIRE
                    ptr += p.nb_null_period
        self._buf.consume(ptr)
        return frames
