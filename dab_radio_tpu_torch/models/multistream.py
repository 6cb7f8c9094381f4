"""Batched multi-ensemble streaming demodulation (port of
``dab_radio_tpu/models/multistream.py``).

Many independent 2.048 MSPS IQ streams demodulated at once on one device.
Each stream keeps its own host read pointer and sync state, but every
tracking round batches all locked streams' windows into ONE batched frame
step (or K-frame scan) on the device, with the u8 dequantise before it and
the merge of the carry under the ready mask after it: one program (a
captured CUDA graph on a CUDA device, ``utils/graphs.py``) that holds the
carry, as the JAX class jits ``_masked``. Streams acquire independently
(acquisition is rare); tracking dominates and is fully batched. A stream
that loses lock falls back to acquisition without stalling the batch.
"""

from typing import List

import numpy as np
import torch

from .demodulator import OFDMDemodulator, DemodCarry, _select
from ..parallel.mesh import _u8_to_complex, shard_demod_batch
from ..utils.backend import to_device
from ..utils.graphs import CapturedProgram


class MultiStreamDemodulator:
    """B concurrent streams over one OFDMDemodulator, on `device` (which
    must be the demodulator's; there is no default: the caller says where
    the batch runs).

    ingest="u8" keeps the raw RTL-SDR byte stream end to end: host buffers
    hold interleaved uint8 IQ, and the dequantisation ((x - 127.5) times the
    float32 reciprocal of 127.5, as the fused round forms it) happens on the
    device inside the round: a quarter of the host-to-device bytes of
    complex64. Acquisition dequantises its one window on the host, by a
    divide, as the JAX class does.

    fetch_bits=False keeps each round's soft bits on the device (the frames
    returned are rows of the batched output); pair it with ReceiverFleet,
    whose decode takes them there, so that only decoded bytes reach the
    host.

    mesh= (a ``parallel.mesh.ReceiverMesh``, one process a rank) splits the
    nb_streams rows over the mesh's 'ens' axis, as the JAX class's
    ``sharding=`` splits the windows' rows over devices: this rank holds and
    steps the streams ``rows = (lo, hi)`` of its ens coordinate
    (``parallel/mesh.py:shard_demod_batch``), takes pushes for them only and
    returns their frames under their global stream numbers. Every stream's
    demodulation is its own, so no collective runs; feed the frames to a
    ReceiverFleet of hi - lo receivers on the same rank. A mesh whose 'time'
    or 'sub' axis is above 1 is refused.

    cuda_graph (``utils/graphs.py``): None runs the round as a captured
    CUDA graph on a CUDA device (on a mesh too: no collective runs) and
    eagerly on the CPU, True asks for the capture, False is the eager
    path. Frames handed out are the caller's own either way."""

    def __init__(self, demod: OFDMDemodulator, nb_streams: int,
                 frames_per_step: int = 1, ingest: str = "c64",
                 fetch_bits: bool = True, *, device, mesh=None,
                 cuda_graph=None):
        if ingest not in ("c64", "u8"):
            raise ValueError(f"ingest must be 'c64' or 'u8', got {ingest!r}")
        self.device = torch.device(device)
        if self.device != demod.device:
            raise ValueError(f"the demodulator lies on {demod.device}, the "
                             f"batch was asked for on {self.device}")
        self.fetch_bits = fetch_bits
        self.demod = demod
        self.nb_streams = nb_streams
        self.rows = (0, nb_streams)
        if mesh is not None:
            for axis in ("time", "sub"):
                if mesh.shape[axis] > 1:
                    raise ValueError(
                        "MultiStreamDemodulator splits only the batch's rows: "
                        f"the mesh's {axis!r} axis has {mesh.shape[axis]} "
                        "ranks, it must have 1")
            _, self.rows = shard_demod_batch(demod, mesh, nb_streams)
        self.B = self.rows[1] - self.rows[0]        # the streams held here
        self.ingest = ingest
        empty = (np.zeros(0, np.complex64) if ingest == "c64"
                 else np.zeros(0, np.uint8))
        self.bufs: List[np.ndarray] = [empty.copy() for _ in range(self.B)]
        self.tracking = np.zeros(self.B, dtype=bool)
        self.l1 = np.zeros(self.B, dtype=np.float32)
        # the round, its carry held by the program
        self.program = CapturedProgram(
            self._masked, self.device,
            state=DemodCarry.init((self.B,), device=self.device),
            cuda_graph=cuda_graph)
        self.frames_emitted = 0
        # K-frame rounds: B streams x K tracking steps per host read
        self.frames_per_step = max(1, frames_per_step)

    def load_state(self, state: dict):
        """Take over the streaming state of another instance (see
        ``convert.multistream_state_from_jax``): carry leaves (B,), unread
        samples, lock flags, acquisition levels, frame count. On a mesh the
        state may be the whole batch's (nb_streams rows, as one process
        holds it): this rank takes its rows of it; the frame count stays
        the whole batch's."""
        n = len(state["bufs"])
        rows = slice(*self.rows) if n == self.nb_streams else slice(None)
        if n not in (self.B, self.nb_streams) or \
                state["ingest"] != self.ingest:
            raise ValueError("the state is of another batch: "
                             f"{n} streams of {state['ingest']}, this one "
                             f"has {self.B} of {self.ingest}")
        self.carry = DemodCarry.from_numpy(
            [np.asarray(x)[rows] for x in state["carry"]], self.device)
        self.bufs = [np.array(b) for b in state["bufs"][rows]]
        self.tracking = np.array(state["tracking"][rows], dtype=bool)
        self.l1 = np.array(state["l1"][rows], dtype=np.float32)
        self.frames_emitted = int(state["frames_emitted"])

    @property
    def carry(self) -> DemodCarry:
        """A copy of the batch's carry (fields (B,)), on the device."""
        return self.program.read_state()

    @carry.setter
    def carry(self, carry: DemodCarry):
        self.program.load_state(carry)

    # ---- the batched device round: demod and ready-mask carry merge ----

    def _masked(self, carry, raw, mask, nb_frames: int):
        """The program's function: the (B, n) block of raw samples (u8
        bytes or complex64) dequantised, one frame step (nb_frames 1) or
        scan of every row, and the carry of the rows that mask leaves out
        kept as it was -> (carry, (consumed, valid (B, K), bits (B, K,
        nb_bits))) for a scan, (carry, {bits, sync_ok, offset}) for a
        step."""
        raw = to_device(raw, self.device)
        iq = _u8_to_complex(raw) if self.ingest == "u8" else raw
        mask = to_device(mask, self.device)
        if nb_frames == 1:
            new_c, out = self.demod._frame_step_impl(carry, iq)
            return _select(mask, new_c, carry), out
        new_c, consumed, outs = self.demod._frame_scan_impl(nb_frames, carry,
                                                            iq)
        return _select(mask, new_c, carry), (
            consumed, outs["valid"] & mask[:, None], outs["bits"])

    # ---- ingest-format helpers (sample units; u8 stores 2 bytes/sample) --

    def _n_samples(self, i: int) -> int:
        n = self.bufs[i].shape[0]
        return n // 2 if self.ingest == "u8" else n

    def _slice_raw(self, i: int, nb_samples: int) -> np.ndarray:
        if self.ingest == "u8":
            return self.bufs[i][:2 * nb_samples]
        return self.bufs[i][:nb_samples]

    def _slice_c64(self, i: int, nb_samples: int) -> np.ndarray:
        raw = self._slice_raw(i, nb_samples)
        if self.ingest == "u8":
            x = (raw.astype(np.float32) - 127.5) / np.float32(127.5)
            return x[:x.size // 2 * 2].view(np.complex64)
        return raw

    def _advance(self, i: int, nb_samples: int):
        k = 2 * nb_samples if self.ingest == "u8" else nb_samples
        self.bufs[i] = self.bufs[i][k:]

    def push(self, stream_idx: int, iq: np.ndarray):
        """c64 mode: complex64 samples. u8 mode: raw interleaved uint8 IQ
        bytes (2 per sample)."""
        if self.ingest == "u8":
            arr = np.frombuffer(iq, np.uint8) if isinstance(iq, bytes) \
                else np.asarray(iq, np.uint8)
        else:
            arr = np.asarray(iq, np.complex64)
        lo, hi = self.rows
        if not lo <= stream_idx < hi:
            raise ValueError(f"stream {stream_idx} is not held here: this "
                             f"rank holds the streams [{lo}, {hi})")
        i = stream_idx - lo
        self.bufs[i] = np.concatenate([self.bufs[i], arr])

    def _acquire_stream(self, i: int) -> bool:
        d = self.demod
        while self._n_samples(i) >= d.window_len:
            block = d._as_iq(self._slice_c64(i, d.window_len))
            if self.l1[i] == 0.0:
                self.l1[i] = float(d.l1(block))
            found, end_idx = d.acquire(block, self.l1[i])
            self.l1[i] = 0.7 * self.l1[i] + 0.3 * float(d.l1(block))
            if bool(found):
                rewind = 2 * d.cfg.null_search_nb_samples
                start = max(int(end_idx) - d.params.nb_null_period - rewind, 0)
                self._advance(i, start)
                return True
            self._advance(i, d.window_len - d.params.nb_null_period)
        return False

    def _restart_carry(self, i: int):
        """Fresh sync state for stream i at its acquisition level; the
        cumulative counters survive re-acquisition."""
        c = self.carry
        fresh = [x.clone() for x in c]
        for x in fresh:
            x[i] = 0
        fresh = DemodCarry(*fresh)
        fresh.signal_l1_avg[i] = float(self.l1[i])
        self.carry = fresh._replace(total_frames=c.total_frames,
                                    total_desync=c.total_desync)

    def _ready_block(self, nb_samples: int):
        """The streams that track and hold nb_samples, their samples as one
        (B, n) host block (idle rows: mid-scale bytes / zeros) and the
        mask, both numpy."""
        ready = [i for i in range(self.B)
                 if self.tracking[i] and self._n_samples(i) >= nb_samples]
        if not ready:
            return ready, None, None
        if self.ingest == "u8":
            block = np.full((self.B, 2 * nb_samples), 127, np.uint8)
        else:
            block = np.zeros((self.B, nb_samples), np.complex64)
        for i in ready:
            block[i] = self._slice_raw(i, nb_samples)
        mask = np.zeros(self.B, dtype=bool)
        mask[ready] = True
        return ready, block, mask

    def _bits(self, bits: torch.Tensor):
        """The round's bits as handed out: on the host, or (fetch_bits off)
        on the device, copied out of a captured program's buffers so that
        they outlive its next call."""
        if self.fetch_bits:
            return bits.cpu().numpy()
        return bits.clone() if self.program.captured else bits

    def step(self):
        """One round: acquire unlocked streams, batch-demod locked ones.
        Returns list of (stream_idx, bits) for frames produced, by global
        stream number; bits is a numpy array, or with fetch_bits=False a row
        of a device tensor."""
        d = self.demod
        lo = self.rows[0]
        for i in range(self.B):
            if not self.tracking[i] and self._acquire_stream(i):
                self.tracking[i] = True
                self._restart_carry(i)

        K = self.frames_per_step
        if K > 1:
            scan_len = K * d.frame_advance + d.window_len
            ready, block, mask = self._ready_block(scan_len)
            if not ready:
                return []
            consumed, valid, bits = self.program(block, mask, K)
            # one fetch of the round's control outputs; the frame bits stay
            # on the device when fetch_bits is off
            consumed, valid = consumed.cpu().numpy(), valid.cpu().numpy()
            bits_h = self._bits(bits)
            results = []
            for k in range(K):
                for i in ready:
                    if valid[i, k]:
                        results.append((lo + i, bits_h[i, k]))
            for i in ready:
                nb_ok = int(valid[i].sum())
                self._advance(i, int(consumed[i]))
                if nb_ok < K:
                    self.tracking[i] = False
                    self._advance(i, d.params.nb_null_period)
            self.frames_emitted += len(results)
            return results

        # ready streams contribute real windows; the others get idle rows,
        # and their carry is restored afterwards
        ready, block, mask = self._ready_block(d.window_len)
        if not ready:
            return []
        out = self.program(block, mask, 1)
        sync_ok = out["sync_ok"].cpu().numpy()
        offsets = out["offset"].cpu().numpy()
        bits = self._bits(out["bits"])
        results = []
        for i in ready:
            if sync_ok[i]:
                results.append((lo + i, bits[i]))
                self._advance(i, int(offsets[i]) + d.frame_advance)
            else:
                self.tracking[i] = False
                self._advance(i, d.params.nb_null_period)
        self.frames_emitted += len(results)
        return results

    def run_available(self, max_rounds: int = 1000):
        """Drain all buffered samples; yields (stream_idx, bits)."""
        for _ in range(max_rounds):
            res = self.step()
            if not res:
                break
            yield from res
