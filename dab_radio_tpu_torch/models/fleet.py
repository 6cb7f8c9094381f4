"""Fleet orchestration: many ensembles decoded with cross-ensemble batching
(port of ``dab_radio_tpu/models/fleet.py``).

A naive fleet runs one DabReceiver per ensemble and pays one FIC decode plus
one MSC decode per protection shape per frame and ensemble. This
orchestrator flips that:

  * FIC: every receiver's CIF groups stack into ONE Viterbi batch per round
    (N ensembles x 4 groups lanes, one K1 launch).
  * MSC: all active subchannels across ALL ensembles group by protection
    shape (dab.msc.group_key) and decode in one launch per shape.

Both decodes are programs (captured CUDA graphs on a CUDA device,
``utils/graphs.py``): the stacked FIC decode one for each number of
groups, and each protection shape's persistent ``MSCDecodeGroup``, which
holds its members' deinterleaver histories from round to round. Host
byte-level work (FIG parse, superframe/PAD/MOT, database) stays
per-receiver and untouched, so fleet decode is bit-identical to running the
receivers standalone. This is the dynamic path: channels appear as the FIC
names them. Once the layout is known, ``FusedFleet`` is the faster static
one.
"""

import pickle
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..params import get_dab_params
from ..dab.fic import _fic_decode_fn, fic_program
from ..dab.msc import (MSCDecodeGroup, finalize_frame_group, group_key,
                       persistent_group)
from ..utils.backend import to_device
from ..utils.profiler import profile_scope
from .fused_fleet import _Fetch
from .receiver import DabReceiver


class ReceiverFleet:
    """N independent ensembles, one device-batched decode path, on `device`
    (no default: the caller says where the fleet runs).

    pipeline_depth > 0 defers the host's use of each round's decoded bits by
    that many rounds: on a CUDA device the bits go to pinned host memory
    behind an event, without blocking, so the decodes of round t are queued
    while the copy of round t - depth lands and its byte layer runs. Side
    effect: FIG ingest, and therefore channel discovery, lags `depth`
    frames, which only delays a new channel's first decoded frame.

    cuda_graph (``utils/graphs.py``) applies to the fleet's decodes and its
    receivers'."""

    def __init__(self, nb_receivers: int, transmission_mode: int = 1,
                 benchmark_all: bool = False, pipeline_depth: int = 0, *,
                 device, cuda_graph=None):
        self.device = torch.device(device)
        self.cuda_graph = cuda_graph
        self.dab = get_dab_params(transmission_mode)
        self.receivers: List[DabReceiver] = [
            DabReceiver(transmission_mode, benchmark_all=benchmark_all,
                        device=self.device, cuda_graph=cuda_graph)
            for _ in range(nb_receivers)]
        self.spec = _fic_decode_fn()[0]
        self._fic_decode = fic_program(self.device, cuda_graph)
        self.total_frames = 0
        self.pipeline_depth = pipeline_depth
        self._pending = deque()
        # persistent decode groups with their stacked history on the device,
        # rebuilt only when the channel membership of a protection shape
        # changes
        self._groups: Dict[object, MSCDecodeGroup] = {}

    # ---- one round's device half ----

    def _split(self, frame):
        """One frame's soft bits, a numpy array or a row of a device tensor
        (MultiStreamDemodulator with fetch_bits=False), as tensors on the
        fleet's device: (fic groups (G, nb_in), cifs (nb_cifs, nb_cif_bits)).
        A device row is sliced where it lies, so demodulator output chains
        into the decode without the 230k soft bits a frame going to the host
        and back."""
        bits = to_device(frame, self.device, np.int8).reshape(-1)
        fic = bits[: self.dab.nb_fic_bits]
        cifs = bits[self.dab.nb_fic_bits:].reshape(
            self.dab.nb_cifs, self.dab.nb_cif_bits)
        return fic, cifs

    def _split_all(self, frames):
        idxs = [i for i, _ in frames]
        if len(set(idxs)) != len(idxs):
            raise ValueError("one frame per receiver per round")
        fics, all_cifs = [], {}
        for i, frame in frames:
            fic, cifs = self._split(frame)
            fics.append(fic.reshape(self.receivers[i].fic.nb_groups, -1))
            all_cifs[i] = cifs
        return fics, all_cifs

    def _msc_jobs(self, frames, all_cifs) -> Dict[object, list]:
        """protection shape -> [(channel, its ensemble's CIFs)], from the
        channel sets as they stand."""
        jobs: Dict[object, list] = {}
        for i, _ in frames:
            for ch in list(self.receivers[i].channels.values()):
                jobs.setdefault(group_key(ch.msc.cfg), []).append(
                    (ch, all_cifs[i]))
        return jobs

    def _dispatch_msc(self, key, chans):
        """The persistent group of the (channel, CIFs) pairs of one
        protection shape, dispatched: its handle."""
        group = persistent_group(self._groups, key,
                                 [ch.msc for ch, _ in chans],
                                 self.cuda_graph)
        return group.dispatch([c for _, c in chans])

    def _dispatch(self, frames):
        fics, all_cifs = self._split_all(frames)
        groups_per_rx = [f.shape[0] for f in fics]
        with profile_scope("fleet/fic_dispatch"):
            fic_bits, _err = self._fic_decode(torch.cat(fics, dim=0))

        # MSC jobs use the channel set as of the last finalized round
        handles = []
        with profile_scope("fleet/msc_dispatch"):
            for key, chans in self._msc_jobs(frames, all_cifs).items():
                handles.append(([ch for ch, _ in chans],
                                self._dispatch_msc(key, chans)))

        # every decoded tensor of the round on its way to the host at once
        fetch = self._fetch([fic_bits] + [h[1] for _, h in handles])
        self._pending.append((list(frames), groups_per_rx, fetch, handles))

    def _fetch(self, tensors) -> _Fetch:
        pinned = None
        if self.device.type == "cuda":
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in tensors]
        return _Fetch(tensors, pinned)

    def _finalize_one(self):
        frames, groups_per_rx, fetch, handles = self._pending.popleft()
        with profile_scope("fleet/fic_finalize"):
            fic_bits, *msc_bits = fetch.arrays()       # waits for the copies
            bits = fic_bits.astype(np.uint8)
        ofs = 0
        for (i, _), g in zip(frames, groups_per_rx):
            rx = self.receivers[i]
            fibs, _ = rx.fic.postprocess(bits[ofs:ofs + g])
            ofs += g
            rx.ingest_fibs(fibs)
        with profile_scope("fleet/msc_finalize"):
            for (chans, h), host_bits in zip(handles, msc_bits):
                decoders, _, pushed0, nb_cifs = h
                h = (decoders, torch.from_numpy(host_bits), pushed0, nb_cifs)
                for ch, payloads in zip(chans, finalize_frame_group(h)):
                    for p in payloads:
                        if p is not None:
                            ch._handle_payload(p)
        for i, _ in frames:
            self.receivers[i].total_frames += 1
        self.total_frames += len(frames)

    def process_frames(self, frames: Sequence[Tuple[int, np.ndarray]]):
        """One round: frames is a sequence of (receiver_index, frame_soft_bits)
        - typically the per-stream output of MultiStreamDemodulator.step().
        At most one frame per receiver per round.

        Synchronous mode (depth 0) ingests each frame's FIC before
        collecting its MSC jobs, so a channel completed by this frame's FIGs
        decodes this same frame: identical to DabReceiver.process_frame."""
        if not frames:
            while len(self._pending) > self.pipeline_depth:
                self._finalize_one()
            return
        if self.pipeline_depth == 0:
            fics, all_cifs = self._split_all(frames)
            with profile_scope("fleet/fic_decode"):
                fic_bits, _err = self._fic_decode(torch.cat(fics, dim=0))
                bits = fic_bits.cpu().numpy().astype(np.uint8)
            ofs = 0
            for (i, _), f in zip(frames, fics):
                rx = self.receivers[i]
                fibs, _ = rx.fic.postprocess(bits[ofs:ofs + f.shape[0]])
                ofs += f.shape[0]
                rx.ingest_fibs(fibs)
            with profile_scope("fleet/msc_decode"):
                for key, chans in self._msc_jobs(frames, all_cifs).items():
                    h = self._dispatch_msc(key, chans)
                    for (ch, _), payloads in zip(chans,
                                                 finalize_frame_group(h)):
                        for p in payloads:
                            if p is not None:
                                ch._handle_payload(p)
            for i, _ in frames:
                self.receivers[i].total_frames += 1
            self.total_frames += len(frames)
            return

        self._dispatch(frames)
        while len(self._pending) > self.pipeline_depth:
            self._finalize_one()

    def flush(self):
        """Finalize every in-flight round (call when the streams end)."""
        while self._pending:
            self._finalize_one()
        for g in self._groups.values():
            g.sync_back()

    # ---- checkpoint/resume ----

    def snapshot(self) -> bytes:
        """Serialize every receiver's decode state (in-flight rounds are
        finalized first), as numpy and plain objects: no device tensor.
        Observers/codecs re-attach after restore."""
        self.flush()
        return pickle.dumps({
            "mode": self.dab.mode,
            "receivers": self.receivers,
            "total_frames": self.total_frames,
            "pipeline_depth": self.pipeline_depth,
        })

    @classmethod
    def from_snapshot(cls, blob: bytes, device) -> "ReceiverFleet":
        """Rebuild a fleet from snapshot() on `device`. The receivers load
        on the device their states name and move from there."""
        d = pickle.loads(blob)
        fleet = cls(0, d["mode"], pipeline_depth=d["pipeline_depth"],
                    device=device)
        fleet.receivers = d["receivers"]
        for rx in fleet.receivers:
            rx.to(fleet.device)
        fleet.total_frames = d["total_frames"]
        return fleet

    def summary(self) -> dict:
        return {
            "receivers": len(self.receivers),
            "frames": self.total_frames,
            "ensembles_discovered": sum(
                1 for r in self.receivers if r.db.services),
            "channels": sum(len(r.channels) for r in self.receivers),
        }
