"""Fused serving fleet: N ensembles, one device round per call (port of
``dab_radio_tpu/models/fused_fleet.py``).

The static-configuration throughput path for serving once the subchannel
layout is known: demodulation, FIC Viterbi, time deinterleave and MSC
Viterbi for every stream run as one round of frames_per_step frames on the
fleet's device (``parallel/mesh.py:receiver_step``, mixed UEP/EEP shapes
included, one Viterbi launch a round). The decoded bits are packed to bytes
on the device, and the host touches only the FIG and superframe byte layer.
On a CUDA device the round and the packing run as one captured CUDA graph
(``utils/graphs.py``, the counterpart of the JAX fleet's jitted step and
``_pack``), which holds the round's state (the demod carry and the
deinterleaver history) in buffers of its own.

Feed rounds with ``process_round(iq)`` where iq is (N, 2 * K *
frame_samples) raw interleaved uint8 IQ: a numpy array, or a tensor that
already lies on the device (the feeder's staging). FIBs flow into each
stream's DabReceiver (database, labels); superframe AUs fire
``on_access_unit(stream, subchannel, au_index, n_aus, au, header)``.

Long-running serving contract: watch ``drift_correction`` and advance the
read grid by it (sample-clock drift re-anchor), watch ``last_fib_ok`` for
sustained zeros and then ``resync()`` + ``find_alignment`` (hard desync
recovery), and ``snapshot()`` / ``from_snapshot()`` to checkpoint or
migrate. ``apps/fleet_serve.py`` implements all three loops.

With ``mesh=`` (a ``parallel.mesh.ReceiverMesh``, one process a rank) the
round is ``multichip_receiver_step``: each rank serves the streams of its
'ens' coordinate (``rows``), demodulates its frame block of the round
('time': a round is time * frames_per_step frames) and decodes its
subchannels ('sub'). The packed subchannel bytes of the 'sub' ranks are
gathered to the ens group's leader (time 0, sub 0), which alone runs the
byte layer of its streams: its receivers, observers and ``summary()`` are
those of its streams, and observers get global stream numbers. The health
signals are every rank's: each holds its group's FIBs (it decodes the FIC)
and the offsets of all its frames (gathered over 'time'), so
``drift_correction``, ``last_fib_ok`` and ``materialized_rounds`` read the
same on every rank of a group, and a serving loop on any rank may move its
read grid by them. Every rank calls ``process_round`` each round with the
whole round of all N streams. The round is captured there too, its
collectives inside the graph, when they run over NCCL; over gloo it stays
eager (``parallel/mesh.py:mesh_cuda_graph``).
"""

from typing import Callable, List, Optional

import numpy as np
import torch

from ..dab.aac import SuperframeProcessor
from ..ops.crc import crc16_check_batch
from ..ops.rs import dab_plus_rs, syndrome_constants
from ..params import SubchannelConfig, get_dab_params, get_ofdm_params
from ..utils.backend import to_device
from ..utils.graphs import CapturedProgram
from ..utils.profiler import profile_scope
from .demodulator import DemodCarry, OFDMDemodulator
from .receiver import DabReceiver


# Classic DAB's byte layer, counted always: "frames" (the logical frames of
# the "mp2" subchannels handed out as MP2 frames), their "bytes", and
# "synced", the frames whose first two bytes carry the MPEG audio sync and
# MPEG-1 Layer II (0xFF, then b & 0xFE == 0xFC: either protection bit)
MP2_STATS = {"frames": 0, "bytes": 0, "synced": 0}


def count_mp2_frames(heads: np.ndarray, nbytes: int):
    """Add a round's MP2 frames to MP2_STATS: heads (..., 2) uint8, the
    first two bytes of each frame, and nbytes, the bytes of all of them."""
    synced = int(np.count_nonzero((heads[..., 0] == 0xFF)
                                  & ((heads[..., 1] & 0xFE) == 0xFC)))
    MP2_STATS["frames"] += heads.size // 2
    MP2_STATS["bytes"] += nbytes
    MP2_STATS["synced"] += synced


def _cfg_from_db(sub) -> SubchannelConfig:
    """Database Subchannel entity -> static decode config."""
    return SubchannelConfig(
        start_address=sub.start_address, length=sub.length,
        is_uep=sub.is_uep, uep_table_index=sub.uep_table_index or 0,
        eep_type=sub.eep_type or "A",
        eep_prot_level=sub.eep_prot_level or 0)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) 0/1 values -> (..., n) uint8, MSB first, on bits' device.
    The weights 128 .. 1 are made on the device: a captured graph copies
    nothing from the host."""
    w = 128 >> torch.arange(8, dtype=torch.int32, device=bits.device)
    b = bits.to(torch.int32).reshape(*bits.shape[:-1], -1, 8)
    return (b * w).sum(-1).to(torch.uint8)


class _Fetch:
    """One round's packed outputs on their way to the host.

    On a CUDA device the copies go to pinned host tensors without blocking
    and an event marks their end: ``arrays()`` waits for that event alone,
    so the caller can do host work while the round is still on the card.
    The copies are queued right after the round on its stream, so they read
    the captured round's output buffers before the next round overwrites
    them. The pinned tensors belong to the fleet and are reused every other
    round. On the CPU the tensors are handed over as they are."""

    def __init__(self, packed, pinned):
        self.event = None
        if pinned is None:
            self.host = packed
            return
        self.host = pinned
        for dst, src in zip(pinned, packed):
            dst.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def arrays(self):
        with profile_scope("fleet/fetch_wait"):
            if self.event is not None:
                self.event.synchronize()
            return [t.numpy() for t in self.host]


class FusedFleet:
    def __init__(self, nb_streams: int,
                 subchannel_cfgs: List[SubchannelConfig],
                 transmission_mode: int = 1, frames_per_step: int = 8, *,
                 device, block_tracking: bool = False,
                 subchannel_kinds=None, viterbi: str = "exact",
                 chainback: str = "sequential",
                 viterbi_branch: str = "matmul", fuse_fic: bool = True,
                 consume_workers: int = 0, mesh=None, cuda_graph=None):
        """consume_workers is kept for the benchmark's configs, which pass
        it, and goes when they drop the key: 0 and 1 both mean the calling
        thread, which runs the byte layer; any other value is refused."""
        if consume_workers not in (0, 1):
            raise ValueError(
                f"consume_workers={consume_workers}: the byte layer runs on "
                "the calling thread; pass 0 or 1")
        from ..parallel.mesh import (mesh_cuda_graph,
                                     multichip_receiver_step, receiver_step,
                                     track_collectives)
        self.nb_streams = nb_streams
        self.mesh = mesh
        self.device = torch.device(device)
        self._cfgs_arg = subchannel_cfgs
        self._block_tracking = block_tracking
        self._viterbi = viterbi
        self._chainback = chainback
        self._viterbi_branch = viterbi_branch
        # serving default ON: the FIC lanes ride the MSC Viterbi decode, one
        # launch a round instead of two (parallel/mesh.py, fuse_fic)
        self._fuse_fic = fuse_fic
        # per-stream heterogeneity: pass a list of per-stream cfg rows and
        # each stream decodes its OWN ensemble layout in the same round
        per_stream = bool(subchannel_cfgs) and \
            isinstance(subchannel_cfgs[0], (list, tuple))
        self.S = len(subchannel_cfgs[0]) if per_stream \
            else len(subchannel_cfgs)
        self.K = frames_per_step
        self._mode = transmission_mode
        self.dab = get_dab_params(transmission_mode)
        self.fs = get_ofdm_params(transmission_mode).nb_frame_samples
        args = dict(frames_per_shard=frames_per_step, ingest="u8",
                    subchannel_cfgs=subchannel_cfgs,
                    block_tracking=block_tracking, viterbi=viterbi,
                    chainback=chainback, viterbi_branch=viterbi_branch,
                    fuse_fic=fuse_fic, cuda_graph=False)
        if mesh is None:
            self.frames_per_round = frames_per_step
            self.step, state = receiver_step(
                self.device, transmission_mode, subchannels_per_shard=self.S,
                ensembles_per_shard=nb_streams, **args)
        else:
            if nb_streams % mesh.shape["ens"] or self.S % mesh.shape["sub"]:
                raise ValueError(
                    f"{nb_streams} streams and {self.S} subchannels do not "
                    f"split over the mesh {mesh.shape}")
            # each round takes frames_per_step frames a time shard
            self.frames_per_round = mesh.shape["time"] * frames_per_step
            self.step, state = multichip_receiver_step(
                mesh, transmission_mode,
                subchannels_per_shard=self.S // mesh.shape["sub"],
                ensembles_per_shard=nb_streams // mesh.shape["ens"],
                device=self.device, **args)
        # self.step is the plain round; the program runs it with the bit
        # packing and holds its state (carry, history)
        self._init_state = state[:2]
        self.program = track_collectives(CapturedProgram(
            self._round, self.device, state=self._init_state,
            cuda_graph=mesh_cuda_graph(mesh, cuda_graph)), mesh)
        # the global stream rows this fleet serves: all of them, or on a
        # mesh those of this rank's ens coordinate
        self.rows = (0, nb_streams) if mesh is None else self.step.rows
        self.N = self.rows[1] - self.rows[0]
        # per-(stream, sub) byte-layer kind: "audio" (DAB+ superframes),
        # "mp2" (classic DAB: each logical frame IS one MP2 frame, fired
        # via on_mp2_frame + optional PCM decode), or ("packet",
        # packet_address, fec_scheme) for packet-mode data subchannels.
        # `subchannel_kinds` mirrors subchannel_cfgs' shape (flat list
        # shared by all streams, or per-stream rows); None entries default
        # to "audio".
        def kind_row(row):
            row = list(row) if row is not None else []
            row += [None] * (self.S - len(row))
            return ["audio" if k is None else k for k in row]
        if subchannel_kinds is None:
            self._kinds = [kind_row(None)] * self.N
        elif subchannel_kinds and \
                isinstance(subchannel_kinds[0], (list, tuple)) and not (
                    len(subchannel_kinds[0]) and
                    subchannel_kinds[0][0] == "packet"):
            self._kinds = [kind_row(r) for r in
                           subchannel_kinds[self.rows[0]:self.rows[1]]]
        else:
            self._kinds = [kind_row(subchannel_kinds)] * self.N
        self.receivers = [DabReceiver(transmission_mode, device=self.device)
                          for _ in range(self.N)]
        self.on_access_unit: List[Callable] = []
        self.on_audio_data: List[Callable] = []   # (stream, sub, pcm, rate, nch)
        self.on_data_group: List[Callable] = []   # (stream, sub, DataGroupResult)
        self.on_mp2_frame: List[Callable] = []    # (stream, sub, frame bytes)
        self._audio_enabled = set()               # (stream, sub) pairs
        self._decoders = {}                       # (stream, sub) -> decoder
        self._sfp = self._make_procs()
        self.total_rounds = 0
        self.total_aus = 0
        self.total_data_groups = 0
        self.total_mp2_frames = 0

        nbl = self.step.msc_nb_data_bits
        self._nbytes = [[n // 8 for n in
                         (nbl[b] if self.step.per_stream else nbl)]
                        for b in range(*self.rows)]
        self._pending: Optional[_Fetch] = None
        self._pinned = [None, None]    # the fetches' host tensors, in turns
        self.last_frame_offsets = np.zeros(self.N, np.int64)
        self.last_fib_ok = np.zeros(self.N, np.int64)
        self.materialized_rounds = 0   # rounds whose results reached host
        # the byte layer's RS syndromes run on the device (_consume_batched):
        # their constants go there now, in set-up
        rs = dab_plus_rs()
        syndrome_constants(rs.nroots, rs.pad, self.device)

    def _make_procs(self):
        """Fresh per-(stream, sub) byte-layer processors: superframe
        decoders for audio subchannels, packet processors (with RS FEC
        when the FIG 0/14 scheme says so) for packet-mode data."""
        from ..dab.packets import PacketProcessor
        procs = []
        for b in range(self.N):
            row = []
            for s in range(self.S):
                k = self._kinds[b][s]
                if k == "audio":
                    row.append(SuperframeProcessor())
                elif k == "mp2":
                    row.append(None)          # frames fire directly
                else:
                    _, addr, fec = k
                    # data groups reach observers via _packet_events'
                    # collector + _fire; the proc's own list stays free
                    # for direct subscribers
                    row.append(PacketProcessor(addr or 0,
                                               use_fec=(fec == 1)))
            procs.append(row)
        return procs

    # ---- the device state, as numpy ----

    def state(self):
        """(carry leaves, deinterleaver history) as numpy arrays: the six
        DemodCarry fields of shape (N, 1) and the (N, S, 16, nb_sub_bits)
        int8 history."""
        carry, hist = self.program.read_state()
        return carry.numpy(), hist.cpu().numpy()

    @property
    def carry(self) -> DemodCarry:
        """A copy of the demod carry, on the fleet's device."""
        return self.program.read_state()[0]

    def load_state(self, carry, hist):
        """Inverse of state(); raises if the shapes are not this fleet's."""
        ref = [tuple(x.shape) for x in (*self._init_state[0],
                                        self._init_state[1])]
        got = [np.asarray(x).shape for x in (*carry, hist)]
        if ref != got:
            raise ValueError(
                "the state does not fit this fleet's round (streams, "
                f"subchannel width or time axis differ): {ref} vs {got}")
        self.program.load_state((
            DemodCarry.from_numpy(carry, self.device),
            to_device(np.asarray(hist, np.int8), self.device)))

    # ---- checkpoint/resume ----

    def snapshot(self) -> bytes:
        """Serialize the full serving-fleet decode state: the device
        carry and deinterleaver history (as numpy), every stream's
        receiver database, the byte-layer superframe/packet sync state,
        and the counters. A deferred round is consumed first. The device,
        observers (on_access_unit etc.) and codec handles are NOT
        captured: from_snapshot takes the target device, and sinks and
        audio re-attach after.

        On a mesh every rank calls it, and rank 0 gets the snapshot of the
        whole fleet (None on the others): the device state in the layout
        of the whole mesh, carry fields (N, n_time) and history (N, S, 16,
        nb_sub_bits), and the byte layer of every ens group's leader."""
        import pickle
        self.flush()
        carry, hist = self.state()
        # processor callback lists (the packet relays are closures) are
        # excluded by PacketProcessor/MOTProcessor.__getstate__
        blob = {
            "mode": self._mode, "N": self.nb_streams, "K": self.K,
            "cfgs": self._cfgs_arg, "kinds": self._kinds,
            "block_tracking": self._block_tracking,
            "viterbi": self._viterbi,
            "chainback": self._chainback,
            "viterbi_branch": self._viterbi_branch,
            "fuse_fic": self._fuse_fic,
            "carry": carry, "hist": hist,
            "receivers": self.receivers, "sfp": self._sfp,
            "counters": (self.total_rounds, self.total_aus,
                         self.total_data_groups, self.total_mp2_frames),
            # signal-health state: a resumed serving loop must see the
            # same drift/desync signals an uninterrupted one would
            "health": (self.last_frame_offsets, self.last_fib_ok,
                       self.materialized_rounds),
        }
        if self.mesh is not None:
            blob = self._gather_snapshot(blob)
        return None if blob is None else pickle.dumps(blob)

    def _gather_snapshot(self, mine: dict):
        """A mesh fleet's snapshot dict with the whole fleet's state, on
        rank 0; None on the other ranks."""
        from ..parallel.mesh import _gather_objects, gather_round
        state = gather_round(self.mesh, *self.program.read_state(), {})
        keys = ("kinds", "receivers", "sfp", "counters", "health")
        parts = _gather_objects(self.mesh, {k: mine[k] for k in keys}
                                if self.mesh.is_leader else None, 0)
        if state is None:
            return None
        leaders = [p for p in parts if p is not None]      # in ens order
        counts = np.array([p["counters"] for p in leaders])
        health = [p["health"] for p in leaders]
        return dict(
            mine, carry=list(state[0]), hist=state[1],
            kinds=[row for p in leaders for row in p["kinds"]],
            receivers=[rx for p in leaders for rx in p["receivers"]],
            sfp=[row for p in leaders for row in p["sfp"]],
            counters=(int(counts[0, 0]),
                      *(int(x) for x in counts[:, 1:].sum(axis=0))),
            health=(np.concatenate([h[0] for h in health]),
                    np.concatenate([h[1] for h in health]), health[0][2]))

    @classmethod
    def from_snapshot(cls, blob: bytes, device, mesh=None) -> "FusedFleet":
        """Rebuild a serving fleet from snapshot() on `device` (the device
        is not part of the snapshot), on one device or, with `mesh`, on
        every rank of it. The resumed decode is byte-identical to an
        uninterrupted run. The mesh's 'time' factor must be that of the
        fleet the snapshot was taken from (each time shard keeps its own
        carry); the 'ens' and 'sub' factors may differ. On a mesh the
        counters of access units, data groups and MP2 frames go to rank 0's
        streams, so that the leaders' summaries add up to the snapshot's."""
        import pickle
        d = pickle.loads(blob)
        fleet = cls(d["N"], d["cfgs"], transmission_mode=d["mode"],
                    frames_per_step=d["K"], device=device,
                    block_tracking=d["block_tracking"],
                    subchannel_kinds=d["kinds"], viterbi=d["viterbi"],
                    chainback=d["chainback"],
                    viterbi_branch=d["viterbi_branch"],
                    fuse_fic=d["fuse_fic"], mesh=mesh)
        n_time = 1 if mesh is None else mesh.shape["time"]
        carry0, hist0 = fleet._init_state
        want = [(fleet.nb_streams, n_time)] * len(carry0) + [
            (fleet.nb_streams, fleet.S) + tuple(hist0.shape[2:])]
        got = [np.asarray(x).shape for x in (*d["carry"], d["hist"])]
        if got != want:
            raise ValueError(
                "the snapshot is incompatible with the target mesh: it was "
                "taken with a different 'time' axis size or round shape; "
                f"restore it on a mesh with the same time factor: {want} vs "
                f"{got}")
        (lo, hi), (s0, s1) = fleet.rows, fleet.step.subs
        t = 0 if mesh is None else mesh.coords["time"]
        fleet.load_state([np.asarray(c)[lo:hi, t:t + 1] for c in d["carry"]],
                         np.asarray(d["hist"])[lo:hi, s0:s1])
        fleet.receivers = d["receivers"][lo:hi]
        for rx in fleet.receivers:     # pickled with the device it ran on
            rx.device = fleet.device
        fleet._sfp = d["sfp"][lo:hi]
        for row in fleet._sfp:
            for p in row:
                # observer lists are stripped by __getstate__; restore the
                # empty list the collector in _packet_events appends to
                if p is not None and hasattr(p, "on_data_group"):
                    p.on_data_group = []
        fleet.total_rounds = d["counters"][0]
        if mesh is None or mesh.rank == 0:
            (fleet.total_aus, fleet.total_data_groups,
             fleet.total_mp2_frames) = d["counters"][1:]
        offsets, fib_ok, fleet.materialized_rounds = d["health"]
        fleet.last_frame_offsets = offsets[lo:hi]
        fleet.last_fib_ok = fib_ok[lo:hi]
        return fleet

    def reset(self):
        """Restart decode state: device carry and deinterleaver history AND
        the host byte layer (receiver databases, superframe/packet sync,
        audio decoders, counters), keeping the round's tables and the
        registered callbacks. Used to retune a serving fleet to a new
        capture or frequency."""
        self.program.load_state(self._init_state)
        self.receivers = [DabReceiver(self._mode, device=self.device)
                          for _ in range(self.N)]
        self._sfp = self._make_procs()
        for dec in self._decoders.values():
            dec.close()
        self._decoders = {}
        self._pending = None
        self.last_frame_offsets = np.zeros(self.N, np.int64)
        self.last_fib_ok = np.zeros(self.N, np.int64)
        self.materialized_rounds = 0
        self.total_rounds = 0
        self.total_aus = 0
        self.total_data_groups = 0
        self.total_mp2_frames = 0

    @classmethod
    def from_receiver(cls, receiver, nb_streams: int = None,
                      **kw) -> "FusedFleet":
        """Discovery -> serving handoff: build the static fused round from
        the subchannel layout a (dynamic) DabReceiver discovered via FIC,
        or from a LIST of receivers, one per stream, for per-stream
        ensemble layouts. The deployment flow is: run the dynamic path
        until the database completes, then switch the hot loop to the
        fused round (decode state restarts; databases carry over)."""
        from ..dab.database import AUDIO_DAB, PACKET_DATA, STREAM_AUDIO

        def row(rx):
            return [_cfg_from_db(rx.db.subchannels[k])
                    for k in sorted(rx.db.subchannels)]

        def kinds(rx):
            out = []
            for k in sorted(rx.db.subchannels):
                comp = rx.db.component_by_subchannel(k)
                sub = rx.db.subchannels[k]
                if comp is not None and comp.transport_mode == PACKET_DATA:
                    out.append(("packet", comp.packet_address or 0,
                                sub.fec_scheme or 0))
                elif (comp is not None
                      and comp.transport_mode == STREAM_AUDIO
                      and comp.audio_service_type == AUDIO_DAB):
                    out.append("mp2")
                else:
                    out.append("audio")
            return out
        if isinstance(receiver, (list, tuple)):
            rxs = list(receiver)
            fleet = cls(nb_streams or len(rxs), [row(r) for r in rxs],
                        subchannel_kinds=[kinds(r) for r in rxs], **kw)
            for b, r in enumerate(rxs):
                fleet.receivers[b].updater = r.updater
        else:
            fleet = cls(nb_streams or 1, row(receiver),
                        subchannel_kinds=kinds(receiver), **kw)
            fleet.receivers[0].updater = receiver.updater
        return fleet

    @property
    def round_samples(self) -> int:
        return self.frames_per_round * self.fs

    def find_alignment(self, iq_u8_row) -> Optional[int]:
        """Cold-start alignment: null-dip acquisition + one probe frame
        over one stream's raw u8 IQ. Returns the BYTE offset of the first
        whole frame (slice the stream there and feed frame-aligned rounds
        to process_round; the fused round tracks drift once locked but
        its rounds must start on a frame boundary), or None if no frame
        sync was found in the block."""
        if not hasattr(self, "_align_demod"):
            self._align_demod = OFDMDemodulator(self._mode,
                                                device=self.device)
        d = self._align_demod
        p = d.params
        u = np.asarray(iq_u8_row, np.uint8).astype(np.float32)
        c64 = (((u[0::2] - 127.5) + 1j * (u[1::2] - 127.5)) / 127.5
               ).astype(np.complex64)
        if c64.shape[0] < d.window_len:
            return None
        x = to_device(c64, self.device)
        l1 = d.l1(x[:d.window_len])
        rewind = 2 * d.cfg.null_search_nb_samples
        ptr = 0
        while ptr + d.window_len <= c64.shape[0]:
            found, end = d.acquire(x[ptr:ptr + d.window_len], l1)
            if bool(found):
                null_start = max(
                    ptr + int(end) - p.nb_null_period - rewind, ptr)
                if null_start + d.window_len > c64.shape[0]:
                    return None
                carry = DemodCarry.init(device=self.device)._replace(
                    signal_l1_avg=l1)
                _, out = d.frame_step(
                    carry, x[null_start:null_start + d.window_len])
                if not bool(out["sync_ok"]):
                    return None
                return 2 * (null_start + int(out["offset"]))
            ptr += d.window_len - p.nb_null_period
        return None

    @property
    def tail_bytes(self) -> int:
        """u8 bytes of the NEXT round's head to pass as process_round's
        tail (2 bytes per sample; feeds the final frame's timing margin)."""
        return 2 * self.step.tail_samples

    def process_round(self, iq_u8, defer_fetch: bool = False, tail_u8=None):
        """One K-frame round for all N streams. iq_u8: (N, 2*K*fs) uint8
        (numpy, or a tensor on the device). tail_u8: (N, tail_bytes), the
        stream bytes that FOLLOW this round (next round's head); without it
        the final frame's timing margin reads zeros, which corrupts that
        frame whenever sample-clock drift pushes the fine-time offset
        positive (omit only at end of stream). With defer_fetch, the
        previous round's byte layer is consumed while this round runs on
        the device (one round of latency: on a CUDA device the round is
        only queued here, and its outputs are fetched behind an event).

        On a mesh every rank calls process_round each round, with the
        whole round of all N streams as above; the rank takes its rows and,
        of iq_u8, its time block."""
        if self.mesh is not None:
            iq_u8, tail_u8 = self._local(iq_u8), self._local(tail_u8, False)
        fib, offsets, msc = self.program(iq_u8, tail_u8)
        packed = (fib, offsets)
        packed += (msc,) if self.mesh is None else self._to_leader(msc)
        fetch = _Fetch(packed, self._pinned_for(packed))
        if defer_fetch:
            prev, self._pending = self._pending, fetch
            if prev is not None:
                self._materialize(prev)
        else:
            self._materialize(fetch)
        self.total_rounds += 1

    def _round(self, state, iq_u8, tail_u8):
        """The program's function: the round from state (carry, history),
        then the bit packing, which stays on the device (8x fewer bytes to
        fetch) -> (new state, (FIB bytes, each stream's last frame offset,
        subchannel bytes))."""
        carry, hist, out = self.step(*state, iq_u8, tail_u8)
        return (carry, hist), (_pack_bits(out["fib_bits"]),
                               out["offsets"][:, -1],
                               _pack_bits(out["msc_bits"]))

    def _local(self, x, block: bool = True):
        """This rank's part of a round's input of all N streams: its
        streams' rows, and with block the columns of its time coordinate."""
        if x is None:
            return None
        if x.shape[0] != self.nb_streams:
            raise ValueError(f"a round on a mesh holds all {self.nb_streams} "
                             f"streams, got {x.shape[0]} rows")
        x = x[self.rows[0]:self.rows[1]]
        if block:
            n = x.shape[1] // self.mesh.shape["time"]
            t = self.mesh.coords["time"]
            x = x[:, t * n:(t + 1) * n]
        return x

    def _to_leader(self, msc_bytes):
        """(the packed subchannel bytes of every sub rank,) on the leader,
        gathered over 'sub' among the time-0 ranks; () on the others."""
        from ..parallel.mesh import _all_gather
        if self.mesh.coords["time"] != 0:
            return ()
        msc = _all_gather(self.mesh, "sub", msc_bytes)
        if not self.mesh.is_leader:
            return ()
        # (n_sub, N, S_loc, C, n) -> (N, S, C, n)
        return (msc.transpose(0, 1).reshape(self.N, self.S, *msc.shape[3:]),)

    def _pinned_for(self, packed):
        """This round's pinned host tensors (CUDA only): two sets used in
        turns, since the previous round's may still be pending."""
        if self.device.type != "cuda":
            return None
        k = self.total_rounds % 2
        if self._pinned[k] is None:
            self._pinned[k] = [torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True) for t in packed]
        return self._pinned[k]

    def _materialize(self, fetch: _Fetch):
        fib, offs, *msc = fetch.arrays()
        self.last_frame_offsets = offs.astype(np.int64)
        if msc:
            self._consume(fib, msc[0])
        else:          # a rank of a mesh other than its group's leader
            self._check_fibs(fib)
        self.materialized_rounds += 1

    @property
    def drift_correction(self) -> np.ndarray:
        """Per-stream sample-clock re-anchor hint: each stream's FINAL
        frame fine-time offset from the most recently materialized round
        (one round stale under defer_fetch; drift is slow). A long-running
        server must advance its read grid by this many SAMPLES (2x bytes
        of u8 IQ) when the magnitude grows past noise (~16): the fused
        window only absorbs [-CP, +one symbol] = [-504, +2552] of
        accumulated drift in mode I, which a real SDR's ~20 ppm clock
        error (~41 samples/s) exhausts in about a minute. This is the
        serving analog of the dynamic path's per-frame pointer advance
        (StreamingDemodulator: pos += offset). fleet_serve applies it
        automatically with a 2-round cooldown. Desynced frames report 0
        (no correction): a noise burst must not move the grid."""
        return self.last_frame_offsets

    def resync(self):
        """Hard re-acquisition: reset the DEVICE decode state (demod sync
        carry and deinterleaver history) while keeping databases,
        byte-layer processors, codecs and counters. Call after re-aligning
        the stream (find_alignment) when the signal was lost outright
        (retune, deep fade): the stale carry's coarse-CFO/timing estimates
        would otherwise fight the new signal. Superframe/packet sync
        machines re-sync themselves; the 16-CIF deinterleaver warm-up
        garbage is CRC-gated as usual."""
        self.program.load_state(self._init_state)
        self._pending = None
        self.last_frame_offsets = np.zeros(self.N, np.int64)
        self.last_fib_ok = np.zeros(self.N, np.int64)
        self.materialized_rounds = 0

    def flush(self):
        """Consume any round still deferred."""
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._materialize(prev)

    # ---- host byte layer -------------------------------------------------

    def _check_fibs(self, fib_bytes: np.ndarray):
        """(the round's FIBs (N, F, FIBs, 32), their CRC flags)."""
        B, F = fib_bytes.shape[:2]
        fibs = fib_bytes.reshape(B, F, -1, 32)
        ok = crc16_check_batch(fibs.reshape(-1, 32)).reshape(fibs.shape[:3])
        # per-stream signal-health metric for the serving loop's desync
        # detector: valid FIBs in this round (a locked stream passes
        # nearly all; a desynced/retuned one passes none)
        self.last_fib_ok = ok.reshape(B, -1).sum(axis=1)
        return fibs, ok

    def _consume(self, fib_bytes: np.ndarray, msc_bytes: np.ndarray):
        """One round's byte layer: the FIB check, the byte work of every
        stream (_consume_batched), then the observers (_fire), stream by
        stream, on the calling thread."""
        with profile_scope("fleet/consume"):
            fibs, ok = self._check_fibs(fib_bytes)
            per_stream = self._consume_batched(fibs, ok, msc_bytes)
            with profile_scope("fleet/fire"):
                for b, events in enumerate(per_stream):
                    self._fire(b, events)

    def _ingest_fibs(self, b, fibs, ok):
        for f in range(fibs.shape[1]):
            self.receivers[b].ingest_fibs(
                [bytes(fib[:30]) for fib, o
                 in zip(fibs[b, f], ok[b, f]) if o])

    def _mp2_events(self, pairs, msc_bytes):
        """One round of the "mp2" subchannels `pairs` [(stream, sub)]:
        their logical frames, each one MP2 frame, counted in MP2_STATS ->
        {(stream, sub): events}."""
        C = msc_bytes.shape[2]
        with profile_scope("fleet/mp2_frames"):
            bs = np.array(pairs)
            count_mp2_frames(msc_bytes[bs[:, 0], bs[:, 1], :, :2],
                             C * sum(self._nbytes[b][s] for b, s in pairs))
            out = {}
            for b, s in pairs:
                nb = self._nbytes[b][s]
                events = []
                for row in msc_bytes[b, s, :, :nb]:
                    payload = row.tobytes()
                    pcm = self._decode_mp2(b, s, payload) \
                        if (b, s) in self._audio_enabled else None
                    events.append(("mp2", s, payload, pcm))
                out[(b, s)] = events
            return out

    def _packet_events(self, b, s, msc_bytes):
        """One round of a packet-mode subchannel -> its events."""
        nb = self._nbytes[b][s]
        # collect the data groups: observers fire after the round's byte
        # work (_fire), not from inside the relay
        proc = self._sfp[b][s]
        local = []
        proc.on_data_group.append(local.append)
        try:
            for c in range(msc_bytes.shape[2]):
                proc.process(msc_bytes[b, s, c][:nb].tobytes())
        finally:
            proc.on_data_group.remove(local.append)
        return [("dg", s, local)] if local else []

    def _superframe_event(self, b, s, res):
        header, aus = res
        pcm = self._decode_audio(b, s, header, aus) \
            if (b, s) in self._audio_enabled else None
        return ("sf", s, header, aus, pcm)

    def _consume_batched(self, fibs, ok, msc_bytes):
        """The round's byte work with its RS decodes BATCHED: audio
        subchannels advance in frame lockstep across every (stream, sub),
        and whenever superframes complete, ONE ReedSolomonDecoder.decode
        call corrects all of them together and ONE
        SuperframeProcessor.finish_batch call finishes them. Each
        processor sees the push/finish sequence of its own frames. The
        batch is a CIF of the whole fleet (2,304 codewords for 16 ensembles
        of 18 DAB+ subchannels), so its syndromes are computed on the
        fleet's device; Berlekamp-Massey and Forney stay on the host for
        the rows they gate. Returns a list of per-stream event lists,
        subchannel-major, for _fire."""
        from ..dab.aac import RS_MESSAGE
        C = msc_bytes.shape[2]
        for b in range(self.N):
            self._ingest_fibs(b, fibs, ok)
        ev_bs = {(b, s): [] for b in range(self.N) for s in range(self.S)}
        audio = [bs for bs in ev_bs if self._kinds[bs[0]][bs[1]] == "audio"]
        rs = dab_plus_rs()
        # a fleet without DAB+ subchannels opens none of their spans
        for c in range(C if audio else 0):
            done = []                     # (b, s, (n_cols, 120) codewords)
            with profile_scope("fleet/push_frames"):
                for b, s in audio:
                    nb = self._nbytes[b][s]
                    sf = self._sfp[b][s].push_frame(
                        msc_bytes[b, s, c][:nb].tobytes())
                    if sf is not None:
                        arr = np.frombuffer(sf, np.uint8).reshape(
                            RS_MESSAGE, len(sf) // RS_MESSAGE)
                        done.append((b, s, arr.T))
            if not done:
                continue
            with profile_scope("fleet/rs_decode"):
                cw = np.concatenate([d[2] for d in done], axis=0)
                corrected, nerr = rs.decode(cw, device=self.device)
            with profile_scope("fleet/finish"):
                results = SuperframeProcessor.finish_batch(
                    [self._sfp[b][s] for b, s, _ in done], corrected, nerr)
                for (b, s, _), res in zip(done, results):
                    if res is not None:
                        ev_bs[(b, s)].append(
                            self._superframe_event(b, s, res))
        mp2 = [bs for bs in ev_bs if self._kinds[bs[0]][bs[1]] == "mp2"]
        if mp2:
            ev_bs.update(self._mp2_events(mp2, msc_bytes))
        for b, s in ev_bs:
            if self._kinds[b][s] not in ("audio", "mp2"):
                ev_bs[(b, s)] = self._packet_events(b, s, msc_bytes)
        return [[e for s in range(self.S) for e in ev_bs[(b, s)]]
                for b in range(self.N)]

    def _fire(self, b, events):
        """Replay one stream's collected events through the observers and
        counters, on the calling thread, in decode order. Observers get the
        global stream number."""
        b += self.rows[0]
        for ev in events:
            if ev[0] == "sf":
                _, s, header, aus, pcm = ev
                self.total_aus += len(aus)
                for i, au in enumerate(aus):
                    for cb in self.on_access_unit:
                        cb(b, s, i, len(aus), au, header)
                for out in pcm or ():
                    for cb in self.on_audio_data:
                        cb(b, s, *out)
            elif ev[0] == "mp2":
                _, s, payload, pcm = ev
                self.total_mp2_frames += 1
                for cb in self.on_mp2_frame:
                    cb(b, s, payload)
                for out in pcm or ():
                    for cb in self.on_audio_data:
                        cb(b, s, *out)
            else:
                _, s, local = ev
                for res in local:
                    self.total_data_groups += 1
                    for cb in self.on_data_group:
                        cb(b, s, res)

    def enable_audio(self, stream: int, sub: int):
        """Decode this (stream, subchannel) to PCM and fire on_audio_data:
        DAB+ AUs through HE-AAC (incl. SBR@960 and parametric stereo) or,
        for an 'mp2' subchannel, classic DAB MP2 frames (host/codecs.py).
        Off by default: serving deployments usually ship the bitstream
        downstream. `stream` is the global stream number."""
        self._audio_enabled.add((stream - self.rows[0], sub))

    def _decode_mp2(self, b, s, frame: bytes):
        """-> [(pcm, rate, nch), ...] for _fire, which makes the observer
        calls."""
        from ..host.codecs import MP2Decoder
        dec = self._decoders.get((b, s))
        if dec is None:
            dec = MP2Decoder()
            self._decoders[(b, s)] = dec
        if not dec.is_available:
            return []
        out = dec.decode(frame)
        return [out] if out is not None else []

    def _decode_audio(self, b, s, header, aus):
        """-> [(pcm, rate, nch), ...] for _fire (see _decode_mp2)."""
        from ..host.codecs import AACDecoder
        dec = self._decoders.get((b, s))
        if dec is None or dec.header != header:
            if dec is not None:
                dec.close()
            dec = AACDecoder(header)
            self._decoders[(b, s)] = dec
        if not dec.is_available:
            return []
        outs = []
        for au in aus:
            out = dec.decode_au(au)
            if out is not None:
                outs.append(out)
        return outs

    def summary(self) -> dict:
        return {
            "streams": self.N,
            "rounds": self.total_rounds,
            "frames": self.total_rounds * self.frames_per_round * self.N,
            "access_units": self.total_aus,
            "data_groups": self.total_data_groups,
            "mp2_frames": self.total_mp2_frames,
            "services": sum(len(r.db.services) for r in self.receivers),
        }
