"""DAB receiver orchestration (port of ``dab_radio_tpu/models/receiver.py``).

Per OFDM frame: split FIC/MSC soft bits, decode the FIC into the ensemble
database, and when subchannel + component entries complete, instantiate
channel decoders (DAB+ stream audio / DAB stream audio / packet data). The
Viterbi decodes run on the receiver's device as programs (captured CUDA
graphs on a CUDA device, ``utils/graphs.py``): the FIC decode, and one
persistent decode group for each protection shape that two or more
subchannels share, which holds their deinterleaver histories from frame to
frame; the byte-level protocol layers are the JAX package's numpy modules
and run on the host; observers are plain callback lists.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from ..params import get_dab_params, SubchannelConfig
from ..dab.fig_native import NativeFIGParser
from ..dab.database import (
    DatabaseUpdater, STREAM_AUDIO, PACKET_DATA, AUDIO_DAB, AUDIO_DAB_PLUS,
    Subchannel, db_mutation_clock,
)
from ..dab.aac import SuperframeProcessor
from ..dab.fic import FICDecoder
from ..dab.msc import (MSCDecoder, finalize_frame_group, group_key,
                       persistent_group, release_groups)
from ..utils.profiler import profile_scope
from .controls import AudioControls


@dataclass
class ChannelEvents:
    """Observable hooks of one decoded channel (reference
    Basic_DAB_Plus_Channel observables)."""
    on_audio_data: List[Callable] = field(default_factory=list)
    on_access_unit: List[Callable] = field(default_factory=list)
    on_superframe_header: List[Callable] = field(default_factory=list)
    on_frame_data: List[Callable] = field(default_factory=list)
    on_dynamic_label: List[Callable] = field(default_factory=list)


class ChannelCheckpointMixin:
    """Checkpoint/resume for channels: all decode state
    (deinterleaver history, superframe buffers, PAD/MOT assemblers) pickles;
    external observers (events, slideshow hooks) and host codec handles do
    not — re-attach sinks and re-enable audio after restore."""

    def __getstate__(self):
        d = dict(self.__dict__)
        d["events"] = None
        d.pop("_audio_decoder", None)
        d.pop("_decoder_header", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.events = ChannelEvents()
        self._audio_decoder = None
        # MOTProcessor.__getstate__ drops ALL on_entity hooks (external
        # observers may hold closures/file handles); the channel's own
        # internal slideshow wiring must come back
        rewire = getattr(self, "_rewire", None)
        if rewire is not None:
            rewire()
        if self.kind == "dab+":
            self._decoder_header = None


class DabPlusChannel(ChannelCheckpointMixin):
    """MSC subchannel -> DAB+ superframe -> access units + PAD (dynamic
    labels, MOT slideshows); PCM audio decode attaches via host.codecs."""

    kind = "dab+"

    def __init__(self, cfg: SubchannelConfig, device: torch.device,
                 cuda_graph=None):
        from ..dab.aac_data import AACDataDecoder
        from ..dab.slideshow import SlideshowManager
        self.cfg = cfg
        self.msc = MSCDecoder(cfg, device, cuda_graph)
        self.superframe = SuperframeProcessor()
        self.events = ChannelEvents()
        self.header = None
        self.aac_data = AACDataDecoder()
        self.slideshows = SlideshowManager()
        self.aac_data.pad.on_mot_entity.append(
            self.slideshows.process_mot_entity)
        self.dynamic_label = ""
        self.aac_data.pad.on_label.append(self._set_label)
        self.controls = AudioControls()
        self._audio_decoder = None
        self._decoder_header = None

    def _rewire(self):
        self.aac_data.pad.on_mot_entity.append(
            self.slideshows.process_mot_entity)

    def _set_label(self, label: str):
        self.dynamic_label = label
        for cb in self.events.on_dynamic_label:
            cb(label)

    @property
    def on_dynamic_label(self):
        return self.events.on_dynamic_label

    @property
    def on_slideshow(self):
        return self.slideshows.on_slideshow

    def enable_audio_decode(self) -> bool:
        """Attach the AAC decoder (host.codecs); PCM flows to
        events.on_audio_data. Returns availability."""
        self.controls.decode_audio = True
        return True

    def _ensure_decoder(self, header):
        from ..host.codecs import AACDecoder
        if self._audio_decoder is None or self._decoder_header != header:
            if self._audio_decoder is not None:
                self._audio_decoder.close()
            self._audio_decoder = AACDecoder(header)
            self._decoder_header = header
        return self._audio_decoder

    def process_frame_cifs(self, msc_cifs: np.ndarray):
        """All CIFs of one frame in one decode."""
        for payload in self.msc.decode_frame(msc_cifs):
            if payload is not None:
                self._handle_payload(payload)

    def process_cif(self, msc_soft_bits: np.ndarray):
        payload = self.msc.decode_cif(msc_soft_bits)
        if payload is None:
            return
        self._handle_payload(payload)

    def _handle_payload(self, payload: bytes):
        for cb in self.events.on_frame_data:   # raw MSC logical frame
            cb(payload)
        res = self.superframe.process_frame(payload)
        if res is None:
            return
        header, aus = res
        if header != self.header:
            self.header = header
            for cb in self.events.on_superframe_header:
                cb(header)
        for i, au in enumerate(aus):
            if self.controls.decode_data:
                self.aac_data.process_access_unit(au)
            for cb in self.events.on_access_unit:
                cb(i, len(aus), au, header)
            if self.controls.decode_audio:
                dec = self._ensure_decoder(header)
                if dec.is_available:
                    out = dec.decode_au(au)
                    if out is not None:
                        pcm, rate, ch = out
                        for cb in self.events.on_audio_data:
                            cb(pcm, rate, ch)


class DabChannel(ChannelCheckpointMixin):
    """MSC subchannel -> MP2 logical frames + PAD (classic DAB audio)."""

    kind = "dab"

    def __init__(self, cfg: SubchannelConfig, device: torch.device,
                 cuda_graph=None):
        from ..dab.mp2 import MP2PadExtractor
        from ..dab.slideshow import SlideshowManager
        self.cfg = cfg
        self.msc = MSCDecoder(cfg, device, cuda_graph)
        self.events = ChannelEvents()
        self.pad_extractor = MP2PadExtractor()
        self.slideshows = SlideshowManager()
        self.pad_extractor.pad.on_mot_entity.append(
            self.slideshows.process_mot_entity)
        self.dynamic_label = ""
        self.pad_extractor.pad.on_label.append(self._set_label)
        self.controls = AudioControls()
        self._audio_decoder = None

    def _rewire(self):
        self.pad_extractor.pad.on_mot_entity.append(
            self.slideshows.process_mot_entity)

    def _set_label(self, label: str):
        self.dynamic_label = label
        for cb in self.events.on_dynamic_label:
            cb(label)

    def enable_audio_decode(self) -> bool:
        from ..host.codecs import MP2Decoder
        self.controls.decode_audio = True
        self._audio_decoder = MP2Decoder()
        return self._audio_decoder.is_available

    def process_frame_cifs(self, msc_cifs: np.ndarray):
        for payload in self.msc.decode_frame(msc_cifs):
            if payload is not None:
                self._handle_payload(payload)

    def process_cif(self, msc_soft_bits: np.ndarray):
        payload = self.msc.decode_cif(msc_soft_bits)
        if payload is None:
            return
        self._handle_payload(payload)

    def _handle_payload(self, payload: bytes):
        if self.controls.decode_data:
            self.pad_extractor.process_frame(payload)
        for cb in self.events.on_frame_data:
            cb(payload)
        if (self.controls.decode_audio and self._audio_decoder is not None
                and self._audio_decoder.is_available):
            out = self._audio_decoder.decode(payload)
            if out is not None:
                pcm, rate, ch = out
                if ch == 1:
                    # reference duplicates mono to stereo for the pipeline
                    pcm = np.repeat(pcm.reshape(-1, 1), 2, axis=1).reshape(-1)
                    ch = 2
                for cb in self.events.on_audio_data:
                    cb(pcm, rate, ch)


class DataPacketChannel(ChannelCheckpointMixin):
    """MSC subchannel -> packet mode (optional RS FEC) -> data groups/MOT."""

    kind = "packet"

    def __init__(self, cfg: SubchannelConfig, packet_address: int,
                 fec_scheme: int, device: torch.device, cuda_graph=None):
        from ..dab.packets import PacketProcessor
        self.cfg = cfg
        self.msc = MSCDecoder(cfg, device, cuda_graph)
        self.events = ChannelEvents()
        self.processor = PacketProcessor(packet_address,
                                         use_fec=(fec_scheme == 1))

    def process_frame_cifs(self, msc_cifs: np.ndarray):
        for payload in self.msc.decode_frame(msc_cifs):
            if payload is not None:
                self._handle_payload(payload)

    def process_cif(self, msc_soft_bits: np.ndarray):
        payload = self.msc.decode_cif(msc_soft_bits)
        if payload is None:
            return
        self._handle_payload(payload)

    def _handle_payload(self, payload: bytes):
        self.processor.process(payload)
        for cb in self.events.on_frame_data:
            cb(payload)


class DabReceiver:
    """Frame soft bits in -> ensemble database + per-subchannel channels.
    cuda_graph (``utils/graphs.py``) applies to its FIC decoder, its
    channels' decoders and its decode groups."""

    def __init__(self, transmission_mode: int = 1, benchmark_all: bool = False,
                 *, device: torch.device, cuda_graph=None):
        self.device = torch.device(device)
        self.cuda_graph = cuda_graph
        self.dab = get_dab_params(transmission_mode)
        self.fic = FICDecoder(transmission_mode, self.device, cuda_graph)
        # C++ parser when native/libdabfig.so is available (differential-
        # fuzzed equal to dab.fig.FIGParser); falls back to Python
        self.parser = NativeFIGParser()
        self.updater = DatabaseUpdater()
        self.channels: Dict[int, object] = {}
        self.on_audio_channel: List[Callable] = []
        self.on_data_channel: List[Callable] = []
        self._last_stats = None
        self.benchmark_all = benchmark_all
        self.total_frames = 0
        self._fib_memo: Dict[bytes, bool] = {}  # see ingest_fibs
        self._fib_memo_clock = -1               # db_mutation_clock at build
        # group_key -> the persistent MSCDecodeGroup of the channels of
        # that protection shape, when there are two or more
        self._groups: Dict[object, object] = {}

    @property
    def db(self):
        return self.updater.db

    # ---- checkpoint/resume: the pickle holds numpy, never device tensors ----

    def __getstate__(self):
        # the channels' decoders pickle their current histories (a group's
        # rows included); the groups and their graphs stay behind
        d = dict(self.__dict__)
        d["on_audio_channel"] = []
        d["on_data_channel"] = []
        d["device"] = str(self.device)
        d["_groups"] = {}
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = torch.device(d["device"])
        self.__dict__.setdefault("cuda_graph", None)
        self.__dict__.setdefault("_groups", {})

    def to(self, device) -> "DabReceiver":
        """Move the receiver, its FIC decoder and every channel's
        deinterleaver history to `device`."""
        release_groups(self._groups)
        self.device = torch.device(device)
        self.fic.to(self.device)
        for ch in self.channels.values():
            ch.msc.to(self.device)
        return self

    def snapshot(self) -> bytes:
        """Serialize the full receiver decode state: database, every
        channel's deinterleaver/superframe/PAD/MOT state. External observers
        (on_audio_channel etc., channel events) and codec handles are NOT
        captured — re-attach sinks and re-enable audio after restore."""
        import pickle
        return pickle.dumps(self)

    @classmethod
    def from_snapshot(cls, blob: bytes) -> "DabReceiver":
        import pickle
        rx = pickle.loads(blob)
        assert isinstance(rx, cls)
        return rx

    def split_frame(self, frame_soft_bits: np.ndarray):
        """(nb_frame_bits,) int8 -> (fic bits, msc cifs (nb_cifs, nb_cif_bits))."""
        bits = np.asarray(frame_soft_bits).reshape(-1)
        assert bits.shape[0] == self.dab.nb_frame_bits
        fic = bits[: self.dab.nb_fic_bits]
        cifs = bits[self.dab.nb_fic_bits:].reshape(
            self.dab.nb_cifs, self.dab.nb_cif_bits)
        return fic, cifs

    def ingest_fibs(self, fibs):
        """Host half of the FIC path: FIG parse -> database -> channel
        creation. Exposed so a fleet can batch the FIC Viterbi across
        receivers and feed each receiver its decoded FIBs.

        Exact-repeat fast path: the FIC carousel retransmits identical
        FIBs every ~0.25-1 s; a converged long-running receiver skips the
        whole parse+apply loop per repeated FIB. Applying a FIB is NOT
        always idempotent against an incomplete database — a FIG can
        silently no-op when an entity it references hasn't been linked yet
        (e.g. FIG 0/13 user-app before the FIG 0/2 packet ref) and only
        the carousel's re-application converges it — so a FIB is only
        memoized once its application provably changed nothing (database
        mutation clock unmoved, no conflicts), and the whole memo is
        flushed whenever any mutation lands (a change can make a
        previously-no-op FIB effective). Time-varying FIGs (0/0 CIF
        counters, 0/10 datetime) change the FIB bytes and always miss.
        Observable difference vs re-applying: update/conflict counters no
        longer re-count carousel repetitions of proven-no-op FIBs."""
        with profile_scope("radio/fig_parse"):
            memo = getattr(self, "_fib_memo", None)
            if memo is None:            # snapshots from older builds
                memo = self._fib_memo = {}
                self._fib_memo_clock = -1
            up = self.updater
            for fib in fibs:
                clock = db_mutation_clock()
                if getattr(self, "_fib_memo_clock", -1) != clock:
                    memo.clear()
                    self._fib_memo_clock = clock
                if fib in memo:
                    continue
                events = self.parser.parse_fib(fib)
                conflicts = up.conflicts
                for ev in events:
                    up.apply(ev)
                if (db_mutation_clock() == clock
                        and up.conflicts == conflicts
                        and len(memo) < 4096):
                    memo[fib] = True    # proven no-op against current state

        stats = self.updater.stats()
        if stats != self._last_stats:
            self._last_stats = stats
            self._update_channels()

    def process_frame(self, frame_soft_bits: np.ndarray):
        """One OFDM frame of soft bits (nb_frame_bits int8)."""
        with profile_scope("radio/frame"):
            fic, cifs = self.split_frame(frame_soft_bits)
            with profile_scope("radio/fic_decode"):
                fibs, _ = self.fic.decode_fic(fic)
            self.ingest_fibs(fibs)
            with profile_scope("radio/msc_channels"):
                self._msc_channels(cifs)
            self.total_frames += 1

    def _msc_channels(self, cifs):
        """Every channel's MSC decode of one frame, then the byte layer
        of all of them in channel order (span radio/superframes)."""
        # group same-protection subchannels into one batched decode, by a
        # group kept from frame to frame while its members stay
        groups: Dict[object, list] = {}
        for ch in list(self.channels.values()):
            groups.setdefault(group_key(ch.msc.cfg), []).append(ch)
        decoded = []                  # (channel, its payloads of the frame)
        for key, chans in groups.items():
            if len(chans) == 1:
                decoded.append((chans[0], chans[0].msc.decode_frame(cifs)))
                continue
            group = persistent_group(self._groups, key,
                                     [c.msc for c in chans], self.cuda_graph)
            decoded += zip(chans, finalize_frame_group(
                group.dispatch([cifs] * len(chans))))
        with profile_scope("radio/superframes"):
            for ch, payloads in decoded:
                for p in payloads:
                    if p is not None:
                        ch._handle_payload(p)

    # ---- dynamic channel instantiation ----

    def _subchannel_config(self, s: Subchannel) -> SubchannelConfig:
        if s.is_uep:
            return SubchannelConfig(s.start_address, s.length, True,
                                    uep_table_index=s.uep_table_index)
        return SubchannelConfig(s.start_address, s.length, False,
                                eep_type=s.eep_type,
                                eep_prot_level=s.eep_prot_level)

    def _update_channels(self):
        db = self.db
        for sub_id, sub in db.subchannels.items():
            if not sub.is_complete or sub_id in self.channels:
                continue
            comp = db.component_by_subchannel(sub_id)
            if comp is None or not comp.is_complete:
                continue
            cfg = self._subchannel_config(sub)
            ch = None
            if (comp.transport_mode == STREAM_AUDIO
                    and comp.audio_service_type == AUDIO_DAB_PLUS):
                ch = DabPlusChannel(cfg, self.device, self.cuda_graph)
            elif (comp.transport_mode == STREAM_AUDIO
                    and comp.audio_service_type == AUDIO_DAB):
                ch = DabChannel(cfg, self.device, self.cuda_graph)
            elif (comp.transport_mode == PACKET_DATA
                    and sub.fec_scheme is not None):
                ch = DataPacketChannel(cfg, comp.packet_address or 0,
                                       sub.fec_scheme, self.device,
                                       self.cuda_graph)
            if ch is None:
                continue
            self.channels[sub_id] = ch
            cbs = (self.on_data_channel if ch.kind == "packet"
                   else self.on_audio_channel)
            for cb in cbs:
                cb(sub_id, ch)
