"""MSC subchannel decoder (port of ``dab_radio_tpu/dab/msc.py``): CIF slice
-> time deinterleave -> punctured Viterbi -> energy-dispersal descramble.

The deinterleaver history is a (16, nb_bits) int8 tensor on the decoder's
device, held as the state of a program (``utils/graphs.py``: a captured
CUDA graph on a CUDA device, one for each CIF count, as the JAX package
jits its ``step`` and ``frame``). Same-protection subchannels are decoded
as one group, ``MSCDecodeGroup``, whose program holds their stacked
histories and runs one deinterleave and one batched Viterbi over every
subchannel and CIF of the frame: the exact full-trellis decode, or after
``set_decode_mode("tiled")`` the overlap-save tiled one
(``ops/viterbi.py:viterbi_decode_tiled``). The descramble to bytes stays on
the host.

Pickled state holds numpy arrays, never device tensors.
"""

import dataclasses
import functools

import numpy as np
import torch

from ..ops.scrambler import prbs_bytes
from ..params import msc_puncture_schedule, SubchannelConfig
from ..params.puncture import build_puncture_mask
from ..ops import viterbi as vit
from ..utils.backend import to_device
from ..utils.graphs import CapturedProgram, as_argument
from ..utils.profiler import profile_scope
from ..ops.deinterleave import (make_gather_index, deinterleave_push_block,
                                DEPTH, CIF_OFFSETS)

CU_BITS = 64

# MSC Viterbi mode of this process: "exact" = the full-trellis decode;
# "tiled" = the overlap-save decode, every window of every subchannel and
# CIF in one launch of K1's windowed mode: equal output at operating SNR,
# and the per-layer CRCs gate the heavy-noise corner.
_DECODE_MODE = "exact"


def set_decode_mode(mode: str) -> None:
    """Choose the Viterbi of every MSCDecoder and MSCDecodeGroup of the
    process. Decoders read the mode at each decode and pass it to their
    program as a value, so each mode is a graph of its own and there is no
    cache to clear."""
    global _DECODE_MODE
    if mode not in ("exact", "tiled"):
        raise ValueError(f"decode mode must be 'exact' or 'tiled', got {mode!r}")
    _DECODE_MODE = mode


def _vit_decode(soft: torch.Tensor, spec: vit.ViterbiSpec, mode: str):
    if mode == "tiled":
        return vit.viterbi_decode_tiled(soft, spec)
    return vit.viterbi_decode(soft, spec)


@functools.lru_cache(maxsize=None)
def msc_spec(cfg: SubchannelConfig) -> vit.ViterbiSpec:
    """Decode plan of one subchannel protection, shared by every decoder."""
    return vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))


@functools.lru_cache(maxsize=None)
def _gather_index(nb_bits: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(make_gather_index(nb_bits), dtype=torch.int64,
                           device=device)


def _decode_block(hist, subs, spec: vit.ViterbiSpec, mode: str):
    """The device half of a decode: history (..., 16, nb_bits) and CIF
    slices (..., C, nb_bits) int8 -> (new history, bits (..., C,
    nb_data_bits)); one deinterleave gather, one Viterbi over every lane."""
    hist, deints = deinterleave_push_block(
        hist, subs, _gather_index(subs.shape[-1], subs.device))
    deints = deints[..., :spec.nb_in]
    bits, _err = _vit_decode(deints.reshape(-1, spec.nb_in), spec, mode)
    return hist, bits.reshape(*deints.shape[:-1], -1)


def _descramble(bits: np.ndarray) -> bytes:
    by = np.packbits(bits)
    return bytes(by ^ prbs_bytes(by.shape[0]))


def group_key(cfg: SubchannelConfig) -> SubchannelConfig:
    """Subchannels that differ only in start address share decode shapes."""
    return dataclasses.replace(cfg, start_address=0)


class MSCDecodeGroup:
    """Same-protection decode group: the stacked (N, 16, nb_bits)
    deinterleaver history of N subchannels is the state of one program,
    which slices every member's CIFs, deinterleaves and decodes them in one
    batched Viterbi a frame (JAX's ``_group_frame_fn``). A persistent group
    (``persistent_group``) keeps its history and its graph from frame to
    frame.

    While the group holds them, its members' ``history`` reads their rows
    of it; ``sync_back()`` hands the rows back to the members, and a member
    that decodes on its own takes its row back first. A dispatch after
    either takes the members' histories in again."""

    def __init__(self, decoders: list, cuda_graph=None):
        self.decoders = list(decoders)
        self.key = group_key(decoders[0].cfg)
        self.spec = msc_spec(self.key)
        self.device = decoders[0].device
        self._starts = tuple(d.cfg.start_address * CU_BITS
                             for d in self.decoders)
        self.program = CapturedProgram(
            self._decode, self.device, state=self._stacked(),
            cuda_graph=cuda_graph)
        self._attach()

    def _stacked(self) -> torch.Tensor:
        return torch.stack([d.history for d in self.decoders])

    def _attach(self):
        for i, d in enumerate(self.decoders):
            d._group = (self, i)

    def _holds(self, i: int) -> bool:
        g = self.decoders[i]._group
        return g is not None and g[0] is self and g[1] == i

    def read_row(self, i: int) -> torch.Tensor:
        """A copy of member i's current history."""
        return self.program.read_state()[i]

    def _decode(self, hist, srcs, which, mode):
        """The program's function: srcs are the distinct CIF arrays
        (nb_cifs, nb_msc_cif_bits) of the members, which[i] the one of
        member i."""
        srcs = [to_device(c, self.device, np.int8) for c in srcs]
        n = self.key.nb_cif_bits
        subs = torch.stack([srcs[w][:, a:a + n]
                            for w, a in zip(which, self._starts)])
        return _decode_block(hist, subs, self.spec, mode)

    def dispatch(self, cifs_list):
        """Decode one frame: cifs_list[i] is member i's (nb_cifs,
        nb_msc_cif_bits) array (numpy, or a tensor that may lie on the
        device, sliced there). Returns a handle for finalize_frame_group;
        its bits are the program's output, valid until its next call."""
        if not all(self._holds(i) for i in range(len(self.decoders))):
            self.program.load_state(self._stacked())
            self._attach()
        srcs, which, seen = [], [], {}
        for c in cifs_list:
            if id(c) not in seen:
                seen[id(c)] = len(srcs)
                srcs.append(as_argument(c, np.int8))
            which.append(seen[id(c)])
        bits = self.program(tuple(srcs), tuple(which), _DECODE_MODE)
        nb_cifs = bits.shape[1]
        pushed0 = []
        for d in self.decoders:
            pushed0.append(d.nb_pushed)
            d.nb_pushed += nb_cifs
        return self.decoders, bits, pushed0, nb_cifs

    def sync_back(self):
        """Hand each member that the group still holds its current row."""
        rows = self.program.read_state()
        for i, d in enumerate(self.decoders):
            if self._holds(i):
                d._group = None
                d._program.load_state(rows[i])


def persistent_group(groups: dict, key, decoders: list,
                     cuda_graph=None) -> MSCDecodeGroup:
    """The group of `decoders` kept in `groups` under `key` (one a
    protection shape): the same group while its members stay, else a new
    one built after the old one has handed its rows back."""
    g = groups.get(key)
    if g is None or len(g.decoders) != len(decoders) or any(
            a is not b for a, b in zip(g.decoders, decoders)):
        if g is not None:
            g.sync_back()
        g = groups[key] = MSCDecodeGroup(decoders, cuda_graph)
    return g


def release_groups(groups: dict):
    """Hand every group's rows back to its members and forget the groups."""
    for g in groups.values():
        g.sync_back()
    groups.clear()


def dispatch_frame_group(decoders: list, msc_cifs):
    """Device half of decode_frame_group: one batched decode over N
    same-protection subchannels, by a group made for this call alone (run
    eagerly: it is never replayed). Updates each decoder's deinterleaver
    history and returns a handle for finalize_frame_group."""
    if isinstance(msc_cifs, (list, tuple)):
        cifs_list = list(msc_cifs)
    else:
        cifs_list = [msc_cifs] * len(decoders)
    g = MSCDecodeGroup(decoders, cuda_graph=False)
    handle = g.dispatch(cifs_list)
    g.sync_back()
    return handle


def finalize_frame_group(handle) -> list:
    """Host half: fetch decoded bits, descramble, emit per-decoder payload
    lists matching MSCDecoder.decode_frame."""
    decoders, bits, pushed0, nb_cifs = handle
    with profile_scope("msc/fetch"):
        bits = bits.cpu().numpy()
    bits = bits.astype(np.uint8)
    results = []
    for i, d in enumerate(decoders):
        out = []
        for c in range(nb_cifs):
            if pushed0[i] + c + 1 < DEPTH:
                out.append(None)
                continue
            out.append(_descramble(bits[i, c]))
        results.append(out)
    return results


def decode_frame_group(decoders: list, msc_cifs) -> list:
    """Decode one frame of several same-protection subchannels at once.
    msc_cifs is one (nb_cifs, nb_msc_cif_bits) array shared by every decoder
    or a sequence of such arrays, one per decoder. Returns per-decoder lists
    matching MSCDecoder.decode_frame."""
    return finalize_frame_group(dispatch_frame_group(decoders, msc_cifs))


class MSCDecoder:
    """Streaming decoder for one subchannel. Its deinterleaver history is
    the state of its program (``decode_cif`` and ``decode_frame`` are one
    program, a graph for each CIF count), or a row of a decode group's
    while a group holds it; ``history`` reads a copy of the current one.
    cuda_graph: see ``utils/graphs.py``."""

    def __init__(self, cfg: SubchannelConfig, device: torch.device,
                 cuda_graph=None):
        self.cfg = cfg
        self.nb_bits = cfg.nb_cif_bits
        self.spec = msc_spec(cfg)
        self.device = torch.device(device)
        self.cuda_graph = cuda_graph
        self._init_program(torch.zeros((DEPTH, self.nb_bits),
                                       dtype=torch.int8, device=self.device))
        self.nb_pushed = 0

    def _init_program(self, history: torch.Tensor):
        self._program = CapturedProgram(self._decode, self.device,
                                        state=history,
                                        cuda_graph=self.cuda_graph)
        self._group = None       # (group, row) while a group holds it

    @property
    def history(self) -> torch.Tensor:
        """A copy of the (16, nb_bits) int8 deinterleaver history, on the
        decoder's device."""
        if self._group is not None:
            group, row = self._group
            return group.read_row(row)
        return self._program.read_state()

    # checkpoint/resume: the carry is the deinterleaver history + fill count
    def __getstate__(self):
        return {"cfg": self.cfg, "nb_pushed": self.nb_pushed,
                "history": self.history.cpu().numpy(),
                "device": str(self.device), "cuda_graph": self.cuda_graph}

    def __setstate__(self, state):
        self.cfg = state["cfg"]
        self.nb_bits = self.cfg.nb_cif_bits
        self.spec = msc_spec(self.cfg)
        self.device = torch.device(state["device"])
        self.cuda_graph = state.get("cuda_graph")
        self._init_program(to_device(state["history"], self.device, np.int8))
        self.nb_pushed = state["nb_pushed"]

    def to(self, device) -> "MSCDecoder":
        """Move the history to `device`; a group that held it lets it go
        (it takes it in again at its next dispatch)."""
        history = self.history
        self.device = torch.device(device)
        self._init_program(history.to(self.device))
        return self

    def _decode(self, hist, cifs, mode):
        return _decode_block(hist, to_device(cifs, self.device, np.int8),
                             self.spec, mode)

    def _run(self, cifs) -> np.ndarray:
        """(C, nb_bits) CIF slices through the program -> (C, nb_data)
        decoded bits on the host."""
        if self._group is not None:             # take the row back
            group, row = self._group
            self._group = None
            self._program.load_state(group.read_row(row))
        bits = self._program(cifs, _DECODE_MODE)
        return bits.cpu().numpy().astype(np.uint8)

    def _slice(self, msc) -> np.ndarray:
        start = self.cfg.start_address * CU_BITS
        return np.asarray(msc, np.int8)[..., start:start + self.nb_bits]

    def decode_cif(self, msc_soft_bits: np.ndarray):
        """msc_soft_bits: one CIF of soft bits (nb_cif_bits of the whole MSC).
        Returns decoded bytes (descrambled) or None while the deinterleaver
        is still filling."""
        bits = self._run(self._slice(msc_soft_bits)[None])
        self.nb_pushed += 1
        if self.nb_pushed < DEPTH:
            return None
        return _descramble(bits[0])

    def decode_frame(self, msc_cifs: np.ndarray):
        """All CIFs of one frame: (nb_cifs, nb_msc_cif_bits) -> list of
        decoded byte payloads (None entries while the deinterleaver fills)."""
        bits = self._run(self._slice(msc_cifs))
        out = []
        for c in range(bits.shape[0]):
            self.nb_pushed += 1
            if self.nb_pushed < DEPTH:
                out.append(None)
                continue
            out.append(_descramble(bits[c]))
        return out


class MSCEncoder:
    """Inverse path for tests/transmitter: payload bytes -> interleaved CIF
    soft bits of the subchannel (numpy)."""

    def __init__(self, cfg: SubchannelConfig):
        self.cfg = cfg
        self.nb_bits = cfg.nb_cif_bits
        self.mask = build_puncture_mask(msc_puncture_schedule(cfg))
        self.nb_data_bits = self.mask.shape[0] // 4 - 6
        self.nb_data_bytes = self.nb_data_bits // 8
        # interleaver state: future CIF contributions (bit i of the CIF sent
        # at time t+offset comes from the frame encoded at time t)
        self._pending = np.zeros((DEPTH, self.nb_bits), dtype=np.int8)
        self._t = 0

    def encode_cif(self, payload: bytes) -> np.ndarray:
        """Encode one logical frame and emit the time-interleaved CIF soft
        bits that would be transmitted this CIF period (includes
        contributions from the previous 15 logical frames)."""
        assert len(payload) == self.nb_data_bytes
        data = np.frombuffer(payload, dtype=np.uint8) ^ prbs_bytes(self.nb_data_bytes)
        bits = np.unpackbits(data)
        coded = vit.conv_encode(bits)
        tx = vit.bits_to_soft(vit.puncture(coded, self.mask))
        if tx.shape[0] < self.nb_bits:    # UEP padding bits
            tx = np.concatenate([tx, np.zeros(self.nb_bits - tx.shape[0], np.int8)])

        # scatter: bit i of this frame goes out at time t + offset[i%16]
        offs = CIF_OFFSETS[np.arange(self.nb_bits) % DEPTH]
        for d in range(DEPTH):
            sel = offs == d
            self._pending[(self._t + d) % DEPTH][sel] = tx[sel]
        out = self._pending[self._t % DEPTH].copy()
        self._t += 1
        return out
