"""MSC subchannel decoder (port of ``dab_radio_tpu/dab/msc.py``): CIF slice
-> time deinterleave -> punctured Viterbi -> energy-dispersal descramble.

The deinterleaver history is an explicit (16, nb_bits) int8 tensor on the
decoder's device. Same-protection subchannels are decoded as one group: one
deinterleave and one batched Viterbi over every subchannel and CIF of the
frame: the exact full-trellis decode, or after ``set_decode_mode("tiled")``
the overlap-save tiled one (``ops/viterbi.py:viterbi_decode_tiled``).

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
from ..ops.deinterleave import (make_gather_index, deinterleave_push,
                                deinterleave_push_block, DEPTH, CIF_OFFSETS)

CU_BITS = 64

# MSC Viterbi mode of this process: "exact" = the full-trellis decode;
# "tiled" = the overlap-save decode, every window of every subchannel and
# CIF in one launch of K1's windowed mode: equal output at operating SNR,
# and the per-layer CRCs gate the heavy-noise corner.
_DECODE_MODE = "exact"


def set_decode_mode(mode: str) -> None:
    """Choose the Viterbi of every MSCDecoder and MSCDecodeGroup of the
    process. Decoders read the mode at each decode and hold nothing that
    depends on it, so there is no cache to clear."""
    global _DECODE_MODE
    if mode not in ("exact", "tiled"):
        raise ValueError(f"decode mode must be 'exact' or 'tiled', got {mode!r}")
    _DECODE_MODE = mode


def _vit_decode(soft: torch.Tensor, spec: vit.ViterbiSpec):
    if _DECODE_MODE == "tiled":
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


def _descramble(bits: np.ndarray) -> bytes:
    by = np.packbits(bits)
    return bytes(by ^ prbs_bytes(by.shape[0]))


def group_key(cfg: SubchannelConfig) -> SubchannelConfig:
    """Subchannels that differ only in start address share decode shapes."""
    return dataclasses.replace(cfg, start_address=0)


class MSCDecodeGroup:
    """Same-protection decode group: the stacked deinterleaver history of N
    subchannels, decoded in one deinterleave + one Viterbi per frame. Use
    sync_back() before using the individual MSCDecoder objects again."""

    def __init__(self, decoders: list):
        self.decoders = list(decoders)
        self.key = group_key(decoders[0].cfg)
        self.spec = msc_spec(self.key)
        self.device = decoders[0].device
        self.hist = torch.stack([d.history for d in self.decoders])

    def dispatch(self, cifs_list):
        # one host->device copy per distinct CIF array, slices on the device
        on_dev = {}
        for c in cifs_list:
            if id(c) not in on_dev:
                on_dev[id(c)] = to_device(c, self.device, np.int8)
        subs = torch.stack([
            on_dev[id(c)][:, d.cfg.start_address * CU_BITS:
                          d.cfg.start_address * CU_BITS + d.nb_bits]
            for d, c in zip(self.decoders, cifs_list)])
        gidx = _gather_index(self.key.nb_cif_bits, self.device)
        self.hist, deints = deinterleave_push_block(self.hist, subs, gidx)
        deints = deints[..., :self.spec.nb_in]
        n, c, length = deints.shape
        bits, _err = _vit_decode(deints.reshape(n * c, length), self.spec)
        pushed0 = []
        for d in self.decoders:
            pushed0.append(d.nb_pushed)
            d.nb_pushed += c
        return self.decoders, bits.reshape(n, c, -1), pushed0, c

    def sync_back(self):
        for i, d in enumerate(self.decoders):
            d.history = self.hist[i]


def dispatch_frame_group(decoders: list, msc_cifs):
    """Device half of decode_frame_group: one batched decode over N
    same-protection subchannels. Updates each decoder's deinterleaver
    history (device tensor) and returns a handle for finalize_frame_group."""
    if isinstance(msc_cifs, (list, tuple)):
        cifs_list = list(msc_cifs)
    else:
        cifs_list = [msc_cifs] * len(decoders)
    g = MSCDecodeGroup(decoders)
    handle = g.dispatch(cifs_list)
    g.sync_back()
    return handle


def finalize_frame_group(handle) -> list:
    """Host half: fetch decoded bits, descramble, emit per-decoder payload
    lists matching MSCDecoder.decode_frame."""
    decoders, bits, pushed0, nb_cifs = handle
    bits = bits.cpu().numpy().astype(np.uint8)
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
    """Streaming decoder for one subchannel."""

    def __init__(self, cfg: SubchannelConfig, device: torch.device):
        self.cfg = cfg
        self.nb_bits = cfg.nb_cif_bits
        self.spec = msc_spec(cfg)
        self.device = torch.device(device)
        self.history = torch.zeros((DEPTH, self.nb_bits), dtype=torch.int8,
                                   device=self.device)
        self.nb_pushed = 0

    # checkpoint/resume: the carry is the deinterleaver history + fill count
    def __getstate__(self):
        return {"cfg": self.cfg, "nb_pushed": self.nb_pushed,
                "history": self.history.cpu().numpy(),
                "device": str(self.device)}

    def __setstate__(self, state):
        self.cfg = state["cfg"]
        self.nb_bits = self.cfg.nb_cif_bits
        self.spec = msc_spec(self.cfg)
        self.device = torch.device(state["device"])
        self.history = to_device(state["history"], self.device, np.int8)
        self.nb_pushed = state["nb_pushed"]

    def to(self, device) -> "MSCDecoder":
        self.device = torch.device(device)
        self.history = self.history.to(self.device)
        return self

    def _slice(self, msc: np.ndarray) -> torch.Tensor:
        start = self.cfg.start_address * CU_BITS
        return to_device(np.asarray(msc)[..., start:start + self.nb_bits],
                         self.device, np.int8)

    def decode_cif(self, msc_soft_bits: np.ndarray):
        """msc_soft_bits: one CIF of soft bits (nb_cif_bits of the whole MSC).
        Returns decoded bytes (descrambled) or None while the deinterleaver
        is still filling."""
        gidx = _gather_index(self.nb_bits, self.device)
        self.history, deint = deinterleave_push(
            self.history, self._slice(msc_soft_bits), gidx)
        bits, _err = _vit_decode(deint[None, :self.spec.nb_in], self.spec)
        self.nb_pushed += 1
        if self.nb_pushed < DEPTH:
            return None
        return _descramble(bits[0].cpu().numpy().astype(np.uint8))

    def decode_frame(self, msc_cifs: np.ndarray):
        """All CIFs of one frame: (nb_cifs, nb_msc_cif_bits) -> list of
        decoded byte payloads (None entries while the deinterleaver fills)."""
        gidx = _gather_index(self.nb_bits, self.device)
        self.history, deints = deinterleave_push_block(
            self.history, self._slice(msc_cifs), gidx)
        bits, _err = _vit_decode(deints[..., :self.spec.nb_in], self.spec)
        bits = bits.cpu().numpy().astype(np.uint8)
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
