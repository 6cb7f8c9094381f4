"""FIC decode and encode (port of ``dab_radio_tpu/dab/fic.py``).

Decode: per CIF, one FIB group of soft bits -> depuncture (PI_16/PI_15/PI_X)
-> Viterbi -> energy-dispersal descramble -> split into FIBs -> CRC16 gate.
The Viterbi runs on the decoder's device, batched over all CIF groups of a
frame, as one program (``fic_program``: a captured CUDA graph on a CUDA
device, one for each number of groups, as the JAX package jits it);
byte-level work stays on the host.

Encode: FIGs -> FIBs + CRC -> scramble -> convolutional encode -> puncture
-> ideal soft bits (numpy, for closed-loop tests and the transmitter).
"""

import functools

import numpy as np
import torch

from ..ops.scrambler import prbs_bytes
from ..ops.crc import crc16, crc16_check
from ..params import fic_puncture_schedule, get_dab_params
from ..params.puncture import build_puncture_mask
from ..ops import viterbi as vit
from ..utils.backend import to_device
from ..utils.graphs import CapturedProgram, as_argument

FIB_BYTES = 32
FIB_DATA_BYTES = 30


@functools.lru_cache(maxsize=None)
def fic_spec() -> vit.ViterbiSpec:
    """The FIC decode plan (one schedule for the 2304-bit FIB groups of
    modes I/II/IV), shared by every FICDecoder."""
    return vit.ViterbiSpec.from_schedule(fic_puncture_schedule())


@functools.lru_cache(maxsize=None)
def _fic_decode_fn():
    """(spec, decode) shared by every FICDecoder and by fleet-level batches:
    decode(soft (G, nb_in) int8 tensor) -> (bits (G, 768), path errors (G,)),
    one Viterbi launch for the G stacked FIB groups, on soft's device."""
    spec = fic_spec()
    return spec, lambda soft: vit.viterbi_decode(soft, spec)


def fic_program(device, cuda_graph=None) -> CapturedProgram:
    """The FIC decode on `device` as a program (``utils/graphs.py``; see
    there for cuda_graph): soft (G, nb_in) int8, a numpy array or a tensor
    -> (bits (G, 768), path errors (G,)), one graph for each G. Its outputs
    are valid until its next call."""
    device = torch.device(device)
    _, decode = _fic_decode_fn()
    return CapturedProgram(
        lambda soft: decode(to_device(soft, device, np.int8)), device,
        cuda_graph=cuda_graph)


class FICDecoder:
    """Soft FIC bits of one frame -> list of CRC-valid 30-byte FIB payloads.
    cuda_graph: see ``fic_program``."""

    def __init__(self, transmission_mode: int, device: torch.device,
                 cuda_graph=None):
        self.dab = get_dab_params(transmission_mode)
        if self.dab.nb_fib_cif_bits != 2304:
            raise NotImplementedError(
                "puncture schedule known for 2304-bit FIB groups (modes I/II/IV)")
        self.spec = fic_spec()
        self.nb_groups = self.dab.nb_cifs
        self.device = torch.device(device)
        self.cuda_graph = cuda_graph
        self._program = fic_program(self.device, cuda_graph)

    def __getstate__(self):
        return {"dab": self.dab, "nb_groups": self.nb_groups,
                "device": str(self.device), "cuda_graph": self.cuda_graph}

    def __setstate__(self, state):
        self.dab = state["dab"]
        self.nb_groups = state["nb_groups"]
        self.device = torch.device(state["device"])
        self.spec = fic_spec()
        self.cuda_graph = state.get("cuda_graph")
        self._program = fic_program(self.device, self.cuda_graph)

    def to(self, device) -> "FICDecoder":
        if torch.device(device) != self.device:
            self.device = torch.device(device)
            self._program = fic_program(self.device, self.cuda_graph)
        return self

    def decode_fic(self, fic_soft_bits: np.ndarray):
        """fic_soft_bits: (nb_fic_bits,) int8. Returns (fibs, errors) where
        fibs is a list of CRC-valid FIB data payloads (bytes, 30 each)."""
        groups = as_argument(fic_soft_bits, np.int8).reshape(
            self.nb_groups, -1)
        assert groups.shape[1] == self.spec.nb_in
        bits, path_err = self._program(groups)
        return self.postprocess(bits.cpu().numpy().astype(np.uint8),
                                path_err.cpu().numpy())

    def postprocess(self, bits: np.ndarray, path_err=None):
        """Host half of decode_fic: decoded group bits (G, 768) ->
        (fibs, errors)."""
        data = np.packbits(bits, axis=-1)                # (G, 96)
        prbs = prbs_bytes(data.shape[1])
        data = data ^ prbs[None, :]

        fibs, crc_errors = [], 0
        for g in range(bits.shape[0]):
            group = data[g]
            for k in range(self.dab.nb_fibs_per_cif):
                fib = group[k * FIB_BYTES:(k + 1) * FIB_BYTES]
                if crc16_check(fib):
                    fibs.append(bytes(fib[:FIB_DATA_BYTES]))
                else:
                    crc_errors += 1
        return fibs, {"crc_errors": crc_errors, "viterbi_error": path_err}


class FICEncoder:
    """Inverse path: FIB payloads -> one frame of ideal FIC soft bits."""

    def __init__(self, transmission_mode: int = 1):
        self.dab = get_dab_params(transmission_mode)
        self.mask = build_puncture_mask(fic_puncture_schedule())

    def encode_fib_payload(self, payload: bytes) -> np.ndarray:
        """Pad a FIG byte string to 30 bytes (0xFF delimiter + zeros), append
        CRC16; returns the 32-byte FIB."""
        buf = bytearray(payload)
        if len(buf) > FIB_DATA_BYTES:
            raise ValueError("FIB payload too long")
        if len(buf) < FIB_DATA_BYTES:
            buf.append(0xFF)
            buf.extend(b"\x00" * (FIB_DATA_BYTES - len(buf)))
        c = crc16(bytes(buf))
        buf += bytes([(c >> 8) & 0xFF, c & 0xFF])
        return np.frombuffer(bytes(buf), dtype=np.uint8)

    def encode_fic(self, fib_payloads) -> np.ndarray:
        """List of nb_fibs FIG byte strings -> (nb_fic_bits,) int8 soft bits."""
        assert len(fib_payloads) == self.dab.nb_fibs
        per_cif = self.dab.nb_fibs_per_cif
        out = []
        for g in range(self.dab.nb_cifs):
            group = np.concatenate([
                self.encode_fib_payload(fib_payloads[g * per_cif + k])
                for k in range(per_cif)])
            group = group ^ prbs_bytes(group.shape[0])
            bits = np.unpackbits(group)
            coded = vit.conv_encode(bits)
            tx = vit.puncture(coded, self.mask)
            out.append(vit.bits_to_soft(tx))
        return np.concatenate(out)
