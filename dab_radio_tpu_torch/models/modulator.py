"""OFDM modulator (port of ``dab_radio_tpu/models/modulator.py``).

QPSK-map logical bits, frequency-interleave onto physical carriers,
accumulate the differential phase across symbols (``torch.cumprod`` over
the symbol axis, where the JAX package uses an associative scan), batched
IFFT, cyclic prefix by concatenation: one program (a captured CUDA graph on
a CUDA device) a call. ``modulate_reference_bytes`` gives the reference
transmitter's byte contract (bytes straight onto physical carriers) for the
simulate_transmitter app.

Bit convention: input bits are in the demodulator output order: for data
symbol s, bits[s, i] is b0 and bits[s, i + ncarriers] is b1 of logical
carrier i, so modulate -> demodulate -> hard decision is the identity.
"""

import numpy as np
import torch

from ..params import get_ofdm_params, get_prs_reference
from ..params.mapper import get_carrier_mapper, get_carrier_to_fft_bin
from ..utils.graphs import CapturedProgram


class OFDMModulator:
    """The modulator on `device`. cuda_graph (``utils/graphs.py``): None
    runs ``modulate_frame`` and ``modulate_reference_bytes`` as captured
    CUDA graphs on a CUDA device, one for each input shape (the JAX
    package jits its frame modulation), and eagerly on the CPU; True asks
    for the capture, False is the eager path. The results are the same
    either way and are the caller's own."""

    def __init__(self, transmission_mode: int, device: torch.device,
                 cuda_graph=None):
        self.params = p = get_ofdm_params(transmission_mode)
        self.device = dev = torch.device(device)
        prs_fft = get_prs_reference(transmission_mode, p.nb_fft)
        carrier_map = get_carrier_mapper(p.nb_fft, p.nb_data_carriers)
        carrier_bins = get_carrier_to_fft_bin(p.nb_fft, p.nb_data_carriers)
        inv = np.empty(p.nb_data_carriers, dtype=np.int64)
        inv[carrier_map] = np.arange(p.nb_data_carriers)
        # logical carrier i -> physical slot map[i], as a gather
        self.inv_map = torch.as_tensor(inv, device=dev)
        self.carrier_bins = torch.as_tensor(carrier_bins, dtype=torch.int64,
                                            device=dev)
        # PRS spectrum restricted to the data-carrier slots (phase seed)
        self.prs_slots = torch.as_tensor(
            prs_fft[carrier_bins].astype(np.complex64), device=dev)
        # the reference byte contract's QPSK points, by 2-bit value
        amp = 1.0 / np.sqrt(2.0)
        self._phase_map = torch.as_tensor(np.array(
            [-amp - 1j * amp, amp - 1j * amp, amp + 1j * amp,
             -amp + 1j * amp], np.complex64), device=dev)
        self._shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
        self._bits_program = CapturedProgram(self._modulate_bits, dev,
                                             cuda_graph=cuda_graph)
        self._bytes_program = CapturedProgram(self._modulate_bytes, dev,
                                              cuda_graph=cuda_graph)

    def _call(self, program: CapturedProgram, x) -> torch.Tensor:
        """program(x): a captured program takes numpy as it is (it stages
        it) and its output is copied out of the graph's buffer; an eager
        one takes x as a tensor on the device."""
        if program.captured:
            return program(x if torch.is_tensor(x) else np.asarray(x)).clone()
        return program(torch.as_tensor(x, device=self.device))

    def modulate_frame(self, bits) -> torch.Tensor:
        """bits: (..., S-1, 2*ncarriers) or (..., (S-1)*2*ncarriers) 0/1.
        Returns (..., nb_frame_samples) complex64: NULL + PRS + data symbols."""
        return self._call(self._bits_program, bits)

    def _modulate_bits(self, bits: torch.Tensor) -> torch.Tensor:
        p = self.params
        ncarr = p.nb_data_carriers
        s_data = p.nb_data_symbols
        if bits.shape[-1] == s_data * 2 * ncarr:
            bits = bits.reshape(*bits.shape[:-1], s_data, 2 * ncarr)
        assert tuple(bits.shape[-2:]) == (s_data, 2 * ncarr), bits.shape

        b0 = bits[..., :ncarr].to(torch.float32)
        b1 = bits[..., ncarr:].to(torch.float32)
        amp = 1.0 / np.sqrt(2.0)
        q_logical = torch.complex(1.0 - 2.0 * b0, 1.0 - 2.0 * b1) * amp

        q_slots = q_logical[..., self.inv_map]                # (..., S-1, ncarr)

        # differential accumulation: sym_k = PRS * prod_{m<=k} q_m
        prs = self.prs_slots.expand(*q_slots.shape[:-2], 1, ncarr)
        return self._frame(torch.cumprod(torch.cat([prs, q_slots], dim=-2),
                                         dim=-2))

    def _frame(self, spec_slots: torch.Tensor) -> torch.Tensor:
        """(..., S, ncarr) carrier slots -> (..., nb_frame_samples): the
        slots into their FFT bins, IFFT, cyclic prefix, NULL in front."""
        p = self.params
        spec = torch.zeros((*spec_slots.shape[:-1], p.nb_fft),
                           dtype=torch.complex64, device=self.device)
        spec[..., self.carrier_bins] = spec_slots

        td = torch.fft.ifft(spec) * p.nb_fft                  # unnormalised
        sym = torch.cat([td[..., -p.nb_cyclic_prefix:], td], dim=-1)
        body = sym.reshape(*sym.shape[:-2],
                           p.nb_frame_symbols * p.nb_symbol_period)
        null = torch.zeros((*body.shape[:-1], p.nb_null_period),
                           dtype=torch.complex64, device=self.device)
        return torch.cat([null, body], dim=-1)

    def modulate_stream(self, frames_bits) -> torch.Tensor:
        """(F, S-1, 2*ncarr) bits -> concatenated multi-frame IQ stream."""
        return self.modulate_frame(frames_bits).reshape(-1)

    def modulate_reference_bytes(self, data) -> np.ndarray:
        """Reference byte contract (ofdm_modulator.cpp CreateDataSymbol):
        2-bit groups map directly onto physical carriers, the first half of
        each symbol's bytes fill the negative frequencies. For the
        simulate_transmitter app: the gather onto the phase map, the
        differential phase and the IFFT run on the modulator's device;
        returns one frame of IQ as numpy complex64."""
        p = self.params
        data = np.asarray(data, dtype=np.uint8).reshape(
            p.nb_data_symbols, p.nb_data_carriers * 2 // 8)
        return self._call(self._bytes_program, data).cpu().numpy()

    def _modulate_bytes(self, data: torch.Tensor) -> torch.Tensor:
        pairs = ((data[..., None] >> self._shifts) & 0b11).reshape(
            data.shape[0], -1).to(torch.int64)
        q = self._phase_map[pairs]                            # (S-1, ncarr)
        # slots ordered negative-then-positive == carrier_bins layout
        return self._frame(torch.cumprod(torch.cat([self.prs_slots[None], q]),
                                         dim=0))
