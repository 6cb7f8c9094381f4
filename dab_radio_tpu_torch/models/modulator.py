"""OFDM modulator (port of ``dab_radio_tpu/models/modulator.py``, the
modulate path).

QPSK-map logical bits, frequency-interleave onto physical carriers,
accumulate the differential phase across symbols (``torch.cumprod`` over
the symbol axis, where the JAX package uses an associative scan), batched
IFFT, cyclic prefix by concatenation.

Bit convention: input bits are in the demodulator output order: for data
symbol s, bits[s, i] is b0 and bits[s, i + ncarriers] is b1 of logical
carrier i, so modulate -> demodulate -> hard decision is the identity.
"""

import numpy as np
import torch

from dab_radio_tpu.params import get_ofdm_params, get_prs_reference
from dab_radio_tpu.params.mapper import get_carrier_mapper, get_carrier_to_fft_bin


class OFDMModulator:
    def __init__(self, transmission_mode: int = 1,
                 device: torch.device = torch.device("cpu")):
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

    def modulate_frame(self, bits) -> torch.Tensor:
        """bits: (..., S-1, 2*ncarriers) or (..., (S-1)*2*ncarriers) 0/1.
        Returns (..., nb_frame_samples) complex64: NULL + PRS + data symbols."""
        p = self.params
        ncarr = p.nb_data_carriers
        s_data = p.nb_data_symbols
        bits = torch.as_tensor(bits, device=self.device)
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
        spec_slots = torch.cumprod(torch.cat([prs, q_slots], dim=-2), dim=-2)

        # scatter slots into FFT bins
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
