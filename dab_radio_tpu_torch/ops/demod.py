"""OFDM frame-body demodulation (port of ``dab_radio_tpu/ops/demod.py``):
batched FFT, differential QPSK, frequency deinterleave, soft-bit demap.

The whole frame is one (S, nfft) batched ``torch.fft.fft`` and the DQPSK
halo is fft[1:] * conj(fft[:-1]) against the previous symbol.
"""

import torch

from .pll import apply_pll

SOFT_HIGH = 127.0


def demod_frame_body(body: torch.Tensor, freq_offset, *, nb_fft: int,
                     nb_symbol_period: int, nb_frame_symbols: int,
                     nb_cyclic_prefix: int, carrier_bins: torch.Tensor,
                     carrier_map: torch.Tensor, symbol_chunk: int = 0):
    """Demodulate one aligned frame body.

    body: (..., nb_frame_symbols * nb_symbol_period) complex64 starting at
    the PRS. freq_offset: (...,) normalised CFO correction (coarse + fine).
    carrier_bins, carrier_map: int64 index tensors on body's device.

    Returns (soft_bits (..., (S-1) * ncarriers * 2) int8,
             mean_cyclic_phase_error (...,),
             fft_frame (..., S, nb_fft))."""
    ncarr = carrier_map.shape[0]
    s = nb_frame_symbols

    # continuous-phase CFO correction across the whole frame body
    x = apply_pll(body, freq_offset)
    syms = x.reshape(*x.shape[:-1], s, nb_symbol_period)

    # fractional-CFO metric from the cyclic prefix, averaged over symbols
    prefix = syms[..., :nb_cyclic_prefix]
    tail = syms[..., nb_fft: nb_fft + nb_cyclic_prefix]
    v = torch.sum(tail * torch.conj(prefix), dim=-1)
    cyclic_err = torch.atan2(v.imag, v.real)
    mean_cyclic_err = torch.sum(cyclic_err, dim=-1) / s

    # cyclic prefix removal + batched FFT; symbol_chunk > 0 transforms the
    # symbol axis in chunks of that many symbols (bounds the working set)
    data = syms[..., nb_cyclic_prefix:]
    if symbol_chunk and s % symbol_chunk == 0:
        fft = torch.cat([torch.fft.fft(c) for c in
                         torch.split(data, symbol_chunk, dim=-2)], dim=-2)
    else:
        fft = torch.fft.fft(data)                             # (..., S, nfft)

    # differential demod between consecutive symbols, PRS as phase
    # reference: conj(sym_k+1) * sym_k pairs with the b0=-re, b1=+im demap
    dq = torch.conj(fft[..., 1:, :]) * fft[..., :-1, :]       # (..., S-1, nfft)
    vec = dq[..., carrier_bins]                               # (..., S-1, ncarr)

    # L-inf normalised QPSK soft demap
    deint = vec[..., carrier_map]                             # logical order
    re, im = deint.real, deint.imag
    a = torch.maximum(re.abs(), im.abs())
    a = torch.clamp(a, min=1e-20)
    b0 = -re / a * SOFT_HIGH
    b1 = im / a * SOFT_HIGH
    bits = torch.cat([b0, b1], dim=-1)                        # (..., S-1, 2*ncarr)
    # C-style float->int8 cast truncates toward zero
    bits = torch.clamp(torch.trunc(bits), -127, 127).to(torch.int8)
    return (bits.reshape(*bits.shape[:-2], (s - 1) * ncarr * 2),
            mean_cyclic_err, fft)
