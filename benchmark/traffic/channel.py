"""The channel of the captures, on the device: a carrier offset, AWGN at a
signal-to-noise ratio, and 8-bit quantisation as rtl_sdr writes it
(127.5 + 127.5 x, I and Q interleaved). The same steps as the port's
``chip_smoke.py:make_capture``, drawn from a ``torch.Generator``."""

import math

import torch


def apply(iq: torch.Tensor, cfo_bins: float, snr_db: float, nb_fft: int,
          generator: torch.Generator) -> torch.Tensor:
    """(N,) complex64 -> (2N,) uint8 on iq's device. The carrier offset is
    cfo_bins carrier spacings (nb_fft samples a spacing); its phase is
    formed in float64 and reduced to a turn before the rotation."""
    n = torch.arange(iq.shape[0], dtype=torch.float64, device=iq.device)
    turns = torch.remainder(n * (cfo_bins / nb_fft), 1.0)
    rot = torch.polar(torch.ones_like(turns), 2 * math.pi * turns)
    x = iq.to(torch.complex128) * rot
    p_sig = torch.mean(x.abs() ** 2)
    std = torch.sqrt(p_sig / 10 ** (snr_db / 10) / 2)
    noise = torch.randn((2, iq.shape[0]), dtype=torch.float64,
                        device=iq.device, generator=generator)
    x = x + std * torch.complex(noise[0], noise[1])
    x = (x / x.abs().max() * 0.5).to(torch.complex64)
    u = torch.view_as_real(x).reshape(-1) * 127.5 + 127.5
    return torch.clamp(u, 0, 255).to(torch.uint8)
