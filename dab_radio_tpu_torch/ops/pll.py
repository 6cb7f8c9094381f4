"""Frequency-shift (PLL) mixing (port of ``dab_radio_tpu/ops/pll.py``).

y(t) = x(t) * e^{j 2 pi f (t0 + t)} with f normalised to the sample rate.
The phase is formed in float32 in the same order as the JAX op,
2*pi * (f * (t + t0)), because t reaches ~2e5 samples and a different
rounding order moves the demodulated soft bits.
"""

import math

import torch

TWO_PI = 2.0 * math.pi


def apply_pll(x: torch.Tensor, freq_norm, t0=0.0) -> torch.Tensor:
    """Mix x (..., N) complex64 by normalised frequency freq_norm
    (broadcastable leading dims), starting at sample offset t0."""
    n = x.shape[-1]
    dev = x.device
    t = torch.arange(n, dtype=torch.float32, device=dev)
    f = torch.as_tensor(freq_norm, dtype=torch.float32, device=dev)
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    phase = TWO_PI * (f[..., None] * (t + t0[..., None]))
    return x * torch.polar(torch.ones_like(phase), phase)
