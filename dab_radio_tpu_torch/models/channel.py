"""Propagation channel models for closed-loop TX -> RX stress tests.

The reference stresses its demodulator only with manual CFO shifts
(`examples/apply_frequency_shift.cpp`) and live captures; it has no channel
simulator. This module is net-new capability: a tapped-delay-line (TDL)
multipath/SFN model with optional Rayleigh tap fading, a continuous
sample-clock drift (ppm) resampler, CFO, and AWGN — the impairments that the
demodulator's fine-time matched filter (reference
src/ofdm/ofdm_demodulator.cpp:473-548 is the analogous surface), coarse/fine
frequency loops, and the serving layer's drift re-anchor actually face on
real broadcasts.

Everything is host-side NumPy: the channel runs once per test/sweep on the
TX output, not in the jitted receive path.

Components
----------
- ``EchoTap``: one TDL tap — fractional-sample delay, gain, static phase,
  optional Jakes-spectrum Rayleigh fading with a given Doppler.
- ``ChannelModel``: composes taps -> CFO -> clock drift -> AWGN. The tap
  convolution uses a shared windowed-sinc fractional-delay kernel; the drift
  resampler evaluates the same kernel at continuously advancing fractional
  positions (an output clock running at ``1 + ppm*1e-6`` times the input
  clock — exactly what a mis-trimmed SDR crystal does).
- ``parse_echo_spec``: CLI grammar ``delay_us:gain_db[:doppler_hz[:rayleigh]]``
  used by ber_sweep / simulate_transmitter.

Typical SFN scenarios (mode I, 2.048 MHz, guard = 504 samples = 246 us):
  in-guard echo       EchoTap(delay_us=100, gain_db=-3)
  guard-edge echo     EchoTap(delay_us=240, gain_db=-3)
  beyond-guard echo   EchoTap(delay_us=350, gain_db=-8)
  mobile Rayleigh     EchoTap(delay_us=5, gain_db=-1, doppler_hz=40,
                              rayleigh=True)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..params.ofdm import SAMPLE_RATE_HZ

# Fractional-delay / resampler kernel: 16-tap Kaiser-windowed sinc. At DAB's
# 1.536 MHz occupied bandwidth on a 2.048 MHz clock (0.75 Nyquist) this keeps
# interpolation images ~60 dB down — far below the AWGN floors the sweeps
# operate at; linear interpolation would alias at ~-25 dB and dominate the
# high-SNR BER floor.
_KERNEL_TAPS = 16
_KAISER_BETA = 8.0


def _frac_delay_kernel(frac: np.ndarray) -> np.ndarray:
    """Windowed-sinc interpolation weights.

    frac: (...,) fractional positions in [0, 1). Returns (..., _KERNEL_TAPS)
    weights such that  y = sum_k w[k] * x[i0 + k]  interpolates x at position
    i0 + (_KERNEL_TAPS // 2 - 1) + frac.
    """
    frac = np.asarray(frac, np.float64)
    k = np.arange(_KERNEL_TAPS, dtype=np.float64)
    centre = _KERNEL_TAPS // 2 - 1
    t = k[None, :] - (centre + frac[..., None])  # sample offsets from target
    w = np.sinc(t)
    # Kaiser window evaluated at the *shifted* positions so the window tracks
    # the interpolation point (polyphase-consistent: frac=0 reproduces x).
    x = t / (_KERNEL_TAPS / 2)
    x = np.clip(x, -1.0, 1.0)
    win = np.i0(_KAISER_BETA * np.sqrt(1.0 - x * x)) / np.i0(_KAISER_BETA)
    w = w * win
    return (w / w.sum(axis=-1, keepdims=True)).astype(np.float64)


def _interp_at(x: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Evaluate complex signal x at fractional sample positions pos.

    Positions outside the valid support are zero-filled. Block-processed so
    the (N, 16) gather never materialises more than ~8 MB at a time.
    """
    n = x.shape[0]
    centre = _KERNEL_TAPS // 2 - 1
    out = np.empty(pos.shape, np.complex64)
    block = 1 << 16
    for s in range(0, pos.shape[0], block):
        p = pos[s:s + block]
        i0 = np.floor(p).astype(np.int64) - centre
        frac = p - np.floor(p)
        w = _frac_delay_kernel(frac)
        idx = i0[:, None] + np.arange(_KERNEL_TAPS)[None, :]
        valid = (idx >= 0) & (idx < n)
        xv = np.where(valid, x[np.clip(idx, 0, n - 1)], 0)
        out[s:s + block] = (xv * w).sum(axis=-1).astype(np.complex64)
    return out


@dataclass(frozen=True)
class EchoTap:
    """One tapped-delay-line path relative to the (implicit) direct path."""
    delay_us: float
    gain_db: float
    phase_deg: float = 0.0
    doppler_hz: float = 0.0     # >0 => time-varying tap
    rayleigh: bool = False      # Jakes-spectrum complex Gaussian fading

    @property
    def amplitude(self) -> float:
        return float(10.0 ** (self.gain_db / 20.0))


def _jakes_gains(n: int, doppler_hz: float, sample_rate: float,
                 rng: np.random.Generator, nb_sinusoids: int = 8,
                 step: int = 128) -> np.ndarray:
    """Unit-mean-power Rayleigh tap gain process, Jakes Doppler spectrum.

    Sum-of-sinusoids: g(t) = sqrt(1/M) * sum_m exp(j(2*pi*fd*cos(a_m)*t+p_m)).
    Evaluated every `step` samples and linearly interpolated — the coherence
    time at any DAB-relevant Doppler (<=500 Hz) spans thousands of samples,
    so the decimated evaluation is exact to float precision for this use.
    """
    alpha = rng.uniform(0, 2 * np.pi, nb_sinusoids)
    phi = rng.uniform(0, 2 * np.pi, nb_sinusoids)
    freqs = doppler_hz * np.cos(alpha)            # per-sinusoid Doppler (Hz)
    t_knots = np.arange(0, n + step, step, dtype=np.float64) / sample_rate
    ph = 2 * np.pi * freqs[None, :] * t_knots[:, None] + phi[None, :]
    g_knots = np.exp(1j * ph).sum(axis=1) / np.sqrt(nb_sinusoids)
    t = np.arange(n, dtype=np.float64) / step
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    g = g_knots[i0] * (1 - frac) + g_knots[i0 + 1] * frac
    return g.astype(np.complex64)


@dataclass
class ChannelModel:
    """TDL multipath + CFO + sample-clock drift + AWGN channel.

    Application order models the physics: multipath acts on the RF waveform,
    the receiver's LO offset (CFO) rotates it, the receiver's ADC clock
    (drift_ppm) resamples it, and receiver noise adds last.

    snr_db is defined against the power of the *faded* signal actually
    reaching the receiver (measured on the input block), matching how the
    ber_sweep calibrates AWGN-only points.
    """
    taps: Sequence[EchoTap] = field(default_factory=list)
    cfo_hz: float = 0.0
    drift_ppm: float = 0.0
    snr_db: float | None = None
    seed: int = 0
    sample_rate: float = float(SAMPLE_RATE_HZ)
    direct_gain_db: float = 0.0     # direct path; set -inf via direct=False
    direct: bool = True
    # measure signal power for the SNR calibration over this [start, stop)
    # slice instead of the whole block — harnesses that pad the signal with
    # silence (acquisition lead, flush tail) would otherwise get a noise
    # floor calibrated against the diluted average power.
    snr_ref: tuple | None = None

    def apply(self, iq: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        x = np.asarray(iq, np.complex64)

        # --- tapped delay line -------------------------------------------
        y = (10.0 ** (self.direct_gain_db / 20.0)) * x if self.direct else \
            np.zeros_like(x)
        for tap in self.taps:
            d = tap.delay_us * 1e-6 * self.sample_rate
            pos = np.arange(x.shape[0], dtype=np.float64) - d
            delayed = _interp_at(x, pos)
            g: np.ndarray | complex = (
                tap.amplitude * np.exp(1j * np.deg2rad(tap.phase_deg)))
            if tap.rayleigh:
                g = g * _jakes_gains(x.shape[0], max(tap.doppler_hz, 1e-3),
                                     self.sample_rate, rng)
            elif tap.doppler_hz:
                # deterministic single-Doppler tap (e.g. a moving reflector)
                t = np.arange(x.shape[0], dtype=np.float64) / self.sample_rate
                g = g * np.exp(2j * np.pi * tap.doppler_hz * t)
            y = y + (delayed * g).astype(np.complex64)

        # --- receiver LO offset ------------------------------------------
        if self.cfo_hz:
            f = self.cfo_hz / self.sample_rate
            y = (y * np.exp(2j * np.pi * f * np.arange(y.shape[0]))
                 ).astype(np.complex64)

        # --- receiver sample-clock drift ---------------------------------
        if self.drift_ppm:
            # ADC clock fast by +ppm => it takes samples *closer together*
            # in signal time: output n reads input position n / (1 + ppm).
            rate = 1.0 + self.drift_ppm * 1e-6
            nb_out = int(np.floor((y.shape[0] - _KERNEL_TAPS) * rate))
            pos = np.arange(nb_out, dtype=np.float64) / rate
            y = _interp_at(y, pos)

        # --- receiver noise ----------------------------------------------
        if self.snr_db is not None:
            ref = y if self.snr_ref is None else \
                y[self.snr_ref[0]:self.snr_ref[1]]
            sig_pow = float(np.mean(np.abs(ref) ** 2))
            noise_std = np.sqrt(sig_pow / 10 ** (self.snr_db / 10) / 2)
            y = (y + rng.normal(0, noise_std, y.shape)
                 + 1j * rng.normal(0, noise_std, y.shape)
                 ).astype(np.complex64)
        return y


def parse_echo_spec(spec: str) -> List[EchoTap]:
    """Parse ``delay_us:gain_db[:doppler_hz[:r]]`` (comma-separated taps)."""
    taps: List[EchoTap] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"echo tap {part!r}: need delay_us:gain_db[:doppler_hz[:r]]")
        delay_us = float(fields[0])
        gain_db = float(fields[1])
        doppler = float(fields[2]) if len(fields) > 2 and fields[2] else 0.0
        rayleigh = len(fields) > 3 and fields[3].lower() in ("r", "rayleigh",
                                                             "1", "true")
        taps.append(EchoTap(delay_us=delay_us, gain_db=gain_db,
                            doppler_hz=doppler, rayleigh=rayleigh))
    return taps
