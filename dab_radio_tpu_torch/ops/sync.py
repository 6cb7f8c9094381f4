"""OFDM synchronisation ops (port of ``dab_radio_tpu/ops/sync.py``):
null-dip frame search, coarse integral CFO, fine (fractional) CFO from the
cyclic prefix, and PRS matched-filter fine time sync.

Each op evaluates its metric over a whole block and selects offsets with
argmax/where, batched over any leading dims. ``torch.argmax`` returns the
first maximal index, as ``jnp.argmax`` does; boolean masks are cast to
int32 before it.
"""

import numpy as np
import torch

from .pll import apply_pll


def l1_average(x: torch.Tensor) -> torch.Tensor:
    """Mean L1 magnitude |re|+|im| over the trailing axis."""
    return torch.mean(x.real.abs() + x.imag.abs(), dim=-1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def find_null_dip(block: torch.Tensor, l1_avg, *, nb_block: int = 100,
                  thresh_start: float = 0.35, thresh_end: float = 0.75):
    """Block-parallel null-symbol power-dip search.

    block: (..., N) complex64. Returns (found (...,) bool, end_index (...,)
    int32), end_index being the sample index just past the dip."""
    n = block.shape[-1]
    m = n // nb_block
    chunks = block[..., : m * nb_block].reshape(*block.shape[:-1], m, nb_block)
    l1 = l1_average(chunks)                                   # (..., m)
    l1_avg = torch.as_tensor(l1_avg, dtype=torch.float32, device=block.device)
    below = l1 < (l1_avg[..., None] * thresh_start)
    above = l1 > (l1_avg[..., None] * thresh_end)

    start_found = below.any(dim=-1)
    i0 = _first_true(below)
    after = above & (torch.arange(m, device=block.device) > i0[..., None])
    end_found = after.any(dim=-1)
    j0 = _first_true(after)
    found = start_found & end_found
    end_index = ((j0 + 1) * nb_block).to(torch.int32)
    return found, end_index


def _relative_phase(spectrum: torch.Tensor) -> torch.Tensor:
    """conj(z_i) * z_{i+1} per bin, zero in the last slot."""
    d = torch.conj(spectrum[..., :-1]) * spectrum[..., 1:]
    return torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)


def make_prs_time_correlation_ref(prs_fft: np.ndarray) -> np.ndarray:
    """Precompute conj(IFFT(relative_phase(PRS))) used by coarse CFO sync
    (numpy, built once per mode like the JAX constant)."""
    d = np.conj(prs_fft[:-1]) * prs_fft[1:]
    d = np.concatenate([d, np.zeros(1, dtype=prs_fft.dtype)])
    return np.conj(np.fft.ifft(d)).astype(np.complex64)


def coarse_freq_estimate(prs_rx: torch.Tensor, prs_time_ref: torch.Tensor,
                         nb_fft: int, max_offset_norm: float = 0.5):
    """Integral CFO estimate by correlating relative-phase spectra.

    prs_rx: (..., nb_fft) received PRS samples. Returns the predicted coarse
    offset normalised to the sample rate (3-point magnitude-weighted lerp
    around the correlation peak)."""
    spec = torch.fft.fft(prs_rx)
    rel = _relative_phase(spec)
    td = torch.fft.ifft(rel) * prs_time_ref
    corr = torch.fft.fft(td)
    mag = corr.abs()                                          # (..., nb_fft)
    m = nb_fft // 2
    # fftshift so index i corresponds to bin offset (i - m)
    mag_s = torch.fft.fftshift(mag, dim=-1)
    max_off = min(int(max_offset_norm * nb_fft), m)
    window = mag_s[..., m - max_off: m + max_off + 1]
    peak = torch.argmax(window, dim=-1).to(torch.int32)       # offset+max_off

    def at(k):
        kc = torch.clamp(k, 0, window.shape[-1] - 1).to(torch.int64)
        return torch.gather(window, -1, kc[..., None])[..., 0]

    w_m1, w_0, w_p1 = at(peak - 1), at(peak), at(peak + 1)
    idx = peak.to(torch.float32) - max_off
    num = (w_m1 * (idx - 1) + w_0 * idx + w_p1 * (idx + 1))
    den = w_m1 + w_0 + w_p1
    lerp = num / torch.clamp(den, min=1e-20)
    return -lerp / nb_fft


def coarse_freq_update(pred, freq_coarse, is_found, nb_fft: int,
                       slow_beta: float = 0.1):
    """Slow/fast blend of the coarse estimate: large corrections (or the
    first lock) apply instantly, sub-bin corrections move slowly. Returns
    (new_coarse, delta)."""
    err = pred - freq_coarse
    large = err.abs() > (1.5 / nb_fft)
    fast = large | ~is_found
    beta = torch.where(fast, 1.0, slow_beta).to(torch.float32)
    delta = beta * err
    return freq_coarse + delta, delta


def fine_time_offset(prs_rx: torch.Tensor, prs_fft_conj: torch.Tensor,
                     freq_offset, nb_fft: int, nb_cyclic_prefix: int,
                     nb_symbol_period: int,
                     peak_threshold_db: float = 20.0,
                     distance_probability: float = 0.15):
    """PRS matched filter: returns (offset, sync_ok, impulse_db).

    offset is relative to the nominal PRS start; sync_ok is False when the
    weighted peak is less than peak_threshold_db above the mean."""
    x = apply_pll(prs_rx, freq_offset)
    spec = torch.fft.fft(x)
    corr = torch.fft.ifft(spec * prs_fft_conj)
    imp_db = 20.0 * torch.log10(torch.clamp(corr.abs(), min=1e-20))

    i = torch.arange(nb_fft, dtype=torch.float32, device=prs_rx.device)
    dist = (i - float(nb_cyclic_prefix)).abs() / float(nb_symbol_period)
    prob = 1.0 - (1.0 - distance_probability) * dist
    weighted = prob * imp_db

    peak_idx = torch.argmax(weighted, dim=-1)
    peak_val = torch.gather(weighted, -1, peak_idx[..., None])[..., 0]
    avg = torch.mean(imp_db, dim=-1)
    sync_ok = (peak_val - avg) >= peak_threshold_db
    offset = peak_idx.to(torch.int32) - nb_cyclic_prefix
    return offset, sync_ok, imp_db


def cyclic_phase_error(symbols: torch.Tensor, nb_fft: int,
                       nb_cyclic_prefix: int):
    """Fractional CFO metric from the cyclic prefix: arg(sum tail *
    conj(prefix)) per symbol, averaged over the symbols.

    symbols: (..., S, nb_symbol_period). Returns (...,)."""
    prefix = symbols[..., :nb_cyclic_prefix]
    tail = symbols[..., nb_fft: nb_fft + nb_cyclic_prefix]
    v = torch.sum(tail * torch.conj(prefix), dim=-1)
    err = torch.atan2(v.imag, v.real)                         # (..., S)
    return torch.sum(err, dim=-1) / symbols.shape[-2]


def fine_freq_error(cyclic_err, nb_fft: int):
    """Phase error -> normalised frequency error."""
    return (1.0 / nb_fft) * cyclic_err / (2.0 * np.pi)


def wrap_fine_offset(freq_fine, nb_fft: int):
    """Keep the fine offset within half an FFT bin (1% margin), removing
    whole carrier spacings only (round to the nearest bin)."""
    bound = 0.5 * (1.0 / nb_fft) * 1.01
    wrapped = freq_fine - torch.round(freq_fine * nb_fft) * (1.0 / nb_fft)
    return torch.where(freq_fine.abs() > bound, wrapped, freq_fine)
