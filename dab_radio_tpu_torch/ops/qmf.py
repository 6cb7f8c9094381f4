"""SBR QMF filterbanks (ISO/IEC 14496-3 4.6.18.4) as dense matrix transforms.

The reference gets these from faad2's sbr_qmf.c; here both banks are
expressed as (windowed fold) @ (complex exponential matrix) products — the
shape of a batched matrix product. NumPy runs on the host (per-AU work is
tiny); only matmul, reshape and strided adds are used. A copy of
``dab_radio_tpu/ops/qmf.py``.

Conventions (validated to perfect reconstruction, then differentially
against libavcodec's HE-AAC@1024 SBR decode):
- Analysis (32-band, core rate): sliding 320-sample newest-first window x,
  z = x * c_ds; u[n] = sum_j z[n+64j]; W[k] = sum_n u[n] e^{j pi/64 (k+0.5)(2n-1)}.
- Synthesis (64-band, 2x rate): the adjoint operator with a one-half-slot
  band phase alignment: u[n] = Re sum_k X[k] e^{-j pi/64 (k+0.5)(n-1)},
  overlap-added through the 640-tap window, 64 samples out per slot.
  The measured pass-band chain gain is normalized to exactly 1.
"""

import numpy as np

from ..dab import aac_tables as T


def _analysis_mats():
    c = T.sbr_qmf_window(downsampled=True).astype(np.float64)  # 320 taps
    n = np.arange(64)
    k = np.arange(32)
    M = np.exp(1j * np.pi / 64.0 * (k[None, :] + 0.5)
               * (2.0 * n[:, None] - 1.0))
    return c, M


def _synthesis_mats():
    c = T.sbr_qmf_window(downsampled=False).astype(np.float64)  # 640 taps
    n = np.arange(128)
    k = np.arange(64)
    # adjoint of the 64-band analysis convention, plus the half-slot phase
    # that time-aligns the 32-band analysis with the 64-band synthesis
    M = np.exp(-1j * np.pi / 64.0 * (k[:, None] + 0.5) * (n[None, :] - 1.0))
    return c, M


# chain gain of analysis->synthesis measured on pass-band noise; divides the
# synthesis so the low-band passthrough is exactly unity
_CHAIN_GAIN = None


def _chain_gain() -> float:
    global _CHAIN_GAIN
    if _CHAIN_GAIN is None:
        rng = np.random.default_rng(12345)
        n = 32 * 160
        x2 = rng.standard_normal(n * 2)
        X2 = np.fft.rfft(x2)
        f2 = np.fft.rfftfreq(len(x2), 0.5)        # cycles per input sample
        X2[f2 > 0.2] = 0                          # pass-band only
        x = np.fft.irfft(X2)[::2][:n]
        up = np.fft.irfft(np.concatenate(
            [np.fft.rfft(x), np.zeros(n // 2)])) * 2
        a = AnalysisQMF()
        W = a.process(x)
        X = np.zeros((W.shape[0], 64), np.complex128)
        X[:, :32] = W
        s = SynthesisQMF(_normalize=False)
        y = s.process(X)
        # chain delay: 640-sample synthesis window end-aligned, minus the
        # 62-sample analysis/synthesis offset (measured, fixed)
        best, bd = 0.0, 0
        for d in range(500, 700):
            b = up[4000 - d:4000 - d + 4000]
            c = float(np.dot(y[4000:8000], b))
            if abs(c) > abs(best):
                best, bd = c, d
        b = up[4000 - bd:4000 - bd + 4000]
        aa = y[4000:8000]
        _CHAIN_GAIN = float(np.dot(aa, aa) / np.dot(b, aa))
    return _CHAIN_GAIN


class AnalysisQMF:
    """32-band analysis; carries the 288-sample window tail across calls."""

    def __init__(self):
        self.c, self.M = _analysis_mats()
        self.hist = np.zeros(288, np.float64)

    def process(self, pcm: np.ndarray) -> np.ndarray:
        """pcm: (n_slots*32,) float; returns (n_slots, 32) complex128."""
        pcm = np.asarray(pcm, np.float64)
        n_slots = pcm.shape[0] // 32
        arr = np.concatenate([self.hist, pcm])
        # frame l = arr[32l .. 32l+319] newest-first (ends at 287+32(l+1))
        frames = np.lib.stride_tricks.sliding_window_view(arr, 320)[0::32]
        frames = frames[:n_slots, ::-1]
        z = frames * self.c
        u = z.reshape(n_slots, 5, 64).sum(axis=1)
        self.hist = arr[-288:].copy()
        return u @ self.M


class SynthesisQMF:
    """64-band synthesis; carries the 576-sample overlap-add tail."""

    def __init__(self, _normalize: bool = True):
        self.c, self.M = _synthesis_mats()
        self.carry = np.zeros(576, np.float64)
        self.scale = 1.0 / _chain_gain() if _normalize else 1.0

    def process(self, X: np.ndarray) -> np.ndarray:
        """X: (n_slots, 64) complex; returns (n_slots*64,) float64 at the
        2x (SBR output) rate."""
        X = np.asarray(X, np.complex128)
        n_slots = X.shape[0]
        u = (X @ self.M).real                       # (n_slots, 128)
        z = np.tile(u, (1, 5)) * self.c             # (n_slots, 640)
        rev = z[:, ::-1] * self.scale
        out = np.zeros(n_slots * 64 + 576, np.float64)
        out[:576] = self.carry
        for j in range(10):
            out[j * 64: j * 64 + n_slots * 64] += \
                rev[:, j * 64:(j + 1) * 64].reshape(-1)
        self.carry = out[n_slots * 64:].copy()
        return out[:n_slots * 64]
