"""The plain reference of the receiver's synchronisation and demodulation,
in float64 (or, for the control, with every stored value rounded to
bfloat16), written from the DAB standard's PRS and carrier tables.

It follows the semantics the receiver states for each frame: the running
L1 level of the frame window; the coarse (integral) carrier offset from
the PRS's relative-phase correlation with a 3-point lerp, blended fast on
first lock or a jump past 1.5 carrier spacings and slowly (0.1) otherwise;
fine timing from the PRS matched filter, weighted by the distance from the
cyclic prefix and held to a 20 dB peak; a same-frame fine correction past
0.05 spacings; the frame body mixed down, the cyclic-prefix phase error, the
FFT, differential QPSK, frequency deinterleaving and an L-infinity soft
demap to int8 (truncated toward zero); then the fine offset moves by 0.9 of
the measured error, wrapped to half a spacing. Frequencies are normalised
to the sample rate.

A track is a run of frames through one looped capture: "grid" windows at
fixed positions a frame apart (the serving round's fixed read grid), or
"tracked" windows that advance by each frame's timing offset (the
streaming demodulator's read pointer). Many tracks run as one batch.
"""

import math

import numpy as np
import torch

from traffic import standard as S

L1_BETA = 0.95
NULL_BLOCK = 100
COARSE_SLOW_BETA = 0.1
COARSE_FAST_BINS = 1.5
PEAK_DB = 20.0
DISTANCE_PROB = 0.15
FINE_SAMEFRAME_BINS = 0.05
FINE_BETA = 0.9
SOFT = 127.0


class Precision:
    """float64 arithmetic, or ("bf16") float32 arithmetic whose every
    stored tensor is rounded to bfloat16: the control."""

    def __init__(self, name: str):
        self.name = name
        self.real = torch.float64 if name == "f64" else torch.float32
        self.complex = torch.complex128 if name == "f64" else torch.complex64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f64":
            return x
        if x.is_complex():
            r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
            return torch.view_as_complex(r.contiguous())
        if x.is_floating_point():
            return x.to(torch.bfloat16).to(torch.float32)
        return x


class Reference:
    def __init__(self, mode: int, device, precision: str = "f64"):
        self.p = p = S.OFDM_MODES[mode]
        self.dev = torch.device(device)
        self.pr = pr = Precision(precision)
        self.nfft, self.cp = p.nb_fft, p.nb_cyclic_prefix
        self.fs = p.nb_frame_samples
        self.body_len = p.nb_frame_symbols * p.nb_symbol_period
        self.window_len = self.window_len_of(mode)
        prs = S.prs_spectrum(mode).astype(np.complex128)
        self.prs_conj = torch.as_tensor(np.conj(prs), device=self.dev).to(
            pr.complex)
        d = np.conj(prs[:-1]) * prs[1:]
        d = np.concatenate([d, np.zeros(1)])
        self.rel_ref = torch.as_tensor(np.conj(np.fft.ifft(d)),
                                       device=self.dev).to(pr.complex)
        self.bins = torch.as_tensor(S.carrier_bins(mode), device=self.dev)
        self.cmap = torch.as_tensor(S.carrier_map(mode), device=self.dev)
        i = torch.arange(self.nfft, dtype=pr.real, device=self.dev)
        self.weight = 1.0 - (1.0 - DISTANCE_PROB) * (i - self.cp).abs() \
            / p.nb_symbol_period

    @staticmethod
    def window_len_of(mode: int) -> int:
        """Samples a frame's window reads: NULL, the frame's symbols and a
        symbol of timing margin."""
        p = S.OFDM_MODES[mode]
        return p.nb_frame_samples + p.nb_symbol_period

    # ---- pieces of one frame, batched over tracks ----

    def _wrap(self, f):
        n = self.nfft
        wrapped = f - torch.round(f * n) / n
        return torch.where(f.abs() > 0.5 / n * 1.01, wrapped, f)

    def _mix(self, x, freq):
        pr = self.pr
        t = torch.arange(x.shape[-1], dtype=pr.real, device=self.dev)
        ph = 2 * math.pi * (freq[:, None] * t)
        return pr.q(x * pr.q(torch.polar(torch.ones_like(ph), ph)))

    def _coarse(self, prs_rx):
        pr, n = self.pr, self.nfft
        spec = pr.q(torch.fft.fft(prs_rx))
        rel = pr.q(torch.conj(spec[:, :-1]) * spec[:, 1:])
        rel = torch.cat([rel, torch.zeros_like(rel[:, :1])], dim=1)
        corr = pr.q(torch.fft.fft(pr.q(torch.fft.ifft(rel)) * self.rel_ref))
        mag = torch.fft.fftshift(pr.q(corr.abs()), dim=-1)
        peak = torch.argmax(mag, dim=-1)
        at = [torch.gather(mag, 1, torch.clamp(peak + k, 0, n - 1)[:, None])
              [:, 0] for k in (-1, 0, 1)]
        idx = (peak - n // 2).to(pr.real)
        num = at[0] * (idx - 1) + at[1] * idx + at[2] * (idx + 1)
        lerp = pr.q(num / torch.clamp(at[0] + at[1] + at[2], min=1e-20))
        return pr.q(-lerp / n)

    def _timing(self, prs_rx, freq):
        pr = self.pr
        spec = pr.q(torch.fft.fft(self._mix(prs_rx, freq)))
        corr = pr.q(torch.fft.ifft(pr.q(spec * self.prs_conj)))
        imp_db = pr.q(20.0 * torch.log10(torch.clamp(corr.abs(), min=1e-20)))
        weighted = pr.q(self.weight * imp_db)
        peak = torch.argmax(weighted, dim=-1)
        top = torch.gather(weighted, 1, peak[:, None])[:, 0]
        ok = (top - imp_db.mean(dim=-1)) >= PEAK_DB
        offset = torch.clamp(peak - self.cp, -self.cp, self.p.nb_symbol_period)
        return offset, ok

    def _cyclic_error(self, syms):
        pr = self.pr
        v = pr.q(torch.sum(syms[..., self.nfft:] * torch.conj(
            syms[..., :self.cp]), dim=-1))
        err = pr.q(torch.atan2(v.imag, v.real))
        return pr.q(err.mean(dim=-1) / (2 * math.pi * self.nfft))

    def _soft_bits(self, syms):
        pr = self.pr
        fft = pr.q(torch.fft.fft(syms[..., self.cp:]))
        dq = pr.q(torch.conj(fft[:, 1:]) * fft[:, :-1])
        deint = dq[..., self.bins][..., self.cmap]
        re, im = deint.real, deint.imag
        a = torch.clamp(torch.maximum(re.abs(), im.abs()), min=1e-20)
        b = torch.cat([pr.q(-re / a * SOFT), pr.q(im / a * SOFT)], dim=-1)
        return torch.clamp(torch.trunc(b), -127, 127).to(torch.int8).reshape(
            b.shape[0], -1)

    def step(self, carry, windows, want_bits):
        """One frame of every track: carry (coarse, fine, found, l1) ->
        (carry, timing offset, sync_ok, soft bits or None)."""
        pr = self.pr
        coarse, fine, found, l1 = carry
        p = self.p
        windows = pr.q(windows)
        measured = pr.q((windows.real.abs() + windows.imag.abs()).mean(dim=-1))
        l1 = pr.q(torch.where(l1 > 0, L1_BETA * l1 + (1 - L1_BETA) * measured,
                              measured))
        prs_rx = windows[:, p.nb_null_period:p.nb_null_period + self.nfft]
        err = self._coarse(prs_rx) - coarse
        fast = (err.abs() > COARSE_FAST_BINS / self.nfft) | ~found
        delta = pr.q(torch.where(fast, 1.0, COARSE_SLOW_BETA) * err)
        coarse = pr.q(coarse + delta)
        fine = pr.q(self._wrap(fine - delta))
        offset, ok = self._timing(prs_rx, coarse + fine)
        idx = (p.nb_null_period + offset)[:, None] + torch.arange(
            self.body_len, device=self.dev)
        body = torch.gather(windows, 1, idx)
        shape = (body.shape[0], p.nb_frame_symbols, p.nb_symbol_period)
        pre = self._mix(body, coarse + fine).reshape(shape)
        ferr = self._cyclic_error(pre)
        fine = pr.q(torch.where(ferr.abs() > FINE_SAMEFRAME_BINS / self.nfft,
                                self._wrap(fine - ferr), fine))
        syms = self._mix(body, coarse + fine).reshape(shape)
        bits = self._soft_bits(syms) if want_bits else None
        fine2 = pr.q(self._wrap(fine - FINE_BETA * self._cyclic_error(syms)))
        zero = torch.zeros_like(coarse)
        carry = (torch.where(ok, coarse, zero), torch.where(ok, fine2, zero),
                 ok, l1)
        return carry, offset, ok, bits

    # ---- tracks through looped captures ----

    def acquire(self, capture: torch.Tensor, start: int) -> int:
        """The first NULL symbol at or after sample `start` of a looped
        capture: where the level of NULL_BLOCK-sample blocks first falls
        under a third of the mean and rises again. Returns its start."""
        n = capture.shape[0]
        span = 2 * self.fs // NULL_BLOCK * NULL_BLOCK
        idx = (start + torch.arange(span, device=self.dev)) % n
        x = capture[idx]
        lvl = (x.real.abs() + x.imag.abs()).reshape(-1, NULL_BLOCK).mean(-1)
        mean = lvl.mean()
        low = torch.nonzero(lvl < mean / 3)[:, 0]
        first = int(low[0])
        run = first
        while run + 1 < lvl.shape[0] and lvl[run + 1] < mean / 3:
            run += 1
        # the block after the dip ends the NULL; step back over it
        return start + (run + 1) * NULL_BLOCK - self.p.nb_null_period

    def align(self, capture: torch.Tensor, start: int = 0):
        """The first whole frame at or after sample `start` of a looped
        capture, to the sample: the NULL that acquire() finds, moved by
        the PRS timing of one frame read there from a cold start. Returns
        (its first sample, whether that frame synced)."""
        null = self.acquire(capture, start)
        idx = (null + torch.arange(self.window_len, device=self.dev)) \
            % capture.shape[0]
        zero = torch.zeros(1, dtype=self.pr.real, device=self.dev)
        carry = (zero, zero.clone(),
                 torch.zeros(1, dtype=torch.bool, device=self.dev), zero)
        window = capture[idx].to(self.pr.complex)[None]
        _, offset, ok, _ = self.step(carry, window, False)
        return null + int(offset[0]), bool(ok[0])

    def run(self, captures, tracks, bits_at=()):
        """Run tracks, each a dict with "capture" (index into `captures`,
        complex IQ tensors of one period on the device), "start" (sample
        of the first window), "frames", "mode" ("grid" or "tracked") and
        optionally "l1", the level the carry starts from (0: the first
        frame's own).
        Returns (per track final carry as numpy dict, {(track, frame):
        soft bits} for the (track, frame) pairs in bits_at, per track the
        count of frames out of sync)."""
        pr = self.pr
        ext = [torch.cat([c, c[:self.window_len + self.fs]]).to(pr.complex)
               for c in captures]
        n = [c.shape[0] for c in captures]
        B = len(tracks)
        pos = [t["start"] % n[t["capture"]] for t in tracks]
        zero = torch.zeros(B, dtype=pr.real, device=self.dev)
        l1 = torch.tensor([t.get("l1", 0.0) for t in tracks], dtype=pr.real,
                          device=self.dev)
        carry = (zero, zero.clone(), torch.zeros(B, dtype=torch.bool,
                                                 device=self.dev), l1)
        lost = [0] * B
        frames = max(t["frames"] for t in tracks)
        want = {}
        for k, f in bits_at:
            want.setdefault(f, []).append(k)
        out_bits = {}
        final = [None] * B
        ar = torch.arange(self.window_len, device=self.dev)
        for f in range(frames):
            live = [k for k, t in enumerate(tracks) if f < t["frames"]]
            win = torch.stack([ext[tracks[k]["capture"]][pos[k] + ar]
                               if k in live else ext[0][ar]
                               for k in range(B)])
            carry, offset, ok, bits = self.step(carry, win, f in want)
            offs, oks = offset.tolist(), ok.tolist()
            for k in live:
                t = tracks[k]
                if not oks[k]:
                    lost[k] += 1
                step = self.fs + (offs[k] if t["mode"] == "tracked" and oks[k]
                                  else 0)
                pos[k] = (pos[k] + step) % n[t["capture"]]
                if f == t["frames"] - 1:
                    final[k] = {"freq_coarse": float(carry[0][k]),
                                "freq_fine": float(carry[1][k]),
                                "signal_l1_avg": float(carry[3][k])}
            for k in want.get(f, ()):
                out_bits[(k, f)] = bits[k].cpu().numpy()
        return final, out_bits, lost
