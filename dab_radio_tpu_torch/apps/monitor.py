"""Headless monitor: renders the reference GUI's OFDM diagnostic views to a
PNG dashboard (examples/gui/ofdm/render_ofdm_demod.cpp analog; port of
``dab_radio_tpu/apps/monitor.py``, same flags and panels).

Panels: raw sampling buffer, fine-time PRS impulse response, coarse-frequency
correlation response, DQPSK IQ constellation, soft-bit histogram, per-symbol
spectrum, plus sync state and per-stage profiler table on stderr. The
diagnostics are computed on the device --backend names (default cuda;
raises without a GPU); the PNG needs matplotlib.
"""

import argparse
import sys

import numpy as np
import torch

from ..host.io import IQReader
from ..models.demodulator import OFDMDemodulator, StreamingDemodulator
from ..ops import sync as sync_ops
from ..ops.demod import demod_frame_body
from ..utils.backend import add_backend_flag, apply_backend, to_device
from ..utils.profiler import get_profiler


def mer_db_from_dqpsk(points) -> float:
    """Modulation error ratio of differential (pi/4-DQPSK) symbols in dB:
    unit-magnitude phase projection against the nearest ideal point, so
    MER = E[|ideal|^2] / E[|err|^2]. Computed on the DIFFERENTIAL stream
    (the quantity that drives DQPSK BER); amplitude carries no
    information and is normalized out."""
    z = np.asarray(points).ravel()
    z = z[np.abs(z) > 0]
    if z.size == 0:
        return float("nan")
    ang = np.angle(z)
    ideal = np.pi / 4 + np.round((ang - np.pi / 4) / (np.pi / 2)) * np.pi / 2
    err2 = np.mean(2.0 * (1.0 - np.cos(ang - ideal)))
    return float(10.0 * np.log10(1.0 / max(err2, 1e-12)))


def estimate_mer_db(demod: OFDMDemodulator, window, nb_transitions=8):
    """Light per-frame signal-quality probe over a locked frame window
    (a few sampled symbol transitions; the webmon/TUI status metric).
    Host numpy: a window is a host copy of the stream buffer."""
    p = demod.params
    w = np.asarray(window)
    if w.ndim == 2:            # float32 (N, 2) IQ pairs
        w = w[:, 0] + 1j * w[:, 1]
    w = w.astype(np.complex128)   # headroom for |FFT|^2-scale products
    if w.shape[0] < p.nb_null_period + 2 * p.nb_symbol_period + p.nb_fft:
        return float("nan")
    bins = np.concatenate([np.arange(1, p.nb_data_carriers // 2 + 1),
                           np.arange(p.nb_fft - p.nb_data_carriers // 2,
                                     p.nb_fft)])
    last_sym = p.nb_frame_symbols - 2
    pts = []
    for k in sorted(set(np.linspace(0, last_sym, nb_transitions)
                        .astype(int))):
        s0 = p.nb_null_period + k * p.nb_symbol_period + p.nb_cyclic_prefix
        s1 = s0 + p.nb_symbol_period
        if s1 + p.nb_fft > w.shape[0]:
            break
        f0 = np.fft.fft(w[s0:s0 + p.nb_fft])
        f1 = np.fft.fft(w[s1:s1 + p.nb_fft])
        pts.append((f1 * np.conj(f0))[bins])
    return mer_db_from_dqpsk(np.concatenate(pts)) if pts else float("nan")


def collect_diagnostics(demod: OFDMDemodulator, window: np.ndarray,
                        carry) -> dict:
    """Recompute the GUI-visible intermediates for one frame window on
    demod.device: the PRS matched filter, the coarse-frequency correlation,
    the frame body's demodulation and the DQPSK product. Returns numpy
    arrays with the JAX package's keys and dtypes."""
    p = demod.params
    freq = float(carry.freq_coarse) + float(carry.freq_fine)
    w = to_device(np.asarray(window), demod.device, np.complex64)
    prs = w[p.nb_null_period:p.nb_null_period + p.nb_fft]

    _, _, impulse_db = sync_ops.fine_time_offset(
        prs, demod.prs_fft_conj, freq,
        p.nb_fft, p.nb_cyclic_prefix, p.nb_symbol_period)

    spec = torch.fft.fft(prs)
    rel = torch.conj(spec[:-1]) * spec[1:]
    rel = torch.cat([rel, rel.new_zeros(1)])
    corr = torch.fft.fft(torch.fft.ifft(rel) * demod.prs_time_corr_ref)
    freq_response_db = 20 * torch.log10(
        torch.clamp(torch.fft.fftshift(corr).abs(), min=1e-9))

    body = w[p.nb_null_period:p.nb_null_period + demod.body_len]
    bits, _, fft_frame = demod_frame_body(
        body, freq, nb_fft=p.nb_fft, nb_symbol_period=p.nb_symbol_period,
        nb_frame_symbols=p.nb_frame_symbols, nb_cyclic_prefix=p.nb_cyclic_prefix,
        carrier_bins=demod.carrier_bins, carrier_map=demod.carrier_map)
    dq = torch.conj(fft_frame[1:]) * fft_frame[:-1]
    dq_carriers = dq[:, demod.carrier_bins].cpu().numpy()
    constellation = dq_carriers[:8].reshape(-1)
    return {
        "impulse_db": impulse_db.cpu().numpy(),
        "freq_response_db": freq_response_db.cpu().numpy(),
        "constellation": constellation,
        "mer_db": mer_db_from_dqpsk(dq_carriers),
        "bits": bits.cpu().numpy(),
        "spectrum_db": 20 * np.log10(np.abs(np.fft.fftshift(
            fft_frame[1].cpu().numpy())) + 1e-9),
        "window": window,
    }


def render_dashboard(diag: dict, carry, out_path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 2, figsize=(13, 10))
    ax = axes[0, 0]
    w = diag["window"][::16]
    ax.plot(np.real(w), lw=0.3)
    ax.plot(np.imag(w), lw=0.3)
    ax.set_title("sampling buffer (decimated)")

    ax = axes[0, 1]
    ax.plot(diag["impulse_db"], lw=0.5)
    ax.set_title("fine time: PRS impulse response (dB)")

    ax = axes[1, 0]
    ax.plot(diag["freq_response_db"], lw=0.5)
    ax.set_title("coarse freq: correlation response (dB)")

    ax = axes[1, 1]
    c = diag["constellation"]
    c = c / (np.abs(c).mean() + 1e-12)
    ax.plot(np.real(c), np.imag(c), ".", ms=1, alpha=0.3)
    mer = diag.get("mer_db")
    ax.set_title("DQPSK constellation (first 8 symbols)"
                 + (f" — MER {mer:.1f} dB" if mer == mer else ""))
    ax.set_aspect("equal")

    ax = axes[2, 0]
    ax.hist(diag["bits"].astype(np.int32), bins=64)
    ax.set_title("soft bit histogram")

    ax = axes[2, 1]
    ax.plot(diag["spectrum_db"], lw=0.5)
    ax.set_title("data symbol spectrum (dB)")

    fig.suptitle(
        f"coarse={float(carry.freq_coarse) * 2.048e6:+.1f} Hz  "
        f"fine={float(carry.freq_fine) * 2.048e6:+.1f} Hz  "
        f"frames={int(carry.total_frames)}  desync={int(carry.total_desync)}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    print(f"wrote {out_path}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", default="-")
    ap.add_argument("-F", "--format", default="u8")
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("-o", "--output", default="dab_monitor.png")
    ap.add_argument("--frames", type=int, default=4,
                    help="frames to lock before rendering")
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    device = apply_backend(args)

    get_profiler().enabled = True
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    try:
        reader = IQReader(fin, args.format)
        demod = OFDMDemodulator(args.transmission_mode, device=device)
        sd = StreamingDemodulator(demod)
        locked = 0
        while locked < args.frames:
            iq = reader.read_block(1 << 20)
            if iq is None:
                break
            locked += len(sd.process(iq))
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
    if sd.last_window is None:
        print("no signal captured", file=sys.stderr)
        return 1
    diag = collect_diagnostics(demod, sd.last_window, sd.carry)
    render_dashboard(diag, sd.carry, args.output)
    print(get_profiler().report(), file=sys.stderr)
    return 0


def decimate_minmax(a: np.ndarray, n: int = 512) -> list:
    """Min/max-preserving downsample for line plots (peaks must survive:
    the impulse response's fine-time peak is 1-2 samples wide)."""
    a = np.asarray(a, np.float64).reshape(-1)
    if a.shape[0] <= n:
        return [round(float(v), 2) for v in a]
    m = -(-a.shape[0] // (n // 2))   # ceil: output stays <= n points
    k = (a.shape[0] // m) * m
    blocks = a[:k].reshape(-1, m)
    out = np.empty(blocks.shape[0] * 2)
    out[0::2] = blocks.min(axis=1)
    out[1::2] = blocks.max(axis=1)
    return [round(float(v), 2) for v in out]


def plot_payload(diag: dict) -> dict:
    """collect_diagnostics output -> the compact JSON the browser canvas
    renderer draws (webmon and fleet_serve /plot.json share this): the
    reference GUI's four live OFDM windows
    (render_ofdm_demod.cpp:39-336) as decimated numeric arrays."""
    con = np.asarray(diag["constellation"])
    if con.shape[0] > 1024:
        con = con[:: con.shape[0] // 1024 + 1]
    scale = float(np.abs(con).mean()) or 1.0
    out = {
        "impulse_db": decimate_minmax(diag["impulse_db"]),
        "freq_response_db": decimate_minmax(diag["freq_response_db"]),
        "spectrum_db": decimate_minmax(diag["spectrum_db"]),
        "constellation": [[round(float(c.real / scale), 3),
                           round(float(c.imag / scale), 3)] for c in con],
    }
    mer = diag.get("mer_db")
    if mer is not None and mer == mer:
        out["mer_db"] = round(float(mer), 1)
    return out


if __name__ == "__main__":
    sys.exit(main())
