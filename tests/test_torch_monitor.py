"""The port's ``apps/monitor.py`` and ``StreamingDemodulator.last_window``
against the JAX package's, on the CPU, on one capture: mode I, 2 DAB+
services with a label and a slideshow on their X-PAD, 12 frames from the
JAX simulate_transmitter, through the JAX ChannelModel (1300 Hz offset,
AWGN at 18 dB: a noise-free capture bunches the soft values at one
magnitude, so a tiny rotation would flip many of them together).

Tolerances, with the same window and the same carry values in both
packages: the dB panels in linear amplitude within 1e-4 of their maximum;
the constellation within 1e-4 of its mean magnitude; the soft bits 1 LSB on
at most 1e-4 of values, none more (the parity contract); MER within
0.05 dB; ``plot_payload`` within its rounding (0.02 for dB, 0.002 for the
constellation); ``last_window``, ``estimate_mer_db`` and ``decimate_minmax``
exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dab_radio_tpu.apps import monitor as jmon
from dab_radio_tpu.apps import simulate_transmitter as j_tx
from dab_radio_tpu.host.native import iq_convert, iq_quantize_u8
from dab_radio_tpu.models import demodulator as jdem
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu_torch.apps import monitor as tmon
from dab_radio_tpu_torch.models import demodulator as tdem
from test_torch_tx_apps import run_main

torch.set_num_threads(1)

LEAD = 7000


def make_capture(path):
    """The capture of this module's docstring, written to `path` as u8."""
    rc, cap = run_main(j_tx.main, ["--payload", "ensemble", "--services", "2",
                                   "--slideshow", "-n", "12", "-F", "u8"])
    assert rc == 0
    pad = np.zeros(LEAD, np.complex64)
    iq = np.concatenate([pad, iq_convert(cap, "u8"), pad])
    iq = ChannelModel(cfo_hz=1300.0, snr_db=18.0, seed=1,
                      snr_ref=(LEAD, iq.shape[0] - LEAD)).apply(iq)
    path.write_bytes(iq_quantize_u8(
        (iq / np.abs(iq).max() * 0.5).astype(np.complex64)))
    return path


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return make_capture(tmp_path_factory.mktemp("monitor") / "cap.u8")


@pytest.fixture(scope="module")
def streamed(capture):
    """Both packages' StreamingDemodulator over the capture in blocks, with
    last_window after each process call: (frames_per_step -> (JAX sd, port
    sd, [(JAX last_window, port last_window)]))."""
    iq = iq_convert(capture.read_bytes(), "u8")
    out = {}
    for k in (1, 4):
        jsd = jdem.StreamingDemodulator(jdem.OFDMDemodulator(1), k)
        tsd = tdem.StreamingDemodulator(
            tdem.OFDMDemodulator(1, device="cpu"), k)
        assert jsd.last_window is None and tsd.last_window is None
        windows = []
        for i in range(0, iq.shape[0], 1 << 16):
            nj = len(jsd.process(iq[i:i + (1 << 16)]))
            nt = len(tsd.process(iq[i:i + (1 << 16)]))
            assert nj == nt
            windows.append((jsd.last_window, tsd.last_window))
        out[k] = (jsd, tsd, windows)
    return out


@pytest.mark.parametrize("frames_per_step", [1, 4])
def test_last_window_matches_jax(streamed, frames_per_step):
    _, tsd, windows = streamed[frames_per_step]
    # the first block is shorter than a frame window
    assert windows[0][0] is None and windows[0][1] is None
    assert windows[-1][1] is not None
    for want, got in windows:
        if want is None:
            assert got is None
        else:
            assert isinstance(got, np.ndarray) and got.dtype == np.complex64
            assert np.array_equal(got, want)
    # a copy, not a view of the stream buffer
    assert tsd.last_window.base is None


def _carry(jsd):
    return SimpleNamespace(freq_coarse=float(jsd.carry.freq_coarse),
                           freq_fine=float(jsd.carry.freq_fine))


def _lin(db):
    return 10.0 ** (np.asarray(db, np.float64) / 20.0)


@pytest.fixture(scope="module")
def diags(streamed):
    jsd, tsd, _ = streamed[1]
    window, carry = jsd.last_window, _carry(jsd)
    return (jmon.collect_diagnostics(jsd.demod, window, carry),
            tmon.collect_diagnostics(tsd.demod, window, carry))


def test_collect_diagnostics_matches_jax(diags):
    want, got = diags
    assert set(got) == set(want)
    for k in ("impulse_db", "freq_response_db", "spectrum_db",
              "constellation", "bits"):
        assert isinstance(got[k], np.ndarray), k
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        a, b = _lin(want[k]), _lin(got[k])
        assert np.abs(a - b).max() <= 1e-4 * a.max(), k
    con = want["constellation"]
    assert np.abs(got["constellation"] - con).max() \
        <= 1e-4 * np.abs(con).mean()
    d = np.abs(got["bits"].astype(np.int32) - want["bits"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4
    assert abs(got["mer_db"] - want["mer_db"]) <= 0.05
    assert got["mer_db"] > 10.0                # a locked frame at 18 dB
    assert got["window"] is want["window"]


def test_plot_payload_matches_jax(diags):
    want, got = (m.plot_payload(d) for m, d in zip((jmon, tmon), diags))
    assert set(got) == set(want) == {"impulse_db", "freq_response_db",
                                     "spectrum_db", "constellation", "mer_db"}
    for k in ("impulse_db", "freq_response_db", "spectrum_db"):
        assert len(got[k]) == len(want[k]) >= 128
        assert np.abs(np.subtract(got[k], want[k])).max() <= 0.02 + 1e-9, k
    assert len(got["constellation"]) == len(want["constellation"]) >= 256
    assert np.abs(np.subtract(got["constellation"],
                              want["constellation"])).max() <= 0.002 + 1e-9
    assert abs(got["mer_db"] - want["mer_db"]) <= 0.1 + 1e-9


@pytest.mark.parametrize("n", [5, 512, 2048, 3001])
def test_decimate_minmax_matches_jax(n):
    a = np.random.default_rng(n).normal(0.0, 20.0, n).astype(np.float32)
    assert tmon.decimate_minmax(a) == jmon.decimate_minmax(a)
    assert tmon.decimate_minmax(a, 64) == jmon.decimate_minmax(a, 64)


@pytest.mark.parametrize("nb_transitions", [4, 8])
def test_estimate_mer_db_matches_jax(streamed, nb_transitions):
    jsd, tsd, _ = streamed[4]
    w = jsd.last_window
    want = jmon.estimate_mer_db(jsd.demod, w, nb_transitions)
    assert tmon.estimate_mer_db(tsd.demod, w, nb_transitions) == want
    assert want == want
    # too short a window: NaN in both
    assert np.isnan(tmon.estimate_mer_db(tsd.demod, w[:5000]))
    pts = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(64)))
    assert tmon.mer_db_from_dqpsk(pts * 1.01) \
        == jmon.mer_db_from_dqpsk(pts * 1.01)


def test_render_dashboard_and_main_write_png(diags, streamed, capture,
                                             tmp_path):
    png = tmp_path / "dash.png"
    tmon.render_dashboard(diags[1], streamed[1][1].carry, str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert png.stat().st_size > 10_000
    out = tmp_path / "main.png"
    assert tmon.main(["-i", str(capture), "-o", str(out), "--frames", "4",
                      "--backend", "cpu"]) == 0
    assert out.stat().st_size > 10_000
    # no frame locks in silence: rc 1 and no PNG, as in the JAX app
    silent = tmp_path / "silent.u8"
    silent.write_bytes(b"\x80" * 600_000)
    assert tmon.main(["-i", str(silent), "-o", str(tmp_path / "none.png"),
                      "--backend", "cpu"]) == 1
    assert not (tmp_path / "none.png").exists()
