"""The port's ``apps/tui.py`` against the JAX package's, on the CPU, on the
capture of ``tests/test_torch_monitor.py`` (mode I, 2 DAB+ services with
X-PAD, 12 frames, 1300 Hz offset, AWGN at 18 dB).

Each package decodes the capture with its own demodulator and receiver.
With the same frame window and the same carry values, the dashboard's text
(``constellation_ascii``, ``diagnostics_lines``, ``render_lines``) is
identical: the panels are host numpy on the window, and the references the
port fetches from its device are the JAX package's arrays. ``main --plain``
prints the markers that ``tests/test_apps.py`` asks of the JAX app.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dab_radio_tpu.apps import tui as jtui
from dab_radio_tpu.host.native import iq_convert
from dab_radio_tpu.models import demodulator as jdem
from dab_radio_tpu.models import receiver as jrec
from dab_radio_tpu.utils.profiler import get_profiler as j_profiler
from dab_radio_tpu_torch.apps import tui as ttui
from dab_radio_tpu_torch.models import demodulator as tdem
from dab_radio_tpu_torch.models import receiver as trec
from dab_radio_tpu_torch.utils.profiler import get_profiler as t_profiler
from test_torch_monitor import make_capture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return make_capture(tmp_path_factory.mktemp("tui") / "cap.u8")


def _decode(tui, dem, rec, iq, **dev):
    demod = dem.OFDMDemodulator(1, **dev)
    sd = dem.StreamingDemodulator(demod)
    rx = rec.DabReceiver(1, benchmark_all=True, **dev)
    stats = {}
    rx.on_audio_channel.append(
        lambda sub_id, ch: stats.__setitem__(sub_id, tui.ChannelStats(ch)))
    rx.on_data_channel.append(
        lambda sub_id, ch: stats.__setitem__(sub_id, tui.ChannelStats(ch)))
    nb = 0
    for i in range(0, iq.shape[0], 1 << 18):
        for bits in sd.process(iq[i:i + (1 << 18)]):
            rx.process_frame(bits)
            nb += 1
    return SimpleNamespace(demod=demod, sd=sd, rx=rx, stats=stats, nb=nb)


@pytest.fixture(scope="module")
def decoded(capture):
    iq = iq_convert(capture.read_bytes(), "u8")
    j = _decode(jtui, jdem, jrec, iq)
    t = _decode(ttui, tdem, trec, iq, device="cpu")
    assert j.nb == t.nb == 12
    c = j.sd.carry
    # the same window and carry values for both packages (a carry held on
    # each side would differ by an ulp of CFO, ROADMAP F3)
    sd = SimpleNamespace(last_window=j.sd.last_window, state=1,
                         carry=SimpleNamespace(
                             freq_coarse=float(c.freq_coarse),
                             freq_fine=float(c.freq_fine),
                             signal_l1_avg=float(c.signal_l1_avg),
                             total_frames=int(c.total_frames),
                             total_desync=int(c.total_desync)))
    return j, t, sd


def test_constellation_and_diagnostics_text_match_jax(decoded):
    j, t, sd = decoded
    want = jtui.constellation_ascii(j.demod, sd)
    assert ttui.constellation_ascii(t.demod, sd) == want
    assert len(want) == 12 and sum(r.count(".") for r in want) > 50
    want = jtui.diagnostics_lines(j.demod, sd)
    assert ttui.diagnostics_lines(t.demod, sd) == want
    assert len(want) == 5
    # the port's device references were fetched once and are kept
    assert ttui._host_refs(t.demod) is ttui._host_refs(t.demod)
    empty = SimpleNamespace(last_window=None, carry=sd.carry, state=0)
    assert ttui.constellation_ascii(t.demod, empty) == ["(no frame yet)"]
    assert ttui.diagnostics_lines(t.demod, empty) == []


def test_render_lines_match_jax(decoded, monkeypatch):
    j, t, sd = decoded
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    for prof in (j_profiler(), t_profiler()):
        prof.reset()
        monkeypatch.setattr(prof, "enabled", False)
    for sel in (None, 3):
        want = jtui.render_lines(j.demod, sd, j.rx, j.stats, j.nb, 990.0,
                                 selected=sel)
        got = ttui.render_lines(t.demod, sd, t.rx, t.stats, t.nb, 990.0,
                                selected=sel)
        assert got == want
    text = "\n".join(got)
    assert "state=TRACK" in text and "MER=" in text and "<SEL" in text
    assert "Radio TPU 1" in text and "Radio TPU 2" in text
    assert text.count("aus=") == 2
    # with the port's own carry (tensors) the text still renders
    assert ttui.render_lines(t.demod, t.sd, t.rx, t.stats, t.nb, 990.0)[0] \
        .endswith("state=TRACK")


@pytest.mark.parametrize("vals", [
    np.arange(10.0), np.linspace(-40.0, 3.0, 700), np.array([1.0, np.nan, 2.0]),
    np.full(5, np.nan), np.zeros(0)])
def test_spark_matches_jax(vals):
    assert ttui._spark(vals) == jtui._spark(vals)
    assert ttui._spark(vals, 8) == jtui._spark(vals, 8)


def test_tags_match_jax(decoded):
    j, t, _ = decoded
    for sub in sorted(t.stats):
        jch, tch = j.stats[sub].ch, t.stats[sub].ch
        assert ttui._controls_tag(tch) == jtui._controls_tag(jch)
        assert ttui._codec_tag(tch) == jtui._codec_tag(jch)
        assert t.stats[sub].access_units == j.stats[sub].access_units > 0
    bare = SimpleNamespace()
    assert ttui._controls_tag(bare) == ttui._codec_tag(bare) == ""


def test_plain_main_prints_the_dashboard(capture, capsys):
    assert ttui.main(["-i", str(capture), "-F", "u8", "--plain",
                      "--max-frames", "12", "--refresh", "30",
                      "--backend", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "state=TRACK" in out
    assert "Radio TPU 1" in out and "Radio TPU 2" in out
    assert "aus=" in out
    assert "constellation" in out
    for name in ("fine-time impulse", "coarse-freq corr", "null symbol PSD",
                 "data symbol PSD", "sampling buffer"):
        assert name in out
