"""The port's ``radio_app`` (tuner device -> demodulator -> receiver ->
audio pipeline) against the JAX package's ``radio_app.main``, in process on
the CPU, on one capture: mode I, 2 DAB+ services with tone audio, a dynamic
label and a slideshow on each, 12 frames, from the JAX simulate_transmitter.

The JAX app itself is the reference here (it takes a few seconds on the
CPU). The WAV is byte-identical: the audio decode is the same host code fed
byte-exact access units. The "+ channel" and "label:" lines and the final
summary on stderr are the same.
"""

import sys

import numpy as np
import pytest

from dab_radio_tpu.apps import radio_app as j_app
from dab_radio_tpu.apps import radio_cli as j_cli
from dab_radio_tpu.apps import simulate_transmitter as j_tx
from dab_radio_tpu_torch.apps import radio_app as t_app
from test_torch_tx_apps import app_lines, jax_compile_cache_off, run_main


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    rc, cap = run_main(j_tx.main, ["--payload", "ensemble", "--services", "2",
                                   "--slideshow", "-n", "12", "-F", "u8"])
    assert rc == 0
    path = tmp_path_factory.mktemp("radio_app") / "cap.u8"
    path.write_bytes(cap)
    return path


def _events(err):
    return [ln for ln in app_lines(err)
            if ln.startswith("+ channel") or ln.startswith("  label:")]


def test_radio_app_matches_jax(capture, tmp_path, capfd, monkeypatch):
    # the JAX summarize() binds sys.stderr when its module is imported
    # (ROADMAP F5); point it at this test's stderr for this test only
    monkeypatch.setattr(j_cli.summarize, "__defaults__", (sys.stderr,))
    argv = ["--device", "file", "-i", str(capture), "-c", "5C"]
    capfd.readouterr()
    with jax_compile_cache_off(monkeypatch):
        assert j_app.main(argv + ["--audio-out", str(tmp_path / "j.wav")]) \
            == 0
    jerr = "\n".join(app_lines(capfd.readouterr().err))
    assert t_app.main(argv + ["--audio-out", str(tmp_path / "t.wav"),
                              "--backend", "cpu"]) == 0
    terr = "\n".join(app_lines(capfd.readouterr().err))

    want, got = (tmp_path / "j.wav").read_bytes(), \
        (tmp_path / "t.wav").read_bytes()
    assert got == want and got[:4] == b"RIFF"
    pcm = np.frombuffer(got[44:], np.int16).astype(np.float64)
    assert pcm.size > 48000 and np.sqrt(np.mean(pcm ** 2)) > 100

    assert _events(terr) == _events(jerr)
    assert {"+ channel 3 (dab+)", "+ channel 4 (dab+)",
            "  label: Now: Radio TPU 1", "  label: Now: Radio TPU 2"} \
        <= set(_events(terr))
    final = terr[terr.rindex("ensemble: id="):]
    assert final == jerr[jerr.rindex("ensemble: id="):]
    assert "services=2" in final and "rs_err=0 au_err=0" in final


def test_radio_app_null_sink_and_bad_arguments(capture, capfd):
    """--audio-out '' takes the null sink; --device file without -i and a
    tuner without librtlsdr fail as the JAX app does."""
    assert t_app.main(["--device", "file", "-i", str(capture), "--audio-out",
                       "", "--backend", "cpu"]) == 0
    assert "label: Now: Radio TPU 1" in capfd.readouterr().err
    with pytest.raises(SystemExit):
        t_app.main(["--device", "file", "--backend", "cpu"])
    with pytest.raises(RuntimeError, match="librtlsdr"):
        t_app.main(["--device", "rtlsdr", "--backend", "cpu"])
    with pytest.raises(SystemExit):
        t_app.main(["-c", "ZZ", "--backend", "cpu"])
