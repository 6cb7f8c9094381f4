"""The port's transmit side and tool apps against the JAX package's, in
process on the CPU: ``OFDMModulator.modulate_reference_bytes``, the
transmitter's X-PAD carousel (``queue_dynamic_label``,
``queue_slideshow``), and the apps ``simulate_transmitter``,
``apply_frequency_shift``, ``convert_viterbi``, ``loop_file`` and
``rtl_sdr`` with ``host/device.py``.

Tolerances:
- reference-bytes IQ: the carriers, taken back out of each symbol by a
  float64 FFT (unit power), within 1e-5 of JAX's (FFT rounding of the
  complex64 IFFT; the largest difference measured is 2.7e-6, in mode III),
  the null symbol exactly zero;
- simulate_transmitter u8: equal length, no byte off by more than 1 and at
  most 1e-3 of them off (the measured share is 4.8e-6);
- the ensemble capture decodes through each package's radio_cli to the
  same ensemble, services, subchannels, labels and slideshow files;
- PAD fields, apply_frequency_shift, convert_viterbi, loop_file: exact.
"""

import contextlib
import glob
import io
import os
import re
import sys

import numpy as np
import pytest

from dab_radio_tpu.apps import (apply_frequency_shift as j_afs,
                                convert_viterbi as j_cv, loop_file as j_lf,
                                radio_cli as j_cli,
                                simulate_transmitter as j_tx)
from dab_radio_tpu.models.modulator import OFDMModulator as JMod
from dab_radio_tpu.models.transmitter import (EnsembleTransmitter as JTx,
                                              ServiceSpec as JSpec)
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.apps import (apply_frequency_shift as t_afs,
                                      convert_viterbi as t_cv,
                                      loop_file as t_lf, radio_cli as t_cli,
                                      rtl_sdr as t_rtl,
                                      simulate_transmitter as t_tx)
from dab_radio_tpu_torch.host import device as t_dev
from dab_radio_tpu_torch.models.modulator import OFDMModulator as TMod
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter as TTx,
                                                    ServiceSpec as TSpec)
from dab_radio_tpu_torch.params import SubchannelConfig as TCfg

CPU = ["--backend", "cpu"]


def run_main(main, argv, stdin=b""):
    """main(argv) with sys.stdin / sys.stdout on byte buffers, as a
    subprocess would see them; returns (rc, stdout bytes)."""
    out = io.BytesIO()
    fake_out = io.TextIOWrapper(out, write_through=True)
    fake_in = io.TextIOWrapper(io.BytesIO(stdin))
    saved = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = fake_in, fake_out
    try:
        rc = main(argv)
    finally:
        fake_out.flush()
        sys.stdin, sys.stdout = saved
    return rc, out.getvalue()


# absl's log prefix, which XLA writes to fd 2 (e.g. "E1017 04:12:33.123456
# 2906 cpu_aot_loader.cc:210] Loading XLA:CPU AOT result ...")
ABSL_LINE = re.compile(r"^[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+ +\d+ \S+:\d+\]")


def app_lines(text):
    """The lines an app printed to fd 2, without absl/XLA log lines (these
    come from the JAX runtime, not from the app)."""
    return [ln for ln in text.splitlines() if not ABSL_LINE.match(ln)]


@contextlib.contextmanager
def jax_compile_cache_off(monkeypatch):
    """The JAX package's persistent compile cache off while the block runs.
    Its apps turn it on for the whole process (`utils/cache.py`); a hit there
    writes an XLA log line to fd 2 that the app did not print. The cache
    directory goes back to None (and the cache is reset, since JAX reads the
    directory once), then the old value comes back."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    from dab_radio_tpu.utils import cache as jax_cache
    monkeypatch.setattr(jax_cache, "enable_compile_cache", lambda: None)
    saved = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
        compilation_cache.reset_cache()


# ------------------------------------------------- reference byte contract

@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_modulate_reference_bytes_matches_jax(mode):
    jm, tm = JMod(mode), TMod(mode, "cpu")
    p = jm.params
    data = t_tx._dvb_scrambler_bytes(
        p.nb_data_symbols * p.nb_data_carriers * 2 // 8)
    assert np.array_equal(data, j_tx._dvb_scrambler_bytes(data.size))
    want = jm.modulate_reference_bytes(data)
    got = tm.modulate_reference_bytes(data)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert not np.any(got[:p.nb_null_period])
    n_sym = p.nb_fft + p.nb_cyclic_prefix

    def carriers(x):
        body = x[p.nb_null_period:].astype(np.complex128).reshape(-1, n_sym)
        return np.fft.fft(body[:, p.nb_cyclic_prefix:]) / p.nb_fft

    cw, cg = carriers(want), carriers(got)
    on = np.abs(cw) > 0.5
    assert on.sum() == p.nb_frame_symbols * p.nb_data_carriers
    np.testing.assert_allclose(np.abs(cw[on]), 1.0, atol=1e-4)
    assert np.abs(cg - cw).max() <= 1e-5


# -------------------------------------------------------- X-PAD carousel

def test_queue_label_and_slideshow_fill_the_same_pad_fields():
    def tx(Tx, Spec, Cfg, **kw):
        t = Tx(1, services=[Spec(0xF123 + i, 3 + i, f"S{i}",
                                 Cfg(48 * i, 48, False, eep_type="A",
                                     eep_prot_level=2)) for i in range(2)],
               **kw)
        t.enable_tone_audio()
        t.queue_dynamic_label(3, "Now: Radio TPU 1, a label longer than "
                                 "one segment of sixteen bytes")
        t.queue_slideshow(4, t_tx._test_card_png(1), name="card_1.png")
        t.queue_dynamic_label(4, "Now: Radio TPU 2")
        return t
    j, t = tx(JTx, JSpec, JCfg), tx(TTx, TSpec, TCfg, device="cpu")
    for sub in (3, 4):
        want = list(j._tone_source(sub).pad_fields)
        got = list(t._tone_source(sub).pad_fields)
        assert want and got == want
    assert j_tx._test_card_png(1) == t_tx._test_card_png(1)
    with pytest.raises(ValueError, match="no tone AU source"):
        TTx(1, services=[TSpec(0xF123, 3, "S", TCfg(0, 48, False,
                                                    eep_type="A",
                                                    eep_prot_level=2))],
            device="cpu").queue_dynamic_label(3, "x")


# ------------------------------------------------- simulate_transmitter

def test_simulate_transmitter_random_payload_matches_jax():
    argv = ["--payload", "random", "-n", "2", "-F", "u8"]
    rc_j, want = run_main(j_tx.main, argv)
    rc_t, got = run_main(t_tx.main, argv + CPU)
    assert rc_j == rc_t == 0
    assert len(got) == len(want) == 2 * 2 * 196608
    d = np.abs(np.frombuffer(got, np.uint8).astype(np.int16)
               - np.frombuffer(want, np.uint8))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3


@pytest.mark.parametrize("fmt,size", [("s16", 4), ("f32", 8)])
def test_simulate_transmitter_other_formats(fmt, size):
    argv = ["--payload", "random", "-n", "1", "-F", fmt, "-M", "2"]
    _, want = run_main(j_tx.main, argv)
    rc, got = run_main(t_tx.main, argv + CPU)
    assert rc == 0 and len(got) == len(want) == 49152 * size
    dt = np.int16 if fmt == "s16" else np.float32
    a, b = np.frombuffer(got, dt), np.frombuffer(want, dt)
    tol = 1 if fmt == "s16" else 1e-5
    assert np.abs(a.astype(np.float64) - b).max() <= tol


def _decode(cli, path, scrape, extra, capfd):
    assert cli.main(["-i", str(path), "-F", "u8", "--scraper-enable",
                     "--scraper-output", str(scrape)] + extra) == 0
    err = "\n".join(app_lines(capfd.readouterr().err))
    final = err[err.rindex("ensemble: id="):]
    files = {os.path.relpath(p, scrape): open(p, "rb").read()
             for p in glob.glob(os.path.join(scrape, "*", "*"))
             if not p.endswith(".aac")}
    aac = {os.path.relpath(p, scrape): os.path.getsize(p)
           for p in glob.glob(os.path.join(scrape, "*", "*.aac"))}
    return final, files, aac


def test_ensemble_with_slideshow_decodes_as_jax(tmp_path, capfd,
                                                monkeypatch):
    # the JAX summarize() binds sys.stderr when its module is imported
    # (ROADMAP F5); point it at this test's stderr for this test only
    monkeypatch.setattr(j_cli.summarize, "__defaults__", (sys.stderr,))
    argv = ["--payload", "ensemble", "--services", "2", "--slideshow",
            "-n", "24", "-F", "u8"]
    _, jcap = run_main(j_tx.main, argv)
    rc, tcap = run_main(t_tx.main, argv + CPU)
    assert rc == 0 and len(tcap) == len(jcap)
    d = np.abs(np.frombuffer(tcap, np.uint8).astype(np.int16)
               - np.frombuffer(jcap, np.uint8))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3
    (tmp_path / "j.u8").write_bytes(jcap)
    (tmp_path / "t.u8").write_bytes(tcap)
    capfd.readouterr()
    with jax_compile_cache_off(monkeypatch):
        j_final, j_files, j_aac = _decode(j_cli, tmp_path / "j.u8",
                                          tmp_path / "js", [], capfd)
    t_final, t_files, t_aac = _decode(t_cli, tmp_path / "t.u8",
                                      tmp_path / "ts", CPU, capfd)
    assert t_final == j_final
    assert "ensemble: id=C0FE" in t_final and "desync=0" in t_final
    assert "'Radio TPU 1'" in t_final and "'Radio TPU 2'" in t_final
    assert t_files == j_files
    assert sorted(t_aac) == sorted(j_aac) and min(t_aac.values()) > 0
    for i in range(2):
        d = f"service_{0xF123 + i:X}_component_0"
        assert t_files[f"{d}/card_{i}.png"] == t_tx._test_card_png(i)
        assert f"Now: Radio TPU {i + 1}" in \
            t_files[f"{d}/labels.txt"].decode().splitlines()


# ----------------------------------------------------------- host apps

def test_apply_frequency_shift_matches_jax():
    raw = np.random.default_rng(3).integers(0, 256, 300001,
                                            dtype=np.uint8).tobytes()
    for f in ("1200", "-1200"):
        argv = ["-f", f, "-b", "65536"]
        _, want = run_main(j_afs.main, argv, raw)
        rc, got = run_main(t_afs.main, argv + CPU, raw)
        assert rc == 0 and got == want and len(got) == len(raw) - 1


def test_convert_viterbi_roundtrip_matches_jax():
    soft = np.random.default_rng(4).integers(-127, 128, 40000,
                                             dtype=np.int8).tobytes()
    _, j_hard = run_main(j_cv.main, [], soft)
    rc, t_hard = run_main(t_cv.main, CPU, soft)
    assert rc == 0 and t_hard == j_hard and len(t_hard) == 5000
    _, j_soft = run_main(j_cv.main, ["-d"], j_hard)
    rc, t_soft = run_main(t_cv.main, ["-d"] + CPU, t_hard)
    assert rc == 0 and t_soft == j_soft
    back = np.frombuffer(t_soft, np.int8)
    np.testing.assert_array_equal(back > 0, np.frombuffer(soft, np.int8) > 0)


def test_loop_file_matches_jax(tmp_path):
    plain = tmp_path / "x.bin"
    plain.write_bytes(b"abcdef" * 1000)
    wav = tmp_path / "x.wav"
    body = bytes(range(256)) * 3
    wav.write_bytes(b"RIFF" + (36 + len(body)).to_bytes(4, "little")
                    + b"WAVEfmt " + (16).to_bytes(4, "little") + bytes(16)
                    + b"data" + len(body).to_bytes(4, "little") + body)
    for path, n in ((plain, "3"), (wav, "2")):
        argv = ["-i", str(path), "-n", n, "-b", "1000"]
        _, want = run_main(j_lf.main, argv)
        rc, got = run_main(t_lf.main, argv + CPU)
        assert rc == 0 and got == want
    assert got == body * 2


# ------------------------------------------- rtl_sdr and host/device.py

def test_rtl_sdr_list_channels():
    rc, out = run_main(t_rtl.main, ["--list-channels"])
    out = out.decode()
    assert rc == 0 and "5C" in out and "9C" in out and "MHz" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("9C"))
    assert "206.352" in line


def test_rtl_sdr_no_device_errors_cleanly(capsys):
    rc, _ = run_main(t_rtl.main, ["-c", "9C"])
    assert rc == 1 and "error" in capsys.readouterr().err.lower()
    with pytest.raises(RuntimeError):
        t_dev.RTLSDRDevice()


def test_rtl_sdr_unknown_channel(capsys):
    rc, _ = run_main(t_rtl.main, ["-c", "ZZ"])
    assert rc == 1 and "unknown channel" in capsys.readouterr().err


def test_rtl_sdr_list_devices_without_hardware():
    assert t_dev.list_devices() == []
    rc, out = run_main(t_rtl.main, ["--list-devices"])
    assert rc == 0 and out == b""


def test_file_device_replays_a_capture(tmp_path):
    """FileDevice hands the capture's samples to its callbacks from its
    reader thread, as the JAX class does."""
    from dab_radio_tpu.host import device as j_dev
    raw = np.random.default_rng(5).integers(0, 256, 2 * 70000,
                                            dtype=np.uint8)
    (tmp_path / "c.u8").write_bytes(raw.tobytes())
    out = []
    for mod in (j_dev, t_dev):
        dev = mod.FileDevice(str(tmp_path / "c.u8"), "u8", realtime=False,
                             block_samples=30000)
        got, freqs = [], []
        dev.on_data.append(got.append)
        dev.on_frequency_change.append(lambda *a: freqs.append(a))
        dev.set_center_frequency("9C", mod.BLOCK_FREQUENCIES["9C"])
        dev.start()
        dev._thread.join(10)
        dev.stop()
        out.append(([g.shape[0] for g in got], np.concatenate(got), freqs))
    assert out[0][0] == out[1][0] == [30000, 30000, 10000]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][2] == out[0][2] == [("9C", 206352000)]


def test_pad_carousel_reaches_services_announced_late(tmp_path, capfd):
    """With 12 services in mode I the FIC announces service 12 in the second
    frame, after its one round of X-PAD (ROADMAP F14): its slideshow never
    arrives. --pad-carousel queues the label and slideshow again whenever
    they drain, and every service's arrive."""
    got = {}
    for flag in ([], ["--pad-carousel"]):
        rc, cap = run_main(t_tx.main, ["--payload", "ensemble", "--services",
                                       "12", "--slideshow", "-n", "16"]
                           + flag + CPU)
        assert rc == 0
        path, scrape = tmp_path / "c.u8", tmp_path / f"s{len(flag)}"
        path.write_bytes(cap)
        assert t_cli.main(["-i", str(path), "--scraper-enable",
                           "--scraper-output", str(scrape)] + CPU) == 0
        capfd.readouterr()
        got[bool(flag)] = {os.path.basename(p) for p in
                           glob.glob(str(scrape / "*" / "card_*.png"))}
    every = {f"card_{i}.png" for i in range(12)}
    assert got[True] == every
    assert "card_11.png" not in got[False] and got[False] < every
