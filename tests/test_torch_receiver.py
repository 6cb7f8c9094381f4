"""The slice as a whole: u8/complex IQ -> streaming demodulator -> FIC ->
database -> grouped and single MSC decode -> DAB+ access units, through the
JAX package and through the PyTorch port (on the CPU), on one capture.

A small mode-I ensemble from the JAX transmitter: two DAB+ subchannels of
one protection (the grouped MSC path) and one of another (the single
channel path), with a carrier offset and noise. Frame count, FIBs,
database and every subchannel's access-unit bytes must be identical, and
the port's radio_cli must print the JAX CLI's summary, timings aside.
"""

import pickle
import sys

import numpy as np
import pytest
import torch

from dab_radio_tpu.apps import radio_cli as jcli
from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.utils import cache as jax_cache
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.demodulator import (OFDMDemodulator as JDemod,
                                              StreamingDemodulator as JStream)
from dab_radio_tpu.models.receiver import DabReceiver as JRx
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig
from dab_radio_tpu_torch.apps import radio_cli as tcli
from dab_radio_tpu_torch.models.demodulator import (
    OFDMDemodulator as TDemod, StreamingDemodulator as TStream)
from dab_radio_tpu_torch.models.receiver import DabReceiver as TRx

torch.set_num_threads(1)

NB_FRAMES = 16
HDR = SuperFrameHeader(48000, True, True, False, 0)


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


@pytest.fixture(scope="module")
def capture():
    eep = dict(is_uep=False, eep_type="A", eep_prot_level=2)
    services = [
        ServiceSpec(0xF201, 1, "Group A", SubchannelConfig(0, 12, **eep),
                    superframe_header=HDR),
        ServiceSpec(0xF202, 2, "Group B", SubchannelConfig(12, 12, **eep),
                    superframe_header=HDR),
        ServiceSpec(0xF203, 3, "Single", SubchannelConfig(
            24, 21, True, uep_table_index=1), superframe_header=HDR),
    ]
    tx = EnsembleTransmitter(1, services=services)
    for s in services:
        tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
    lead = np.zeros(9000, np.complex64)
    iq = np.concatenate([lead, tx.generate(NB_FRAMES), lead])
    return ChannelModel(cfo_hz=3210.0, snr_db=18.0, seed=5,
                        snr_ref=(9000, iq.shape[0] - 9000)).apply(iq)


def _run(Stream, Demod, Rx, iq):
    sd, rx = Stream(Demod(1)), Rx(1)
    got = {"fibs": [], "aus": {}}
    inner = rx.fic.decode_fic

    def decode_fic(bits):
        fibs, err = inner(bits)
        got["fibs"].append((fibs, err["crc_errors"]))
        return fibs, err
    rx.fic.decode_fic = decode_fic

    def on_channel(sub_id, ch):
        aus = got["aus"].setdefault(sub_id, [])
        ch.events.on_access_unit.append(lambda i, n, au, h: aus.append(au))
    rx.on_audio_channel.append(on_channel)
    frames = []
    for i in range(0, iq.shape[0], 100000):
        frames += sd.process(iq[i:i + 100000])
    for f in frames:
        rx.process_frame(f)
    got["frames"] = len(frames)
    got["desync"] = int(sd.carry.total_desync)
    return rx, got


def _db_view(rx):
    db = rx.db
    return {
        "ensemble": (db.ensemble.id, db.ensemble.label),
        "services": {sid: s.label for sid, s in db.services.items()},
        "subchannels": {i: (s.start_address, s.length, s.is_uep,
                            s.uep_table_index, s.eep_type, s.eep_prot_level)
                        for i, s in db.subchannels.items()},
        "channels": {i: (ch.kind, ch.superframe.stats)
                     for i, ch in rx.channels.items()},
    }


def test_port_chain_matches_jax_chain(capture):
    jrx, jgot = _run(JStream, JDemod, JRx, capture)
    trx, tgot = _run(TStream, TDemod, TRx, capture)
    assert tgot["frames"] == jgot["frames"] >= NB_FRAMES - 1
    assert tgot["desync"] == jgot["desync"] == 0
    assert tgot["fibs"] == jgot["fibs"]
    assert _db_view(trx) == _db_view(jrx)
    assert jrx.db.ensemble.id == 0xC0FE and len(jrx.db.services) == 3
    assert sorted(tgot["aus"]) == [1, 2, 3]
    for sub_id, aus in jgot["aus"].items():
        assert len(aus) >= 6
        assert tgot["aus"][sub_id] == aus


def test_radio_cli_matches_jax_cli(capture, tmp_path, capfd, monkeypatch):
    # the JAX summarize() binds sys.stderr when its module is imported
    # (ROADMAP F5); point it at this test's stderr for this test only, and
    # keep the JAX CLI from turning on its on-disk compile cache in-process
    monkeypatch.setattr(jcli.summarize, "__defaults__", (sys.stderr,))
    monkeypatch.setattr(jax_cache, "enable_compile_cache", lambda: None)
    path = tmp_path / "capture.u8"
    iq = capture / np.abs(capture).max() * 0.5
    path.write_bytes(iq_quantize_u8(iq))
    argv = ["-i", str(path), "-F", "u8", "--benchmark", "--backend", "cpu"]
    capfd.readouterr()
    assert jcli.main(argv) == 0
    jerr = capfd.readouterr().err
    assert tcli.main(argv) == 0
    terr = capfd.readouterr().err

    def summary(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("benchmark:")]
    assert summary(terr) == summary(jerr)
    assert "desync=0" in terr and "id=C0FE" in terr
    assert "rs_err=0 au_err=0" in terr
    assert "benchmark: frames=" in terr


def test_radio_cli_refuses_what_is_not_ported(tmp_path):
    path = tmp_path / "empty.u8"
    path.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcli.main(["-i", str(path), "--viterbi", "tiled", "--backend", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["-i", str(path), "--backend", "cuda"])


def test_radio_cli_snapshot_resume_matches_one_run(capture, tmp_path, capfd):
    """--snapshot-out then --resume on the rest of the capture ends with the
    summary of one uninterrupted run: the pickled state is complete, and it
    holds numpy arrays only."""
    iq = capture / np.abs(capture).max() * 0.5
    raw = iq_quantize_u8(iq)
    cut = (len(raw) // 2) & ~1
    paths = [tmp_path / n for n in ("all.u8", "head.u8", "tail.u8")]
    for p, b in zip(paths, (raw, raw[:cut], raw[cut:])):
        p.write_bytes(b)
    snap = tmp_path / "state.pkl"

    def run(*args):
        capfd.readouterr()
        assert tcli.main(["-F", "u8", "--backend", "cpu", *args]) == 0
        err = capfd.readouterr().err
        return err[err.rindex("ensemble: id="):]
    full = run("-i", str(paths[0]))
    run("-i", str(paths[1]), "--snapshot-out", str(snap))
    resumed = run("-i", str(paths[2]), "--resume", str(snap))
    assert resumed == full
    state = pickle.loads(snap.read_bytes())
    assert b"_rebuild_tensor" not in state["radio"]       # no tensors inside
    assert all(isinstance(x, np.ndarray) for x in state["demod"]["carry"])
