"""``FusedFleet``: the port (on the CPU) against the JAX package's, fed the
same u8 rounds.

Small mode-II ensembles from the JAX transmitter (two DAB+ subchannels of
12 CU with seeded access units; a DAB+ / MP2 / packet-mode mix), with a
carrier offset and noise from the JAX channel model. The observer events
(access-unit bytes in order, MP2 frames, data groups), the databases,
``last_fib_ok``, ``drift_correction`` and ``summary()`` must be identical:
the byte layer sees decoded bits, which the two packages produce bit for
bit (the soft-bit tolerance of the round itself is in
tests/test_torch_fused_round.py).
"""

import pickle

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.dab.mot import HEADER, UNSCRAMBLED_BODY
from dab_radio_tpu.host.native import iq_convert, iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.demodulator import (OFDMDemodulator as JDemod,
                                              StreamingDemodulator as JStream)
from dab_radio_tpu.models.fused_fleet import FusedFleet as JFleet
from dab_radio_tpu.models.pad_writer import (build_mot_header,
                                             build_mot_segment)
from dab_radio_tpu.models.receiver import DabReceiver as JRx
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import (fused_state_from_jax,
                                         subchannel_config_from_jax as own)
from dab_radio_tpu_torch.models.demodulator import (
    OFDMDemodulator as TDemod, StreamingDemodulator as TStream)
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet as TFleet
from dab_radio_tpu_torch.models.receiver import DabReceiver as TRx

torch.set_num_threads(1)

MODE = 2
K = 4                            # frames a round
NB_FRAMES = 45                   # 11 rounds and the tail
HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
AUDIO_CFGS = [JCfg(0, 12, **EEP3A), JCfg(12, 12, **EEP3A)]
CPU = torch.device("cpu")


# the port's constructors take the device; these stand where the JAX
# package's classes are passed in
def CPU_DEMOD(mode):
    return TDemod(mode, device="cpu")


def CPU_RX(mode):
    return TRx(mode, device="cpu")


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


def _u8(iq):
    return np.frombuffer(iq_quantize_u8(
        (iq / np.abs(iq).max() * 0.5).astype(np.complex64)), np.uint8)


def _audio_iq(ensemble_id, label, cfgs, nb_frames=NB_FRAMES):
    services = [ServiceSpec(0xF200 + 16 * (ensemble_id & 15) + i, i + 1,
                            f"{label} {i}", cfg, superframe_header=HDR)
                for i, cfg in enumerate(cfgs)]
    tx = EnsembleTransmitter(MODE, ensemble_id=ensemble_id,
                             ensemble_label=label, services=services)
    for s in services:
        tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
    return tx.generate(nb_frames)


@pytest.fixture(scope="module")
def streams():
    """(2, bytes) u8: one two-service ensemble through two channels."""
    iq = _audio_iq(0xC0FE, "Fleet", AUDIO_CFGS)
    return np.stack([
        _u8(ChannelModel(cfo_hz=1100.0, snr_db=18.0, seed=1).apply(iq)),
        _u8(ChannelModel(cfo_hz=-700.0, snr_db=16.0, seed=2).apply(iq))])


def tcfgs(cfgs):
    return [[own(c) for c in row] for row in cfgs] \
        if isinstance(cfgs[0], list) else [own(c) for c in cfgs]


def record(fleet):
    """Attach observers; returns the list they append to."""
    events = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, hdr: events.append(
            ("au", b, s, i, n, bytes(au), tuple(vars(hdr).values()))))
    fleet.on_mp2_frame.append(
        lambda b, s, fr: events.append(("mp2", b, s, bytes(fr))))
    fleet.on_data_group.append(
        lambda b, s, res: events.append(("dg", b, s, bytes(res.data))))
    return events


def drive(fleet, u8, rounds, defer=True, health=None):
    """Feed rounds `rounds` (an iterable of round numbers) of u8 (N, bytes),
    each with its tail; appends (fib_ok, drift) of every round to health."""
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    for r in rounds:
        blk = u8[:, r * chunk:(r + 1) * chunk]
        tail = u8[:, (r + 1) * chunk:(r + 1) * chunk + tb]
        fleet.process_round(blk, defer_fetch=defer,
                            tail_u8=tail if tail.shape[1] == tb else None)
        if health is not None:
            health.append((fleet.last_fib_ok.tolist(),
                           fleet.drift_correction.tolist()))
    fleet.flush()


def nb_rounds(fleet, u8):
    return u8.shape[1] // (2 * fleet.round_samples)


def db_view(fleet):
    return [{
        "ensemble": (rx.db.ensemble.id, rx.db.ensemble.label),
        "services": {sid: s.label for sid, s in rx.db.services.items()},
        "subchannels": {i: (s.start_address, s.length, s.is_uep,
                            s.uep_table_index, s.eep_type, s.eep_prot_level)
                        for i, s in rx.db.subchannels.items()},
    } for rx in fleet.receivers]


def full_run(fleet, u8, defer=True):
    events, health = record(fleet), []
    drive(fleet, u8, range(nb_rounds(fleet, u8)), defer, health)
    return {"events": events, "health": health, "summary": fleet.summary(),
            "db": db_view(fleet), "fib_ok": fleet.last_fib_ok.tolist(),
            "materialized": fleet.materialized_rounds}


@pytest.fixture(scope="module")
def jax_runs(streams):
    """The JAX fleet's full run on the shared capture, deferred and not."""
    return {defer: full_run(JFleet(2, AUDIO_CFGS, MODE, K), streams, defer)
            for defer in (True, False)}


def make_tfleet(**kw):
    return TFleet(2, tcfgs(AUDIO_CFGS), MODE, K, device=CPU, **kw)


@pytest.mark.parametrize("defer", [True, False], ids=["deferred", "direct"])
def test_fleet_matches_jax(streams, jax_runs, defer):
    want = jax_runs[defer]
    got = full_run(make_tfleet(), streams, defer)
    aus = [e for e in got["events"] if e[0] == "au"]
    assert len(aus) >= 2 * 2 * 3 * 4          # streams x subs x superframes
    assert {(e[1], e[2]) for e in aus} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert got == want
    assert got["db"][0]["ensemble"] == (0xC0FE, "Fleet")
    assert got["summary"]["services"] == 4
    assert got["materialized"] == got["summary"]["rounds"] == 11
    assert min(got["fib_ok"]) > 0


def test_deferred_fetch_is_one_round_late(streams):
    """With defer_fetch the health signals of round r show up after round
    r + 1; flush() brings the last round in."""
    a, b = make_tfleet(), make_tfleet()
    ha, hb = [], []
    drive(a, streams, range(4), True, ha)
    drive(b, streams, range(4), False, hb)
    assert ha[0] == ([0, 0], [0, 0]) and ha[1:] == hb[:-1]
    assert a.materialized_rounds == b.materialized_rounds == 4
    assert a.last_fib_ok.tolist() == hb[-1][0]


def test_reset_reproduces_a_fresh_decode(streams, jax_runs):
    fleet = make_tfleet()
    first = full_run(fleet, streams)
    fleet.reset()
    del fleet.on_access_unit[:], fleet.on_mp2_frame[:], fleet.on_data_group[:]
    again = full_run(fleet, streams)
    assert again == first == jax_runs[True]


def test_resync_matches_jax(streams):
    """resync() after 5 rounds: the device state restarts, the byte layer and
    the counters go on; both packages then decode alike."""
    def run(fleet):
        events, health = record(fleet), []
        drive(fleet, streams, range(5), True, health)
        fleet.resync()
        assert fleet.materialized_rounds == 0
        assert not fleet.last_fib_ok.any()
        drive(fleet, streams, range(5, 11), True, health)
        return events, health, fleet.summary()
    got = run(make_tfleet())
    assert got == run(JFleet(2, AUDIO_CFGS, MODE, K))
    assert got[2]["rounds"] == 11 and got[2]["access_units"] > 0


def test_snapshot_resume_is_byte_identical(streams, jax_runs):
    fleet = make_tfleet()
    events = record(fleet)
    drive(fleet, streams, range(5))
    # a deferred round is consumed by snapshot() itself
    fleet.process_round(streams[:, 5 * 2 * fleet.round_samples:
                                6 * 2 * fleet.round_samples],
                        defer_fetch=True)
    blob = fleet.snapshot()
    assert fleet.materialized_rounds == 6
    state = pickle.loads(blob)
    assert b"_rebuild_tensor" not in blob                  # numpy only
    assert all(isinstance(x, np.ndarray) for x in state["carry"])
    assert state["hist"].shape == (2, 2, 16, 12 * 64)
    assert "device" not in state

    resumed = TFleet.from_snapshot(blob, CPU)
    assert resumed.total_rounds == 6 and resumed.device == CPU
    assert resumed.last_fib_ok.tolist() == fleet.last_fib_ok.tolist()
    events2 = record(resumed)
    drive(resumed, streams, range(6, 11))
    # round 5 ran without its tail here; the capture has no clock drift, so
    # the decode is that of the uninterrupted run
    assert events + events2 == jax_runs[True]["events"]
    assert resumed.summary() == jax_runs[True]["summary"]
    assert db_view(resumed) == jax_runs[True]["db"]
    # a state of another shape is refused
    other = TFleet(1, tcfgs(AUDIO_CFGS), MODE, K, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        other.load_state(state["carry"], state["hist"])


def test_state_carried_over_from_jax(streams):
    """fused_state_from_jax: two rounds in JAX, the device state carried
    into the port, round three equal in both."""
    jfleet = JFleet(2, AUDIO_CFGS, MODE, K)
    drive(jfleet, streams, range(2))
    tfleet = make_tfleet()
    carry, hist = fused_state_from_jax(jfleet._carry, jfleet._hist)
    assert [x.dtype for x in carry] == [np.float32, np.float32, np.bool_,
                                        np.float32, np.int32, np.int32]
    tfleet.load_state(carry, hist)
    chunk, tb = 2 * tfleet.round_samples, tfleet.tail_bytes
    blk = streams[:, 2 * chunk:3 * chunk]
    tail = streams[:, 3 * chunk:3 * chunk + tb]
    jc, jh, jout = jfleet.step(jfleet._carry, jfleet._hist, blk, tail)
    tc, th, tout = tfleet.step(*tfleet.program.read_state(), blk, tail)
    for k in ("fib_bits", "msc_bits", "offsets"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    assert [int(x) for x in tc.total_frames.ravel()] == [12, 12]
    np.testing.assert_allclose(tc.freq_fine.numpy(), np.asarray(jc.freq_fine),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match=r"\(B, 1\)"):
        fused_state_from_jax([np.zeros(2)] * 6, hist)


def _discover(Stream, Demod, Rx, u8_row):
    demod = Demod(MODE)
    sd, rx = Stream(demod), Rx(MODE)
    need = 2 * 10 * demod.params.nb_frame_samples
    for bits in sd.process(iq_convert(u8_row[:need].tobytes(), "u8")):
        rx.process_frame(bits)
    return rx


@pytest.fixture(scope="module")
def two_ensembles():
    """u8 (2, bytes): two ensembles with different subchannel layouts."""
    rows = [[JCfg(0, 12, **EEP3A), JCfg(12, 12, **EEP3A)],
            [JCfg(6, 18, False, eep_type="B", eep_prot_level=2),
             JCfg(40, 16, True, uep_table_index=0)]]
    caps = [ChannelModel(cfo_hz=500.0 * (k + 1), snr_db=18.0, seed=3 + k)
            .apply(_audio_iq(0xD000 + k, f"Own {k}", row, 33))
            for k, row in enumerate(rows)]
    return rows, np.stack([_u8(c) for c in caps])


def test_from_receiver_one_and_a_list(streams, two_ensembles):
    """Discovery to serving handoff: the layouts and kinds read from the
    database equal the JAX fleet's, the database carries over, and the
    decode matches; a list of receivers gives per-stream rows."""
    jrx = _discover(JStream, JDemod, JRx, streams[0])
    trx = _discover(TStream, CPU_DEMOD, CPU_RX, streams[0])
    jf = JFleet.from_receiver(jrx, nb_streams=2, transmission_mode=MODE,
                              frames_per_step=K)
    tf = TFleet.from_receiver(trx, nb_streams=2, transmission_mode=MODE,
                              frames_per_step=K, device=CPU)
    assert tf.step.subchannel_cfgs == tcfgs(jf.step.subchannel_cfgs) \
        == tcfgs(AUDIO_CFGS)
    assert tf._kinds == jf._kinds == [["audio", "audio"]] * 2
    assert tf.receivers[0].updater is trx.updater
    assert db_view(tf)[0]["ensemble"] == (0xC0FE, "Fleet")   # before a round
    assert full_run(tf, streams[:, :2 * 16 * 49152]) \
        == full_run(jf, streams[:, :2 * 16 * 49152])

    rows, u8 = two_ensembles
    jrxs = [_discover(JStream, JDemod, JRx, row) for row in u8]
    trxs = [_discover(TStream, CPU_DEMOD, CPU_RX, row) for row in u8]
    jf = JFleet.from_receiver(jrxs, transmission_mode=MODE, frames_per_step=K)
    tf = TFleet.from_receiver(trxs, transmission_mode=MODE, frames_per_step=K,
                              device=CPU)
    assert tf.N == 2 and tf.step.per_stream
    assert tf.step.subchannel_cfgs == tcfgs(rows)
    assert tf._nbytes == jf._nbytes
    got = full_run(tf, u8)
    assert got == full_run(jf, u8)
    assert {(e[1], e[2]) for e in got["events"]} \
        == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert [d["ensemble"] for d in got["db"]] \
        == [(0xD000, "Own 0"), (0xD001, "Own 1")]


def _mixed_capture():
    """A mode-I ensemble of a DAB+ service, an MP2 service and a packet-mode
    service carrying a MOT object: (services, u8 (1, bytes))."""
    services = [
        ServiceSpec(0xA001, 1, "AAC Service", JCfg(0, 12, **EEP3A),
                    kind="dab+"),
        ServiceSpec(0xA002, 2, "MP2 Service",
                    JCfg(12, 84, True, uep_table_index=33), kind="dab"),
        ServiceSpec(0xA003, 3, "Data Service", JCfg(96, 48, **EEP3A),
                    kind="packet", scid=0x10, packet_address=2),
    ]
    tx = EnsembleTransmitter(1, services=services)
    tx.enable_tone_audio()
    rng = np.random.default_rng(7)
    body = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    segs = [body[i:i + 128] for i in range(0, len(body), 128)]
    for _ in range(8):
        tx.push_packet_data_group(
            3, build_mot_segment(HEADER, 0, True, 0x42,
                                 build_mot_header(body, "file.bin")))
        for i, seg in enumerate(segs):
            tx.push_packet_data_group(
                3, build_mot_segment(UNSCRAMBLED_BODY, i,
                                     i == len(segs) - 1, 0x42, seg))
    iq = ChannelModel(cfo_hz=300.0, snr_db=20.0, seed=11).apply(
        tx.generate(21))
    return services, body, _u8(iq)[None]


@pytest.fixture(scope="module")
def mixed():
    return _mixed_capture()


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "two_workers"])
def test_mixed_kinds_match_jax(mixed, workers):
    """DAB+ superframes, MP2 frames and packet-mode data groups through one
    round, serial and with consume_workers=2: the same events in the same
    order as the JAX fleet's serial consume."""
    services, body, u8 = mixed
    cfgs = [s.cfg for s in services]
    kinds = ["audio", "mp2", ("packet", 2, 0)]

    def run(fleet):
        mot = []
        fleet._sfp[0][2].mot.on_entity.append(mot.append)
        out = full_run(fleet, u8)
        return out, [(m.body, m.header.content_name) for m in mot]
    want, jmot = run(JFleet(1, cfgs, 1, 4, subchannel_kinds=kinds))
    got, tmot = run(TFleet(1, tcfgs(cfgs), 1, 4, device=CPU,
                           subchannel_kinds=kinds, consume_workers=workers))
    assert got == want
    assert tmot == jmot and tmot[0] == (body, "file.bin")
    names = [e[0] for e in got["events"]]
    assert names.count("mp2") == 80 and "au" in names and "dg" in names
    assert got["summary"]["mp2_frames"] == 80
    assert got["summary"]["data_groups"] == names.count("dg")


def test_consume_workers_equal_serial(streams, jax_runs):
    assert full_run(make_tfleet(consume_workers=2), streams) \
        == jax_runs[True]


def test_find_alignment_matches_jax(streams):
    """The byte offset of the first whole frame in a misaligned stream."""
    junk = np.full(2 * 30011, 127, np.uint8)
    stream = np.concatenate([junk, streams[0][:2 * 5 * 49152]])
    jf = JFleet(1, AUDIO_CFGS[:1], MODE, 2)
    tf = TFleet(1, tcfgs(AUDIO_CFGS[:1]), MODE, 2, device=CPU)
    want = jf.find_alignment(stream)
    assert want is not None and abs(want - junk.shape[0]) <= 2 * 64
    assert tf.find_alignment(stream) == want
    assert tf.find_alignment(streams[1][:2 * 3 * 49152]) \
        == jf.find_alignment(streams[1][:2 * 3 * 49152])
    assert tf.find_alignment(junk) is None is jf.find_alignment(junk)
    assert tf.find_alignment(junk[:1000]) is None
    assert tf.tail_bytes == jf.tail_bytes and tf.round_samples == 2 * 49152


def test_kinds_and_device_arguments():
    with pytest.raises(TypeError, match="device"):
        TFleet(1, tcfgs(AUDIO_CFGS))
    f = TFleet(2, tcfgs(AUDIO_CFGS), MODE, 2, device="cpu",
               subchannel_kinds=["mp2"])
    assert f.device == CPU and f.carry.freq_fine.device == CPU
    assert f._kinds == [["mp2", "audio"]] * 2
    f = TFleet(2, tcfgs(AUDIO_CFGS), MODE, 2, device=CPU,
               subchannel_kinds=[["audio", "mp2"], [("packet", 3, 1)]])
    assert f._kinds == [["audio", "mp2"], [("packet", 3, 1), "audio"]]
    assert f._sfp[0][1] is None and f._sfp[1][0]._fec is not None
    # every decode variant is accepted; what the round rejects, it rejects
    f = TFleet(1, tcfgs(AUDIO_CFGS), MODE, 2, device=CPU, viterbi="tiled")
    assert f._viterbi == "tiled"
    with pytest.raises(ValueError, match="radix8"):
        TFleet(1, tcfgs(AUDIO_CFGS), MODE, 2, device=CPU, viterbi="radix8",
               chainback="fused")


@pytest.mark.parametrize("kw", [
    dict(viterbi="tiled"), dict(viterbi="tiled", chainback="parallel"),
    dict(chainback="fused", viterbi_branch="lut")],
    ids=lambda kw: "-".join(kw.values()))
def test_decode_variants_match_jax_and_survive_a_snapshot(streams, kw):
    """A fleet built with a decode variant gives the JAX fleet's events
    (and, at this SNR, the default fleet's), and a snapshot taken from it
    restores the variant."""
    u8 = streams[:, :2 * 24 * 49152]                    # 6 rounds
    want = full_run(JFleet(2, AUDIO_CFGS, MODE, K, **kw), u8)
    fleet = make_tfleet(**kw)
    events = record(fleet)
    drive(fleet, u8, range(3))
    resumed = TFleet.from_snapshot(fleet.snapshot(), CPU)
    assert (resumed._viterbi, resumed._chainback, resumed._viterbi_branch) \
        == (fleet._viterbi, fleet._chainback, fleet._viterbi_branch) \
        == (kw.get("viterbi", "exact"), kw.get("chainback", "sequential"),
            kw.get("viterbi_branch", "matmul"))
    events2 = record(resumed)
    drive(resumed, u8, range(3, 6))
    assert events + events2 == want["events"]
    assert resumed.summary() == want["summary"]
    assert any(e[0] == "au" for e in events2)


def _corrupting(fleet):
    """Flip bytes of each round's subchannel bytes before the byte layer
    sees them. A subchannel here carries 48 bytes a CIF, so a superframe
    is 2 RS(120,110) codewords of 5 CIFs, byte p of it in codeword p % 2.
    Stream 0, subchannel 0: byte 30 of every CIF, 5 errors (t/2, one in a
    parity byte) in codeword 0 of every superframe: all corrected. Stream
    1, subchannel 1: bytes 13, 15, 17 of each round's second CIF, 3 errors
    in codeword 1, or 6 (uncorrectable) where a superframe holds two."""
    assert fleet._nbytes[0] == [48, 48]
    consume = fleet._consume

    def corrupted(fib_bytes, msc_bytes):
        msc_bytes = msc_bytes.copy()
        msc_bytes[0, 0, :, 30] ^= 0x5A
        msc_bytes[1, 1, 1, [13, 15, 17]] ^= 0xA5
        consume(fib_bytes, msc_bytes)
    fleet._consume = corrupted
    return fleet


def test_batched_byte_layer_takes_rs_syndromes_on_the_device(streams,
                                                             jax_runs):
    """_consume_batched decodes each CIF's superframes with their
    syndromes on the fleet's device: with errors injected into two
    streams' superframes, its events are byte-identical to the sequential
    path's (_stream_job, the host syndromes a superframe at a time), the
    corrected subchannel gives the clean run's AUs, and every codeword of
    its decodes went through the device stage."""
    from dab_radio_tpu_torch.ops.rs import RS_STATS
    seq = _corrupting(make_tfleet())
    seq._consume_batched = lambda fibs, ok, msc: [
        seq._stream_job(b, fibs, ok, msc) for b in range(seq.N)]
    before = dict(RS_STATS)
    want = full_run(seq, streams)
    assert RS_STATS["device_codewords"] == before["device_codewords"]

    before = dict(RS_STATS)
    got = full_run(_corrupting(make_tfleet()), streams)
    used = {k: RS_STATS[k] - before[k] for k in before}
    assert got == want
    assert used["codewords"] > 0
    assert used["device_codewords"] == used["codewords"]
    assert used["gated_rows"] > used["failed_rows"] > 0

    def aus(events, b, s):
        return [e for e in events if e[:3] == ("au", b, s)]
    clean = jax_runs[True]["events"]
    assert aus(got["events"], 0, 0) == aus(clean, 0, 0)
    assert aus(got["events"], 0, 1) == aus(clean, 0, 1)
    assert 0 < len(aus(got["events"], 1, 1)) < len(aus(clean, 1, 1))
