"""The JAX package's remaining compiled programs as the port's programs
(``utils/graphs.py``), on the CPU: the FIC and MSC decodes of the one-stream
path and the fleet, ``MultiStreamDemodulator``'s masked round, acquisition
and its L1 level, the modulator, and the mesh step's bodies.

A CUDA graph exists only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold each captured program against its eager run, bit for
bit). Here the programs run under ``Replayed`` (tests/test_torch_graphs.py),
a CPU stand-in for a captured program that hands out its results in buffers
which the next call of the same shapes overwrites, as a replay does:

* ``DabReceiver`` keeps one decode group a protection shape from frame to
  frame, its members' histories held by the group's program; fed the same
  soft-bit frames of a JAX-transmitter ensemble whose channel set grows
  between the first and the second frame (the FIC names 11 of its 13
  services in the first), its FIBs, MSC payloads and access units equal the JAX
  receiver's: exact and tiled, straight through and with a snapshot and
  resume in the middle; ``MSCDecoder.history`` reads the group's rows;
* ``ReceiverFleet`` equals the JAX fleet on the same frames;
* ``MultiStreamDemodulator``'s round program equals its eager run bit for
  bit, and the JAX batch within F3's tolerance (soft bits within 1 LSB, the
  carry's floats within 1e-5), at K = 1 and K = 2;
* ``OFDMModulator`` equals its eager run bit for bit and JAX's within FFT
  rounding (atol 2e-3 on samples of magnitude ~40); acquisition and L1
  equal JAX's (found and end index exact, the level to 1e-6 relative);
* every new body makes no tensor from host data and reads no device value
  on the host (``HostTraffic``), and ``cuda_graph=True`` raises on the CPU
  for every new constructor.
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab import msc as jmsc
from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.models.demodulator import OFDMDemodulator as JDemod
from dab_radio_tpu.models.modulator import OFDMModulator as JMod
from dab_radio_tpu.models.multistream import MultiStreamDemodulator as JMulti
from dab_radio_tpu.models.receiver import DabReceiver as JRx
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg, get_ofdm_params
from dab_radio_tpu_torch.dab import fic as tfic, msc as tmsc
from dab_radio_tpu_torch.models.demodulator import DemodCarry
from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator as TDemod
from dab_radio_tpu_torch.models.fleet import ReceiverFleet as TFleet
from dab_radio_tpu_torch.models.fused_fleet import _Fetch
from dab_radio_tpu_torch.models.modulator import OFDMModulator as TMod
from dab_radio_tpu_torch.models.multistream import (
    MultiStreamDemodulator as TMulti)
from dab_radio_tpu_torch.models.receiver import DabReceiver as TRx
from dab_radio_tpu_torch.parallel.mesh import (
    ReceiverMesh, make_coldstart_timesharded_demod, make_timesharded_demod,
    multichip_receiver_step)
from dab_radio_tpu_torch.params import SubchannelConfig as TCfg
from dab_radio_tpu_torch.utils.graphs import CapturedProgram

from test_torch_graphs import HostTraffic, Replayed, k1_stubbed  # noqa: F401
from test_torch_fleet import (ensembles, jax_full, rounds,  # noqa: F401
                              run as run_fleet)
from test_torch_multistream import (MODE as MS_MODE, assert_frames_close,
                                    assert_state_equal, drive)
from test_torch_multistream import streams  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
NB_EEP = 12             # some of them only named in the second frame
NB_FRAMES = 12
CUT = 6                          # the frame before which a snapshot is taken


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


@pytest.fixture(scope="module")
def frames():
    """(nb_frame_bits,) int8 soft-bit frames of a mode-I ensemble of 12 EEP
    3-A services of 12 CU and one UEP service (a decode of its own), from
    the JAX transmitter, with Gaussian noise from a numpy seed."""
    cfgs = [JCfg(12 * i, 12, **EEP3A) for i in range(NB_EEP)]
    cfgs.append(JCfg(12 * NB_EEP, 21, True, uep_table_index=1))
    services = [ServiceSpec(0xA200 + i, i + 1, f"Svc {i}", c,
                            superframe_header=HDR)
                for i, c in enumerate(cfgs)]
    tx = EnsembleTransmitter(1, services=services)
    for s in services:
        tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
    rng = np.random.default_rng(13)
    out = []
    for _ in range(NB_FRAMES):
        soft = np.asarray(tx.next_frame_bits()).astype(np.float64)
        soft = soft + rng.normal(0.0, 40.0, soft.shape)
        out.append(np.clip(np.round(soft), -127, 127).astype(np.int8))
    return out


def replaying(monkeypatch, *modules):
    """Every program that the modules make from now on runs under
    Replayed; returns the list of the groups made."""
    made = []
    for mod in modules:
        monkeypatch.setattr(mod, "CapturedProgram",
                            lambda *a, **k: Replayed(CapturedProgram(*a, **k)))
    group = tmsc.MSCDecodeGroup

    class Counted(group):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(tmsc, "MSCDecodeGroup", Counted)
    return made


class Tap:
    """A receiver's FIBs, MSC payloads and access units as they come."""

    def __init__(self):
        self.fibs, self.payloads, self.aus = [], {}, {}

    def attach(self, rx):
        inner = rx.fic.decode_fic

        def decode_fic(bits):
            fibs, err = inner(bits)
            self.fibs.append((fibs, err["crc_errors"]))
            return fibs, err
        rx.fic.decode_fic = decode_fic
        rx.on_audio_channel.append(self.on_channel)
        for sub_id, ch in rx.channels.items():     # a restored receiver's
            self.on_channel(sub_id, ch)

    def on_channel(self, sub_id, ch):
        pay = self.payloads.setdefault(sub_id, [])
        aus = self.aus.setdefault(sub_id, [])
        ch.events.on_frame_data.append(lambda p: pay.append(bytes(p)))
        ch.events.on_access_unit.append(
            lambda i, n, au, h: aus.append(bytes(au)))


def receive(Rx, frames, cut=None):
    """Feed the frames; with cut, snapshot the receiver before frame cut and
    go on with the one restored from it. Returns (tap, receiver, the
    channel counts after each frame)."""
    rx, tap, counts = Rx(), Tap(), []
    tap.attach(rx)
    for f, frame in enumerate(frames):
        if f == cut:
            rx = type(rx).from_snapshot(rx.snapshot())
            tap.attach(rx)
        rx.process_frame(frame)
        counts.append(len(rx.channels))
    return tap, rx, counts


@pytest.mark.parametrize("cut", [None, CUT], ids=["straight", "resumed"])
@pytest.mark.parametrize("mode", ["exact", "tiled"])
def test_receiver_groups_match_jax(frames, monkeypatch, mode, cut):
    """DabReceiver with its decode groups kept from frame to frame (and
    replayed programs) against the JAX receiver: the channel set grows
    from 11 to 13 after the first frame, the group of EEP 3-A to its 12
    members; FIBs, payloads and access units identical, the group rebuilt
    only when its members change, and the histories the JAX decoders'."""
    made = replaying(monkeypatch, tmsc, tfic)
    try:
        jmsc.set_decode_mode(mode)
        tmsc.set_decode_mode(mode)
        jtap, jrx, jcounts = receive(lambda: JRx(1), frames)
        ttap, trx, tcounts = receive(lambda: TRx(1, device=CPU), frames, cut)
    finally:
        jmsc.set_decode_mode("exact")
        tmsc.set_decode_mode("exact")
    assert tcounts == jcounts and tcounts[:2] == [NB_EEP - 1, NB_EEP + 1]
    assert ttap.fibs == jtap.fibs
    assert ttap.payloads == jtap.payloads
    assert ttap.aus == jtap.aus
    assert sum(len(a) for a in ttap.aus.values()) >= 100
    assert len(ttap.aus) == NB_EEP + 1
    # one group a shape with two or more members: built on the first
    # frame, again at 12 members (and once more after the resume)
    sizes = [len(g.decoders) for g in made]
    assert sizes[0] < NB_EEP and sizes[1:] == [NB_EEP] * (2 if cut else 1)
    (group,) = trx._groups.values()
    for sub_id, ch in trx.channels.items():
        want = np.asarray(jrx.channels[sub_id].msc.history)
        assert np.array_equal(ch.msc.history.numpy(), want)
        assert ch.msc.nb_pushed == jrx.channels[sub_id].msc.nb_pushed
    assert all(ch.msc._group[0] is group for ch in trx.channels.values()
               if ch.msc.cfg.length == 12)


def test_snapshot_and_history_read_the_groups_rows(frames, monkeypatch):
    """While a group holds the histories, a snapshot and
    MSCDecoder.history read its current rows; a member that decodes alone
    takes its row back, the group's next dispatch takes it in again, and
    the decodes go on equal to the JAX receiver's."""
    replaying(monkeypatch, tmsc, tfic)
    trx, jrx = TRx(1, device=CPU), JRx(1)
    for frame in frames[:5]:
        trx.process_frame(frame)
        jrx.process_frame(frame)
    (group,) = trx._groups.values()
    rows = group.program.read_state()
    for i, dec in enumerate(group.decoders):
        assert torch.equal(dec.history, rows[i])
        assert np.array_equal(dec.__getstate__()["history"], rows[i].numpy())
    restored = TRx.from_snapshot(trx.snapshot())
    assert not restored._groups
    for sub_id, ch in restored.channels.items():
        assert torch.equal(ch.msc.history, trx.channels[sub_id].msc.history)
    # one member decodes a frame alone, in both packages
    cifs = trx.split_frame(frames[5])[1]
    dec = group.decoders[3]
    jdec = next(ch.msc for ch in jrx.channels.values()
                if ch.msc.cfg.start_address == dec.cfg.start_address)
    assert dec.decode_frame(cifs) == jdec.decode_frame(cifs)
    assert dec._group is None
    for frame in frames[6:]:
        trx.process_frame(frame)
        jrx.process_frame(frame)
    assert trx._groups[tmsc.group_key(dec.cfg)] is group
    assert dec._group == (group, 3)
    for sub_id, ch in trx.channels.items():
        assert np.array_equal(ch.msc.history.numpy(),
                              np.asarray(jrx.channels[sub_id].msc.history))


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "depth2"])
def test_fleet_groups_match_jax(ensembles, jax_full, monkeypatch, depth):
    """ReceiverFleet whose FIC decode and persistent decode groups replay
    (a pipelined round's bits copied out right after the dispatch, as the
    card's pinned fetch does) against the JAX fleet: access units and
    state equal, and a group built once a protection shape."""
    made = replaying(monkeypatch, tmsc, tfic)
    fleet = TFleet(3, 1, pipeline_depth=depth, device=CPU)
    assert isinstance(fleet._fic_decode, Replayed)
    fleet._fetch = lambda ts: _Fetch([t.clone() for t in ts], None)
    tsink, tview = run_fleet(fleet, rounds(ensembles, 0, 16))
    jsink, jview = jax_full[depth]
    assert tview == jview and tsink == jsink
    # built as the channels appear, then kept: not one a round
    assert all(any(g is k for k in made) for g in fleet._groups.values())
    assert len(made) <= 2 * len(fleet._groups)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("ingest", ["u8", "c64"])
def test_multistream_round_program(streams, ingest, K):
    """The masked round as one program: replayed (its bits kept on the
    device over later rounds) equal to eager bit for bit, carry included,
    and to the JAX batch within F3's tolerance."""
    kw = dict(frames_per_step=K, ingest=ingest, device=CPU)
    eager = TMulti(TDemod(MS_MODE, device=CPU), 3, cuda_graph=False, **kw)
    replay = TMulti(TDemod(MS_MODE, device=CPU), 3, fetch_bits=False, **kw)
    replay.program = Replayed(replay.program)
    want, wlocks = drive(eager, streams, ingest)
    got, glocks = drive(replay, streams, ingest)
    assert glocks == wlocks and len(got) == len(want) > 40
    assert all(a[:2] == b[:2] and np.array_equal(a[2], b[2])
               for a, b in zip(got, want))
    for a, b in zip(replay.carry, eager.carry):
        assert torch.equal(a, b)
    jms = JMulti(JDemod(MS_MODE), 3, frames_per_step=K, ingest=ingest)
    jwant, jlocks = drive(jms, streams, ingest)
    assert jlocks == glocks
    assert_frames_close(got, jwant)
    assert_state_equal(replay, jms)


@pytest.mark.parametrize("mode", [1, 2])
def test_modulator_programs(mode):
    """modulate_frame and modulate_reference_bytes replayed equal eager bit
    for bit, and JAX's within FFT rounding."""
    p = get_ofdm_params(mode)
    rng = np.random.default_rng(20 + mode)
    bits = rng.integers(0, 2, (p.nb_data_symbols, 2 * p.nb_data_carriers)
                        ).astype(np.uint8)
    data = rng.integers(0, 256, p.nb_data_symbols * p.nb_data_carriers // 4
                        ).astype(np.uint8)
    eager = TMod(mode, CPU, cuda_graph=False)
    replay = TMod(mode, CPU)
    replay._bits_program = Replayed(replay._bits_program)
    replay._bytes_program = Replayed(replay._bytes_program)
    for b in (bits, 1 - bits):                   # the second call replays
        got = replay.modulate_frame(b)
        assert torch.equal(got, eager.modulate_frame(b))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JMod(mode).modulate_frame(b)), rtol=0,
            atol=2e-3)
    kept = replay.modulate_frame(bits)
    replay.modulate_frame(1 - bits)
    assert torch.equal(kept, eager.modulate_frame(bits))   # its own copy
    for d in (data, 255 - data):
        got = replay.modulate_reference_bytes(d)
        assert np.array_equal(got, eager.modulate_reference_bytes(d))
        np.testing.assert_allclose(
            got, np.asarray(JMod(mode).modulate_reference_bytes(d)), rtol=0,
            atol=2e-3)


def test_acquire_and_l1_programs_match_jax(streams):
    """The null-dip search and the L1 level, replayed, against the JAX
    demodulator's jitted _acquire and _l1 on windows of a stream: found
    and end index exact, the level to 1e-6 relative."""
    from dab_radio_tpu.ops.iq import iq_pairs
    jd, td = JDemod(MS_MODE), TDemod(MS_MODE, device=CPU)
    td._acquire_program = Replayed(td._acquire_program)
    td._l1_program = Replayed(td._l1_program)
    W = td.window_len
    found_any = False
    for lo in range(0, 6 * W, W // 2):
        win = streams[0][lo:lo + W]
        jblock = iq_pairs(win)
        jl1 = float(jd._l1(jblock))
        tl1 = td.l1(win)
        assert float(tl1) == pytest.approx(jl1, rel=1e-6)
        jf, je = jd._acquire(jblock, np.float32(jl1))
        tf, te = td.acquire(win, tl1)
        assert (bool(tf), int(te)) == (bool(jf), int(je))
        assert (bool(td.acquire(win, jl1)[0])) == bool(jf)
        found_any |= bool(jf)
    assert found_any


# ---- the new bodies touch nothing on the host ------------------------------

def _second_call_traffic(fn, *args):
    fn(*args)                                  # the warm-up: cached tables
    watch = HostTraffic()
    with watch:
        fn(*args)
    return dict(watch.seen)


def _soft(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("mode", ["exact", "tiled"])
def test_decode_bodies_have_no_host_traffic(k1_stubbed, mode):
    rng = np.random.default_rng(3)
    cfgs = [TCfg(12 * i, 12, False, eep_type="A", eep_prot_level=2)
            for i in range(3)]
    decs = [tmsc.MSCDecoder(c, CPU) for c in cfgs]
    group = tmsc.MSCDecodeGroup(decs)
    cifs = _soft(rng, (4, 55296))
    hist = group.program.read_state()
    assert not _second_call_traffic(group._decode, hist, (cifs, cifs.flip(0)),
                                    (0, 1, 0), mode)
    dec = tmsc.MSCDecoder(cfgs[1], CPU)
    for c in (1, 4):
        assert not _second_call_traffic(dec._decode, dec.history,
                                        cifs[:c, :768], mode)
    fic_body = tfic.fic_program(CPU).fn
    assert not _second_call_traffic(fic_body,
                                    _soft(rng, (8, tfic.fic_spec().nb_in)))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("ingest", ["u8", "c64"])
def test_round_and_acquire_bodies_have_no_host_traffic(ingest, K):
    demod = TDemod(MS_MODE, device=CPU)
    ms = TMulti(demod, 2, frames_per_step=K, ingest=ingest, device=CPU)
    rng = np.random.default_rng(4)
    n = (K * demod.frame_advance if K > 1 else 0) + demod.window_len
    iq = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(
        np.complex64) * 0.2
    raw = torch.from_numpy(iq if ingest == "c64" else np.clip(
        np.round(iq.view(np.float32) * 127.5 + 127.5), 0, 255
    ).astype(np.uint8))
    mask = torch.tensor([True, False])
    carry = DemodCarry.init((2,), device=CPU)._replace(
        signal_l1_avg=torch.full((2,), 0.2))
    assert not _second_call_traffic(ms._masked, carry, raw, mask, K)
    block = torch.from_numpy(iq[0, :demod.window_len])
    assert not _second_call_traffic(demod._acquire_impl,
                                    torch.tensor(0.2), block)
    assert not _second_call_traffic(demod._l1_program.fn, block)


def test_modulator_bodies_have_no_host_traffic():
    mod = TMod(1, CPU)
    p = mod.params
    rng = np.random.default_rng(5)
    bits = torch.from_numpy(rng.integers(
        0, 2, (2, p.nb_data_symbols, 2 * p.nb_data_carriers)).astype(np.uint8))
    data = torch.from_numpy(rng.integers(
        0, 256, (p.nb_data_symbols, p.nb_data_carriers // 4)).astype(np.uint8))
    assert not _second_call_traffic(mod._modulate_bits, bits)
    assert not _second_call_traffic(mod._modulate_bytes, data)


def test_mesh_bodies_have_no_host_traffic(k1_stubbed):
    """The time-sharded demod, the cold start and the round with a mesh (a
    mesh without a process group: its collectives are the identity, as
    NCCL's are operations on the card)."""
    one = ReceiverMesh((1, 1, 1))
    demod = TDemod(MS_MODE, device=CPU)
    rng = np.random.default_rng(6)
    T = 2 * demod.frame_advance
    iq = torch.from_numpy(((rng.normal(size=(2, T)) + 1j * rng.normal(
        size=(2, T))) * 0.2).astype(np.complex64))
    carry = DemodCarry.init((2, 1), device=CPU)._replace(
        signal_l1_avg=torch.full((2, 1), 0.2))
    for bt in (False, True):
        fn = make_timesharded_demod(demod, 2, bt, mesh=one)
        assert not isinstance(fn, CapturedProgram)
        assert not _second_call_traffic(fn, carry, iq, iq[:, :fn.halo])
    cold = make_coldstart_timesharded_demod(demod, one, 2)
    assert not _second_call_traffic(
        cold, iq, torch.zeros((2, cold.halo), dtype=torch.complex64))
    step, (c, h, x) = multichip_receiver_step(
        one, MS_MODE, 1, subchannels_per_shard=2, ensembles_per_shard=2,
        ingest="u8", fuse_fic=True, device=CPU)
    tail = torch.full((2, 2 * step.tail_samples), 127, dtype=torch.uint8)
    assert not _second_call_traffic(step, c, h, x, tail)


@pytest.mark.parametrize("build", [
    lambda: tfic.FICDecoder(1, CPU, cuda_graph=True),
    lambda: tmsc.MSCDecoder(TCfg(0, 12, False, eep_type="A",
                                 eep_prot_level=2), CPU, cuda_graph=True),
    lambda: tmsc.MSCDecodeGroup([tmsc.MSCDecoder(
        TCfg(0, 12, False, eep_type="A", eep_prot_level=2), CPU)],
        cuda_graph=True),
    lambda: TRx(1, device=CPU, cuda_graph=True),
    lambda: TFleet(2, 1, device=CPU, cuda_graph=True),
    lambda: TMulti(TDemod(MS_MODE, device=CPU), 2, device=CPU,
                   cuda_graph=True),
    lambda: TMod(1, CPU, cuda_graph=True),
    lambda: make_timesharded_demod(TDemod(MS_MODE, device=CPU), 1,
                                   cuda_graph=True),
    lambda: make_coldstart_timesharded_demod(
        TDemod(MS_MODE, device=CPU), ReceiverMesh((1, 1, 1)), 1,
        cuda_graph=True)],
    ids=["fic", "msc", "msc_group", "receiver", "fleet", "multistream",
         "modulator", "timesharded", "coldstart"])
def test_cuda_graph_true_raises_on_the_cpu(build):
    with pytest.raises(ValueError, match="cuda_graph=True needs a CUDA"):
        build()
