"""Classic DAB on the fleet path (the port, on the CPU): MP2 services at UEP
row 35 (96 CU, 128 kbit/s, level 3) through FusedFleet.

- ``fleet_serve``'s --discover route derives "mp2" and UEP row 35 from the
  FIGs, as --subchannels ...:UEP35:mp2 states them;
- FusedFleet's MP2 frames equal the plain reference's decode
  (``benchmark/reference/msc.py``) of the float64 reference demodulator's
  soft bits (``benchmark/reference/demod.py``) over the same u8, and the
  frames sent, after the cold deinterleaver's first 15;
- the MP2 byte layer's span ``fleet/mp2_frames`` and counter ``MP2_STATS``.

Captures come from the port's transmitter, through the port's channel
model at 15 dB (20 dB for the discovery).
"""

import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from dab_radio_tpu_torch.apps import fleet_serve as tserve
from dab_radio_tpu_torch.host.native import iq_quantize_u8
from dab_radio_tpu_torch.models import fused_fleet
from dab_radio_tpu_torch.models.channel import ChannelModel
from dab_radio_tpu_torch.models.fused_fleet import MP2_STATS, FusedFleet
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                    ServiceSpec)
from dab_radio_tpu_torch.params import SubchannelConfig
from dab_radio_tpu_torch.utils.profiler import get_profiler

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CPU = torch.device("cpu")
MODE = 1
K = 2                                   # frames a round
FRAMES = 10                             # frames served
EEP3A = SubchannelConfig(0, 48, False, 0, "A", 2)
UEP35 = SubchannelConfig(48, 96, True, 35)
MP2_SUB = 11                            # the MP2 service's subchannel id
COLD = 15                               # frames a cold deinterleaver spoils


def _u8(iq):
    return np.frombuffer(iq_quantize_u8(
        (iq / np.abs(iq).max() * 0.5).astype(np.complex64)), np.uint8)


def _transmit(services, frames):
    """(IQ, the MP2 frames sent {subchannel id: [frame]}, one a CIF)."""
    tx = EnsembleTransmitter(MODE, services=services, device=CPU)
    sent = {s.subchannel_id: [] for s in services if s.kind == "dab"}
    own = tx._next_subchannel_frame

    def record(sub_id):
        frame = own(sub_id)
        if sub_id in sent:
            sent[sub_id].append(frame)
        return frame
    tx._next_subchannel_frame = record
    return tx.generate(frames), sent


@pytest.fixture(scope="module")
def mixed():
    """2 streams of one ensemble of a DAB+ service at EEP 3-A and an MP2
    service at UEP row 35, through two channels at 15 dB."""
    iq, sent = _transmit([
        ServiceSpec(0xF123, 3, "Radio TPU 0", EEP3A),
        ServiceSpec(0xF200, MP2_SUB, "Classic 0", UEP35, kind="dab")],
        FRAMES + 2)
    u8 = np.stack([
        _u8(ChannelModel(cfo_hz=cfo, snr_db=15.0, seed=seed).apply(iq))
        for cfo, seed in ((3370.0, 1), (-4200.0, 2))])
    return types.SimpleNamespace(u8=u8, sent=sent[MP2_SUB])


def make_fleet(**kw):
    return FusedFleet(2, [EEP3A, UEP35], transmission_mode=MODE,
                      frames_per_step=K, device=CPU,
                      subchannel_kinds=["audio", "mp2"], **kw)


def serve(fleet, u8, rounds=FRAMES // K, defer=True):
    """Align each stream, serve `rounds` rounds with their tails; returns
    (the MP2 frames of each stream, each stream's first sample)."""
    frames = [[] for _ in range(u8.shape[0])]
    fleet.on_mp2_frame.append(lambda b, s, f: frames[b].append(f))
    starts = [fleet.find_alignment(row[:2 * 4 * fleet.fs]) for row in u8]
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    for r in range(rounds):
        blk = np.stack([row[a + r * chunk:a + (r + 1) * chunk]
                        for row, a in zip(u8, starts)])
        tail = np.stack([row[a + (r + 1) * chunk:a + (r + 1) * chunk + tb]
                         for row, a in zip(u8, starts)])
        fleet.process_round(blk, defer_fetch=defer, tail_u8=tail)
    fleet.flush()
    return frames, [a // 2 for a in starts]


def load_reference(name):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import importlib
    return importlib.import_module(f"reference.{name}")


def test_discover_derives_mp2_at_uep_row_35():
    """fleet_serve --discover: FusedFleet.from_receiver reads FIG 0/2's
    ASCTy (classic DAB) as "mp2" and FIG 0/1's table index as UEP row 35,
    for every service; the fleet equals the one --subchannels
    0:96:UEP35:mp2,96:96:UEP35:mp2 builds."""
    services = [ServiceSpec(0xF200 + k, 10 + k, f"Classic {k}",
                            SubchannelConfig(96 * k, 96, True, 35), kind="dab")
                for k in range(2)]
    iq, _ = _transmit(services, 12)
    u8 = _u8(ChannelModel(cfo_hz=1500.0, snr_db=20.0, seed=5).apply(iq))
    args = types.SimpleNamespace(
        resume=None, transmission_mode=MODE, frames_per_step=K,
        viterbi="exact", chainback="sequential", consume_workers=0,
        discover=True, subchannels=None)
    found, _ = tserve._build_fleet(
        args, CPU, 2, lambda: tserve._discover(u8, MODE, CPU))
    cfgs, kinds = tserve.parse_subchannels("0:96:UEP35:mp2,96:96:UEP35:mp2")
    assert found._kinds == [["mp2", "mp2"]] * 2 == [kinds] * 2
    assert found.step.subchannel_cfgs == cfgs
    assert all(c.is_uep and c.uep_table_index == 35 and c.length == 96
               for c in found.step.subchannel_cfgs)
    args.discover, args.subchannels = False, "0:96:UEP35:mp2,96:96:UEP35:mp2"
    given, _ = tserve._build_fleet(args, CPU, 2, None)
    assert given._kinds == found._kinds
    assert given.step.subchannel_cfgs == found.step.subchannel_cfgs


def test_fleet_mp2_frames_equal_the_reference_and_the_frames_sent(mixed):
    """Each stream's MP2 frames, from the 16th on, equal the plain MSC
    reference's decode of the float64 reference demodulator's soft bits
    over the same u8, read on the grid the fleet aligned to; and they are
    the frames sent, in order."""
    demod, msc = load_reference("demod"), load_reference("msc")
    fleet = make_fleet()
    got, starts = serve(fleet, mixed.u8)
    assert int(fleet.carry.total_desync.sum()) == 0
    assert [len(g) for g in got] == [4 * FRAMES] * 2
    ref = demod.Reference(MODE, CPU, "f64")
    caps = [torch.complex(*(torch.as_tensor(row[j::2]).to(torch.float64)
                            .sub(127.5).div(127.5) for j in (0, 1)))
            for row in mixed.u8]
    tracks = [{"capture": b, "frames": FRAMES, "mode": "grid",
               "start": starts[b], "l1": 0.5} for b in range(2)]
    _, bits, lost = ref.run(caps, tracks, [(b, f) for b in range(2)
                                          for f in range(FRAMES)])
    assert lost == [0, 0]
    dab = fused_fleet.get_dab_params(MODE)
    sub = msc.Subchannel(UEP35.start_address, UEP35.length, uep_index=35)
    for b in range(2):
        cifs = np.stack([bits[(b, f)][dab.nb_fic_bits:]
                         for f in range(FRAMES)]).reshape(-1, dab.nb_cif_bits)
        want = msc.mp2_frames(msc.decode(cifs, sub), 128)
        assert len(want) == 4 * FRAMES - COLD
        assert got[b][COLD:] == want
        first = mixed.sent.index(want[0])
        assert want == mixed.sent[first:first + len(want)]


def _span_count(name):
    row = get_profiler().table().get(name)
    return row["count"] if row else 0


@pytest.fixture
def profiler():
    prof = get_profiler()
    prof.reset()
    prof.enabled = True
    try:
        yield prof
    finally:
        prof.enabled = False
        prof.reset()


def test_mp2_span_and_counter(mixed, profiler):
    """fleet/mp2_frames opens once a round in _consume_batched, once a
    stream and round with consume workers, never for a DAB+-only fleet;
    MP2_STATS counts streams x MP2 subchannels x CIFs a round, all synced
    on clean traffic once the deinterleaver is full, and one fewer with a
    header byte altered in the round's bytes."""
    C = 4 * K
    fleet = make_fleet()
    before = dict(MP2_STATS)
    serve(fleet, mixed.u8, rounds=2, defer=False)     # fills the history
    assert _span_count("fleet/mp2_frames") == 2
    assert MP2_STATS["frames"] - before["frames"] == 2 * 1 * C * 2
    assert MP2_STATS["bytes"] - before["bytes"] == 2 * 1 * C * 2 * 384

    # rounds 2 and 3: every frame lies past the cold 15
    u8 = mixed.u8[:, 2 * 2 * fleet.round_samples:]
    warm = dict(MP2_STATS)
    fleet.on_mp2_frame.clear()
    serve(fleet, u8, rounds=2, defer=False)
    frames = MP2_STATS["frames"] - warm["frames"]
    assert frames == 2 * 1 * C * 2
    assert MP2_STATS["synced"] - warm["synced"] == frames

    own = fleet._consume

    def altered(fib, msc):
        msc = msc.copy()
        msc[1, 1, 3, 1] ^= 0x02              # MPEG-1 -> a reserved layer
        return own(fib, msc)
    fleet._consume = altered
    warm = dict(MP2_STATS)
    fleet.on_mp2_frame.clear()
    serve(fleet, u8, rounds=1, defer=False)
    frames = MP2_STATS["frames"] - warm["frames"]
    assert frames == 2 * 1 * C
    assert MP2_STATS["synced"] - warm["synced"] == frames - 1

    profiler.reset()
    workers = make_fleet(consume_workers=2)
    serve(workers, mixed.u8, rounds=2, defer=False)
    assert _span_count("fleet/mp2_frames") == 2 * 2   # streams x rounds

    profiler.reset()
    before = dict(MP2_STATS)
    dabplus = FusedFleet(2, [EEP3A], transmission_mode=MODE,
                         frames_per_step=K, device=CPU)
    serve(dabplus, mixed.u8, rounds=2, defer=False)
    assert _span_count("fleet/mp2_frames") == 0
    assert _span_count("fleet/push_frames") == 2 * C
    assert MP2_STATS == before


def test_mp2_counter_loses_no_update_across_threads():
    """count_mp2_frames from more threads than cores, with a short switch
    interval: no update is lost."""
    heads = np.array([[0xFF, 0xFD], [0xFF, 0xFC], [0xFF, 0xFF], [0, 0xFD]],
                     np.uint8)
    before = dict(MP2_STATS)
    n_threads, calls = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fused_fleet.count_mp2_frames(heads, 1536)
                            for _ in range(calls)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * calls
    assert MP2_STATS["frames"] - before["frames"] == 4 * n
    assert MP2_STATS["synced"] - before["synced"] == 2 * n
    assert MP2_STATS["bytes"] - before["bytes"] == 1536 * n
