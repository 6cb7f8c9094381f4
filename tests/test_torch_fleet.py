"""``ReceiverFleet``: the port (on the CPU) against the JAX package's, fed
the same frames of soft bits.

Three small mode-I ensembles with mixed layouts (EEP 3-A appears in two of
them, so that the fleet forms a decode group across receivers; a UEP and an
EEP-B shape beside it) from the JAX transmitter's ``next_frame_bits``, with
seeded access units and Gaussian noise on the soft bits from a numpy seed.
The decoded bits are exact in both packages, so the access units in order,
the databases and the counters must be identical: synchronous and
pipelined, with partial rounds, through a snapshot, and across a switch of
package in mid-stream (``convert.fleet_snapshot_from_jax``).
"""

import pickle

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.models.fleet import ReceiverFleet as JFleet
from dab_radio_tpu.models.receiver import DabReceiver as JRx
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import fleet_snapshot_from_jax
from dab_radio_tpu_torch.dab import msc as tmsc
from dab_radio_tpu_torch.dab.fic import FICDecoder, _fic_decode_fn
from dab_radio_tpu_torch.models.fleet import ReceiverFleet as TFleet
from dab_radio_tpu_torch.models.receiver import DabReceiver as TRx

torch.set_num_threads(1)

CPU = torch.device("cpu")
NB_FRAMES = 16
HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
LAYOUTS = [
    [JCfg(0, 12, **EEP3A), JCfg(12, 12, **EEP3A)],
    [JCfg(4, 12, **EEP3A), JCfg(20, 16, True, uep_table_index=0)],
    [JCfg(0, 18, False, eep_type="B", eep_prot_level=2)],
]


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


@pytest.fixture(scope="module")
def ensembles():
    """[ensemble][frame] -> (nb_frame_bits,) int8 noisy soft bits."""
    rng = np.random.default_rng(42)
    out = []
    for k, layout in enumerate(LAYOUTS):
        services = [ServiceSpec(0xA100 + 16 * k + i, i + 1, f"Ens{k} Svc {i}",
                                cfg, superframe_header=HDR)
                    for i, cfg in enumerate(layout)]
        tx = EnsembleTransmitter(1, ensemble_id=0xE000 + k,
                                 ensemble_label=f"Ens {k}", services=services)
        for s in services:
            tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
        frames = []
        for _ in range(NB_FRAMES):
            soft = np.asarray(tx.next_frame_bits()).astype(np.float64)
            soft = soft + rng.normal(0.0, 45.0, soft.shape)
            frames.append(np.clip(np.round(soft), -127, 127).astype(np.int8))
        out.append(frames)
    return out


def attach(fleet):
    """Record every receiver's access units: {(rx, subchannel): [bytes]}."""
    sink = {}
    for k, rx in enumerate(fleet.receivers):
        def on_channel(sub_id, ch, _k=k):
            aus = sink.setdefault((_k, sub_id), [])
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: aus.append(bytes(au)))
        rx.on_audio_channel.append(on_channel)
        for sub_id, ch in rx.channels.items():     # restored receivers
            on_channel(sub_id, ch)
    return sink


def view(fleet):
    return {
        "summary": fleet.summary(),
        "frames": [rx.total_frames for rx in fleet.receivers],
        "db": [{
            "ensemble": (rx.db.ensemble.id, rx.db.ensemble.label),
            "services": {sid: s.label for sid, s in rx.db.services.items()},
            "subchannels": {i: (s.start_address, s.length, s.is_uep,
                                s.uep_table_index, s.eep_type,
                                s.eep_prot_level)
                            for i, s in rx.db.subchannels.items()},
            "channels": {i: (ch.kind, ch.msc.nb_pushed, ch.superframe.stats)
                         for i, ch in rx.channels.items()},
            "updates": rx.updater.stats(),
        } for rx in fleet.receivers]}


def rounds(ensembles, lo, hi, partial=False):
    """Rounds lo..hi-1: every receiver's frame, or with `partial` a round
    that leaves out receiver (f % 3) (its frames then run one round late)."""
    nxt = [lo] * len(ensembles)
    out = []
    for f in range(lo, hi):
        who = [k for k in range(len(ensembles))
               if not (partial and k == f % 3)]
        out.append([(k, ensembles[k][nxt[k]]) for k in who if nxt[k] < hi])
        for k in who:
            nxt[k] += 1
    return out


def run(fleet, rnds):
    sink = attach(fleet)
    for frames in rnds:
        fleet.process_frames(frames)
    fleet.flush()
    return sink, view(fleet)


@pytest.fixture(scope="module")
def jax_full(ensembles):
    return {depth: run(JFleet(3, 1, pipeline_depth=depth),
                       rounds(ensembles, 0, NB_FRAMES))
            for depth in (0, 2)}


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "depth2"])
def test_fleet_matches_jax(ensembles, jax_full, depth):
    jsink, jview = jax_full[depth]
    tsink, tview = run(TFleet(3, 1, pipeline_depth=depth, device=CPU),
                       rounds(ensembles, 0, NB_FRAMES))
    assert tview == jview
    assert tsink == jsink
    assert sorted(tsink) == [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1)]
    assert all(len(aus) >= 5 for aus in tsink.values())
    assert tview["summary"] == {"receivers": 3, "frames": 3 * NB_FRAMES,
                                "ensembles_discovered": 3, "channels": 5}


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "depth1"])
def test_partial_rounds_match_jax(ensembles, depth):
    rnds = rounds(ensembles, 0, NB_FRAMES, partial=True)
    jsink, jview = run(JFleet(3, 1, pipeline_depth=depth), rnds)
    tsink, tview = run(TFleet(3, 1, pipeline_depth=depth, device=CPU), rnds)
    assert tview == jview and tsink == jsink
    assert any(tsink.values())


def test_fleet_equals_standalone_receivers(ensembles):
    """Inside the port: the batched fleet decodes what one DabReceiver per
    ensemble decodes."""
    tsink, tview = run(TFleet(3, 1, device=CPU),
                       rounds(ensembles, 0, NB_FRAMES))
    for k, frames in enumerate(ensembles):
        rx, aus = TRx(1, device="cpu"), {}

        def on_channel(sub_id, ch):
            got = aus.setdefault(sub_id, [])
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: got.append(bytes(au)))
        rx.on_audio_channel.append(on_channel)
        for f in frames:
            rx.process_frame(f)
        assert {(k, s): a for s, a in aus.items()} \
            == {key: a for key, a in tsink.items() if key[0] == k}


def test_frames_as_tensor_rows_equal_numpy(ensembles):
    """Frames handed over as rows of one tensor (what MultiStreamDemodulator
    returns with fetch_bits=False) decode as the numpy frames do."""
    rnds = rounds(ensembles, 0, 10)
    as_rows = []
    for frames in rnds:
        block = torch.from_numpy(np.stack([f for _, f in frames]))
        as_rows.append([(k, block[n]) for n, (k, _) in enumerate(frames)])
    a = run(TFleet(3, 1, pipeline_depth=2, device=CPU), rnds)
    b = run(TFleet(3, 1, pipeline_depth=2, device=CPU), as_rows)
    assert a == b and any(a[0].values())


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "depth2"])
def test_snapshot_resume_matches_jax(ensembles, jax_full, depth):
    """Snapshot after 9 rounds (in-flight rounds are finalized by it),
    restore, go on: the uninterrupted JAX run's access units and state."""
    cut = 9
    fleet = TFleet(3, 1, pipeline_depth=depth, device=CPU)
    first = attach(fleet)
    for frames in rounds(ensembles, 0, cut):
        fleet.process_frames(frames)
    blob = fleet.snapshot()
    assert not fleet._pending
    assert b"_rebuild_tensor" not in blob                  # numpy only
    state = pickle.loads(blob)
    assert sorted(state) == ["mode", "pipeline_depth", "receivers",
                             "total_frames"]
    resumed = TFleet.from_snapshot(blob, CPU)
    assert resumed.pipeline_depth == depth and resumed.device == CPU
    assert resumed.total_frames == 3 * cut
    second, tview = run(resumed, rounds(ensembles, cut, NB_FRAMES))
    jsink, jview = jax_full[depth]
    assert tview == jview
    assert {k: first.get(k, []) + second.get(k, []) for k in jsink} == jsink


def test_switch_of_package_in_mid_stream(ensembles, jax_full):
    """9 rounds in the JAX fleet, its snapshot carried over by
    convert.fleet_snapshot_from_jax, the rest in the port: the access units
    and the final state of the JAX fleet's uninterrupted run."""
    cut = 9
    jfleet = JFleet(3, 1, pipeline_depth=2)
    first = attach(jfleet)
    for frames in rounds(ensembles, 0, cut):
        jfleet.process_frames(frames)
    blob = fleet_snapshot_from_jax(jfleet.snapshot(), CPU)
    assert b"dab_radio_tpu." not in blob and b"dab_radio_tpu_torch." in blob
    tfleet = TFleet.from_snapshot(blob, CPU)
    assert all(type(rx) is TRx for rx in tfleet.receivers)
    assert all(type(rx.fic) is FICDecoder for rx in tfleet.receivers)
    assert all(type(ch.msc) is tmsc.MSCDecoder and ch.msc.device == CPU
               and torch.is_tensor(ch.msc.history)
               for rx in tfleet.receivers for ch in rx.channels.values())
    second, tview = run(tfleet, rounds(ensembles, cut, NB_FRAMES))
    jsink, jview = jax_full[2]

    def but_update_count(v):
        # the memo of FIBs proven to change nothing is keyed by a mutation
        # clock that is each package's own, so after the switch the FIC
        # carousel's repeats are applied (and counted) once more
        return dict(v, db=[dict(d, updates=d["updates"][:3])
                           for d in v["db"]])
    assert but_update_count(tview) == but_update_count(jview)
    assert {k: first.get(k, []) + second.get(k, []) for k in jsink} == jsink
    # a single JAX receiver's snapshot comes over the same way
    jrx = JRx(1)
    for f in ensembles[2][:6]:
        jrx.process_frame(f)
    trx = pickle.loads(fleet_snapshot_from_jax(jrx.snapshot(), CPU))
    assert type(trx) is TRx and trx.total_frames == 6
    assert trx.db.ensemble.id == 0xE002 and list(trx.channels) == [1]


def test_a_state_that_names_no_device_is_refused():
    """Nothing restored from a pickle lands on the CPU by default: the
    port's states name their device, and convert writes it into the JAX
    package's."""
    rx = TRx(1, device=CPU)
    for obj in (rx, rx.fic, tmsc.MSCDecoder(
            tmsc.SubchannelConfig(0, 12, False, eep_type="A",
                                  eep_prot_level=2), CPU)):
        state = obj.__getstate__()
        assert state.pop("device") == "cpu"
        with pytest.raises(KeyError, match="device"):
            type(obj).__new__(type(obj)).__setstate__(state)
    assert rx.to("cpu") is rx and rx.fic.device == CPU


def test_tiled_decode_mode_matches_jax(ensembles):
    """set_decode_mode("tiled") in both packages: the groups decode through
    the windowed Viterbi, and at this noise the access units are the same."""
    from dab_radio_tpu.dab import msc as jmsc
    rnds = rounds(ensembles, 0, 12)
    exact = run(TFleet(3, 1, pipeline_depth=1, device=CPU), rnds)
    try:
        jmsc.set_decode_mode("tiled")
        tmsc.set_decode_mode("tiled")
        want = run(JFleet(3, 1, pipeline_depth=1), rnds)
        got = run(TFleet(3, 1, pipeline_depth=1, device=CPU), rnds)
    finally:
        jmsc.set_decode_mode("exact")
        tmsc.set_decode_mode("exact")
    assert got == want == exact and any(got[0].values())


def test_arguments_and_shared_fic_decode():
    with pytest.raises(TypeError, match="device"):
        TFleet(2, 1)
    fleet = TFleet(2, 1, device="cpu")
    assert fleet.device == CPU and fleet.receivers[0].device == CPU
    frame = np.zeros(fleet.dab.nb_frame_bits, np.int8)
    with pytest.raises(ValueError, match="one frame per receiver"):
        fleet.process_frames([(0, frame), (0, frame)])
    fleet.process_frames([])                       # an empty round is a no-op
    assert fleet.total_frames == 0
    spec, decode = _fic_decode_fn()
    assert _fic_decode_fn()[1] is decode and spec is fleet.spec
    bits, err = decode(torch.zeros((8, spec.nb_in), dtype=torch.int8))
    assert tuple(bits.shape) == (8, 768) and tuple(err.shape) == (8,)
