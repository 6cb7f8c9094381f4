"""The mesh round at four ranks and ``FusedFleet(mesh=...)``, over ranks of
a gloo process group on the CPU, against the JAX package on a mesh of the
same axis sizes (tests/conftest.py's 8 virtual CPU devices); and the dry
run of ``dab_radio_tpu_torch.parallel.dryrun`` at four ranks against the
port's one-device decoders.

One launch of four ranks runs the cases of this file (tests/torch_ranks.py
says how). The fleet cases serve two DAB+ ensembles with seeded access
units; the access units of every stream, in order, must be those of the
JAX fleet, before and after a snapshot is restored. The tolerances of the
round are those of tests/test_torch_parallel_mesh.py.
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.fused_fleet import FusedFleet as JFleet
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import subchannel_config_from_jax as own
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet as TFleet
from dab_radio_tpu.models.fleet import ReceiverFleet as JRxFleet
from dab_radio_tpu_torch.convert import multistream_state_from_jax
from torch_ranks import (FS, HALO, MODE, STEP_FLAGS, assert_round_close,
                         assert_soft_close, capture, drive_multistream,
                         jax_multistream, jmesh_of, multistream_chunks,
                         quantise_u8, run_dryrun, run_ranks, step_cases,
                         step_reference)

torch.set_num_threads(1)

HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
AUDIO_CFGS = [JCfg(0, 12, **EEP3A), JCfg(12, 12, **EEP3A)]
FLEET_FRAMES = 33                # 8 rounds of 4 frames and the tail
# the ens x sub fleet: 4 frames a round, a snapshot after 6 rounds, then
# restored on the same mesh and on one of another 'time' factor
FLEET_ENS = dict(axes=(2, 1, 2), K=4, nb_rounds=6, nb_more=2,
                 restore_on={"same": (2, 1, 2), "time2": (1, 2, 2)})
# the time x sub fleet: 2 frames a time rank, 4 a round
FLEET_TIME = dict(axes=(1, 2, 2), K=2, nb_rounds=6, nb_more=0, restore_on={})


def audio_u8(seed, cfo_hz):
    """u8 IQ of a two-service DAB+ ensemble with seeded access units."""
    services = [ServiceSpec(0xF200 + 16 * seed + i, i + 1, f"E{seed} {i}",
                            cfg, superframe_header=HDR)
                for i, cfg in enumerate(AUDIO_CFGS)]
    tx = EnsembleTransmitter(MODE, ensemble_id=0xC0F0 + seed,
                             ensemble_label=f"Mesh {seed}", services=services)
    for s in services:
        rng = np.random.default_rng(s.service_id)
        tx.set_au_source(s.subchannel_id, lambda cap, num, rng=rng: [
            rng.integers(0, 256, n).astype(np.uint8).tobytes()
            for n in [cap // num] * (num - 1) + [cap - cap // num * (num - 1)]])
    iq = ChannelModel(cfo_hz=cfo_hz, snr_db=18.0, seed=seed).apply(
        tx.generate(FLEET_FRAMES))
    return np.frombuffer(iq_quantize_u8(
        (iq / np.abs(iq).max() * 0.5).astype(np.complex64)), np.uint8)


def fleet_case(u8, spec):
    chunk = 2 * spec["axes"][1] * spec["K"] * FS
    tb = 2 * HALO
    rounds = [(u8[:, r * chunk:(r + 1) * chunk],
               u8[:, (r + 1) * chunk:(r + 1) * chunk + tb])
              for r in range(spec["nb_rounds"] + spec["nb_more"])]
    return dict(kind="fleet", axes=spec["axes"], N=2, K=spec["K"],
                cfgs=[own(c) for c in AUDIO_CFGS],
                rounds=rounds[:spec["nb_rounds"]],
                more_rounds=rounds[spec["nb_rounds"]:],
                restore_on=spec["restore_on"])


def fleet_reference(case):
    """The JAX fleet's AUs over the rounds and over the more_rounds, and
    its summary, labels and health signals after the rounds."""
    fleet = JFleet(case["N"], AUDIO_CFGS, MODE, case["K"],
                   mesh=jmesh_of(case["axes"]))
    aus = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, h: aus.append((b, s, bytes(au))))
    for blk, tail in case["rounds"]:
        fleet.process_round(blk, tail_u8=tail)
    first = list(aus)
    summary = fleet.summary()
    health = (fleet.drift_correction, fleet.last_fib_ok,
              fleet.materialized_rounds)
    labels = [rx.db.ensemble.label for rx in fleet.receivers]
    for blk, tail in case["more_rounds"]:
        fleet.process_round(blk, tail_u8=tail)
    return {"aus": first, "more": aus[len(first):], "summary": summary,
            "labels": labels, "health": health}


def by_stream(aus):
    out = {}
    for b, s, au in aus:
        out.setdefault(b, []).append((s, au))
    return out


# the batched path over a mesh: four streams, a rank each on (4, 1, 1), from
# the start and from the JAX batch's state after its first MS_RESUME_AFTER
# pushes (early enough that a fresh fleet still finds superframes in the
# rest); (2, 1, 2) is refused
MS_AXES = (4, 1, 1)
MS_RESUME_AFTER = 2


def multistream_cases(u8):
    """The multistream cases, and the JAX batches they are held against: a
    fresh one, and one that has run the first pushes (whose state the
    second case's ranks load)."""
    chunks = multistream_chunks(u8)
    resumed = jax_multistream(len(u8), MS_AXES)
    drive_multistream(resumed, JRxFleet(len(u8), MODE),
                      chunks[:MS_RESUME_AFTER])
    cases = {"ms_ens": dict(kind="multistream", axes=MS_AXES, chunks=chunks,
                            state=None),
             "ms_resume": dict(kind="multistream", axes=MS_AXES,
                               chunks=chunks[MS_RESUME_AFTER:],
                               state=multistream_state_from_jax(resumed)),
             "ms_sub": dict(kind="multistream", axes=(2, 1, 2),
                            chunks=chunks[:1], state=None)}
    return cases, {"ms_ens": jax_multistream(len(u8), MS_AXES),
                   "ms_resume": resumed}


def multistream_reference(case, jms):
    if jms is None:
        return None
    fleet = JRxFleet(jms.B, MODE)
    frames, aus = drive_multistream(jms, fleet, case["chunks"])
    return {"frames": frames, "aus": aus, "tracking": jms.tracking.tolist(),
            "unread": [x.shape[0] for x in jms.bufs],
            "carry": [np.asarray(x) for x in jms.carry],
            "labels": [rx.db.ensemble.label for rx in fleet.receivers]}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    caps = [capture(4, 9, 700.0), capture(5, 9, -1500.0)]
    cases = step_cases(quantise_u8(np.stack(caps)), (1, 2, 2))
    u8 = np.stack([audio_u8(1, 1100.0), audio_u8(2, -700.0)])
    cases["fleet_ens"] = fleet_case(u8, FLEET_ENS)
    cases["fleet_time"] = fleet_case(u8, FLEET_TIME)
    ms_cases, jms = multistream_cases(np.concatenate(
        [u8, np.stack([audio_u8(3, 400.0), audio_u8(4, -1300.0)])]))
    cases.update(ms_cases)
    refs = {"step": step_reference, "fleet": fleet_reference}

    def reference():
        return {name: multistream_reference(c, jms.get(name))
                if c["kind"] == "multistream" else refs[c["kind"]](c)
                for name, c in cases.items()}
    ref, res = run_ranks(tmp_path_factory.mktemp("four_ranks"), 4, cases,
                         reference)
    return cases, ref, res


@pytest.mark.parametrize("flags", list(STEP_FLAGS))
def test_step_over_time_and_sub_ranks_matches_jax(four_ranks, flags):
    """multichip_receiver_step over (1, 2, 2): each time rank demodulates
    its two frames of the round with the halo of its neighbour, the frames
    are gathered, each sub rank decodes two of the four subchannels."""
    cases, ref, res = four_ranks
    key = f"step_1x2x2_{flags}"
    for jround, tround in zip(ref[key], res[key], strict=True):
        assert_round_close(jround, tround)


@pytest.mark.parametrize("name", ["fleet_ens", "fleet_time"])
def test_fleet_on_a_mesh_matches_jax(four_ranks, name):
    """FusedFleet(mesh=) serves each ens group's streams on its leader: the
    access units of every stream, the ensemble labels and the access-unit
    count of the leaders' summaries are those of the JAX fleet on the same
    mesh."""
    cases, ref, res = four_ranks
    parts, want = res[name], ref[name]
    leaders = [p for p in parts if "summary" in p]
    assert [p["rank"] for p in leaders] == \
        ([0, 2] if name == "fleet_ens" else [0])
    got = [a for p in parts for a in p["aus"]]
    assert not any(p["aus"] for p in parts if "summary" not in p)
    assert want["summary"]["access_units"] > 0
    assert by_stream(got) == by_stream(want["aus"])
    assert sum(p["summary"]["access_units"] for p in leaders) \
        == want["summary"]["access_units"]
    assert sum(p["summary"]["streams"] for p in leaders) == 2
    assert [lb for p in leaders for lb in p["labels"]] == want["labels"]


@pytest.mark.parametrize("name", ["fleet_ens", "fleet_time"])
def test_fleet_health_is_every_ranks(four_ranks, name):
    """Every rank, leader or not, reads its streams' drift correction and
    valid-FIB count of the last round, and the rounds materialized, as the
    JAX fleet gives them for those streams: a serving loop on any rank
    moves its read grid by the same offsets."""
    parts, want = four_ranks[2][name], four_ranks[1][name]
    offsets, fib_ok, rounds = want["health"]
    assert fib_ok.min() > 0 and rounds == len(four_ranks[0][name]["rounds"])
    for p in parts:
        (lo, hi), (t_off, t_ok, t_rounds) = p["rows"], p["health"]
        np.testing.assert_array_equal(t_off, offsets[lo:hi])
        np.testing.assert_array_equal(t_ok, fib_ok[lo:hi])
        assert t_rounds == rounds


def test_snapshot_restores_across_ens_and_sub_only(four_ranks):
    """A snapshot of the (2, 1, 2) fleet restores on the same mesh and on
    one process, and both go on to decode what the JAX fleet decodes; on a
    mesh with another 'time' factor it is refused."""
    cases, ref, res = four_ranks
    parts, want = res["fleet_ens"], ref["fleet_ens"]
    assert want["more"]
    more = [a for p in parts for a in p["restored"]["same"][0]]
    assert by_stream(more) == by_stream(want["more"])
    for p in parts:
        assert "time" in p["restored"]["time2"]
    blob = parts[0]["snapshot"]
    assert all(p["snapshot"] is None for p in parts[1:])
    fleet = TFleet.from_snapshot(blob, "cpu")
    assert fleet.total_rounds == 6 and fleet.mesh is None
    aus = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, h: aus.append((b, s, bytes(au))))
    for blk, tail in cases["fleet_ens"]["more_rounds"]:
        fleet.process_round(blk, tail_u8=tail)
    assert by_stream(aus) == by_stream(want["more"])


def test_snapshot_of_a_time_sharded_fleet_is_refused_on_one_device(four_ranks):
    """The carry of a fleet over two time ranks has two columns a stream:
    one device cannot take it."""
    blob = four_ranks[2]["fleet_time"][0]["snapshot"]
    with pytest.raises(ValueError, match="'time' axis"):
        TFleet.from_snapshot(blob, "cpu")


def test_fleet_rejects_a_mesh_it_does_not_split_over():
    from dab_radio_tpu_torch.parallel.mesh import ReceiverMesh
    with pytest.raises(ValueError, match="do not split"):
        TFleet(3, [own(c) for c in AUDIO_CFGS], MODE, 4, device="cpu",
               mesh=ReceiverMesh((2, 1, 1)))
    # a round on a mesh is the whole round of all N streams
    fleet = TFleet(2, [own(c) for c in AUDIO_CFGS], MODE, 4, device="cpu",
                   mesh=ReceiverMesh((2, 1, 1), 1))
    assert fleet.rows == (1, 2)
    with pytest.raises(ValueError, match="all 2 streams"):
        fleet.process_round(np.zeros((1, 8 * FS), np.uint8))


def test_dryrun_on_four_ranks(tmp_path):
    """The dry run over (1, 2, 2): one stream in two time blocks, a UEP and
    an EEP-A subchannel on two sub ranks, bit-exact against FICDecoder and
    MSCDecoder; no rank loads JAX."""
    report = run_dryrun(tmp_path, 4, (1, 2, 2))
    assert report["mesh"] == {"ens": 1, "time": 2, "sub": 2}
    assert report["subchannels"] == ["EEP3-A", "UEP#0"]
    assert [r["coords"]["time"] for r in report["ranks"]] == [0, 0, 1, 1]


@pytest.mark.parametrize("name", ["ms_ens", "ms_resume"])
def test_multistream_on_a_mesh_matches_jax(four_ranks, name):
    """MultiStreamDemodulator(mesh=) on (4, 1, 1): each rank holds and steps
    the stream of its ens coordinate, and a ReceiverFleet of that stream
    decodes it on the same rank. Against the JAX class whose windows' rows
    are split over the same mesh: every stream's frames in order (soft bits
    within the 1 LSB on 5e-3 of ROADMAP F3), its access units and ensemble
    label, its lock flag, unread samples and integer carry are the JAX
    batch's; the ranks' rows together are all four streams. ms_resume
    starts each rank from its rows of the JAX batch's state after its
    first pushes."""
    parts, want = four_ranks[2][name], four_ranks[1][name]
    assert sorted(p["rows"] for p in parts) == [(b, b + 1) for b in range(4)]
    assert sum(len(v) for v in want["aus"].values()) > 0
    for p in parts:
        lo, hi = p["rows"]
        for b in range(lo, hi):
            got = [bits for _, s, bits in p["frames"] if s == b]
            exp = [bits for _, s, bits in want["frames"] if s == b]
            assert len(got) == len(exp) >= 8, b
            assert_soft_close(np.stack(got), np.stack(exp), f"stream {b}")
            assert p["aus"].get(b) == want["aus"].get(b) and p["aus"][b], b
        assert p["labels"] == want["labels"][lo:hi]
        assert p["tracking"] == want["tracking"][lo:hi]
        assert p["unread"] == want["unread"][lo:hi]
        for k in (2, 4, 5):              # the lock flag and the counters
            np.testing.assert_array_equal(p["carry"][k],
                                          want["carry"][k][lo:hi])


def test_multistream_refuses_a_mesh_with_sub_ranks(four_ranks):
    """JAX's device_put of the windows splits rows only: a mesh whose 'sub'
    axis is above 1 is refused on every rank, with the axis named."""
    parts = four_ranks[2]["ms_sub"]
    assert len(parts) == 4
    for p in parts:
        assert "'sub' axis has 2 ranks" in p["refused"]


def test_multistream_mesh_checks_in_one_process():
    """On one process: the rows of rank 1 of (2, 1, 1), pushes outside them
    refused, the 'time' axis refused, and a state of another batch."""
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    from dab_radio_tpu_torch.models.multistream import MultiStreamDemodulator
    from dab_radio_tpu_torch.parallel.mesh import ReceiverMesh
    demod = OFDMDemodulator(MODE, device="cpu")
    ms = MultiStreamDemodulator(demod, 4, ingest="u8", device="cpu",
                                mesh=ReceiverMesh((2, 1, 1), 1))
    assert ms.rows == (2, 4) and ms.B == 2 and ms.step() == []
    ms.push(3, np.zeros(8, np.uint8))
    with pytest.raises(ValueError, match=r"\[2, 4\)"):
        ms.push(1, np.zeros(8, np.uint8))
    with pytest.raises(ValueError, match="'time' axis has 2"):
        MultiStreamDemodulator(demod, 4, device="cpu",
                               mesh=ReceiverMesh((2, 2, 1), 0))
    with pytest.raises(ValueError, match="does not split"):
        MultiStreamDemodulator(demod, 3, device="cpu",
                               mesh=ReceiverMesh((2, 1, 1), 0))
    other = MultiStreamDemodulator(demod, 3, ingest="u8", device="cpu")
    state = {"carry": [x.numpy() for x in other.carry], "bufs": other.bufs,
             "tracking": other.tracking, "l1": other.l1,
             "frames_emitted": 0, "ingest": "u8"}
    with pytest.raises(ValueError, match="another batch"):
        ms.load_state(state)
