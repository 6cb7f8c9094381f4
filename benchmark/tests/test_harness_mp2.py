"""Classic DAB through the harness: a multiplex of a DAB+ service and an
MP2 service at UEP level 3 made, served by the fleet driver and judged by
the same check.verdict; faults in the MP2 frames' record read not
correct; the frozen MP2 coding decodes byte-exact across the period's
seams; the UEP table index is part of the database compared."""

import copy
import types

import numpy as np
import pytest

from conftest import MIXED, MIXED_SERVICES, run_tiny

SEED = 2 ** 32 + 77


@pytest.fixture(scope="module")
def mixed_run(tiny):
    keep = {}
    line = run_tiny(tiny, MIXED, seed=SEED, keep=keep)
    return line, keep


def _mp2_frames(out):
    return [a for a in out["aus"] if a[1] == 1]


def test_a_mixed_multiplex_runs_correct(mixed_run):
    line, keep = mixed_run
    assert line["correct"], line["checks"]
    assert line["checks"]["au_errors"]["value"] == 0
    assert line["checks"]["db_errors"]["value"] == 0
    traffic, out, window = keep["traffic"], keep["out"], keep["window"]
    mp2, dabp = traffic.ensemble.services[1], traffic.ensemble.services[0]
    assert (mp2.kind, mp2.sub.is_uep, mp2.sub.uep_table_index,
            mp2.frame_bytes) == ("dab", True, 35, 384)
    assert traffic.groups(mp2) == 40 and traffic.groups(dabp) == 8
    # every round of 2 frames brings 8 MP2 frames a stream, one a CIF
    rounds = out["frames_in"] // out["frames_per_round"]
    assert len(_mp2_frames(out)) == 2 * 8 * rounds
    # the units due: 8 MP2 frames a stream and round, and the AUs
    n = window[1] - window[0] + 1
    assert line["attempted"] > 2 * 8 * n


def _on_record(monkeypatch, fault):
    """Break the fleet driver's record of the MP2 frames: the third frame
    recorded in the window altered, left out, or recorded twice."""
    from harness import spec
    load = spec.driver

    def driver(name, bench_dir):
        mod = load(name, bench_dir)
        on_mp2 = mod.Driver._on_mp2

        def broken(self, b, s, frame):
            n = self.__dict__.setdefault("_n_in_window", 0)
            if self.in_window:
                self._n_in_window = n + 1
            if not (self.in_window and n == 2):
                return on_mp2(self, b, s, frame)
            if fault == "altered":
                on_mp2(self, b, s, bytes([frame[0] ^ 1]) + frame[1:])
            elif fault == "twice":
                on_mp2(self, b, s, frame)
                on_mp2(self, b, s, frame)
        mod.Driver._on_mp2 = broken
        return mod
    monkeypatch.setattr(spec, "driver", driver)


@pytest.mark.parametrize("fault", ["altered", "dropped", "twice"])
def test_a_broken_record_of_the_mp2_frames_is_not_correct(tiny, monkeypatch,
                                                          fault):
    _on_record(monkeypatch, fault)
    line = run_tiny(tiny, MIXED, seed=SEED + 1)
    assert not line["correct"], line["checks"]
    assert line["checks"]["au_errors"]["value"] >= 1


def test_a_differing_uep_table_index_counts_in_db_errors(mixed_run):
    from reference import check
    _, keep = mixed_run
    traffic, dbs = keep["traffic"], keep["out"]["dbs"]
    assert check.database(traffic, dbs) == 0
    sent = traffic.ensemble.services[1]
    other = copy.copy(dbs[1].subchannels[sent.subchannel_id])
    other.uep_table_index = 43            # 96 CU too, at level 5
    db = types.SimpleNamespace(
        ensemble=dbs[1].ensemble, services=dbs[1].services,
        subchannels={**dbs[1].subchannels, sent.subchannel_id: other},
        component_by_subchannel=dbs[1].component_by_subchannel)
    assert check.database(traffic, [dbs[0], db]) == 1


def test_the_tuner_driver_refuses_a_classic_dab_service():
    from harness import spec
    from traffic import transmit
    mux = {"mode": 1, "ensemble_id": "C0FE", "ensemble_label": "TPU Ensemble",
           "services": MIXED_SERVICES}
    traffic = types.SimpleNamespace(ensemble=transmit.ensemble_of(mux))
    with pytest.raises(ValueError, match="MP2"):
        spec.driver("tuner").Driver(
            {"serving": {"block_bytes": 262144, "frames_per_step": 1}},
            {"check": {"sampled_frames": 0}}, traffic, "cpu",
            np.random.default_rng(0))


def test_looped_mp2_period_is_seamless_through_the_fleet():
    """Three passes of one period through the port's FusedFleet, the MP2
    subchannel served as "mp2": after the time deinterleaver's first 15
    CIFs every MP2 frame byte-exact and in order across both seams, and
    every AU of the DAB+ service beside it."""
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.params import SubchannelConfig
    from traffic import generate, transmit
    mux = {"mode": 1, "ensemble_id": "C0FE", "ensemble_label": "TPU Ensemble",
           "services": MIXED_SERVICES}
    t = generate.make(mux, {"period_frames": 10, "snr_db": 15.0,
                            "captures": [{"cfo_bins": -4.2}]}, 91, "cpu")
    stream = np.concatenate([t.captures[0]] * 3)
    svcs = t.ensemble.services
    K = 2
    fleet = FusedFleet(
        1, [SubchannelConfig(s.sub.start_address, s.sub.length, s.sub.is_uep,
                             s.sub.uep_table_index, s.sub.eep_type,
                             s.sub.eep_prot_level) for s in svcs],
        transmission_mode=1, frames_per_step=K, device="cpu",
        subchannel_kinds=["audio", "mp2"])
    frames, aus = [], []
    fleet.on_mp2_frame.append(lambda b, s, f: frames.append((s, f)))
    fleet.on_access_unit.append(lambda b, s, i, n, au, h: aus.append(au))
    at = fleet.find_alignment(stream[:2 * 4 * t.frame_samples])
    chunk = 2 * K * t.frame_samples
    while at + chunk + fleet.tail_bytes <= stream.shape[0]:
        fleet.process_round(stream[None, at:at + chunk],
                            tail_u8=stream[None, at + chunk:
                                           at + chunk + fleet.tail_bytes])
        at += chunk
    assert int(fleet.carry.total_desync.sum()) == 0
    assert {s for s, _ in frames} == {1}
    got = [f for _, f in frames][transmit.S.DEPTH - 1:]
    sent = [g[0] for g in t.sent[0][1]]
    first = sent.index(got[0])
    assert got == (sent * 4)[first:first + len(got)]
    assert len(got) >= 2 * t.groups(svcs[1])
    sent_aus = [au for sf in t.sent[0][0] for au in sf]
    first = sent_aus.index(aus[0])
    assert aus == (sent_aus * 4)[first:first + len(aus)]
    assert len(aus) >= 2 * t.superframes * svcs[0].num_aus
