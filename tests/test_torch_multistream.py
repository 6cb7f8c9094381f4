"""``MultiStreamDemodulator``: the port (on the CPU) against the JAX
package's, fed the same samples.

Small mode-II ensembles (two DAB+ subchannels of 12 CU, seeded access
units) from the JAX transmitter, each stream behind its own stretch of
silence, with a carrier offset and noise from the JAX channel model; one
stream loses lock on a stretch of noise in mid-stream and acquires again.
c64 and u8 ingest, one frame and two frames a step.

Tolerances: which stream emits a frame in which round, the lock flags, the
unread sample counts and the integer carry are exact; the soft bits of a
stream may differ by 1 LSB on at most 5e-3 of its values (ROADMAP F3: an
ulp of carried CFO moves the rounding of the PLL phase). Through
``ReceiverFleet`` the FIBs, access units and counters are identical.
"""

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.demodulator import OFDMDemodulator as JDemod
from dab_radio_tpu.models.fleet import ReceiverFleet as JFleet
from dab_radio_tpu.models.multistream import MultiStreamDemodulator as JMulti
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import multistream_state_from_jax
from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator as TDemod
from dab_radio_tpu_torch.models.fleet import ReceiverFleet as TFleet
from dab_radio_tpu_torch.models.multistream import (
    MultiStreamDemodulator as TMulti)

torch.set_num_threads(1)

MODE = 2
FS = 49152                       # samples of a mode-II frame
NB_FRAMES = 36
CPU = torch.device("cpu")
HDR = SuperFrameHeader(48000, True, True, False, 0)
EEP3A = dict(is_uep=False, eep_type="A", eep_prot_level=2)
LAYOUTS = [[JCfg(0, 12, **EEP3A), JCfg(12, 12, **EEP3A)],
           [JCfg(6, 12, **EEP3A), JCfg(30, 16, True, uep_table_index=0)],
           [JCfg(0, 18, False, eep_type="B", eep_prot_level=2)]]
LEADS = [3000, 12345, 30011]
CHUNK = 3 * FS + 1111            # samples pushed at a time


def _au_source(seed):
    rng = np.random.default_rng(seed)

    def make(cap, num):
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


@pytest.fixture(scope="module")
def streams():
    """Three complex64 streams; stream 1 has 1.5 frames of noise in place
    of signal from frame 9 on, so that it loses lock there."""
    out = []
    for k, layout in enumerate(LAYOUTS):
        services = [ServiceSpec(0xB100 + 16 * k + i, i + 1, f"M{k} {i}", cfg,
                                superframe_header=HDR)
                    for i, cfg in enumerate(layout)]
        tx = EnsembleTransmitter(MODE, ensemble_id=0xD100 + k,
                                 ensemble_label=f"Multi {k}",
                                 services=services)
        for s in services:
            tx.set_au_source(s.subchannel_id, _au_source(s.service_id))
        iq = np.asarray(tx.generate(NB_FRAMES))
        pad = np.zeros(LEADS[k], np.complex64)
        iq = np.concatenate([pad, iq, np.zeros(2 * FS, np.complex64)])
        iq = ChannelModel(cfo_hz=700.0 * (k + 1) * (-1) ** k, snr_db=18.0,
                          seed=10 + k,
                          snr_ref=(LEADS[k], LEADS[k] + NB_FRAMES * FS)
                          ).apply(iq)
        iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
        if k == 1:
            rng = np.random.default_rng(77)
            lo = LEADS[k] + 9 * FS
            n = 3 * FS // 2
            iq[lo:lo + n] = 0.05 * (rng.normal(size=n)
                                    + 1j * rng.normal(size=n))
        out.append(iq)
    return out


def as_ingest(iq, ingest):
    if ingest == "c64":
        return iq
    return np.frombuffer(iq_quantize_u8(iq), np.uint8)


def drive(ms, streams, ingest, on_round=None):
    """Push the streams chunk by chunk, stepping until nothing comes; returns
    [(round, stream, bits as numpy)] and the per-round lock flags."""
    per = 2 * CHUNK if ingest == "u8" else CHUNK
    data = [as_ingest(s, ingest) for s in streams]
    frames, locks, rnd = [], [], 0
    for lo in range(0, max(d.shape[0] for d in data), per):
        for i, d in enumerate(data):
            if lo < d.shape[0]:
                ms.push(i, d[lo:lo + per])
        while True:
            res = ms.step()
            rnd += 1
            locks.append(ms.tracking.tolist())
            if on_round is not None:
                on_round(res)
            if not res:
                break
            frames += [(rnd, i, np.asarray(b) if not torch.is_tensor(b)
                        else b.numpy()) for i, b in res]
    return frames, locks


def assert_frames_close(got, want):
    assert [(r, i) for r, i, _ in got] == [(r, i) for r, i, _ in want]
    for i in {i for _, i, _ in got}:
        a = np.stack([b for _, k, b in got if k == i]).astype(np.int16)
        b = np.stack([b for _, k, b in want if k == i]).astype(np.int16)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3, i


def assert_state_equal(tms, jms):
    assert tms.tracking.tolist() == jms.tracking.tolist()
    assert tms.frames_emitted == jms.frames_emitted
    assert [b.shape[0] for b in tms.bufs] == [b.shape[0] for b in jms.bufs]
    np.testing.assert_allclose(tms.l1, jms.l1, rtol=1e-5)
    for name in ("is_coarse_found", "total_frames", "total_desync"):
        np.testing.assert_array_equal(getattr(tms.carry, name).numpy(),
                                      np.asarray(getattr(jms.carry, name)),
                                      err_msg=name)
    for name in ("freq_coarse", "freq_fine", "signal_l1_avg"):
        np.testing.assert_allclose(getattr(tms.carry, name).numpy(),
                                   np.asarray(getattr(jms.carry, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ingest,K", [("c64", 1), ("c64", 2), ("u8", 1),
                                      ("u8", 2)])
def test_multistream_matches_jax(streams, ingest, K):
    jms = JMulti(JDemod(MODE), 3, frames_per_step=K, ingest=ingest)
    tms = TMulti(TDemod(MODE, device=CPU), 3, frames_per_step=K,
                 ingest=ingest, device=CPU)
    want, jlocks = drive(jms, streams, ingest)
    got, tlocks = drive(tms, streams, ingest)
    assert tlocks == jlocks
    assert_frames_close(got, want)
    assert_state_equal(tms, jms)
    per_stream = [sum(1 for _, i, _ in got if i == k) for k in range(3)]
    assert per_stream[0] >= NB_FRAMES - 1 and per_stream[2] >= NB_FRAMES - 3
    # stream 1 lost lock on the noise, and locked again after it
    assert NB_FRAMES - 8 <= per_stream[1] < per_stream[0]
    assert int(tms.carry.total_desync[1]) >= 1
    assert not int(tms.carry.total_desync[0])
    assert any(not lk[1] for lk in tlocks[5:]) and tlocks[-1][1]


@pytest.mark.parametrize("K", [1, 2])
def test_bits_kept_on_the_device_equal_fetched(streams, K):
    """fetch_bits=False hands out rows of the round's tensor: the same
    values, and no numpy copy."""
    a = TMulti(TDemod(MODE, device=CPU), 3, frames_per_step=K, ingest="u8",
               device=CPU)
    b = TMulti(TDemod(MODE, device=CPU), 3, frames_per_step=K, ingest="u8",
               fetch_bits=False, device=CPU)
    kinds = set()
    fa, _ = drive(a, streams[:3], "u8")
    fb, _ = drive(b, streams[:3], "u8",
                  on_round=lambda res: kinds.update(type(x) for _, x in res))
    assert kinds == {torch.Tensor}
    assert [(r, i) for r, i, _ in fa] == [(r, i) for r, i, _ in fb]
    assert all(np.array_equal(x, y) for (_, _, x), (_, _, y) in zip(fa, fb))
    assert fa[0][2].dtype == np.int8


@pytest.mark.parametrize("ingest,K", [("c64", 2), ("u8", 1)])
def test_state_carried_over_from_jax(streams, ingest, K):
    """multistream_state_from_jax: the JAX class demodulates the first half
    of the samples, the port takes over its state, and both go on alike."""
    half = [s[:s.shape[0] // 2] for s in streams]
    rest = [s[s.shape[0] // 2:] for s in streams]
    jms = JMulti(JDemod(MODE), 3, frames_per_step=K, ingest=ingest)
    drive(jms, half, ingest)
    tms = TMulti(TDemod(MODE, device=CPU), 3, frames_per_step=K,
                 ingest=ingest, device=CPU)
    state = multistream_state_from_jax(jms)
    assert [x.dtype for x in state["carry"]] == [
        np.float32, np.float32, np.bool_, np.float32, np.int32, np.int32]
    tms.load_state(state)
    assert_state_equal(tms, jms)
    want, jlocks = drive(jms, rest, ingest)
    got, tlocks = drive(tms, rest, ingest)
    assert tlocks == jlocks and len(got) >= 3 * 12
    assert_frames_close(got, want)
    assert_state_equal(tms, jms)
    other = TMulti(TDemod(MODE, device=CPU), 2, ingest=ingest, device=CPU)
    with pytest.raises(ValueError, match="another batch"):
        other.load_state(state)


@pytest.mark.parametrize("depth,K,fetch", [(0, 1, True), (2, 2, False)],
                         ids=["sync-K1-host", "depth2-K2-device"])
def test_multistream_into_fleet_matches_jax(streams, depth, K, fetch):
    """The older batched path whole: u8 streams through the batched
    demodulator into the fleet, a round of at most one frame a receiver.
    FIBs (the databases), access units and counters equal the JAX pair's."""
    def run(ms, fleet):
        aus = {}
        for k, rx in enumerate(fleet.receivers):
            def on_channel(sub_id, ch, _k=k):
                sink = aus.setdefault((_k, sub_id), [])
                ch.events.on_access_unit.append(
                    lambda i, n, au, hdr: sink.append(bytes(au)))
            rx.on_audio_channel.append(on_channel)

        def on_round(res):
            # a step emits up to K frames a stream, in frame order: split
            # them into rounds of one frame a receiver
            while res:
                seen, now, later = set(), [], []
                for i, b in res:
                    (later if i in seen else now).append((i, b))
                    seen.add(i)
                fleet.process_frames(now)
                res = later
        drive(ms, streams, "u8", on_round)
        fleet.flush()
        return aus, fleet.summary(), [
            ((rx.db.ensemble.id, rx.db.ensemble.label),
             {sid: s.label for sid, s in rx.db.services.items()},
             sorted(rx.channels), rx.total_frames,
             {i: ch.superframe.stats for i, ch in rx.channels.items()})
            for rx in fleet.receivers]
    want = run(JMulti(JDemod(MODE), 3, frames_per_step=K, ingest="u8",
                      fetch_bits=fetch),
               JFleet(3, MODE, pipeline_depth=depth))
    got = run(TMulti(TDemod(MODE, device=CPU), 3, frames_per_step=K,
                     ingest="u8", fetch_bits=fetch, device=CPU),
              TFleet(3, MODE, pipeline_depth=depth, device=CPU))
    assert got == want
    assert sorted(got[0]) == [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1)]
    assert all(got[0][k] for k in ((0, 1), (0, 2), (2, 1)))
    assert got[2][0][0] == (0xD100, "Multi 0")


def test_arguments():
    with pytest.raises(TypeError, match="device"):
        TMulti(TDemod(MODE, device=CPU), 2)
    with pytest.raises(ValueError, match="ingest"):
        TMulti(TDemod(MODE, device=CPU), 2, ingest="s16", device=CPU)
    with pytest.raises(ValueError, match="lies on"):
        TMulti(TDemod(MODE, device=CPU), 2, device="meta")
    ms = TMulti(TDemod(MODE, device=CPU), 2, ingest="u8", device="cpu")
    assert ms.step() == [] and ms.frames_per_step == 1
    ms.push(0, bytes([127, 128] * 10))
    assert ms._n_samples(0) == 10 and ms.bufs[0].dtype == np.uint8
    assert list(ms.run_available()) == []
