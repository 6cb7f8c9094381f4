"""The frozen transmit chain: the same IQ as the port's transmitter, the
same captures from the same seed, DAB+ captures as they were before the
generator coded MP2 frames, and a period that loops seamlessly."""

import hashlib

import numpy as np
import pytest

from conftest import FLEET, TUNER
from harness import spec
from traffic import generate, transmit

MUX = {"mode": 1, "ensemble_id": "C0FE", "ensemble_label": "TPU Ensemble",
       "services": [{"count": 3, "kind": "dab+", "size_cu": 48, "eep": "3-A",
                     "first_service_id": "F123", "first_subchannel_id": 3,
                     "label": "Radio TPU {n}"}]}
TRAFFIC = {"period_frames": 10, "snr_db": 15.0,
           "captures": [{"cfo_bins": 3.37}, {"cfo_bins": -4.20}]}


def test_frozen_transmitter_gives_the_ports_iq():
    from dab_radio_tpu_torch.models.transmitter import (
        EnsembleTransmitter, ServiceSpec)
    from dab_radio_tpu_torch.params import SubchannelConfig
    ens = transmit.ensemble_of(MUX)
    frames = 10
    rng = np.random.default_rng(5)
    aus = [transmit.random_aus(s, frames * 4 // 5, rng) for s in ens.services]
    mine = generate.capture_iq(ens, aus, frames, "cpu", periodic=False)
    specs = [ServiceSpec(s.service_id, s.subchannel_id, s.label,
                         SubchannelConfig(s.sub.start_address, s.sub.length,
                                          False, eep_type="A",
                                          eep_prot_level=2))
             for s in ens.services]
    tx = EnsembleTransmitter(1, services=specs, device="cpu")
    for k, s in enumerate(ens.services):
        it = iter(aus[k])
        tx.set_au_source(s.subchannel_id, lambda cap, num, it=it: next(it))
    theirs = tx.generate(frames)
    assert np.array_equal(mine.numpy(), theirs)


def test_same_seed_same_captures_other_seed_same_sizes():
    a = generate.make(MUX, TRAFFIC, 2 ** 33 + 5, "cpu")
    b = generate.make(MUX, TRAFFIC, 2 ** 33 + 5, "cpu")
    c = generate.make(MUX, TRAFFIC, 2 ** 33 + 6, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.captures, b.captures))
    assert a.sent == b.sent and a.sent != c.sent
    sizes = [[[len(au) for au in sf] for sf in s] for s in a.sent[0]]
    assert sizes == [[[len(au) for au in sf] for sf in s] for s in c.sent[0]]
    assert a.captures[0].shape == (2 * 10 * a.frame_samples,)


def test_looped_period_is_seamless():
    """Three passes of one period through the port's streaming receiver:
    every AU byte-exact and in order across both seams, no lost sync."""
    from dab_radio_tpu_torch.host.native import iq_convert
    from dab_radio_tpu_torch.models.demodulator import (
        OFDMDemodulator, StreamingDemodulator)
    from dab_radio_tpu_torch.models.receiver import DabReceiver
    t = generate.make(MUX, {**TRAFFIC, "captures": TRAFFIC["captures"][:1]},
                      77, "cpu")
    stream = np.concatenate([t.captures[0]] * 3)
    sd = StreamingDemodulator(OFDMDemodulator(1, device="cpu"))
    rx = DabReceiver(1, device="cpu")
    got = {}

    def on_channel(sub_id, ch):
        ch.events.on_access_unit.append(
            lambda i, n, au, h: got.setdefault(sub_id, []).append(au))
    rx.on_audio_channel.append(on_channel)
    for at in range(0, stream.shape[0], 262144):
        for bits in sd.process(iq_convert(stream[at:at + 262144])):
            rx.process_frame(bits)
    assert int(sd.carry.total_desync) == 0
    per_period = t.superframes
    for k, svc in enumerate(t.ensemble.services):
        sent = [au for sf in t.sent[0][k] for au in sf]
        aus = got[svc.subchannel_id]
        first = sent.index(aus[0])
        looped = (sent * 4)[first:first + len(aus)]
        assert aus == looped
        # the last two periods' superframes all came out
        assert len(aus) >= 2 * per_period * svc.num_aus


# SHA-256 of the tiny cells' captures and of the units they carry, seed
# 123456789012, as the generator made them when it coded DAB+ alone
DABPLUS_SHA256 = {
    FLEET: ("4dea7955f8b540efc724e11f46d5c807250d642751879a7f407c11c4faef3630",
            "09d908a455a43ec1c22249c007874adfcc7a6810c4e691fcd16f809e7a56bc78"),
    TUNER: ("1d98c84676c3db2dbb69ea3b216cb7fb51a89ff9800c74163fc76a4106e5d22f",
            "f42510f3a6dbb7d5c531dd53b7ed1f583a28c208aa1f7f750a80e13fb75a6595"),
}


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_dabplus_captures_are_as_before(tiny, cell):
    _, bench = tiny
    c = spec.cell(cell, bench)
    t = generate.make(spec.config(c["config"], bench)["multiplex"],
                      c["traffic"], 123456789012, "cpu")
    caps, units = hashlib.sha256(), hashlib.sha256()
    for cap in t.captures:
        caps.update(cap.tobytes())
    for au in (au for cap in t.sent for svc in cap for sf in svc
               for au in sf):
        units.update(au)
    assert (caps.hexdigest(), units.hexdigest()) == DABPLUS_SHA256[cell]


def test_mp2_frames_have_a_layer_ii_header_and_no_pad():
    from dab_radio_tpu_torch.dab.mp2 import parse_mp2_header
    mux = {**MUX, "services": [{"count": 2, "kind": "dab", "size_cu": 96,
                                "uep_level": 3, "first_service_id": "F200",
                                "first_subchannel_id": 10,
                                "label": "Classic {n}"}]}
    ens = transmit.ensemble_of(mux)
    frames = transmit.random_mp2(ens.services[0], 40,
                                 np.random.default_rng(3))
    assert len(frames) == 40 and all(len(g) == 1 for g in frames)
    for (f,) in frames:
        h = parse_mp2_header(f)
        assert (h.mpeg_version, h.sample_rate, h.bitrate_kbps,
                h.frame_bytes, len(f)) == (1, 48000, 128, 384, 384)
        assert f[1] & 1 and not f[2] & 2 and f[-2:] == b"\0\0"
    assert len({f for (f,) in frames}) == 40
