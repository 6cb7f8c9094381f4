"""The port's batched superframe finish (dab/aac.py:
SuperframeProcessor.finish_batch) against the JAX package's finish, one
superframe a call: every result, header, access unit, counter and sync
state the same after every call, on batches of 1 to 288 superframes with
mixed sizes and headers and each way a superframe can fail after RS; and
its counter SF_STATS over a serving fleet's run."""

import dataclasses

import numpy as np
import pytest

from dab_radio_tpu.dab import aac as jax_aac
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import subchannel_config_from_jax
from dab_radio_tpu_torch.dab import aac
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.ops import crc
from dab_radio_tpu_torch.ops.rs import RS_STATS, dab_plus_rs

# frame bytes of 48 CU and 24 CU at EEP 3-A (64 and 32 kbit/s): 8 and 4
# codewords a superframe; and 28 codewords, whose AU starts pass 2048
WIDE, NARROW, LARGE = 192, 96, 672
# (sampling rate, SBR) -> 3, 6, 2 and 4 access units
HEADERS = [aac.SuperFrameHeader(rate, True, sbr, False, 0)
           for rate, sbr in ((48000, True), (48000, False), (32000, True),
                             (32000, False))]


def _superframe_frames(frame_bytes, header, rng):
    enc = aac.SuperframeEncoder(frame_bytes, header)
    cap, n = enc.au_capacity(), header.num_aus
    sizes = [cap // n] * (n - 1) + [cap - cap // n * (n - 1)]
    return enc.encode([rng.integers(0, 256, s).astype(np.uint8).tobytes()
                       for s in sizes])


def _refire(sf):
    """Rewrite the firecode over a superframe's edited header window."""
    fc = aac.firecode_crc16(bytes(sf[2:11]))
    sf[0], sf[1] = fc >> 8, fc & 0xFF


def _rs_failed(sf, nerr, rng):
    nerr[rng.integers(len(nerr))] = -1


def _firecode_broken(sf, nerr, rng):
    sf[2 + rng.integers(9)] ^= 0x10


def _zero_window(sf, nerr, rng):
    sf[:11] = 0


def _start_out_of_range(sf, nerr, rng):
    sf[3] |= 0xF0                          # the second AU's start >= 3840
    _refire(sf)


def _end_past_the_superframe(sf, nerr, rng):
    """The second AU starts past the superframe, and its last two bytes
    hold the CRC of the first AU up to them: a first AU cut at the
    superframe's end would pass its CRC."""
    first = 3 + -(-(12 * (aac._HEADERS[sf[2]].num_aus - 1)) // 8)
    sf[3], sf[4] = 0xFF, 0xF0 | (sf[4] & 0xF)             # start 4095
    _refire(sf)
    crc_ = aac.crc16(bytes(sf[first:len(sf) - 2]))
    sf[-2], sf[-1] = crc_ >> 8, crc_ & 0xFF


def _start_too_close(sf, nerr, rng):
    """The second AU starts one byte after the first."""
    first = 3 + -(-(12 * (aac._HEADERS[sf[2]].num_aus - 1)) // 8)
    start = first + 1
    sf[3], sf[4] = start >> 4, ((start & 0xF) << 4) | (sf[4] & 0xF)
    _refire(sf)


def _au_crc_flipped(sf, nerr, rng):
    n_cols = len(nerr)
    sf[aac.RS_DATA * n_cols - 1] ^= 0x01   # the last AU's CRC


DAMAGE = {"rs_failed": _rs_failed, "firecode_broken": _firecode_broken,
          "zero_window": _zero_window,
          "start_out_of_range": _start_out_of_range,
          "end_past_the_superframe": _end_past_the_superframe,
          "start_too_close": _start_too_close,
          "au_crc_flipped": _au_crc_flipped}

# case -> (superframes in the batch, their frame bytes, headers, damage
# on every third superframe); a damage case takes 18 superframes
CASES = {"k1": (1, [WIDE], HEADERS[:1], None),
         "k18": (18, [WIDE], HEADERS[:1], None),
         "k288": (288, [WIDE], HEADERS[:1], None),
         "mixed_n_cols": (18, [WIDE, NARROW], HEADERS[:1], None),
         "mixed_headers": (18, [WIDE], HEADERS, None),
         "large": (18, [LARGE, WIDE], HEADERS, None)}
CASES.update({name: (18, [WIDE, NARROW], HEADERS, name) for name in DAMAGE})
CASES["k1_au_crc_flipped"] = (1, [WIDE], HEADERS[:1], "au_crc_flipped")
CASES["python_crc"] = (18, [WIDE, NARROW], HEADERS, "au_crc_flipped")


def _fields(res):
    if res is None:
        return None
    header, aus = res
    return dataclasses.astuple(header), list(aus)


def _state(p):
    return dict(p.stats), p.is_synced, p.desync_count, p.buffer


def _batch(procs, jprocs, k, sizes, headers, damage, rng):
    """Push one superframe into each pair of processors, RS-decode them
    with a byte of one codeword in two wrong (corrected), damage every
    third after RS: (codewords, nerr)."""
    cws, nerrs = [], []
    for i, (p, jp) in enumerate(zip(procs, jprocs)):
        frames = _superframe_frames(sizes[i % len(sizes)],
                                    headers[i % len(headers)], rng)
        sf = None
        for f in frames:
            sf, jsf = p.push_frame(f), jp.push_frame(f)
            assert sf == jsf
        n_cols = len(sf) // aac.RS_MESSAGE
        cw = np.frombuffer(sf, np.uint8).reshape(aac.RS_MESSAGE, n_cols).T
        cw = cw.copy()
        if i % 2:
            cw[rng.integers(n_cols), rng.integers(aac.RS_MESSAGE)] ^= 0x5A
        corrected, nerr = dab_plus_rs().decode(cw)
        if damage is not None and i % 3 == 0:
            flat = corrected.T.reshape(-1).copy()
            DAMAGE[damage](flat, nerr, rng)
            corrected = flat.reshape(aac.RS_MESSAGE, n_cols).T
        cws.append(np.ascontiguousarray(corrected))
        nerrs.append(nerr)
    return np.concatenate(cws), np.concatenate(nerrs)


@pytest.mark.parametrize("synced", [True, False], ids=["synced", "unsynced"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_finish_matches_the_sequential_finish(case, synced,
                                                      monkeypatch):
    if case == "python_crc":
        monkeypatch.setattr(crc, "_native_crc_blocks", lambda: None)
    k, sizes, headers, damage = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    procs = [aac.SuperframeProcessor() for _ in range(k)]
    jprocs = [jax_aac.SuperframeProcessor() for _ in range(k)]
    # a round with damage between clean ones: sync lost and found again
    rounds = [(HEADERS[:1], None), (headers, damage), (headers, None)] \
        if synced else [(headers, damage), (headers, None)]
    for hdrs, dmg in rounds:
        cw, nerr = _batch(procs, jprocs, k, sizes, hdrs, dmg, rng)
        before = dict(aac.SF_STATS)
        got = aac.SuperframeProcessor.finish_batch(procs, cw, nerr)
        want, pos = [], 0
        for jp in jprocs:
            n = jp.frame_bytes * 5 // 120
            want.append(jp.finish(cw[pos:pos + n], nerr[pos:pos + n]))
            pos += n
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert [_state(p) for p in procs] == [_state(p) for p in jprocs]
        assert {key: aac.SF_STATS[key] - before[key] for key in before} == {
            "calls": 1, "superframes": k,
            "finished": sum(r is not None for r in want),
            "intake_calls": 0, "intake_frames": 0, "hunted": 0}
        if dmg is not None:
            assert sum(r is None or len(r[1]) < r[0].num_aus
                       for r in want) == -(-k // 3)
    assert k == 1 or sum(p.stats["rs_corrected_bytes"] for p in procs) > 0


def test_finish_is_the_batch_of_one():
    """finish keeps its signature and its results: one finish_batch call
    of one superframe, equal to the JAX package's finish."""
    rng = np.random.default_rng(7)
    p, jp = aac.SuperframeProcessor(), jax_aac.SuperframeProcessor()
    for header in HEADERS:
        cw, nerr = _batch([p], [jp], 1, [WIDE], [header], None, rng)
        before = aac.SF_STATS["calls"]
        assert _fields(p.finish(cw, nerr)) == _fields(jp.finish(cw, nerr))
        assert aac.SF_STATS["calls"] == before + 1
        assert _state(p) == _state(jp)


def test_crc16_bounds_equal_crc16_of_each_block(monkeypatch):
    """Read in place, with blocks whose bounds go back read as empty,
    natively and in the Python fallback."""
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, 4000).astype(np.uint8)
    bounds = rng.integers(0, len(buf) + 1, 41)
    want = [crc.crc16(buf[a:max(a, b)]) for a, b in zip(bounds, bounds[1:])]
    assert crc.crc16_bounds(buf, bounds).tolist() == want
    assert crc.crc16_bounds(buf, bounds[:1]).tolist() == []
    monkeypatch.setattr(crc, "_native_crc_blocks", lambda: None)
    assert crc.crc16_bounds(buf, bounds).tolist() == want


def test_no_block_shorter_than_its_crc_gives_the_au_residue():
    """finish_batch keeps an AU where the CRC16 over it and its own two CRC
    bytes is the residue, and leaves the check that an AU is at least 2
    bytes long to it: no empty or 1-byte block gives the residue, and
    every AU with its CRC appended does."""
    short = [crc.crc16(b"")] + [crc.crc16(bytes([v])) for v in range(256)]
    assert aac._AU_RESIDUE not in short
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 57):
        au = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert crc.crc16(au + crc.crc16(au).to_bytes(2, "big")) == \
            aac._AU_RESIDUE


# a small serving fleet: 2 streams of one two-service mode-II ensemble (one
# CIF a frame), 4 frames a round, 5 rounds
MODE, FRAMES_PER_ROUND, ROUNDS = 2, 4, 5
FLEET_CFGS = [JCfg(0, 12, False, eep_type="A", eep_prot_level=2),
              JCfg(12, 12, False, eep_type="A", eep_prot_level=2)]


def _fleet_capture():
    """(2, bytes) u8: the JAX transmitter's ensemble through two channels."""
    header = jax_aac.SuperFrameHeader(48000, True, True, False, 0)
    services = [ServiceSpec(0xF200 + i, i + 1, f"Fleet {i}", cfg,
                            superframe_header=header)
                for i, cfg in enumerate(FLEET_CFGS)]
    tx = EnsembleTransmitter(MODE, ensemble_id=0xC0FE,
                             ensemble_label="Fleet", services=services)
    for s in services:
        rng = np.random.default_rng(s.service_id)
        tx.set_au_source(s.subchannel_id, lambda cap, num, rng=rng: [
            rng.integers(0, 256, n).astype(np.uint8).tobytes()
            for n in [cap // num] * (num - 1)
            + [cap - cap // num * (num - 1)]])
    iq = tx.generate(FRAMES_PER_ROUND * ROUNDS + 1)
    rows = []
    for seed, cfo in ((1, 1100.0), (2, -700.0)):
        x = ChannelModel(cfo_hz=cfo, snr_db=18.0, seed=seed).apply(iq)
        rows.append(np.frombuffer(iq_quantize_u8(
            (x / np.abs(x).max() * 0.5).astype(np.complex64)), np.uint8))
    return np.stack(rows)


def test_sf_stats_count_the_fleets_superframes():
    """SF_STATS counts the batched finish: a FusedFleet hands it every
    superframe it finishes (all it completes, on this capture), in one call
    a CIF that completes superframes, so in at most one call an RS decode
    and in fewer calls than superframes."""
    u8 = _fleet_capture()
    fleet = FusedFleet(2, [subchannel_config_from_jax(c) for c in FLEET_CFGS],
                       MODE, FRAMES_PER_ROUND, device="cpu")
    sf, rs = dict(aac.SF_STATS), RS_STATS["calls"]
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    for r in range(ROUNDS):
        fleet.process_round(
            u8[:, r * chunk:(r + 1) * chunk], defer_fetch=True,
            tail_u8=u8[:, (r + 1) * chunk:(r + 1) * chunk + tb])
    fleet.flush()
    done = {k: aac.SF_STATS[k] - sf[k] for k in sf}
    finished = sum(p.stats["superframes"] for row in fleet._sfp for p in row)
    assert done["superframes"] == done["finished"] == finished > 0
    assert 0 < done["calls"] <= RS_STATS["calls"] - rs
    assert done["calls"] < done["superframes"]
