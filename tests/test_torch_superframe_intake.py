"""The fleet's superframe intake (dab/aac.py:SuperframeIntake): a CIF's
DAB+ frames of every (stream, subchannel) taken in one array step, against
one SuperframeProcessor.push_frame a row and frame.

The intake alone, CIF by CIF: the superframes it completes (rows and
codewords), each processor's counters, sync state and buffered frames, and
the SF_STATS counts, through sync hunting, RS failures past the desync
limit, all-zero frames and two frame widths. Then FusedFleet on the CPU:
its observers' calls equal those of the same fleet whose byte layer pushes
frame by frame (the code the intake replaced, kept here as the reference),
a snapshot taken part-way through a superframe resumes to the same access
units, whole or sliced to one stream, and the intake's counters over a
fleet's rounds."""

import dataclasses
import pickle

import numpy as np
import pytest

from dab_radio_tpu_torch.dab import aac
from dab_radio_tpu_torch.dab.aac import SuperframeProcessor
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.ops.rs import dab_plus_rs
from dab_radio_tpu_torch.utils.profiler import profile_scope
from test_torch_fused_fleet import (_corrupting, drive, full_run,
                                    make_tfleet, mixed_fleet, mixed_run,
                                    nb_rounds, record)
from test_torch_fused_fleet import mixed, streams  # noqa: F401

WIDE, NARROW = 192, 96           # 48 and 24 CU at EEP 3-A: 8 and 4 codewords
HEADER = aac.SuperFrameHeader(48000, True, True, False, 0)
CIFS, ROUND = 96, 7              # CIFs in all, CIFs a loaded round


def _superframes(nb, count, rng):
    enc = aac.SuperframeEncoder(nb, HEADER)
    cap, n = enc.au_capacity(), HEADER.num_aus
    sizes = [cap // n] * (n - 1) + [cap - cap // n * (n - 1)]
    return [f for _ in range(count) for f in enc.encode(
        [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes])]


def _row_frames(nb, offset, zeros, rng):
    """CIFS frames of one row: `zeros` all-zero frames, then superframes
    entered `offset` frames into the first."""
    frames = [bytes(nb)] * zeros + _superframes(nb, CIFS // 5 + 2,
                                                rng)[offset:]
    return frames[:CIFS]


def _fail_early_superframes(row, cif):
    """Rows 0, 2 and 4 lose every superframe that completes in CIFs 10 to
    79 to an RS failure: 14 in a row, past the desync limit of 10."""
    return row % 2 == 0 and 10 <= cif < 80


# case -> (frame width of each row, where each enters its superframes,
# all-zero frames first, RS failures by (row, CIF), the rows laid out in
# the loaded array in reverse)
CASES = {
    "synced": ([WIDE] * 6, [0] * 6, [0] * 6, None, False),
    "mid_superframe": ([WIDE] * 6, [0, 1, 2, 3, 4, 2], [0] * 6, None, True),
    "rs_failures": ([WIDE] * 6, [0, 0, 3, 0, 1, 0], [0] * 6,
                    _fail_early_superframes, False),
    "all_zero": ([WIDE] * 4 + [NARROW] * 2, [0, 2, 0, 0, 1, 0],
                 [0, 3, 7, 12, 9, 0], None, False),
    "two_widths": ([WIDE, NARROW, WIDE, NARROW, NARROW, WIDE],
                   [0, 1, 4, 0, 3, 2], [0] * 6, _fail_early_superframes,
                   True),
}


def _fields(res):
    return None if res is None else (dataclasses.astuple(res[0]), res[1])


def _sync(p):
    return dict(p.stats), p.is_synced, p.desync_count, p.frame_bytes


def _push_frames(ref, frames, c):
    """One push_frame a row at CIF c -> the rows that completed a superframe
    {row: superframe bytes}, the rows firecode-checked, the frames taken."""
    done, hunted, taken = {}, 0, 0
    for i, p in enumerate(ref):
        hunted += (not p.is_synced or p.desync_count >= aac.DESYNC_MAX_COUNT) \
            and not p.buffer
        rejected = p.stats["firecode_errors"]
        sf = p.push_frame(frames[i][c])
        taken += p.stats["firecode_errors"] == rejected
        if sf is not None:
            done[i] = sf
    return done, hunted, taken


@pytest.mark.parametrize("case", sorted(CASES))
def test_intake_matches_push_frame_a_row(case):
    """Every CIF: the same completed rows and codewords (grouped by frame
    width, in row order within one, wherever the rows lie in the loaded
    array), and after the same finish_batch every
    processor's counters and sync state, without a write_back, and its
    buffered frames after one; SF_STATS counts one step, the frames taken
    and the rows that hunted."""
    widths, offsets, zeros, fail, reverse = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    frames = [_row_frames(nb, o, z, rng)
              for nb, o, z in zip(widths, offsets, zeros)]
    R, W = len(widths), max(widths)
    procs = [SuperframeProcessor() for _ in range(R)]
    ref = [SuperframeProcessor() for _ in range(R)]
    place = np.arange(R)[::-1] if reverse else np.arange(R)
    intake = aac.SuperframeIntake(procs, widths, at=(place,))
    order = sorted(range(R), key=lambda i: widths[i])     # stable
    hunted_after_sync = 0
    for c in range(CIFS):
        if c % ROUND == 0:
            block = np.zeros((R, ROUND, W), np.uint8)
            for i, row in enumerate(frames):
                for k, f in enumerate(row[c:c + ROUND]):
                    block[place[i], k, :len(f)] = np.frombuffer(f, np.uint8)
            intake.load(block)
        before = dict(aac.SF_STATS)
        rows, got_procs, cw = intake.step(c % ROUND)
        cw = None if cw is None else cw.reshape(-1, aac.RS_MESSAGE)
        want, hunted, taken = _push_frames(ref, frames, c)
        assert {k: aac.SF_STATS[k] - before[k] for k in before} == {
            "calls": 0, "superframes": 0, "finished": 0, "intake_calls": 1,
            "intake_frames": taken, "hunted": hunted}
        if c >= 5 and case == "rs_failures":
            hunted_after_sync += hunted
        want_rows = [i for i in order if i in want]
        assert rows.tolist() == want_rows
        assert got_procs == [procs[i] for i in want_rows]
        if not want_rows:
            assert cw is None
        else:
            n = [len(want[i]) // aac.RS_MESSAGE for i in want_rows]
            assert cw.tolist() == np.concatenate([
                np.frombuffer(want[i], np.uint8).reshape(aac.RS_MESSAGE, k).T
                for i, k in zip(want_rows, n)]).tolist()
            nerr = np.zeros(len(cw), np.int32)
            if fail is not None:
                for i, start in zip(want_rows, np.cumsum([0] + n[:-1])):
                    if fail(i, c):
                        nerr[start] = -1
            got = SuperframeProcessor.finish_batch(got_procs, cw.copy(), nerr)
            intake.read_back()
            expect = SuperframeProcessor.finish_batch(
                [ref[i] for i in want_rows], cw.copy(), nerr)
            assert [_fields(r) for r in got] == [_fields(r) for r in expect]
        assert [_sync(p) for p in procs] == [_sync(p) for p in ref]
        intake.write_back()
        assert [p.buffer for p in procs] == [p.buffer for p in ref]
    assert all(p.stats["superframes"] > 0 for p in ref)
    if case == "rs_failures":
        assert all(ref[i].stats["rs_errors"] == 14 for i in (0, 2, 4))
        assert hunted_after_sync >= 3                 # a reset a row
    if case in ("mid_superframe", "all_zero"):
        assert sum(p.stats["firecode_errors"] for p in ref) > 0


def test_a_processor_enters_with_its_buffer_and_its_rows_width():
    """A processor's buffered frames and sync state go into the ring; one
    of another frame width starts out of sync with nothing buffered, as
    push_frame leaves it after its first frame of the new width."""
    rng = np.random.default_rng(5)
    kept, other = SuperframeProcessor(), SuperframeProcessor()
    for f in _superframes(WIDE, 1, rng)[:3]:
        kept.push_frame(f)
        other.push_frame(f)
    kept.is_synced = other.is_synced = True
    intake = aac.SuperframeIntake([kept, other], [WIDE, NARROW],
                                  at=(np.arange(2),))
    intake.write_back()
    assert len(kept.buffer) == 3 and kept.is_synced
    assert other.buffer == [] and not other.is_synced
    assert other.frame_bytes == NARROW


def _push_frame_consume(self, fibs, ok, msc_bytes):
    """FusedFleet._consume_batched as it was before the intake: one
    push_frame a DAB+ subchannel and CIF; the reference of the intake."""
    C = msc_bytes.shape[2]
    for b in range(self.N):
        self._ingest_fibs(b, fibs, ok)
    ev_bs = {(b, s): [] for b in range(self.N) for s in range(self.S)}
    audio = [bs for bs in ev_bs if self._kinds[bs[0]][bs[1]] == "audio"]
    rs = dab_plus_rs()
    for c in range(C if audio else 0):
        done = []
        with profile_scope("fleet/push_frames"):
            for b, s in audio:
                nb = self._nbytes[b][s]
                sf = self._sfp[b][s].push_frame(
                    msc_bytes[b, s, c][:nb].tobytes())
                if sf is not None:
                    arr = np.frombuffer(sf, np.uint8).reshape(
                        aac.RS_MESSAGE, len(sf) // aac.RS_MESSAGE)
                    done.append((b, s, arr.T))
        if not done:
            continue
        cw = np.concatenate([d[2] for d in done], axis=0)
        corrected, nerr = rs.decode(cw, device=self.device)
        results = SuperframeProcessor.finish_batch(
            [self._sfp[b][s] for b, s, _ in done], corrected, nerr)
        for (b, s, _), res in zip(done, results):
            if res is not None:
                ev_bs[(b, s)].append(self._superframe_event(b, s, res))
    mp2 = [bs for bs in ev_bs if self._kinds[bs[0]][bs[1]] == "mp2"]
    if mp2:
        ev_bs.update(self._mp2_events(mp2, msc_bytes))
    for b, s in ev_bs:
        if self._kinds[b][s] not in ("audio", "mp2"):
            ev_bs[(b, s)] = self._packet_events(b, s, msc_bytes)
    return [[e for s in range(self.S) for e in ev_bs[(b, s)]]
            for b in range(self.N)]


def _frame_by_frame(fleet):
    """The fleet with the reference byte layer, its processors its own."""
    fleet._consume_batched = _push_frame_consume.__get__(fleet)
    fleet._intake = None
    return fleet


def _processor_states(fleet):
    pickle.loads(fleet.snapshot())          # writes the ring back
    return [[None if not isinstance(p, SuperframeProcessor) else
             (_sync(p), p.buffer) for p in row] for row in fleet._sfp]


@pytest.mark.parametrize("traffic", ["clean", "corrupted", "mixed"])
def test_fleet_observers_equal_a_push_frame_byte_layer(streams, mixed,
                                                       traffic):
    """Two streams, every round: the observers' calls (access units with
    their headers, MP2 frames, data groups, in order), the health signals,
    the summary and the databases equal those of the fleet that pushes one
    frame a subchannel and CIF; so do the processors' states at the end.
    "corrupted" puts RS corrections and failures into two subchannels,
    "mixed" a DAB+, an MP2 and a packet-mode subchannel side by side."""
    if traffic == "mixed":
        u8 = np.repeat(mixed[2], 2, axis=0)
        got, got_mot = mixed_run(mixed_fleet(FusedFleet, 2), u8)
        want, want_mot = mixed_run(
            _frame_by_frame(mixed_fleet(FusedFleet, 2)), u8)
        assert got_mot == want_mot
        return_fleets = None
    else:
        def build(frame_by_frame):
            fleet = make_tfleet()
            if frame_by_frame:
                _frame_by_frame(fleet)
            return _corrupting(fleet) if traffic == "corrupted" else fleet
        fleets = build(False), build(True)
        got, want = (full_run(f, streams) for f in fleets)
        return_fleets = fleets
    assert got == want
    assert sum(e[0] == "au" for e in got["events"]) > 0
    if return_fleets is not None:
        assert _processor_states(return_fleets[0]) \
            == _processor_states(return_fleets[1])


@pytest.mark.parametrize("rows", ["whole", "sliced"])
def test_snapshot_part_way_through_a_superframe_resumes(streams, rows):
    """A snapshot after 6 rounds, with frames of an unfinished superframe
    buffered: resumed, whole or as stream 1 alone (the snapshot's rows
    sliced as a mesh rank's from_snapshot slices them), the fleet gives the
    access units of the run that never stopped."""
    R = nb_rounds(make_tfleet(), streams)
    whole = make_tfleet()
    events = record(whole)
    drive(whole, streams, range(6))
    n0 = len(events)
    drive(whole, streams, range(6, R))
    later = events[n0:]

    fleet = make_tfleet()
    drive(fleet, streams, range(6))
    blob = fleet.snapshot()
    d = pickle.loads(blob)
    assert any(p.buffer for row in d["sfp"] for p in row)
    if rows == "sliced":
        d.update(N=1, carry=[c[1:2] for c in d["carry"]],
                 hist=d["hist"][1:2], kinds=d["kinds"][1:2],
                 receivers=d["receivers"][1:2], sfp=d["sfp"][1:2],
                 health=(d["health"][0][1:2], d["health"][1][1:2],
                         d["health"][2]))
        later = [(e[0], 0) + e[2:] for e in later if e[1] == 1]
        blob = pickle.dumps(d)
    resumed = FusedFleet.from_snapshot(blob, "cpu")
    got = record(resumed)
    drive(resumed, streams[1:] if rows == "sliced" else streams,
          range(6, R))
    assert got == later and any(e[0] == "au" for e in got)


@pytest.fixture(scope="module")
def counted(streams):
    """SF_STATS' intake counts of each round of a fleet's run, fetched at
    once, and the fleet's DAB+ rows and CIFs a round."""
    fleet = make_tfleet()
    per_round = []
    for r in range(nb_rounds(fleet, streams)):
        before = dict(aac.SF_STATS)
        drive(fleet, streams, [r], defer=False)
        per_round.append({k: aac.SF_STATS[k] - before[k] for k in before})
    return per_round, 2 * 2, fleet.K


@pytest.mark.parametrize("key", ["intake_calls", "intake_frames", "hunted"])
def test_intake_counts_a_step_a_cif(counted, key):
    """One intake step a CIF; once the streams are in sync (the last five
    rounds), every DAB+ row's frame taken each step and none hunted."""
    per_round, rows, cifs = counted
    synced = per_round[-5:]
    if key == "intake_calls":
        assert all(r[key] == cifs for r in per_round)
    elif key == "intake_frames":
        assert all(r[key] == rows * cifs for r in synced)
        assert all(r[key] <= rows * cifs for r in per_round)
    else:
        assert sum(r[key] for r in per_round) > 0
        assert all(r[key] == 0 for r in synced)


def test_reset_byte_layer_gives_the_intake_the_new_processors(streams):
    """reset_byte_layer() (reset() calls it) rebuilds the processors and
    the intake over them, with nothing buffered."""
    fleet = make_tfleet()
    drive(fleet, streams, range(6))
    old = fleet._intake
    fleet.reset_byte_layer()
    procs = [p for row in fleet._sfp for p in row]
    assert fleet._intake is not old
    assert [p for g in fleet._intake.groups for p in g.procs] == procs
    assert all(not g.count.any() for g in fleet._intake.groups)
    assert fleet.total_aus == 0
