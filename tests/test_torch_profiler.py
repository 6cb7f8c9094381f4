"""The port's stage profiler (``utils/profiler.py``), the spans inside the
serving round's byte layer and the programs' counts (``utils/graphs.py:
GRAPH_STATS``).

The profiler keeps running totals and a bounded ring of spans, costs one
shared no-op while it is off, and stamps its Chrome trace on the clock of
torch.profiler's events. This file imports no JAX, so its test marked
``cuda`` also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiler.py -q
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dab_radio_tpu_torch.host.io import IQReader
from dab_radio_tpu_torch.models.demodulator import (OFDMDemodulator,
                                                    StreamingDemodulator)
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.models.receiver import DabReceiver
from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                    ServiceSpec)
from dab_radio_tpu_torch.ops.rs import ReedSolomonDecoder
from dab_radio_tpu_torch.params import SubchannelConfig, get_dab_params
from dab_radio_tpu_torch.utils import graphs, profiler
from dab_radio_tpu_torch.utils.graphs import GRAPH_STATS, CapturedProgram
from dab_radio_tpu_torch.utils.profiler import Profiler, get_profiler


def test_counts_are_exact_past_the_ring():
    """150,000 spans: the table counts every one, the ring keeps the last
    RING of them, and the trace writes those."""
    p = Profiler(enabled=True)
    n = 150_000
    for _ in range(n):
        with p.scope("tick"):
            pass
    row = p.table()["tick"]
    assert row["count"] == n
    assert 0 < row["max_us"] <= row["total_us"]
    assert row["mean_us"] == pytest.approx(row["total_us"] / n)
    ring = p._state().ring
    assert ring.maxlen == profiler.RING == 100_000 and len(ring) == ring.maxlen
    p.reset()
    assert p.table() == {}


def test_table_merges_threads(tmp_path):
    p = Profiler(enabled=True)

    def work(k):
        p.tag_thread(f"worker {k}")
        for _ in range(10 + k):
            with p.scope("outer"):
                with p.scope(f"inner/{k}"):
                    pass
    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    table = p.table()
    assert table["outer"]["count"] == 10 + 11 + 12
    assert {k: table[f"inner/{k}"]["count"] for k in range(3)} == \
        {0: 10, 1: 11, 2: 12}
    path = tmp_path / "trace.json"
    p.dump_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["args"]["name"]: e["tid"] for e in events if e["ph"] == "M"}
    assert set(names) == {"worker 0", "worker 1", "worker 2"}
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == 2 * (10 + 11 + 12)
    assert {e["pid"] for e in events} == {os.getpid()}
    assert {e["tid"] for e in spans} == set(names.values())


def test_disabled_scope_is_one_shared_no_op():
    p = Profiler(enabled=False)
    a, b = p.scope("a"), p.scope("b")
    assert a is b is profiler._NOOP
    with a:
        with b:
            pass
    assert p.table() == {} and p._threads == []
    glob = get_profiler()
    if not glob.enabled:
        assert profiler.profile_scope("x") is profiler._NOOP


def test_report_has_no_shape_line():
    p = Profiler(enabled=True)
    for name in ("one", "two", "two"):
        with p.scope(name):
            pass
    text = p.report()
    assert "unique trace shapes" not in text
    lines = text.splitlines()
    assert len(lines) == 3 and lines[0].split()[:2] == ["stage", "count"]
    assert {ln.split()[0]: int(ln.split()[1]) for ln in lines[1:]} == \
        {"one": 1, "two": 2}
    assert not hasattr(p, "_trace_counts")


def test_trace_lies_on_torch_profilers_clock(tmp_path):
    """Under a CPU torch.profiler session, each span's Chrome-trace start
    lies within 1 ms of its own record_function event's, and the two
    durations agree within 10% + 50 us."""
    p = Profiler(enabled=False)
    p.enabled = True                     # the clock offset is read here
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        for k in range(3):
            with p.scope(f"clock/{k}"):
                time.sleep(0.002 * (k + 1))
    path = tmp_path / "trace.json"
    p.dump_chrome_trace(str(path))
    mine = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
            if e["ph"] == "X"}
    theirs = {ev.name(): ev for ev in tp.profiler.kineto_results.events()
              if ev.name().startswith("clock/")}
    assert set(mine) == set(theirs) == {"clock/0", "clock/1", "clock/2"}
    for name, e in mine.items():
        ev = theirs[name]
        assert abs(e["ts"] - ev.start_ns() / 1e3) < 1000.0, name
        dur = ev.duration_ns() / 1e3
        assert abs(e["dur"] - dur) <= 0.1 * dur + 50.0, name
        assert e["pid"] == os.getpid()


# ---- the fleet's spans -------------------------------------------------------

MODE, FRAMES_PER_ROUND, ROUNDS = 2, 4, 6
CFGS = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
        SubchannelConfig(12, 12, False, eep_type="A", eep_prot_level=2)]


@pytest.fixture(scope="module")
def rounds():
    """(2, bytes) u8 of two mode-II streams from the port's transmitter,
    with a carrier offset and noise, the second 2 frames behind."""
    tx = EnsembleTransmitter(MODE, services=[
        ServiceSpec(0xF100 + i, i + 1, f"S{i}", c)
        for i, c in enumerate(CFGS)], device="cpu")
    fs = 49152
    iq = tx.generate(FRAMES_PER_ROUND * ROUNDS + 2)
    rng = np.random.default_rng(8)
    n = np.arange(iq.shape[0])
    noise = rng.normal(size=(2, iq.shape[0])) * np.abs(iq).std() * 0.07
    iq = iq * np.exp(2j * np.pi * 0.3 / 512 * n) + noise[0] + 1j * noise[1]
    iq = (iq / np.abs(iq).max() * 0.5).astype(np.complex64)
    u8 = np.clip(np.round(iq.view(np.float32) * 127.5 + 127.5), 0, 255
                 ).astype(np.uint8)
    return np.stack([u8, np.roll(u8, 2 * 2 * fs)])


@pytest.mark.parametrize("kinds", [None, ["mp2", "mp2"], ["audio", "mp2"]],
                         ids=["audio", "mp2", "mixed"])
def test_fleet_spans_at_their_counts(rounds, monkeypatch, kinds):
    """A 2-stream, 2-subchannel FusedFleet on the CPU with the profiler on,
    for each kind of byte layer (DAB+ superframes, MP2 frames, both):
    fleet/consume, fleet/fire and fleet/fetch_wait once a round; with an
    audio subchannel fleet/push_frames once a CIF, fleet/rs_decode and
    fleet/finish once a CIF that completes superframes (one batched RS call
    each); with an MP2 subchannel fleet/mp2_frames once a round. A span of
    a kind the fleet lacks never opens."""
    rs_calls = []
    decode = ReedSolomonDecoder.decode

    def counted(self, *a, **kw):
        rs_calls.append(1)
        return decode(self, *a, **kw)
    monkeypatch.setattr(ReedSolomonDecoder, "decode", counted)
    fleet = FusedFleet(2, CFGS, MODE, FRAMES_PER_ROUND, device="cpu",
                       subchannel_kinds=kinds)
    audio = "audio" in (kinds or ["audio"])
    mp2 = "mp2" in (kinds or [])
    got = []
    fleet.on_access_unit.append(lambda *a: got.append(a))
    fleet.on_mp2_frame.append(lambda *a: got.append(a))
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    prof = get_profiler()
    was = prof.enabled
    prof.reset()
    prof.enabled = True
    try:
        for r in range(ROUNDS):
            fleet.process_round(
                rounds[:, r * chunk:(r + 1) * chunk], defer_fetch=True,
                tail_u8=rounds[:, (r + 1) * chunk:(r + 1) * chunk + tb])
        fleet.flush()
        table = prof.table()
    finally:
        prof.enabled = was
        prof.reset()
    count = {k: v["count"] for k, v in table.items()}
    cifs = FRAMES_PER_ROUND * get_dab_params(MODE).nb_cifs
    assert fleet.materialized_rounds == ROUNDS and got
    assert count["fleet/consume"] == count["fleet/fire"] == ROUNDS
    assert count["fleet/fetch_wait"] == ROUNDS
    assert count.get("fleet/mp2_frames", 0) == (ROUNDS if mp2 else 0)
    if audio:
        assert count["fleet/push_frames"] == cifs * ROUNDS
        assert count["fleet/rs_decode"] == count["fleet/finish"] \
            == len(rs_calls) > 0
    else:
        assert not {"fleet/push_frames", "fleet/rs_decode",
                    "fleet/finish"} & set(count) and not rs_calls
    # the round's parts lie inside the round's byte layer
    inside = sum(table[k]["total_us"] for k in (
        "fleet/push_frames", "fleet/rs_decode", "fleet/finish",
        "fleet/mp2_frames", "fleet/fire") if k in table)
    assert inside <= table["fleet/consume"]["total_us"]
    assert "graph/stage" not in count          # eager on the CPU: no staging


def test_one_stream_spans_at_their_counts(rounds):
    """One stream through IQReader, StreamingDemodulator and DabReceiver on
    the CPU, in blocks of a third of a frame: io/convert and demod/process
    once a block, demod/fetch once a frame step, radio/frame and
    radio/superframes once a frame, msc/fetch once a frame that decodes
    the two same-protection channels as a group; the spans nest."""
    reader = IQReader(None, "u8")
    sd = StreamingDemodulator(OFDMDemodulator(MODE, device="cpu"))
    rx = DabReceiver(MODE, benchmark_all=True, device="cpu")
    block = 2 * 49152 // 3
    data = rounds[0]
    prof = get_profiler()
    was = prof.enabled
    prof.reset()
    prof.enabled = True
    blocks = frames = 0
    try:
        for at in range(0, data.shape[0] - block + 1, block):
            for bits in sd.process(reader.convert(data[at:at + block])):
                rx.process_frame(bits)
                frames += 1
            blocks += 1
        table = prof.table()
    finally:
        prof.enabled = was
        prof.reset()
    count = {k: v["count"] for k, v in table.items()}
    total = {k: v["total_us"] for k, v in table.items()}
    assert frames >= 20 and len(rx.channels) == 2
    assert count["io/convert"] == count["demod/process"] == blocks
    assert count["demod/fetch"] == count["demod/frame_step"] >= frames
    assert count["radio/frame"] == count["radio/superframes"] == frames
    assert 0 < count["msc/fetch"] <= frames
    assert total["radio/superframes"] + total["msc/fetch"] \
        <= total["radio/msc_channels"] <= total["radio/frame"]
    assert total["demod/fetch"] + total["demod/frame_step"] \
        <= total["demod/process"]


def test_eager_program_counts_no_capture():
    before = dict(GRAPH_STATS)
    prog = CapturedProgram(lambda x: x * 2, "cpu")
    assert not prog.captured
    for _ in range(3):
        assert prog(np.arange(4, dtype=np.float32)).tolist() == [0, 2, 4, 6]
    assert GRAPH_STATS == before
    assert graphs.GRAPH_STATS not in graphs.LAUNCH_COUNTERS


@pytest.mark.cuda
def test_captured_program_counts_one_capture_then_replays():
    """On a card: the first call captures (capture_s grows), the later ones
    replay; each call with a host argument stages it in graph/stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    prog = CapturedProgram(lambda x: x * 2, torch.device("cuda", 0))
    before = dict(GRAPH_STATS)
    prof = get_profiler()
    was = prof.enabled
    prof.reset()
    prof.enabled = True
    try:
        for _ in range(4):
            out = prog(np.arange(4, dtype=np.float32))
            assert out.cpu().tolist() == [0, 2, 4, 6]
        table = prof.table()
    finally:
        prof.enabled = was
        prof.reset()
    assert GRAPH_STATS["captures"] == before["captures"] + 1
    assert GRAPH_STATS["replays"] == before["replays"] + 3
    assert GRAPH_STATS["capture_s"] > before["capture_s"]
    assert table["graph/stage"]["count"] == 4
