"""What chip_smoke.py promises without a card, and the arithmetic it prints:
it must fail, printing no result, where there is no GPU, also when it is
run alone in a directory of its own; its roofline bounds follow from the
shapes; it reports every kernel whose launches the wrappers count; and its
byte-layer timers (--measure) change no output, count each part's calls as
the shapes give them, keep per-thread sums under the consume workers and
put the classes back.
"""

import contextlib
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.host.native import iq_quantize_u8
from dab_radio_tpu.models.channel import ChannelModel
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.params import SubchannelConfig as JCfg
from dab_radio_tpu_torch.convert import subchannel_config_from_jax
from dab_radio_tpu_torch.dab.aac import SuperframeProcessor
from dab_radio_tpu_torch.kernels import viterbi_acs as K
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.params import get_dab_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("alone", [False, True])
def test_fails_and_prints_no_result_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the script would run")
    script, cwd = SCRIPT, ROOT
    if alone:
        script = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=cwd, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_every_counted_kernel_is_reported(smoke):
    assert set(smoke.REPLACES) == set(K.LAUNCHES) == set(smoke.REPORT_SHAPE) \
        == set(smoke.KERNEL_PATH)
    shapes = {name for name, _, _ in smoke.K1_SHAPES} | {"eep4a_864cu"}
    assert set(smoke.WINDOWS_OF) <= shapes
    assert set(smoke.REPORT_SHAPE.values()) <= shapes | set(
        smoke.WINDOWS_OF.values())
    assert K.plan(4, smoke.LONG_T)[0] == "pair"
    for _, B, T in smoke.K1_SHAPES:
        assert K.plan(B, T)[0] == "fused"
    # each kernel's path is one whose launches the script reads
    assert set(smoke.KERNEL_PATH.values()) <= {"main", "long", "fleet",
                                               "fleet_tiled"}
    assert smoke.launched(viterbi_acs=2) == dict(
        dict.fromkeys(K.LAUNCHES, 0), viterbi_acs=2)


def test_window_shapes_of_the_tiled_decode(smoke):
    """The windowed entry's four shapes follow from the exact shapes: ceil(T
    / 128) windows of 320 steps a message; the fleet round's 126,464 plan as
    16 a block; the bounds are those of 285 operations a window step."""
    from dab_radio_tpu_torch.ops import viterbi as vit
    lanes = {name: (B, T) for name, B, T in smoke.K1_SHAPES}
    lanes["eep4a_864cu"] = (4, smoke.LONG_T)
    nb = {smoke.WINDOWS_OF[n]: B * -(-T // 128) for n, (B, T) in lanes.items()
          if n in smoke.WINDOWS_OF}
    assert nb == {"fic_tiled": 28, "msc_group_tiled": 936, "long_tiled": 1300,
                  "round16x8_tiled": 126464}
    w, first = vit.tile_windows(torch.zeros((4, 774, 4), dtype=torch.int8))
    assert tuple(w.shape) == (28, smoke.WINDOW_L, 4) and int(first.sum()) == 4
    assert K.plan(126464, 320) == ("fused", 16, 6976)
    assert smoke.REPORT_SHAPE["viterbi_decode_windows"] == "round16x8_tiled"
    for B, want in ((1300, 0.0071), (126464, 0.689)):
        ms, by = smoke.bound("viterbi_decode_windows", B, 320)
        assert by == "operations" and ms == pytest.approx(want, rel=5e-3)
        assert ms == pytest.approx(smoke.bound("viterbi_decode_fused", B,
                                               320)[0])
    # the plain version is compared in chunks that fit the card's memory
    assert 126464 % smoke.WINDOW_PLAIN_CHUNK == 0
    assert 3 * smoke.WINDOW_PLAIN_CHUNK * 320 * 128 * 4 < 8e9
    assert smoke.VARIANT_STREAMS * (18 * 4 + 4) * smoke.VARIANT_K == 608


def test_fleet_rounds_shape(smoke):
    """The fleet path's one decode a round: 16 streams x (18 subchannels x
    32 CIFs + 32 FIC groups) messages of 1542 steps, which plans as the
    fused kernel with 12 messages a block; its bound is 0.2556 ms, by
    operations; the fused kernel is reported at that shape."""
    assert smoke.FLEET_LANES == 9728
    assert ("round16x8", 9728, 1542) in smoke.K1_SHAPES
    assert smoke.REPORT_SHAPE["viterbi_decode_fused"] == "round16x8"
    assert smoke.KERNEL_PATH["viterbi_decode_fused"] == "fleet"
    route, per_block, smem = K.plan(9728, 1542)
    assert (route, per_block, smem) == ("fused", 12, 17984)
    assert -(-9728 // per_block) == 811
    ms, by = smoke.bound("viterbi_decode_fused", 9728, 1542)
    assert by == "operations" and ms == pytest.approx(0.2556, abs=5e-5)
    # the plain version is compared in chunks that fit the card's memory
    assert 3 * smoke.PLAIN_CHUNK * 1542 * 128 * 4 < 8e9
    assert (smoke.NB_FRAMES - 1) // smoke.FLEET_K == 3


@pytest.mark.parametrize("B,T", [(4, 774), (72, 1542), (1152, 1542),
                                 (9728, 1542), (4, 41478)])
def test_roofline_bounds_follow_from_the_shape(smoke, B, T):
    steps = B * T
    fused_ms, fused_by = smoke.bound("viterbi_decode_fused", B, T)
    acs_ms, acs_by = smoke.bound("viterbi_acs", B, T)
    cb_ms, cb_by = smoke.bound("viterbi_chainback", B, T)
    # 280 int32 operations a step against 16.7 T op/s outweigh 12 bytes a
    # step against 3.35 TB/s; the chainback's 5 operations do not
    assert (fused_by, acs_by, cb_by) == ("operations", "operations", "bytes")
    assert acs_ms == pytest.approx(280 * steps / (132 * 64 * 1.98e9) * 1e3)
    assert fused_ms == pytest.approx(285 * steps / (132 * 64 * 1.98e9) * 1e3)
    assert cb_ms == pytest.approx(9 * steps / 3.35e12 * 1e3)
    assert fused_ms > acs_ms > cb_ms > 0


# the byte-layer timers on a small fleet: 2 streams of one two-service
# mode-II ensemble (one CIF a frame), 4 frames a round, 5 rounds
MODE, FRAMES_PER_ROUND, ROUNDS = 2, 4, 5
AUDIO_CFGS = [JCfg(0, 12, False, eep_type="A", eep_prot_level=2),
              JCfg(12, 12, False, eep_type="A", eep_prot_level=2)]


@pytest.fixture(scope="module")
def capture():
    """(2, bytes) u8: the JAX transmitter's ensemble through two channels."""
    header = SuperFrameHeader(48000, True, True, False, 0)
    services = [ServiceSpec(0xF200 + i, i + 1, f"Timed {i}", cfg,
                            superframe_header=header)
                for i, cfg in enumerate(AUDIO_CFGS)]
    tx = EnsembleTransmitter(MODE, ensemble_id=0xC0FE,
                             ensemble_label="Timers", services=services)
    for s in services:
        rng = np.random.default_rng(s.service_id)
        tx.set_au_source(s.subchannel_id, lambda cap, num, rng=rng: [
            rng.integers(0, 256, n).astype(np.uint8).tobytes()
            for n in [cap // num] * (num - 1) + [cap - cap // num * (num - 1)]])
    iq = tx.generate(FRAMES_PER_ROUND * ROUNDS + 1)
    rows = []
    for seed, cfo in ((1, 1100.0), (2, -700.0)):
        x = ChannelModel(cfo_hz=cfo, snr_db=18.0, seed=seed).apply(iq)
        rows.append(np.frombuffer(iq_quantize_u8(
            (x / np.abs(x).max() * 0.5).astype(np.complex64)), np.uint8))
    return np.stack(rows)


def _timed_run(u8, timers=None, workers=0):
    """FusedFleet over the capture's rounds (deferred fetch), with `timers`
    (a context manager or None) around the rounds and the flush ->
    (access units in order, summary, last_fib_ok, the fleet)."""
    fleet = FusedFleet(2, [subchannel_config_from_jax(c) for c in AUDIO_CFGS],
                       MODE, FRAMES_PER_ROUND, device="cpu",
                       consume_workers=workers)
    aus = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, hdr: aus.append((b, s, i, n, bytes(au))))
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    with timers or contextlib.nullcontext():
        for r in range(ROUNDS):
            fleet.process_round(
                u8[:, r * chunk:(r + 1) * chunk], defer_fetch=True,
                tail_u8=u8[:, (r + 1) * chunk:(r + 1) * chunk + tb])
        fleet.flush()
    return aus, fleet.summary(), fleet.last_fib_ok.tolist(), fleet


@pytest.fixture(scope="module")
def timed_runs(smoke, capture):
    """{workers: (run without the timers, run with them, the timers)}."""
    out = {}
    for workers in (0, 2):
        timers = smoke._ByteLayerTimers()
        out[workers] = (_timed_run(capture, workers=workers),
                        _timed_run(capture, timers, workers), timers)
    return out


def _superframes(fleet):
    return sum(p.stats["superframes"] for row in fleet._sfp for p in row)


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "two_workers"])
def test_sf_stats_count_the_fleets_superframes(capture, workers):
    """SF_STATS counts the batched finish: a fleet hands it every
    superframe it finishes (all it completes, on this capture), serially
    in one call a CIF that completes superframes, so in at most one call an
    RS decode; on the consume workers in one call a superframe."""
    from dab_radio_tpu_torch.dab.aac import SF_STATS
    from dab_radio_tpu_torch.ops.rs import RS_STATS
    sf, rs = dict(SF_STATS), RS_STATS["calls"]
    fleet = _timed_run(capture, workers=workers)[3]
    done = {k: SF_STATS[k] - sf[k] for k in SF_STATS}
    assert done["superframes"] == done["finished"] == _superframes(fleet) > 0
    assert 0 < done["calls"] <= RS_STATS["calls"] - rs
    if workers:
        assert done["calls"] == done["superframes"]
    else:
        assert done["calls"] < done["superframes"]


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "two_workers"])
def test_byte_layer_timers_change_no_output(timed_runs, workers):
    """With the part timers on, the fleet decodes the same access units in
    the same order, with the same counters and valid FIBs: serial, and on
    two consume workers (which decode what the serial fleet decodes)."""
    plain, timed, _ = timed_runs[workers]
    assert timed[:3] == plain[:3] == timed_runs[0][0][:3]
    aus, summary, fib_ok, _ = plain
    assert len(aus) >= 2 * 2 * 2 and summary["access_units"] == len(aus)
    assert {(b, s) for b, s, *_ in aus} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert min(fib_ok) > 0


def test_byte_layer_calls_follow_the_shapes(smoke, timed_runs):
    """Each part's calls a round are what the round's shapes give: one FIB
    check, one FIG ingest and one observer replay a stream, one push_frame a
    stream, subchannel and CIF (4 frames of one CIF in mode II), at most one
    batched RS decode a CIF and one batched finish for each of them (a CIF
    that completes superframes); no other kind, no group dispatch; the
    fetch waited for once a round. The parts on the consuming thread fit
    inside _consume, and the rest is "other"."""
    _, timed, timers = timed_runs[0]
    fleet = timed[3]
    streams, subs = fleet.N, fleet.S
    cifs = FRAMES_PER_ROUND * get_dab_params(MODE).nb_cifs
    calls = timers.calls()
    assert len(timers.rounds) == fleet.materialized_rounds == ROUNDS
    assert calls["push_frame"] == streams * subs * cifs * ROUNDS
    assert calls["check_fibs"] == ROUNDS
    assert calls["ingest_fibs"] == calls["fire"] == streams * ROUNDS
    assert calls["finish"] == calls["rs_decode"] > 0
    assert -(-_superframes(fleet) // (streams * subs)) <= calls["rs_decode"] \
        <= cifs * ROUNDS
    assert calls["fetch_wait"] == ROUNDS
    assert "mp2_events" not in calls and "packet_events" not in calls \
        and "msc_dispatch" not in calls
    split = smoke._round_stats(timers.split(skip=0))
    assert split["rounds"] == ROUNDS
    for part in ("check_fibs", "ingest_fibs", "push_frame", "fire"):
        assert split["parts"][part]["calls_per_round"] == \
            calls[part] / ROUNDS
    for c, own, other in zip(split["consume_ms"],
                             split["parts_on_consuming_thread_ms"],
                             split["other_ms"]):
        assert 0 < own <= c and own + other == pytest.approx(c)
    assert split["parts_on_other_threads_ms"] == [0.0] * ROUNDS


def test_byte_layer_thread_sums_under_consume_workers(smoke, timed_runs,
                                                      capture, monkeypatch):
    """On two consume workers each part's time is kept per thread: the
    rounds' sums (consuming thread and the others) add up to the threads'
    sums, the superframe work runs on the workers only, and a timed call
    made inside another one is not counted: process_frame's RS decode and
    finish (a batch of one) are one a superframe, and a push_frame that
    decodes a codeword itself still counts once, its inner decode not at
    all."""
    _, timed, timers = timed_runs[2]
    fleet = timed[3]
    calls = timers.calls()
    assert calls["push_frame"] == timed_runs[0][2].calls()["push_frame"]
    assert calls["rs_decode"] == calls["finish"] == _superframes(fleet)
    split = timers.split(skip=0)
    per_thread = timers.thread_ms()
    for part in ("ingest_fibs", "push_frame", "rs_decode", "finish"):
        assert sum(split["parts"][part]["ms_per_round"]) == pytest.approx(
            sum(row.get(part, 0.0) for row in per_thread.values()))
    workers = [name for name, row in per_thread.items()
               if row.get("push_frame")]
    assert workers and all(name.startswith("ThreadPoolExecutor")
                           for name in workers)
    assert sum(split["parts_on_other_threads_ms"]) > 0

    # a push_frame that runs an RS decode inside itself
    from dab_radio_tpu_torch.ops.rs import dab_plus_rs
    push, inner = SuperframeProcessor.push_frame, []

    def nested_push(proc, frame):
        dab_plus_rs().decode(np.zeros((1, 120), np.uint8))
        inner.append(1)
        return push(proc, frame)
    monkeypatch.setattr(SuperframeProcessor, "push_frame", nested_push)
    nested = smoke._ByteLayerTimers()
    run = _timed_run(capture, nested, workers=2)
    assert run[:3] == timed[:3]
    assert len(inner) == calls["push_frame"]
    assert nested.calls()["push_frame"] == calls["push_frame"]
    assert nested.calls()["rs_decode"] == calls["rs_decode"]


@pytest.mark.parametrize("raised", [False, True], ids=["normal", "raised"])
def test_timers_put_the_classes_back(smoke, raised):
    """Every method the timers wrap (and the feeder watch's __init__) is the
    class's own again after the context, also after an exception inside."""
    from dab_radio_tpu_torch.host.feeder import DoubleBufferedFeeder
    specs = list(smoke.BYTE_LAYER_PARTS.values()) + [
        smoke.BYTE_LAYER_FETCH, smoke.BYTE_LAYER_CONSUME]
    targets = [smoke._ByteLayerTimers._target(spec) for spec in specs]
    targets.append((DoubleBufferedFeeder, "__init__"))
    before = [cls.__dict__[name] for cls, name in targets]
    with contextlib.suppress(KeyError):
        with smoke._ByteLayerTimers(), smoke._FeederWatch():
            assert all(cls.__dict__[name] is not fn
                       for (cls, name), fn in zip(targets, before))
            if raised:
                raise KeyError("inside the timers")
    assert [cls.__dict__[name] for cls, name in targets] == before
