"""The superframe layer's readers (superframe.batch_size,
byte_layer.finish_ms_per_air_s) on known windows and in traced runs of the
DAB+ cells at a small size on the CPU, and the fleet's batched finish
broken where it produces the access units."""

import pytest

from conftest import FLEET, TUNER, run_tiny
from harness import spec


class FakeRun:
    air_s = 2.0
    spans = None


def _window(probe, run, during):
    probe.start(run)
    during()
    probe.stop(run)
    return probe.value(run)


def test_batch_size_reads_superframes_a_call_in_the_window(monkeypatch):
    from dab_radio_tpu_torch.dab import aac
    stats = {"calls": 10, "superframes": 100, "finished": 90}
    monkeypatch.setattr(aac, "SF_STATS", stats)
    reader = spec.metric("superframe.batch_size")

    def three_calls():
        stats["calls"] += 3
        stats["superframes"] += 54
    assert _window(reader.probe(FakeRun()), FakeRun(), three_calls) == 18.0
    assert _window(reader.probe(FakeRun()), FakeRun(), lambda: None) is None
    monkeypatch.delattr(aac, "SF_STATS")
    assert _window(reader.probe(FakeRun()), FakeRun(), lambda: None) is None


def test_finish_time_reads_the_span_over_the_air():
    reader = spec.metric("byte_layer.finish_ms_per_air_s")
    run = FakeRun()
    run.spans = {"fleet/finish": {"count": 4, "total_us": 9000.0}}
    assert reader.probe(run).value(run) == 4.5
    run.spans = {"fleet/finish": {"count": 0, "total_us": 0.0}}
    assert reader.probe(run).value(run) is None
    run.spans = {}
    assert reader.probe(run).value(run) is None


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_traced_run_reads_the_superframe_layer(tiny, cell):
    """The fleet finishes each CIF's superframes in one call (its tiny
    cell: 2 streams of 2 subchannels, so up to 4 a call) and reads the
    span's time; the tuner finishes one superframe a call."""
    metrics = run_tiny(tiny, cell, trace=True)["metrics"]
    size = metrics["superframe.batch_size"]["value"]
    if cell == FLEET:
        assert 1.0 < size <= 4.0
        assert metrics["byte_layer.finish_ms_per_air_s"]["value"] > 0
    else:
        assert size == 1.0
        assert "byte_layer.finish_ms_per_air_s" not in metrics


def test_an_access_unit_altered_in_the_batched_finish_is_not_correct(
        tiny, monkeypatch):
    from dab_radio_tpu_torch.dab.aac import SuperframeProcessor
    finish_batch = SuperframeProcessor.finish_batch

    def altered(processors, corrected, nerr):
        out = finish_batch(processors, corrected, nerr)
        for i, res in enumerate(out):
            if res is not None:
                header, aus = res
                out[i] = header, [bytes([aus[0][0] ^ 1]) + aus[0][1:]] \
                    + list(aus[1:])
        return out
    monkeypatch.setattr(SuperframeProcessor, "finish_batch",
                        staticmethod(altered))
    line = run_tiny(tiny, FLEET)
    assert not line["correct"], line["checks"]
