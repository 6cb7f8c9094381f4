"""The port's double-buffered ingest feeder (host/feeder.py) on the CPU: the
cases of tests/test_feeder.py (ordering, backpressure, end of stream, error
propagation, the shared-stream source's tail lookahead, a feeder-fed fleet
equal to a directly fed one), and a close() that returns promptly with a
full queue, which the JAX package's feeder does not (ROADMAP F1). For a CPU
device the feeder stages nothing: the source's arrays pass through. The
pinned staging and the copy stream are tested on the card
(tests/test_torch_cuda.py).
"""

import io
import queue
import threading
import time

import numpy as np
import pytest
import torch

from dab_radio_tpu.host.feeder import (
    FeederStats as JStats, shared_stream_source as jax_shared_stream_source)
from dab_radio_tpu_torch.host.feeder import (
    DoubleBufferedFeeder, FeederStats, shared_stream_source)
from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
from dab_radio_tpu_torch.params import SubchannelConfig

torch.set_num_threads(1)


def _array_source(rounds):
    it = iter(rounds)

    def src():
        return next(it, None)
    return src


def _feeder(src, depth=2):
    return DoubleBufferedFeeder(src, depth=depth, device="cpu")


def test_feeder_preserves_order_and_content():
    rng = np.random.default_rng(0)
    rounds = [(rng.integers(0, 256, (2, 64)).astype(np.uint8),
               rng.integers(0, 256, (2, 8)).astype(np.uint8) if r % 2 else None)
              for r in range(20)]
    with _feeder(_array_source(rounds)) as f:
        got = list(f)
    assert len(got) == 20
    for (blk, tail), (rblk, rtail) in zip(got, rounds):
        assert blk is rblk and tail is rtail      # identity staging on the CPU
    assert f.stats.rounds == 20
    assert f.stats.bytes == 20 * 128 + 10 * 16
    assert vars(FeederStats()).keys() == vars(JStats()).keys()


def test_feeder_eos_returns_none_every_time():
    with _feeder(_array_source([])) as f:
        assert f.get(timeout=5.0) is None
        assert f.get(timeout=5.0) is None


def test_feeder_get_times_out_on_a_stalled_source():
    gate = threading.Event()

    def src():
        gate.wait(10.0)
        return None
    with _feeder(src) as f:
        with pytest.raises(queue.Empty):
            f.get(timeout=0.2)
        gate.set()
        assert f.get(timeout=5.0) is None


def test_feeder_backpressure_bounds_inflight_rounds():
    """With depth=2 the staging thread may run at most depth+1 rounds
    ahead of the consumer (depth queued + one blocked in put)."""
    calls = []

    def src():
        if len(calls) >= 50:
            return None
        calls.append(len(calls))
        return np.zeros((1, 8), np.uint8), None

    with _feeder(src) as f:
        time.sleep(0.3)                       # consumer stalled
        assert len(calls) <= 2 + 2            # depth + in-put + in-read
        consumed = 0
        while f.get(timeout=5.0) is not None:
            consumed += 1
        assert consumed == 50
    assert f.stats.producer_wait_s > 0.2      # it really blocked


def test_feeder_saturates_slow_consumer():
    """With a source faster than the consumer, every get() after the first
    is served from the pre-filled queue: the consumer's wait stays small
    next to its own compute time, and the producer is the one that blocks."""
    N = 30

    def src(n=iter(range(N))):
        return (np.zeros((1, 8), np.uint8), None) \
            if next(n, None) is not None else None

    consume_s = 0.01
    with _feeder(src) as f:
        rounds = 0
        while f.get(timeout=5.0) is not None:
            time.sleep(consume_s)              # simulated device round
            rounds += 1
    assert rounds == N
    assert f.stats.consumer_wait_s < 0.2 * N * consume_s
    assert f.stats.producer_wait_s > 0


def test_feeder_propagates_source_error():
    def src():
        raise RuntimeError("device unplugged")

    with _feeder(src) as f:
        with pytest.raises(RuntimeError, match="device unplugged"):
            f.get(timeout=5.0)


@pytest.mark.parametrize("depth", [1, 2])
def test_feeder_close_with_a_full_queue_returns_promptly(depth):
    """An endless source fills the queue and blocks the staging thread in
    its put; close() must still end it, in well under 2 s."""
    def src():
        return np.zeros((1, 8), np.uint8), None

    f = _feeder(src, depth=depth)
    time.sleep(0.2)
    assert f._q.full()
    t0 = time.perf_counter()
    f.close()
    assert time.perf_counter() - t0 < 2.0
    assert not f._thread.is_alive()
    assert f.get(timeout=1.0) is None          # closed: no round, no hang
    f.close()                                  # idempotent


def test_feeder_close_after_a_finished_source_returns_promptly():
    rounds = [(np.zeros((1, 8), np.uint8), None)] * 2   # fills depth 2
    f = _feeder(_array_source(rounds))
    time.sleep(0.2)                   # the end mark waits behind a full queue
    t0 = time.perf_counter()
    f.close()
    assert time.perf_counter() - t0 < 2.0 and not f._thread.is_alive()


def test_shared_stream_source_tail_is_next_round_head():
    data = bytes(range(256)) * 4               # 1024 bytes
    src = shared_stream_source(io.BytesIO(data), nb_streams=3,
                               round_bytes=300, tail_bytes=50)
    ref = jax_shared_stream_source(io.BytesIO(data), nb_streams=3,
                                   round_bytes=300, tail_bytes=50)
    for lo in (0, 300, 600):
        blk, tail = src()
        rblk, rtail = ref()
        assert blk.shape == (3, 300) and tail.shape == (3, 50)
        np.testing.assert_array_equal(
            blk[0], np.frombuffer(data[lo:lo + 300], np.uint8))
        np.testing.assert_array_equal(
            tail[0], np.frombuffer(data[lo + 300:lo + 350], np.uint8))
        np.testing.assert_array_equal(blk[0], blk[2])   # broadcast rows
        np.testing.assert_array_equal(blk, rblk)
        np.testing.assert_array_equal(tail, rtail)
    # 124 bytes remain: not a whole round, though enough for round 2's tail
    assert src() is None and ref() is None
    # a last whole round with fewer than tail_bytes behind it has no tail
    src = shared_stream_source(io.BytesIO(data[:620]), 1, 300, 50)
    assert src()[1] is not None and src()[1] is None and src() is None


def test_feeder_drives_fused_fleet_identically():
    """Feeder-fed rounds (from a shared byte stream) decode as rounds fed
    directly to process_round: the same packed bytes round by round."""
    cfgs = [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2)]
    rng = np.random.default_rng(3)

    def consumed(fleet):
        seen = []
        inner = fleet._consume

        def consume(fib, msc):
            seen.append((fib.copy(), msc.copy(),
                         fleet.last_frame_offsets.copy()))
            inner(fib, msc)
        fleet._consume = consume
        return seen

    direct = FusedFleet(2, cfgs, 2, 2, device="cpu")
    fed = FusedFleet(2, cfgs, 2, 2, device="cpu")
    rb, tb = 2 * direct.round_samples, direct.tail_bytes
    data = rng.integers(96, 160, 3 * rb + tb + 10).astype(np.uint8)
    want, got = consumed(direct), consumed(fed)
    for r in range(3):
        blk = np.broadcast_to(data[r * rb:(r + 1) * rb], (2, rb))
        tail = np.broadcast_to(data[(r + 1) * rb:(r + 1) * rb + tb], (2, tb))
        direct.process_round(blk, defer_fetch=True, tail_u8=tail)
    direct.flush()
    src = shared_stream_source(io.BytesIO(data.tobytes()), 2, rb, tb)
    with DoubleBufferedFeeder(src, depth=2, device="cpu") as f:
        for blk, tail in f:
            fed.process_round(blk, defer_fetch=True, tail_u8=tail)
    fed.flush()
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
