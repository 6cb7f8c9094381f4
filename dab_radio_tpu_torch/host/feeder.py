"""Host-to-device ingest that overlaps the running round: a staging thread
with a bounded queue (the port's counterpart of
``dab_radio_tpu/host/feeder.py``, written for CUDA streams).

A staging thread reads whole rounds from a byte source and, for a CUDA
device, copies each into a pinned host buffer and from there to the device
on a copy stream of its own, marking the end of the copy with an event. The
serving loop's ``get()`` makes its current stream wait for that event, never
the host, and hands out the device tensors. With depth=2 the steady state is:
round r computing, round r+1 copying, round r+2 being read from the source,
so a round costs max(compute, copy) instead of their sum. For a CPU device
there is nothing to stage: the source's arrays pass through as they are.

Backpressure is the queue's bound in both directions. A slow consumer blocks
the staging thread, and through it the source (a pipe or SDR front end sees the
stall); a slow source starves the consumer, which blocks in ``get()``.
``close()`` returns promptly whatever the queue holds: every wait of the
staging thread polls the stop flag, and the end-of-stream mark is offered
the same way, never with a blocking put.

``FeederStats`` separates the times that tell a compute-bound deployment
from an ingest-bound one:
  stage_busy_s    staging-thread time reading and queueing copies
  producer_wait_s staging-thread time blocked on a full queue
                  (compute-bound: the device is the bottleneck)
  consumer_wait_s consumer time blocked on an empty queue
                  (ingest-bound: the source or the link is the bottleneck)
"""

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

_POLL_S = 0.05


@dataclass
class FeederStats:
    rounds: int = 0
    bytes: int = 0
    stage_busy_s: float = 0.0
    producer_wait_s: float = 0.0
    consumer_wait_s: float = 0.0
    error: Optional[BaseException] = field(default=None, repr=False)


def shared_stream_source(f, nb_streams: int, round_bytes: int,
                         tail_bytes: int):
    """Round source over ONE byte stream broadcast to N streams (the
    fleet_serve --shared-input topology). Each call returns (blk, tail)
    host uint8 arrays of shape (N, round_bytes) and (N, tail_bytes), or None
    at the end. The tail is the head of the NEXT round (the fused round's
    timing-margin lookahead), so the source keeps one round read ahead; it
    is None when fewer than tail_bytes follow. A final partial round is
    dropped: the fused round wants whole rounds."""
    def read_exact(n: int) -> bytes:
        parts, got = [], 0
        while got < n:
            part = f.read(n - got)
            if not part:
                break
            parts.append(part)
            got += len(part)
        return b"".join(parts)

    ahead = read_exact(round_bytes)

    def rows(data: bytes, n: int) -> np.ndarray:
        return np.broadcast_to(np.frombuffer(data[:n], np.uint8),
                               (nb_streams, n))

    def next_round() -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        nonlocal ahead
        cur = ahead
        if len(cur) < round_bytes:
            return None
        ahead = read_exact(round_bytes)
        tail = rows(ahead, tail_bytes) if len(ahead) >= tail_bytes else None
        return rows(cur, round_bytes), tail

    return next_round


class _PinnedStage:
    """Pinned host buffers and the copy stream of one feeder. Each buffer
    slot is reused only after the event of the copy that last read it."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [{} for _ in range(slots)]
        self.turn = 0

    def put(self, arrays):
        """Host arrays (None allowed) -> (device tensors, the event that
        marks the end of their copies)."""
        slot = self.slots[self.turn]
        self.turn = (self.turn + 1) % len(self.slots)
        if "event" in slot:
            slot["event"].synchronize()
        out = []
        with torch.cuda.stream(self.stream):
            for i, a in enumerate(arrays):
                if a is None:
                    out.append(None)
                    continue
                buf = slot.get(i)
                if buf is None or buf.shape != a.shape:
                    buf = slot[i] = torch.empty(a.shape, dtype=torch.uint8,
                                                pin_memory=True)
                np.copyto(buf.numpy(), a)
                out.append(buf.to(self.device, non_blocking=True))
            slot["event"] = event = torch.cuda.Event()
            event.record(self.stream)
        return out, event


class DoubleBufferedFeeder:
    """Stage (blk, tail) rounds onto `device` ahead of the consumer.

    source: callable returning (blk, tail) host uint8 arrays (blk of shape
        (N, round_bytes), tail (N, tail_bytes) or None), or None at end of
        stream. Called only from the staging thread.
    depth: bounded queue size = rounds in flight beyond the one computing.
        2 = classic double buffering.
    device: where the rounds go. CUDA: pinned staging and an asynchronous
        copy; ``get()`` returns device tensors that the caller's current
        stream may use at once. CPU: the source's arrays, untouched.
    """

    _DONE = object()

    def __init__(self, source: Callable, depth: int = 2, *, device):
        self._source = source
        self.device = torch.device(device)
        depth = max(depth, 1)
        # a pinned buffer is free again once its copy has ended, so one
        # more than the queue holds keeps the staging thread from waiting
        self._stage = _PinnedStage(self.device, depth + 1) \
            if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self.stats = FeederStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ingest-feeder")
        self._thread.start()

    def _offer(self, item) -> None:
        """Queue `item`, giving up as soon as the feeder is closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _run(self):
        st = self.stats
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                item = self._source()
                if item is None:
                    break
                blk, tail = item
                nbytes = blk.size + (0 if tail is None else tail.size)
                event = None
                if self._stage is not None:
                    (blk, tail), event = self._stage.put((blk, tail))
                st.stage_busy_s += time.perf_counter() - t0
                st.rounds += 1
                st.bytes += nbytes
                t0 = time.perf_counter()
                self._offer((blk, tail, event))
                st.producer_wait_s += time.perf_counter() - t0
        except Exception as e:              # noqa: BLE001 - handed to get()
            st.error = e
        finally:
            self._offer(self._DONE)

    def get(self, timeout: Optional[float] = None):
        """Next (blk, tail) pair, or None at end of stream or after
        close(). Re-raises any staging-thread exception; raises queue.Empty
        after `timeout` seconds without a round."""
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    item = self._q.get(timeout=_POLL_S)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        return None
                    if timeout is not None and \
                            time.perf_counter() - t0 >= timeout:
                        raise
        finally:
            self.stats.consumer_wait_s += time.perf_counter() - t0
        if item is self._DONE:
            self._q.put(item)               # every later get() ends too
            if self.stats.error is not None:
                raise self.stats.error
            return None
        blk, tail, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in (blk, tail):
                if t is not None:
                    t.record_stream(cur)
        return blk, tail

    def __iter__(self) -> Iterator:
        while True:
            item = self.get()
            if item is None:
                return
            yield item

    def close(self):
        """Stop staging and drop the queued rounds. Idempotent; returns
        within a poll interval of the source's current read."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
