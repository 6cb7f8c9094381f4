"""Tracing profiler: per-thread stack-scoped spans on the device trace's
clock.

Port of ``dab_radio_tpu/utils/profiler.py``. ``scope(name)`` times a block
of host code. A span that closes adds to running totals per name and
thread (count, total, max), which ``table()`` merges, so the cost of a
span and of a table depends on the number of names, never on the number of
spans recorded; the counts are exact over the whole time the profiler is
on. The thread's latest ``RING`` spans are kept for ``dump_chrome_trace``.

Each span also opens ``torch.profiler.record_function``, so that host
stages line up with device kernels in a ``torch.profiler`` trace, and the
Chrome trace stamps spans on the Unix clock that torch.profiler's events
use, with the process's pid and the threads' native ids: the program's
trace and a torch.profiler trace of the same process lie on one timeline.
While the profiler is off, ``scope`` returns one shared no-op context
manager. Spans time the host: a stage that only enqueues CUDA work ends
before the device finishes it.
"""

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List

import torch

RING = 100_000                  # finished spans kept a thread for the trace
_NOOP = contextlib.nullcontext()


def _unix_offset_ns() -> int:
    """The Unix clock (torch.profiler's) minus ``time.perf_counter_ns()``,
    the spans' clock: one reading of the first between two of the second."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return unix - (a + b) // 2


class _ThreadState:
    __slots__ = ("native_id", "totals", "ring", "label")

    def __init__(self):
        self.native_id = threading.get_native_id()
        self.totals = {}                 # name -> [count, total_ns, max_ns]
        self.ring = deque(maxlen=RING)   # (name, start_ns, end_ns)
        self.label = ""


class _Span:
    """One open span: a record_function range, timed on perf_counter_ns."""

    __slots__ = ("st", "name", "rf", "t0")

    def __init__(self, st: _ThreadState, name: str):
        self.st, self.name = st, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        t0, st = self.t0, self.st
        d = t1 - t0
        tot = st.totals.get(self.name)
        if tot is None:
            st.totals[self.name] = [1, d, d]
        else:
            tot[0] += 1
            tot[1] += d
            if d > tot[2]:
                tot[2] = d
        st.ring.append((self.name, t0, t1))
        return False


class Profiler:
    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)
        self._unix_offset_ns = _unix_offset_ns()
        self._lock = threading.Lock()
        # each thread's state, through a thread-local (an ident can be
        # reused once its thread has ended), and the list of them all
        self._local = threading.local()
        self._threads: List[_ThreadState] = []

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool):
        if on and not self._enabled:
            # turned on: the spans to come are stamped against this reading
            self._unix_offset_ns = _unix_offset_ns()
        self._enabled = bool(on)

    def _state(self) -> _ThreadState:
        st = getattr(self._local, "st", None)
        if st is None:
            st = self._local.st = _ThreadState()
            with self._lock:
                self._threads.append(st)
        return st

    def tag_thread(self, label: str):
        self._state().label = label

    def scope(self, name: str):
        if not self._enabled:
            return _NOOP
        return _Span(self._state(), name)

    # ---- reporting ----

    def _states(self):
        with self._lock:
            return list(self._threads)

    def table(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per-stage stats: {name: {count, total_us, max_us,
        mean_us}}, over every span since the last reset."""
        agg: Dict[str, Dict[str, float]] = {}
        for st in self._states():
            # a copy: another thread may add a name meanwhile
            for name, (n, total, most) in st.totals.copy().items():
                d = agg.setdefault(name, {"count": 0, "total_us": 0.0,
                                          "max_us": 0.0})
                d["count"] += n
                d["total_us"] += total / 1e3
                d["max_us"] = max(d["max_us"], most / 1e3)
        for d in agg.values():
            d["mean_us"] = d["total_us"] / max(d["count"], 1)
        return agg

    def report(self) -> str:
        rows = sorted(self.table().items(), key=lambda kv: -kv[1]["total_us"])
        lines = [f"{'stage':40s} {'count':>8s} {'total ms':>10s} "
                 f"{'mean us':>10s} {'max us':>10s}"]
        for name, d in rows:
            lines.append(f"{name:40s} {int(d['count']):8d} "
                         f"{d['total_us'] / 1e3:10.2f} {d['mean_us']:10.1f} "
                         f"{d['max_us']:10.1f}")
        return "\n".join(lines)

    def dump_chrome_trace(self, path: str):
        """Write each thread's latest spans (up to RING) as a Chrome trace
        (chrome://tracing / Perfetto): ``ts`` in microseconds on the Unix
        clock, as torch.profiler stamps its events."""
        pid, off = os.getpid(), self._unix_offset_ns
        events = []
        for st in self._states():
            if st.label:
                events.append({"ph": "M", "pid": pid, "tid": st.native_id,
                               "name": "thread_name",
                               "args": {"name": st.label}})
            for name, t0, t1 in st.ring.copy():
                events.append({"ph": "X", "pid": pid, "tid": st.native_id,
                               "name": name, "ts": (t0 + off) / 1e3,
                               "dur": (t1 - t0) / 1e3})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def reset(self):
        with self._lock:
            self._local = threading.local()
            self._threads = []


_GLOBAL = Profiler(enabled=False)


def get_profiler() -> Profiler:
    return _GLOBAL


def profile_scope(name: str):
    return _GLOBAL.scope(name)
