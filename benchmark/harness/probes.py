"""What the per-layer metrics' readers are made of. A reader (a file in
metrics/) builds one probe; the harness starts every probe when the traced
window opens, stops it when it closes, and asks its value, which is None
where the probe found nothing to read (the metric is then left out).

- MethodTime: the host clock around every call of a method of the program,
  wrapped at class level and put back when the window closes. With
  self_time, a call made inside another self-timed call is neither timed
  nor counted, so the self-timed parts never overlap (as chip_smoke.py's
  _ByteLayerTimers does).
- Span: a span of the program's own profiler (utils/profiler.py), which
  the harness turns on for the traced window.
- CudaEvents: CUDA events around each call of a callable attribute of the
  driver's objects (an instance attribute, replaced and put back).
Readers of the device trace subclass Probe and read run.trace in value().
"""

import importlib
import threading
import time


class Probe:
    def start(self, run):
        pass

    def stop(self, run):
        pass

    def value(self, run):
        return None


class MethodTime(Probe):
    """ms of host time a second of air in a method, `target` being
    "package.module:Class.method"."""

    _tls = threading.local()        # set while a self-timed call runs

    def __init__(self, target: str, self_time: bool = False):
        module, attr = target.split(":")
        self.module, (self.cls_name, self.method) = module, attr.split(".")
        self.self_time = self_time
        self.ns = self.calls = 0
        self._saved = None

    def start(self, run):
        cls = getattr(importlib.import_module(self.module), self.cls_name)
        fn = cls.__dict__[self.method]
        self._saved = (cls, fn)
        tls, probe = self._tls, self

        def timed(*args, **kw):
            if probe.self_time and getattr(tls, "inside", False):
                return fn(*args, **kw)
            if probe.self_time:
                tls.inside = True
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                probe.ns += time.perf_counter_ns() - t0
                probe.calls += 1
                if probe.self_time:
                    tls.inside = False
        setattr(cls, self.method, timed)

    def stop(self, run):
        if self._saved is not None:
            cls, fn = self._saved
            setattr(cls, self.method, fn)
            self._saved = None

    def value(self, run):
        if not self.calls or run.air_s <= 0:
            return None
        return self.ns / 1e6 / run.air_s


class Span(Probe):
    """ms a second of air inside the program's span `name`."""

    def __init__(self, name: str):
        self.name = name

    def value(self, run):
        row = (run.spans or {}).get(self.name)
        if not row or not row["count"] or run.air_s <= 0:
            return None
        return row["total_us"] / 1e3 / run.air_s


class CudaEvents(Probe):
    """ms of device time a second of air between CUDA events recorded
    around each call of `owner.attr`, where owner is the driver's
    attribute `owner_attr` (the object whose callable is replaced)."""

    def __init__(self, owner_attr: str, attr: str):
        self.owner_attr, self.attr = owner_attr, attr
        self.events = []
        self._owner = None

    def start(self, run):
        import torch
        owner = getattr(run.driver, self.owner_attr, None)
        if owner is None or not torch.cuda.is_available():
            return
        fn = getattr(owner, self.attr)
        self._owner = (owner, self.attr in owner.__dict__, fn)
        setattr(owner, self.attr, _Timed(fn, self.events, torch))

    def stop(self, run):
        if self._owner is None:
            return
        owner, had, fn = self._owner
        if had:
            setattr(owner, self.attr, fn)
        else:
            delattr(owner, self.attr)
        self._owner = None

    def value(self, run):
        if not self.events or run.air_s <= 0:
            return None
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / run.air_s


class _Timed:
    """A callable with CUDA events around each call; every other
    attribute is the wrapped object's."""

    def __init__(self, fn, events, torch):
        self._fn, self._events, self._torch = fn, events, torch

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kw):
        a = self._torch.cuda.Event(enable_timing=True)
        b = self._torch.cuda.Event(enable_timing=True)
        a.record()
        out = self._fn(*args, **kw)
        b.record()
        self._events.append((a, b))
        return out
