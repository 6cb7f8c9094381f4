"""The traced run's device timeline: a torch.profiler session over set-up
and the window, reduced to the window's device activity.

The session starts before set-up, because a CUDA graph instantiated before
a profiler session replays at the host's speed after it. Only events
inside the harness's "bench/window" range count. Host ranges
(record_function: the harness's own "bench/..." ranges and the program's
spans) name the idle gaps: each gap between device activities goes to the
innermost host range open at its middle."""

import bisect
from collections import defaultdict

WINDOW_RANGE = "bench/window"


def ranged(cls, method: str, label: str):
    """Wrap cls.method in a record_function range named label; returns
    the function that puts the method back."""
    from torch.profiler import record_function
    fn = cls.__dict__[method]

    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    setattr(cls, method, wrapped)
    return lambda: setattr(cls, method, fn)


def _is_range(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    if f is not None:
        return bool(f())
    return "::" not in ev.name()


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.summary = None

    def start(self):
        self._prof.__enter__()

    def stop(self):
        self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """{window_s, busy_s, device_ops: {name: s}, idle_by_range:
        {name: s}} of the window, and the breakdown lists."""
        events = self._prof.profiler.kineto_results.events()
        cuda = self._torch.autograd.DeviceType.CUDA
        device, ranges, window = [], [], None
        for ev in events:
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if ev.device_type() != cuda:
                if _is_range(ev):
                    if ev.name() == WINDOW_RANGE:
                        window = (start, end)
                    else:
                        ranges.append((start, end, ev.name()))
            elif not _is_range(ev):
                # a host range also shows on the device's timeline, over the
                # work issued inside it: that is no device activity
                device.append((start, end, ev.name()))
        names = {r[2] for r in ranges} | {WINDOW_RANGE}
        device = [d for d in device if d[2] not in names]
        if window is None:
            raise RuntimeError("the trace holds no window range")
        w0, w1 = window
        ops = defaultdict(float)
        spans = []
        for start, end, name in device:
            a, b = max(start, w0), min(end, w1)
            if b > a:
                ops[name] += (b - a) / 1e9
                spans.append((a, b))
        spans.sort()
        busy, gaps, cur = 0, [], w0
        for a, b in spans:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if w1 > cur:
            gaps.append((cur, w1))
        ranges.sort()
        starts = [r[0] for r in ranges]
        idle = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            name = "outside any range"
            # the latest-starting range that still covers mid is the
            # innermost; look back over a bounded number of ranges
            last = bisect.bisect_right(starts, mid) - 1
            for k in range(last, max(last - 2000, -1), -1):
                if ranges[k][1] >= mid:
                    name = ranges[k][2]
                    break
            idle[name] += (b - a) / 1e9
        self.summary = {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
                        "device_ops": dict(ops), "idle_by_range": dict(idle)}
        return self.summary

    def breakdown(self) -> dict:
        """The 10 device ops that took most time, and the idle time under
        the 10 host ranges that held most of it."""
        s = self.summary

        def rows(d):
            return [[name[:120], v] for name, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": rows(s["device_ops"]),
                "idle_gaps": rows(s["idle_by_range"])}

    def kernel_s(self, names) -> float:
        """Device seconds in the window of ops whose name holds any of
        `names`."""
        return sum(v for k, v in self.summary["device_ops"].items()
                   if any(n in k for n in names))
