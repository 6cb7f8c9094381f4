"""What a driver keeps of a window while it runs, kept out of the garbage
collector's way: arrays and bytes, no tuple a sample."""

from array import array


class SpanTotals:
    """The program's span table (utils/profiler.py), summed over the
    window's steps. That profiler keeps running totals a span name and
    thread (count, total, longest), exact however many spans close, and
    each thread's latest spans in a ring of bounded length (its RING), so
    a span costs the same however many came before it. fold() adds the
    table's counts and totals to the sums here and empties it after every
    step: the sums are what the table would read at the window's end."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.rows = {}

    def fold(self):
        for name, d in self.profiler.table().items():
            row = self.rows.setdefault(name, {"count": 0, "total_us": 0.0})
            row["count"] += d["count"]
            row["total_us"] += d["total_us"]
        self.profiler.reset()


class Latency:
    """Latency samples in arrays: (callback clock, handed-in clock, AUs)."""

    def __init__(self):
        self.cb, self.t_in, self.n = array("d"), array("d"), array("q")

    def add(self, t_cb: float, t_in: float, n: int):
        self.cb.append(t_cb)
        self.t_in.append(t_in)
        self.n.append(n)

    def __iter__(self):
        return zip(self.cb, self.t_in, self.n)
