"""What a driver keeps of a window while it runs, kept out of the garbage
collector's way: arrays and bytes, no tuple a sample."""

from array import array


class SpanTotals:
    """The program's span table (utils/profiler.py), summed over the
    window's steps. That profiler keeps every span and hashes the whole
    list of them at each top-level span's end, a cost that grows with the
    spans kept; so the harness folds the table and empties it after every
    step, and each step pays for its own spans alone."""

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
